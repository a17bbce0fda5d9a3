"""Backend selection: the --platform option, the per-backend predicates of
the detect path, and where the compile cache goes."""

import os
import subprocess
import sys

import jax
import pytest

from ccrs_jax import cli
from ccrs_jax.utils import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, **env_overrides):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_overrides)
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name", ["auto", "cpu", "gpu"])
def test_platform_option_accepts(name):
    assert cli.build_parser().parse_args(["ds", "--platform", name]).platform == name


def test_platform_option_offers_only_auto_cpu_gpu(capsys):
    (opt,) = [a for a in cli.build_parser()._actions if a.dest == "platform"]
    assert tuple(opt.choices) == ("auto", "cpu", "gpu")
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["ds", "--platform", "rocm"])
    assert "invalid choice" in capsys.readouterr().err


def test_gpu_request_without_a_gpu_fails():
    """A run that asked for the GPU never carries on on the CPU."""
    out = _python(
        "from ccrs_jax.utils.backend import select_platform\n"
        "select_platform('gpu')\nprint('carried on')"
    )
    assert out.returncode != 0
    assert "carried on" not in out.stdout
    assert "--platform gpu" in out.stderr


def test_select_platform_cpu_and_auto_keep_the_cpu():
    backend.select_platform("auto")
    backend.select_platform("cpu")
    assert jax.default_backend() == "cpu"
    with pytest.raises(ValueError):
        backend.select_platform("rocm")


def test_fixed_shape_plan_choice(monkeypatch):
    monkeypatch.delenv("CCRS_FORCE_CHUNK_PLAN", raising=False)
    assert not backend.pad_to_fixed_shapes()  # CPU: natural sizes
    monkeypatch.setenv("CCRS_FORCE_CHUNK_PLAN", "1")
    assert backend.pad_to_fixed_shapes()
    monkeypatch.delenv("CCRS_FORCE_CHUNK_PLAN")
    monkeypatch.setattr(backend.jax, "default_backend", lambda: "gpu")
    assert backend.pad_to_fixed_shapes()


def test_compile_cache_honours_environment(tmp_path):
    target = str(tmp_path / "cache")
    out = _python(
        "import jax, ccrs_jax; print(jax.config.jax_compilation_cache_dir)",
        JAX_COMPILATION_CACHE_DIR=target,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == target


def test_compile_cache_default_is_fixed_in_checkout():
    code = "import jax, ccrs_jax; print(jax.config.jax_compilation_cache_dir)"
    first, second = _python(code), _python(code)
    assert first.returncode == 0, first.stderr
    path = first.stdout.strip().splitlines()[-1]
    assert path == os.path.join(REPO, ".xla_cache")
    assert second.stdout.strip().splitlines()[-1] == path
