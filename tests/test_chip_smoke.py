"""chip_smoke.py: refuses to run without a GPU or without the package, and
its phases run end to end on the CPU at a tiny size (test-only entry)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_script(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "chip_smoke.py")], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_fails_without_gpu():
    out = _run_script(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_script(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "ccrs_jax" in out.stderr


def test_tiny_dry_run_on_cpu(tmp_path):
    device, results = chip_smoke.run_phases(
        chip_smoke.TINY, require_gpu=False, work=str(tmp_path / "work")
    )
    assert device == {"platform": "cpu", "kind": "cpu",
                      "count": device["count"]}
    assert set(results) == {"mono", "stereo"}
    assert set(results["stereo"]["cams"]) == {0, 1}
    assert results["mono"]["cams"][0]["mask"].any()


def test_busy_time_is_the_union_of_intervals():
    ev = [(0, 10), (5, 15), (20, 25), (21, 22), (25, 26)]
    assert chip_smoke._busy_ns(ev) == 15 + 5 + 1


def _result(path, shift=0.0, scale=1.0, drop=False):
    mask = np.ones((3, 4), bool)
    if drop:
        mask[1, 2] = False
    np.savez(path, **{
        "mono/0/p2d": np.arange(24.0).reshape(3, 4, 2) + shift,
        "mono/0/mask": mask,
        "mono/0/params": np.array([190.9, 190.8, 254.9, 256.8]) * scale,
        "stereo/ext": np.array([0.0, -0.02, 0.005, -0.11, 0.002, 0.004]) * scale,
    })
    return str(path)


@pytest.mark.parametrize(
    "kw,ok",
    [(dict(), True), (dict(shift=1e-2), True), (dict(shift=5e-2), False),
     (dict(scale=1 + 1e-3), False), (dict(drop=True), False)],
    ids=["same", "corners-in-bound", "corners-out", "params-out", "tags-differ"],
)
def test_four_against_one_comparison(tmp_path, kw, ok):
    a = _result(tmp_path / "a.npz")
    b = _result(tmp_path / "b.npz", **kw)
    if ok:
        chip_smoke.compare_runs(a, b)
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.compare_runs(a, b)
