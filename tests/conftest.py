"""Test configuration: run everything on a hermetic 8-device virtual CPU mesh.

The GPU runs happen through chip_smoke.py; tests validate numerics and the
multi-device sharding story on `--xla_force_host_platform_device_count=8`.
Tests that need a GPU carry the ``gpu`` marker and skip here.
"""

import os

# CCRS_TESTS_ON_GPU=1 leaves JAX its default backend, for the gpu-marked
# tests on a machine with a GPU (see tests/test_gpu.py).
ON_GPU = os.environ.get("CCRS_TESTS_ON_GPU") == "1"

if not ON_GPU:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    # Tests keep a persistent compile cache of their own, never shared with
    # accelerator runs (running uncached pushes the suite past 10 min: the
    # LM / wave-advance graphs are compile-heavy even on CPU).  ccrs_jax
    # leaves the cache directory to JAX_COMPILATION_CACHE_DIR when it is
    # set, so this must run before ccrs_jax is imported.
    os.environ.setdefault(
        "JAX_COMPILATION_CACHE_DIR",
        os.path.join(os.path.dirname(os.path.dirname(__file__)), ".xla_cache_cpu"),
    )

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    # in case a plugin imported jax before the variable above was set
    jax.config.update(
        "jax_compilation_cache_dir", os.environ["JAX_COMPILATION_CACHE_DIR"]
    )

# ROOT CAUSE of the late-suite "jaxlib serialize/deserialize/compile crashes"
# (previously misattributed to a jaxlib (de)serialization bug): mmap
# exhaustion.  Every XLA:CPU JIT-compiled function is loaded as its own
# (r-xp, r--p, rw-p) triplet of small anonymous maps and is NEVER unmapped
# (jax.clear_caches() frees Python refs but not the code pages — measured).
# The full suite compiles enough graph-internal functions to push the
# process past the kernel default vm.max_map_count=65530 (~64.7k maps
# observed at death); the crash then surfaces in whatever allocates next —
# executable serialize, cache deserialize, or backend_compile itself, which
# is why the crash site wandered between runs.  Fix: raise the limit (root
# in this image).  The persistent-cache bypass below stays as a
# defense-in-depth fallback for non-root environments, since cached COLD
# runs (everything deserialized) map fewer functions than compile+serialize
# paths do.
_limit_raised = False
try:
    with open("/proc/sys/vm/max_map_count") as _f:
        _limit = int(_f.read())
    if _limit < 262144:
        with open("/proc/sys/vm/max_map_count", "w") as _f:
            _f.write("262144")
        _limit_raised = True
    else:
        _limit_raised = True  # already high enough
except (OSError, PermissionError):
    pass  # not root: the cache bypass below keeps the map count lower


# Defense-in-depth for environments where the limit can't be raised: from
# the late compile-heavy files on, bypass the persistent compilation cache
# (serialize/deserialize each add transient map pressure right at the peak;
# in-memory jit caches still apply and most late tests reuse earlier graphs,
# so a cold-cache run only pays a few extra minutes).
_CACHE_CUTOFF_FILES = ("test_speculative", "test_stressors", "test_track")
_cache_bypassed = False


def pytest_runtest_setup(item):
    global _cache_bypassed
    if _cache_bypassed or _limit_raised:
        return
    base = item.fspath.purebasename if hasattr(item, "fspath") else ""
    if any(base.startswith(p) for p in _CACHE_CUTOFF_FILES):
        from jax._src import compiler as _compiler

        _compiler._cache_read = lambda *a, **k: (None, None)
        _compiler._cache_write = lambda *a, **k: None
        _cache_bypassed = True
