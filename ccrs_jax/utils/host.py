"""Host-side (local CPU backend) execution scope.

On an accelerator every eagerly-executed jnp primitive compiles its own
one-op device graph and pays a launch and a synchronisation.  Host-side
bookkeeping math (pose generation, validation metrics, PRNG key
splitting) therefore runs on the LOCAL CPU backend, where one-op compiles
are cheap and cached in-process.  ``cpu_scope()`` pins ``jax.default_device`` to the first CPU
device for the duration of the ``with`` block; jitted calls inside the
block also execute on CPU, so keep it around *small host math only* —
never around device compute.
"""

from __future__ import annotations

import contextlib
import functools

import jax


@functools.lru_cache(maxsize=1)
def _cpu_device():
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:  # pragma: no cover - cpu backend always exists
        return None


def cpu_scope():
    """Context manager pinning eager/jit execution to the local CPU."""
    dev = _cpu_device()
    if dev is None:  # pragma: no cover
        return contextlib.nullcontext()
    return jax.default_device(dev)


def on_cpu(fn):
    """Decorator: run ``fn`` entirely under ``cpu_scope()``."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with cpu_scope():
            return fn(*args, **kwargs)

    return wrapper
