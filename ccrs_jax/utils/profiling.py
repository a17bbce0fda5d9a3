"""Tracing / profiling helpers.

The reference's observability is env_logger + manual Instant timing
(SURVEY.md §5); here: scoped wall-clock timers that aggregate per stage,
plus a helper to capture a JAX device profile around any callable.

Enable stage timing with CCRS_TIMING=1 (report printed at exit) and
device traces with ``with_profiler(fn, logdir)`` or the CLI's
``CCRS_PROFILE_DIR`` environment variable.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import os
import threading
import time

_ENABLED = os.environ.get("CCRS_TIMING", "") not in ("", "0")
# CCRS_TIMING_SPANS=1 additionally records every stage invocation as a
# (name, thread, t0, t1) span so overlapped stages (speculation, audit
# sweeps, prewarm threads) can be laid out on a timeline — the aggregate
# totals alone cannot show the critical path.
_SPANS = os.environ.get("CCRS_TIMING_SPANS", "") not in ("", "0")
_totals: dict = collections.defaultdict(float)
_counts: dict = collections.defaultdict(int)
_span_list: list = []
_tls = threading.local()


@contextlib.contextmanager
def stage(name: str):
    """Accumulating wall-clock timer; no-op unless CCRS_TIMING=1."""
    if not _ENABLED:
        yield
        return
    name = getattr(_tls, "prefix", "") + name
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        _totals[name] += t1 - t0
        _counts[name] += 1
        if _SPANS and len(_span_list) < 100_000:
            # bounded: a long-lived process with spans enabled and no
            # reset() must not leak unboundedly
            _span_list.append(
                (name, threading.current_thread().name, t0, t1)
            )


@contextlib.contextmanager
def stage_prefix(prefix: str):
    """Prefix stage names on the CURRENT thread (e.g. "spec/" for the
    speculative calibration so its overlapped wall-clock is not
    conflated with the critical-path calib stages)."""
    prev = getattr(_tls, "prefix", "")
    _tls.prefix = prev + prefix
    try:
        yield
    finally:
        _tls.prefix = prev


def report() -> str:
    lines = ["ccrs timing report:"]
    for name, total in sorted(_totals.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:30s} {total:8.3f}s  x{_counts[name]}")
    return "\n".join(lines)


def reset() -> None:
    """Clear accumulated stage totals (e.g. after a warmup run)."""
    _totals.clear()
    _counts.clear()
    _span_list.clear()


def spans() -> list:
    """Snapshot of (name, thread, t0, t1) spans (CCRS_TIMING_SPANS=1)."""
    return list(_span_list)


def totals() -> dict:
    """Snapshot of accumulated stage wall-clock seconds."""
    return dict(_totals)


def enable() -> None:
    """Turn stage timing on programmatically (bench uses this)."""
    global _ENABLED
    _ENABLED = True


if _ENABLED:  # pragma: no cover
    atexit.register(lambda: print(report()))


@contextlib.contextmanager
def with_profiler(logdir: str):
    """Capture a JAX/XLA device trace (view with TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
