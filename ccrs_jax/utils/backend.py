"""Backend selection and the per-backend choices of the detect path.

Every place where the pipeline behaves differently on an accelerator reads
a predicate here, so a test can force either branch on the CPU by
monkeypatching it.
"""

from __future__ import annotations

import os

import jax

#: values of the CLI's ``--platform`` option
PLATFORMS = ("auto", "cpu", "gpu")


def select_platform(name: str) -> None:
    """Pin JAX to ``name`` ("auto" keeps JAX's default, which is the CUDA
    backend on a machine with a GPU).  Raises SystemExit when the requested
    platform is not what JAX then runs on: a run that asked for the GPU
    never carries on on the CPU."""
    if name not in PLATFORMS:
        raise ValueError(f"unknown platform {name!r}; choose from {PLATFORMS}")
    if name == "auto":
        return
    jax.config.update("jax_platforms", "cuda" if name == "gpu" else name)
    try:
        found = jax.devices()[0].platform
    except Exception as e:  # JAX raises RuntimeError or AssertionError here
        raise SystemExit(
            f"--platform {name}: JAX cannot start that backend ({e!r})"
        ) from e
    if found != name:
        raise SystemExit(f"--platform {name} requested but JAX runs on {found!r}")


def pad_to_fixed_shapes() -> bool:
    """Cover detect batches with the detector's fixed chunk sizes (padding
    with repeated frames) instead of their natural sizes.

    On the GPU every distinct batch shape compiles its own set of detect
    graphs (seconds each, kept in the persistent cache), so datasets of any
    length reuse the same few executables.  On the CPU compiles are cheap
    and small batches keep their size.  ``CCRS_FORCE_CHUNK_PLAN=1`` forces
    the fixed plan anywhere."""
    return jax.default_backend() == "gpu" or bool(
        os.environ.get("CCRS_FORCE_CHUNK_PLAN")
    )

