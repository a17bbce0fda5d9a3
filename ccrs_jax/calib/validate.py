"""Validation metrics: median and best-99% reprojection error.

Mirrors ``validation`` (``src/util.rs:721-826``): project the board through
the final model at each estimated pose, collect per-point L2 pixel errors,
report (avg of best 99%, median).  The metric math runs in host numpy f64
so the report is exact whatever the device (the projection itself is
evaluated via the JAX model on the CPU backend when available).
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..board import Board
from ..models import GenericModel
from ..models.projections import project_fn
from ..types import RvecTvec
from .frames import FrameBatch


def _project_host(model: GenericModel, pts: np.ndarray):
    """Project on the CPU backend for exact f64 (falls back to default)."""
    fn = project_fn(model.name)
    try:
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            p2d, valid = fn(jnp.asarray(model.params), jnp.asarray(pts))
    except RuntimeError:
        p2d, valid = fn(jnp.asarray(model.params), jnp.asarray(pts))
    return np.asarray(p2d), np.asarray(valid)


def reprojection_errors(
    board: Board,
    batch: FrameBatch,
    model: GenericModel,
    rtvecs: Dict[int, RvecTvec],
):
    """Per-frame per-point reprojection errors.

    All frames project in ONE batched call (one dispatch instead of one
    per frame).

    Returns list of (frame_idx, errors (n_i,), p2ds (n_i,2)).
    """
    frames = [i for i, _ in sorted(rtvecs.items()) if batch.mask[i].any()]
    if not frames:
        return []
    # stack camera-frame points for all frames (host f64 transform)
    p3c = np.stack([rtvecs[i].transform(board.p3d) for i in frames])  # (F,N,3)
    proj, _ = _project_host(model, p3c.reshape(-1, 3))
    proj = np.asarray(proj).reshape(len(frames), board.n_corners, 2)
    out = []
    for k, i in enumerate(frames):
        m = batch.mask[i]
        err = np.linalg.norm(proj[k][m] - batch.p2d[i][m], axis=-1)
        out.append((i, err, batch.p2d[i][m]))
    return out


def validation(
    board: Board,
    batch: FrameBatch,
    model: GenericModel,
    rtvecs: Dict[int, RvecTvec],
    recorder=None,
    cam_idx: int = 0,
) -> Tuple[float, float]:
    """(avg of best 99%, median) reprojection error in pixels
    (``src/util.rs:778-795``)."""
    per_frame = reprojection_errors(board, batch, model, rtvecs)
    errs = np.concatenate([e for _, e, _ in per_frame]) if per_frame else np.array([0.0])
    print(f"total pts: {errs.size}")
    errs_sorted = np.sort(errs)
    median = float(errs_sorted[errs_sorted.size // 2])
    n99 = errs_sorted.size * 99 // 100
    avg99 = float(errs_sorted[:n99].sum() / max(n99, 1))
    print(f"Median reprojection error: {median} px")
    print(f"Avg reprojection error of 99%: {avg99} px")
    if recorder is not None:
        recorder.log_validation(cam_idx, batch, board, model, rtvecs, per_frame)
    return avg99, median
