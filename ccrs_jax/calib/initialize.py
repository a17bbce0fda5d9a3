"""Closed-form camera initialization.

Covers the reference flow try_init_camera -> init_ucm
(``src/util.rs:107-378``) and the frame-selection heuristics
(``src/util.rs:168-219``), rebuilt on the batched solvers:

- the 1000-sample radial-distortion-homography RANSAC runs as one vmapped
  batch (ccrs_jax.solve.homography);
- division-model pose init (``src/optimization/linear.rs:5-21``) uses the
  planar PnP, batched over both init frames;
- the [f, alpha] UCM fit and the follow-up two-frame full UCM calibration
  are both ``ba_solve`` instances (theta = reduced UCM params with cx, cy
  frozen for the first stage — exactly the reference's parameter set).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..board import Board
from ..models import GenericModel
from ..models.projections import project_ucm, unproject_ucm
from ..solve.homography import (
    homography_to_focal_traced,
    radial_distortion_homography,
)
from ..solve.lm import ba_solve, expand_theta
from ..solve.pnp import solve_pnp_planar
from .frames import FrameBatch


def find_best_two_frames(batch: FrameBatch, random_pick: bool = False, rng=None):
    """Pick the two init frames (``src/util.rs:168-219``).

    Among frames with the maximum detection count: frame A = largest
    covered area, frame B = farthest feature-centroid from the group mean.
    ``random_pick`` (retry path) picks two random max-count frames.
    """
    counts = batch.counts()
    max_det = counts.max()
    cand = np.flatnonzero(counts == max_det)
    if len(cand) < 2:
        # Robustness improvement over the reference (util.rs:168-219, whose
        # degenerate single-max case returns the SAME frame twice and can
        # poison the two-frame init): widen to near-max frames so the two
        # init frames are always distinct when possible.
        near = np.flatnonzero(counts >= 0.9 * max_det)
        if len(near) >= 2:
            cand = near
        else:
            order = np.argsort(counts)[::-1]
            cand = order[: min(2, len(order))]
    if random_pick:
        rng = rng or np.random.default_rng()
        pick = rng.permutation(cand)
        return int(pick[0]), int(pick[1 % len(pick)])
    # feature centroids
    m = batch.mask[cand][..., None]
    pts = batch.p2d[cand]
    centers = (pts * m).sum(1) / np.maximum(m.sum(1), 1)
    avg_all = centers.mean(0)
    d2 = ((centers - avg_all) ** 2).sum(-1)
    # covered axis-aligned area
    big = np.where(batch.mask[cand][..., None], pts, np.nan)
    area = (np.nanmax(big[:, :, 0], 1) - np.nanmin(big[:, :, 0], 1)) * (
        np.nanmax(big[:, :, 1], 1) - np.nanmin(big[:, :, 1], 1)
    )
    idx_area = cand[int(np.argmax(area))]
    # farthest-centroid frame, required distinct from idx_area when
    # possible (the reference can return the same frame twice, which makes
    # the two-view init degenerate)
    order = np.argsort(d2)[::-1]
    idx_far = idx_area
    for j in order:
        if cand[j] != idx_area:
            idx_far = cand[j]
            break
    return int(idx_area), int(idx_far)


def _normalize(p2d, width, height):
    half_w, half_h = width / 2.0, height / 2.0
    half = max(half_w, half_h)
    return (p2d - np.array([half_w, half_h])) / half, half


@partial(jax.jit, static_argnames=("fixed_focal",))
def _try_init_device(
    key, q0, q1, pair_mask, p3d, p2d, masks, half, wh,
    fixed_focal: Optional[float] = None,
):
    """The ENTIRE init attempt as one device graph (one dispatch):

      RANSAC radial-distortion homography -> closed-form focal ->
      division-model planar PnP poses -> two-frame [f, alpha] UCM fit ->
      two-frame full UCM calibration (pose re-init + mixed-precision BA).

    Covers try_init_camera + init_ucm (src/util.rs:107-378).  Validity
    decisions that used to be host branches between dispatches are carried
    through as an ``ok`` flag.

    Args:
      q0, q1: (N,2) center/half-size-normalized observations of the two
        init frames; pair_mask (N,) both-observed.
      p3d: (N,3) board points; p2d (2,N,2) raw pixel observations;
        masks (2,N) per-frame observation masks.
      half, wh: normalization half-size and (w, h) as device scalars.
      fixed_focal: static — None, or the pinned focal value.

    Returns (params (5,) full UCM, ok flag).
    """
    # the init runs in f64: it is one dispatch and not the bottleneck
    dtype = q0.dtype
    lam, Hm, score = radial_distortion_homography(key, q0, q1, pair_mask)
    f_unit, f_ok = homography_to_focal_traced(Hm)
    ok = jnp.isfinite(score) & f_ok & jnp.isfinite(f_unit) & (f_unit > 0)

    init_f = (
        jnp.asarray(fixed_focal, dtype)
        if fixed_focal is not None
        else f_unit * half
    )
    init_alpha = jnp.abs(lam)
    w2 = masks.astype(dtype)

    # division-model pose init (linear.rs:5-21): undo r' = r (1 + lam r^2)
    q = jnp.stack([q0, q1])
    sc = 1.0 + lam * jnp.sum(q * q, axis=-1)
    qn = q / sc[..., None]
    r, t = jax.vmap(solve_pnp_planar)(
        jnp.broadcast_to(p3d, (2,) + p3d.shape), qn, w2
    )
    poses0 = jnp.concatenate([r, t], axis=1)

    # stage 1: reduced UCM theta = [f, cx, cy, alpha], cx/cy frozen at the
    # image center, f bounded to [f/3, 3f] (util.rs:345-346); loose rtol —
    # it only seeds stage 2
    half_w, half_h = wh[0] / 2.0, wh[1] / 2.0
    theta0 = jnp.stack([init_f, half_w, half_h, init_alpha])
    lo1 = jnp.stack([init_f / 3.0, jnp.zeros_like(init_f), jnp.zeros_like(init_f), jnp.asarray(1e-6, dtype)])
    hi1 = jnp.stack([init_f * 3.0, wh[0], wh[1], jnp.asarray(1.0, dtype)])
    free1 = jnp.asarray([0.0 if fixed_focal is not None else 1.0, 0.0, 0.0, 1.0], dtype)
    res1 = ba_solve(
        project_ucm, theta0, poses0, p3d, p2d, w2, lo1, hi1, free1,
        jnp.ones(2, dtype), one_focal=True, huber_delta=1.0, rtol=1e-6,
    )
    params1 = expand_theta(res1.theta, True)  # (5,) full UCM

    # stage 2: two-frame full UCM calibration with standard bounds
    # (util.rs:364-374) — pose re-init through the fitted model + BA
    from .single import _calib_camera_device

    lo2 = jnp.stack(
        [jnp.asarray(0.0, dtype), jnp.asarray(0.0, dtype),
         jnp.asarray(0.0, dtype), jnp.asarray(1e-6, dtype)]
    )
    hi2 = jnp.stack([jnp.asarray(1e4, dtype), wh[0], wh[1], jnp.asarray(1.0, dtype)])
    free2 = jnp.asarray([0.0 if fixed_focal is not None else 1.0, 1.0, 1.0, 1.0], dtype)
    theta2 = jnp.stack([params1[0], params1[2], params1[3], params1[4]])
    res2, frame_valid = _calib_camera_device(
        unproject_ucm, project_ucm, theta2, params1, p2d, masks, p3d,
        lo2, hi2, free2,
        jnp.zeros((p2d.shape[0], 6), dtype), jnp.zeros(p2d.shape[0], dtype),
        one_focal=True,
    )
    params = expand_theta(res2.theta, True)
    ok = (
        ok
        & jnp.isfinite(res2.cost)
        & (jnp.sum(frame_valid) > 0)
        & jnp.all(jnp.isfinite(params))
        & (params[0] != 0.0)
    )
    return params, ok


def try_init_camera(
    board: Board,
    batch: FrameBatch,
    frame0: int,
    frame1: int,
    key,
    fixed_focal: Optional[float] = None,
) -> Optional[GenericModel]:
    """One initialization attempt (``src/util.rs:107-159``).

    Returns a fitted UCM model or None (caller retries with a new key).
    """
    # matched pairs on normalized coordinates (host: tiny, data-dependent)
    q0, half = _normalize(batch.p2d[frame0], batch.width, batch.height)
    q1, _ = _normalize(batch.p2d[frame1], batch.width, batch.height)
    pair_mask = batch.mask[frame0] & batch.mask[frame1]
    sel = [frame0, frame1]
    # numpy operands: the jit transfers them; eager jnp casts here would
    # each compile a one-op device graph (utils/host.py)
    params, ok = _try_init_device(
        key,
        np.asarray(q0),
        np.asarray(q1),
        np.asarray(pair_mask),
        np.asarray(board.p3d, dtype=np.float64),
        np.asarray(batch.p2d[sel]),
        np.asarray(batch.mask[sel]),
        np.float64(half),
        np.asarray([batch.width, batch.height], np.float64),
        fixed_focal=fixed_focal,
    )
    if not bool(ok):
        return None
    params = np.asarray(params)
    if not np.isfinite(params).all() or params[0] == 0.0:
        return None
    return GenericModel("ucm", params, batch.width, batch.height)
