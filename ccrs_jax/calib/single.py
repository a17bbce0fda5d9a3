"""Single-camera bundle-adjustment calibration.

Rebuilds ``calib_camera`` (``src/util.rs:384-490``) on the Schur-structured
``ba_solve``: the per-feature ReprojectionFactor graph becomes one
``(F, N, 2)`` masked residual tensor; per-frame pose init is the batched
unproject -> planar-PnP path of ``src/util.rs:418-439`` with the <10-valid
frame skip expressed as a frame mask.
"""

from __future__ import annotations

import os
import sys
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.host import cpu_scope
from ..board import Board
from ..models import GenericModel
from ..models.projections import project_fn, unproject_fn
from ..solve.lm import ba_solve, ba_solve_mixed, expand_theta, reduce_params
from ..solve.pnp import solve_pnp_planar
from ..types import RvecTvec
from .frames import FrameBatch

MIN_PNP_POINTS = 10  # src/util.rs:431


def build_bounds(model: GenericModel, one_focal: bool):
    """Parameter bounds mirroring set_problem_parameter_bound
    (``src/util.rs:29-49``): focals in (0, 1e4), cx/cy in (0, w/h),
    distortion bounds from the model table."""
    n = model.n_params
    lo = np.full(n, -np.inf)
    hi = np.full(n, np.inf)
    lo[0:2], hi[0:2] = 0.0, 1e4
    lo[2], hi[2] = 0.0, model.width
    lo[3], hi[3] = 0.0, model.height
    for idx, (l, h) in model.distortion_params_bound().items():
        lo[idx], hi[idx] = l, h
    if one_focal:
        lo = np.delete(lo, 1)
        hi = np.delete(hi, 1)
    return lo, hi


def disabled_free_mask(model: GenericModel, one_focal: bool, disabled: int):
    """Free-mask that fixes the last ``disabled`` distortion params
    (set_problem_parameter_disabled, ``src/util.rs:50-71``); the caller also
    zeroes those entries in theta0."""
    n = model.n_params - (1 if one_focal else 0)
    free = np.ones(n)
    for i in range(disabled):
        free[n - 1 - i] = 0.0
    return free


def _pose_init_core(unproj, params, p2d, mask, p3d):
    """Whole per-frame pose init as ONE device graph: unproject -> x/z ->
    batched planar PnP (eager op-by-op execution would dispatch and
    compile each primitive on its own)."""
    rays, uvalid = unproj(params, p2d)
    uvalid = uvalid & mask
    z = rays[..., 2:3]
    z = jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)
    obs = rays[..., :2] / z
    obs = jnp.where(jnp.isfinite(obs), obs, 0.0)
    counts = jnp.sum(uvalid, axis=1)
    frame_valid = (counts >= MIN_PNP_POINTS).astype(params.dtype)
    w = uvalid.astype(params.dtype)
    w_safe = jnp.where(frame_valid[:, None] > 0, w, 1.0)
    p3d_b = jnp.broadcast_to(p3d, (p2d.shape[0],) + p3d.shape)
    r, t = jax.vmap(solve_pnp_planar)(p3d_b, obs, w_safe)
    poses = jnp.concatenate([r, t], axis=1)
    poses = jnp.where(jnp.isfinite(poses), poses, 0.0)
    return poses, frame_valid


_pose_init_device = partial(jax.jit, static_argnames=("unproj",))(_pose_init_core)


@partial(
    jax.jit,
    static_argnames=(
        "unproj", "project_fn", "one_focal", "max_iters", "huber_delta",
        "polish_iters", "skip_pose_init", "pose_init_f32",
    ),
)
def _calib_camera_device(
    unproj, project_fn, theta0, params_full, p2d, mask, p3d, lo, hi, free,
    warm_poses, warm_valid,
    one_focal: bool, max_iters: int = 60, huber_delta: float = 1.0,
    polish_iters: int = 12, skip_pose_init: bool = False,
    pose_init_f32: bool = False,
):
    """Whole single-camera calibration as ONE device graph:
    unproject -> planar-PnP pose init -> mixed-precision Schur LM bundle
    adjustment (f32 bulk descent + f64 polish; halves the dispatch
    round-trips of calib_camera and runs most iterations in f32).

    ``warm_poses``/``warm_valid``: optional per-frame pose warm start
    (the speculative calibration that overlaps the detector's audit
    rounds seeds the final solve with its result).  Frames with
    warm_valid=0 fall back to the PnP init; an all-zero warm_valid is
    bit-identical to the cold solve, so cold and warm share this ONE
    compiled graph (a dedicated warm graph would be another compile at
    warmup).

    The pose init stays in f64: an f32 variant (now compilable since the
    PnP became Cholesky-only and its GN polish carries the rotation as a
    matrix) measurably degraded the final optimum — median reprojection
    rose 0.130 -> 0.149 px and the bench's f64 interchange gate blew up,
    because the f64 polish budget is sized for f64-quality seeds.

    ``skip_pose_init`` (static): drop the in-graph PnP entirely and seed
    every frame from ``warm_poses`` — the f64 PnP init was measured as the
    single largest cost of this graph, and a warm start that covers all
    frames doesn't need it.  Frame validity then falls back to the
    observed-corner count (>= MIN_PNP_POINTS; the PnP variant counts
    unprojectABLE corners, a strictly tighter test) — the LM still
    damps/rejects, and the callers' sanity gates judge the result.  Only
    the warm (speculation-seeded) path uses this; the cold path keeps
    exact reference semantics.

    ``pose_init_f32`` (static): run the PnP init in f32 instead of f64 —
    ONLY for seed-quality solves (the
    SPECULATIVE path): an f32-initialized FINAL solve measurably degraded
    the optimum (see above), but the speculative output is re-polished by
    the final solve anyway, and shaving its PnP shrinks the device graph
    the detector's audit sweeps queue behind."""
    if skip_pose_init:
        poses0 = warm_poses
        frame_valid = (
            jnp.sum(mask, axis=1) >= MIN_PNP_POINTS
        ).astype(theta0.dtype)
    else:
        f32 = jnp.float32
        poses0, frame_valid = _pose_init_core(
            unproj,
            params_full.astype(f32) if pose_init_f32 else params_full,
            p2d.astype(f32) if pose_init_f32 else p2d,
            mask,
            p3d.astype(f32) if pose_init_f32 else p3d,
        )
        poses0 = poses0.astype(theta0.dtype)
        frame_valid = frame_valid.astype(theta0.dtype) * (
            jnp.sum(mask, axis=1) > 0
        )
        poses0 = jnp.where((warm_valid > 0)[:, None], warm_poses, poses0)
    res = ba_solve_mixed(
        project_fn, theta0, poses0, p3d, p2d, mask.astype(theta0.dtype),
        lo, hi, free, frame_valid,
        one_focal=one_focal, max_iters=max_iters, huber_delta=huber_delta,
        polish_iters=polish_iters,
    )
    return res, frame_valid


def init_frame_poses(board: Board, batch: FrameBatch, model: GenericModel):
    """Batched pose init for every frame: unproject observations through the
    current model, planar PnP on the valid ones (src/util.rs:418-439).

    Returns (poses (F,6) np, frame_valid (F,) np) — frames with fewer than
    MIN_PNP_POINTS valid unprojections are masked out.
    """
    poses, frame_valid = _pose_init_device(
        unproject_fn(model.name),
        jnp.asarray(model.params),
        jnp.asarray(batch.p2d),
        jnp.asarray(batch.mask),
        jnp.asarray(board.p3d, dtype=jnp.float64),
    )
    return np.asarray(poses), np.asarray(frame_valid)


def calib_camera(
    board: Board,
    batch: FrameBatch,
    camera: GenericModel,
    xy_same_focal: bool,
    disabled_distortions: int,
    fixed_focal: bool,
    warm_poses: Optional[np.ndarray] = None,
    warm_valid: Optional[np.ndarray] = None,
    polish_iters: int = 12,
    skip_pose_init: bool = False,
    pose_init_f32: bool = False,
) -> Optional[Tuple[GenericModel, Dict[int, RvecTvec]]]:
    """Full single-camera BA (``src/util.rs:384-490``).

    ``warm_poses`` (F,6) / ``warm_valid`` (F,): optional pose warm start
    (see _calib_camera_device); pass the speculative solve's poses to
    seed the final one.  The intrinsics warm start rides ``camera``.
    ``polish_iters``: f64 polish budget — the SPECULATIVE solve truncates
    it (its output is only a seed; the final solve re-polishes).
    ``skip_pose_init``: drop the in-graph PnP init (requires warm_poses
    covering every frame; see _calib_camera_device).

    Returns (calibrated model, {frame_idx: board->camera pose}) or None.
    """
    if skip_pose_init and warm_poses is None:
        raise ValueError("skip_pose_init requires warm_poses")
    params0 = camera.params.copy()
    with cpu_scope():
        theta0 = np.asarray(reduce_params(jnp.asarray(params0), xy_same_focal))
    lo, hi = build_bounds(camera, xy_same_focal)
    free = disabled_free_mask(camera, xy_same_focal, disabled_distortions)
    # zero the disabled distortion entries (util.rs:69); at this point the
    # free-mask only pins disabled distortion tail entries.  Widen their
    # bounds so the initial clamp cannot move a pinned zero (e.g. beta's
    # lower bound is 1e-6 but a disabled beta must stay exactly 0).
    theta0 = np.where(free == 0.0, 0.0, theta0)
    lo = np.where(free == 0.0, -np.inf, lo)
    hi = np.where(free == 0.0, np.inf, hi)

    F = batch.p2d.shape[0]
    if warm_poses is None:
        warm_poses = np.zeros((F, 6), np.float64)
        warm_valid = np.zeros((F,), np.float64)
    # numpy operands: the jit transfers them; eager jnp casts here would
    # each compile a one-op device graph (utils/host.py)
    res, frame_valid_j = _calib_camera_device(
        unproject_fn(camera.name),
        project_fn(camera.name),
        np.asarray(theta0),
        np.asarray(camera.params, np.float64),
        np.asarray(batch.p2d),
        np.asarray(batch.mask),
        np.asarray(board.p3d, dtype=np.float64),
        np.asarray(lo),
        np.asarray(hi),
        np.asarray(free, np.float64),
        np.asarray(warm_poses, np.float64),
        np.asarray(warm_valid, np.float64),
        one_focal=xy_same_focal,
        polish_iters=polish_iters,
        skip_pose_init=skip_pose_init,
        pose_init_f32=pose_init_f32,
    )
    frame_valid = np.asarray(frame_valid_j)
    if os.environ.get("CCRS_TIMING"):
        print(
            f"[ba] iters total={int(res.n_iters)} "
            f"polish={int(np.asarray(res.n_polish))}",
            file=sys.stderr,
        )
    if frame_valid.sum() == 0 or not np.isfinite(float(res.cost)):
        return None
    theta, poses = res.theta, res.poses
    if fixed_focal:
        # re-solve with f clamped at the requested value (util.rs:459-464)
        theta = theta.at[0].set(params0[0])
        free_fix = free.copy()
        free_fix[0] = 0.0
        res = ba_solve(
            project_fn(camera.name), theta, poses,
            jnp.asarray(board.p3d, dtype=jnp.float64), jnp.asarray(batch.p2d),
            jnp.asarray(batch.mask.astype(np.float64)), jnp.asarray(lo),
            jnp.asarray(hi), jnp.asarray(free_fix), frame_valid_j,
            one_focal=xy_same_focal, huber_delta=1.0,
        )
        theta, poses = res.theta, res.poses

    new_params = np.asarray(expand_theta(theta, xy_same_focal))
    out_model = camera.copy()
    out_model.set_params(new_params)
    poses = np.asarray(poses)
    rtvecs = {
        int(i): RvecTvec(poses[i, :3], poses[i, 3:])
        for i in np.flatnonzero(frame_valid > 0)
    }
    return out_model, rtvecs
