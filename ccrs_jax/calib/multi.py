"""Multi-camera extrinsic initialization + joint calibration.

Rebuilds ``init_camera_extrinsic`` (``src/util.rs:511-561``) and the host
side of ``calib_all_camera_with_extrinsics`` (``src/util.rs:567-715``):
common-frame pose-graph init per camera against cam0 (Huber 0.5 SE3
residuals on the dense LM core), then one joint Schur BA over all cameras'
intrinsics, the camera extrinsics, and the shared board poses.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..board import Board
from ..models import GenericModel
from ..models.projections import project_fn
from ..solve import se3
from ..solve.lm import (
    LMOptions,
    ba_solve_multi_mixed,
    expand_theta,
    lm_solve,
    reduce_params,
)
from ..types import RvecTvec
from .frames import FrameBatch
from .single import build_bounds, disabled_free_mask

log = logging.getLogger(__name__)


def init_camera_extrinsic(cam_rtvecs: List[Dict[int, RvecTvec]]) -> List[RvecTvec]:
    """Estimate T_cam_i<-cam0 from frames seen by both cameras."""
    out = [RvecTvec.identity()]
    for cam_i in range(1, len(cam_rtvecs)):
        common = sorted(set(cam_rtvecs[0]) & set(cam_rtvecs[cam_i]))
        if not common:
            log.warning("cam%d shares no frames with cam0; identity extrinsic", cam_i)
            out.append(RvecTvec.identity())
            continue
        t0b = np.stack(
            [np.concatenate([cam_rtvecs[0][f].rvec, cam_rtvecs[0][f].tvec]) for f in common]
        )
        tib = np.stack(
            [
                np.concatenate([cam_rtvecs[cam_i][f].rvec, cam_rtvecs[cam_i][f].tvec])
                for f in common
            ]
        )
        # init from the first common frame: T_i_0 = T_i_b * T_0_b^-1
        init = cam_rtvecs[cam_i][common[0]].compose(cam_rtvecs[0][common[0]].inverse())
        x0 = jnp.asarray(np.concatenate([init.rvec, init.tvec]))
        t0b_j, tib_j = jnp.asarray(t0b), jnp.asarray(tib)

        def residual(x):
            # log( T_i_b^-1 * T_i_0 * T_0_b ) per common frame (SE3Factor,
            # factors.rs:248-271)
            r_i0, t_i0 = x[:3], x[3:]
            rv_a, tv_a = se3.compose(
                jnp.broadcast_to(r_i0, t0b_j[:, :3].shape),
                jnp.broadcast_to(t_i0, t0b_j[:, 3:].shape),
                t0b_j[:, :3],
                t0b_j[:, 3:],
            )
            r_inv, t_inv = se3.inverse(tib_j[:, :3], tib_j[:, 3:])
            r_d, t_d = se3.compose(r_inv, t_inv, rv_a, tv_a)
            blocks = jnp.concatenate([r_d, t_d], axis=1)  # (K,6)
            return blocks, jnp.ones(blocks.shape[0], dtype=x.dtype)

        x, cost, _ = lm_solve(residual, x0, opts=LMOptions(huber_delta=0.5))
        x = np.asarray(x)
        log.info("extrinsic cam%d<-cam0: rvec %s tvec %s", cam_i, x[:3], x[3:])
        out.append(RvecTvec(x[:3], x[3:]))
    return out


def calib_all_camera_with_extrinsics(
    board: Board,
    cameras: List[GenericModel],
    t_cam_i_0: List[RvecTvec],
    cam_rtvecs: List[Dict[int, RvecTvec]],
    batches: List[FrameBatch],
    xy_same_focal: bool,
    disabled_distortions: int,
    cam0_fixed_focal: bool,
) -> Optional[Tuple[List[GenericModel], List[RvecTvec], Dict[int, RvecTvec]]]:
    """One joint problem over all cameras (``src/util.rs:567-715``).

    Returns (intrinsics, T_i_0 per camera, board poses {frame: T_0_b}) or
    None if the solve diverges (caller falls back to per-camera results,
    bin/camera_calibration.rs:320-343).
    """
    C = len(cameras)
    F = max(b.n_frames for b in batches)
    N = board.n_corners
    name = cameras[0].name
    if any(c.name != name for c in cameras):
        raise ValueError("all cameras must share a model type")
    k = cameras[0].n_params - (1 if xy_same_focal else 0)

    theta0 = np.zeros((C, k))
    lo = np.zeros((C, k))
    hi = np.zeros((C, k))
    free = np.zeros((C, k))
    p2d = np.zeros((C, F, N, 2))
    w = np.zeros((C, F, N))
    cam_frame_valid = np.zeros((C, F))
    ext0 = np.zeros((C, 6))

    # board-pose inits: cam0's estimate wins; else first camera that saw it
    pose0_map: Dict[int, np.ndarray] = {}
    for c in range(C):
        for f, rt in sorted(cam_rtvecs[c].items()):
            if f in pose0_map:
                continue
            if c == 0:
                pose0_map[f] = np.concatenate([rt.rvec, rt.tvec])
            else:
                t_0_b = t_cam_i_0[c].inverse().compose(rt)
                pose0_map[f] = np.concatenate([t_0_b.rvec, t_0_b.tvec])
    if not pose0_map:
        return None
    frame_valid = np.zeros(F)
    poses0 = np.zeros((F, 6))
    for f, p in pose0_map.items():
        frame_valid[f] = 1.0
        poses0[f] = p

    for c in range(C):
        theta0[c] = np.asarray(reduce_params(jnp.asarray(cameras[c].params), xy_same_focal))
        lo_c, hi_c = build_bounds(cameras[c], xy_same_focal)
        free_c = disabled_free_mask(cameras[c], xy_same_focal, disabled_distortions)
        theta0[c] = np.where(free_c == 0.0, 0.0, theta0[c])
        lo_c = np.where(free_c == 0.0, -np.inf, lo_c)
        hi_c = np.where(free_c == 0.0, np.inf, hi_c)
        lo[c], hi[c], free[c] = lo_c, hi_c, free_c
        if c > 0:
            ext0[c] = np.concatenate([t_cam_i_0[c].rvec, t_cam_i_0[c].tvec])
        b = batches[c]
        p2d[c, : b.n_frames] = b.p2d
        for f in cam_rtvecs[c]:
            cam_frame_valid[c, f] = 1.0
            w[c, f] = b.mask[f].astype(np.float64)
    if cam0_fixed_focal:
        free[0, 0] = 0.0  # util.rs:664-667

    import jax

    args = (
        project_fn(name),
        jnp.asarray(theta0),
        jnp.asarray(ext0),
        jnp.asarray(poses0),
        jnp.asarray(board.p3d, dtype=jnp.float64),
        jnp.asarray(p2d),
        jnp.asarray(w),
        jnp.asarray(lo),
        jnp.asarray(hi),
        jnp.asarray(free),
        jnp.asarray(cam_frame_valid),
        jnp.asarray(frame_valid),
    )
    n_dev = len(jax.devices())
    if n_dev > 1 and F >= n_dev:
        # multi-device: frame-sharded joint solve over the device mesh (one
        # psum'd reduced system per LM iteration; SURVEY.md §5 stretch)
        from ..parallel.mesh import multi_ba_sharded_mixed

        log.info("joint BA: %d frames sharded over a %d-device mesh", F, n_dev)
        res = multi_ba_sharded_mixed(*args, one_focal=xy_same_focal, huber_delta=1.0)
    else:
        log.info("joint BA: %d frames on one device (1-device mesh)", F)
        res = ba_solve_multi_mixed(*args, one_focal=xy_same_focal, huber_delta=1.0)
    if not np.isfinite(float(res.cost)):
        return None

    intrinsics = []
    t_i_0_out = []
    theta = np.asarray(res.theta)
    ext = np.asarray(res.ext)
    for c in range(C):
        m = cameras[c].copy()
        m.set_params(np.asarray(expand_theta(jnp.asarray(theta[c]), xy_same_focal)))
        intrinsics.append(m)
        t_i_0_out.append(
            RvecTvec.identity() if c == 0 else RvecTvec(ext[c, :3], ext[c, 3:])
        )
    poses = np.asarray(res.poses)
    board_rtvecs = {
        int(f): RvecTvec(poses[f, :3], poses[f, 3:])
        for f in np.flatnonzero(frame_valid > 0)
    }
    return intrinsics, t_i_0_out, board_rtvecs
