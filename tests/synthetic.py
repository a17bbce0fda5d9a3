"""Shared synthetic-data helpers for tests: feature-level dataset generation
(GT camera + poses -> FrameBatch), mirroring the geometry of a handheld
calibration sequence."""

import numpy as np
import jax.numpy as jnp

from ccrs_jax.board import Board, BoardConfig
from ccrs_jax.calib.frames import FrameBatch
from ccrs_jax.models import GenericModel
from ccrs_jax.models.projections import project_fn
from ccrs_jax.solve import se3


def make_synthetic_batch(
    model: GenericModel,
    board: Board,
    n_frames: int = 24,
    seed: int = 0,
    px_noise: float = 0.0,
    min_corners: int = 24,
):
    """Render feature-level observations of the board through a GT model.

    Poses sweep the board across the FOV with varied tilt/distance so the
    problem is well-conditioned (like a real calibration sequence).
    Returns (FrameBatch, poses_gt (F,6)).
    """
    rng = np.random.default_rng(seed)
    N = board.n_corners
    proj = project_fn(model.name)
    span = board.p3d[:, :2].max(0) - board.p3d[:, :2].min(0)
    center = board.p3d.mean(0)

    poses, p2ds, masks = [], [], []
    f = 0
    attempts = 0
    while f < n_frames and attempts < n_frames * 20:
        attempts += 1
        # camera looks roughly at the board center from varied directions
        tilt = rng.normal(size=3) * np.array([0.45, 0.45, 0.6])
        dist = rng.uniform(0.65, 1.6) * float(max(span))
        offset = rng.normal(size=2) * 0.35 * float(max(span))
        rvec = tilt
        R = np.asarray(se3.exp_so3(jnp.asarray(rvec)))
        # choose t so that the board center lands near the optical axis
        pc_center = R @ center
        t = np.array([offset[0], offset[1], dist]) - pc_center
        pc = board.p3d @ R.T + t
        if (pc[:, 2] <= 0.05).any():
            continue
        p2d, valid = proj(jnp.asarray(model.params), jnp.asarray(pc))
        p2d = np.asarray(p2d)
        valid = np.asarray(valid)
        inside = (
            valid
            & (p2d[:, 0] >= 0)
            & (p2d[:, 0] < model.width)
            & (p2d[:, 1] >= 0)
            & (p2d[:, 1] < model.height)
        )
        if inside.sum() < min_corners:
            continue
        if px_noise > 0:
            p2d = p2d + rng.normal(size=p2d.shape) * px_noise
        poses.append(np.concatenate([rvec, t]))
        p2ds.append(np.where(inside[:, None], p2d, 0.0))
        masks.append(inside)
        f += 1
    assert f == n_frames, f"only generated {f}/{n_frames} frames"
    batch = FrameBatch(
        time_ns=np.arange(n_frames, dtype=np.int64) * 100_000_000,
        p2d=np.stack(p2ds),
        mask=np.stack(masks),
        width=int(model.width),
        height=int(model.height),
    )
    return batch, np.stack(poses)


def tumvi_like_eucm():
    return GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
