"""Detector recall under hard imaging stressors (r02 verdict #9).

Zero egress makes real-dataset validation breadth impossible (BASELINE.md),
so the synthetic stressor battery stands in: motion blur, heavy vignette,
and mild out-of-plane board warp.  Each test RECORDS the measured recall
(printed) and asserts a floor, so regressions in the detect stack surface
as hard failures.
"""

import numpy as np
import pytest

from ccrs_jax.board import create_default_6x6_board
from ccrs_jax.detect import TagDetector, get_family
from ccrs_jax.models import GenericModel
from ccrs_jax.testdata import (
    gt_corners,
    render_board_image,
    smooth_sequence_poses,
)

N_FRAMES = 6


@pytest.fixture(scope="module")
def scene():
    board = create_default_6x6_board()
    fam = get_family("t36h11")
    gt = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    poses = smooth_sequence_poses(N_FRAMES, board, seed=21, keyframe_every=8)
    imgs, vis_tags = [], []
    for f, p in enumerate(poses):
        imgs.append(
            render_board_image(gt, board, fam, p[:3], p[3:], noise=1.0, seed=f)
        )
        p2d, vis = gt_corners(gt, board, p[:3], p[3:])
        # a tag counts as visible when all 4 corners project validly with
        # a safety margin off the border
        v4 = vis.reshape(-1, 4).all(axis=1)
        inb = (
            (p2d.reshape(-1, 4, 2)[..., 0] > 6)
            & (p2d.reshape(-1, 4, 2)[..., 0] < 505)
            & (p2d.reshape(-1, 4, 2)[..., 1] > 6)
            & (p2d.reshape(-1, 4, 2)[..., 1] < 505)
        ).all(axis=1)
        vis_tags.append(v4 & inb)
    return board, np.stack(imgs), np.stack(vis_tags)


def _recall(board, imgs, vis_tags, label):
    det = TagDetector("t36h11", track=False)
    dets = det.detect_batch(imgs, board=board)
    first = board.config.first_id
    n_vis = n_hit = 0
    for f, d in enumerate(dets):
        vt = np.flatnonzero(vis_tags[f]) + first
        n_vis += vt.size
        n_hit += sum(1 for t in vt if t in d)
    recall = n_hit / max(n_vis, 1)
    print(f"stressor recall [{label}]: {n_hit}/{n_vis} = {recall:.3f}")
    return recall


def _motion_blur(imgs, length=7, angle_deg=30.0):
    """Directional box blur (camera shake during exposure)."""
    from scipy.ndimage import convolve

    k = np.zeros((length, length), np.float64)
    a = np.deg2rad(angle_deg)
    c = (length - 1) / 2
    for i in range(length * 4):
        t = -c + i * (2 * c) / (length * 4 - 1)
        y = int(round(c + t * np.sin(a)))
        x = int(round(c + t * np.cos(a)))
        k[y, x] = 1.0
    k /= k.sum()
    out = np.stack([convolve(im.astype(np.float64), k, mode="nearest") for im in imgs])
    return np.clip(out, 0, 255).astype(np.uint8)


def _vignette(imgs, strength=0.65):
    yy, xx = np.mgrid[0 : imgs.shape[1], 0 : imgs.shape[2]]
    cy, cx = (imgs.shape[1] - 1) / 2, (imgs.shape[2] - 1) / 2
    r2 = ((xx - cx) ** 2 + (yy - cy) ** 2) / (cx**2 + cy**2)
    v = 1.0 - strength * r2
    return np.clip(imgs.astype(np.float64) * v, 0, 255).astype(np.uint8)


def _board_warp(imgs, amp=2.0, wavelength=170.0):
    """Mild out-of-plane board bow, modeled as a smooth sinusoidal image
    displacement field (paper boards are never perfectly flat)."""
    from scipy.ndimage import map_coordinates

    B, H, W = imgs.shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    dx = amp * np.sin(2 * np.pi * yy / wavelength)
    dy = amp * np.cos(2 * np.pi * xx / wavelength)
    out = np.stack(
        [
            map_coordinates(im.astype(np.float64), [yy + dy, xx + dx], order=1,
                            mode="nearest")
            for im in imgs
        ]
    )
    return np.clip(out, 0, 255).astype(np.uint8)


def test_recall_clean_baseline(scene):
    board, imgs, vis = scene
    assert _recall(board, imgs, vis, "clean") >= 0.97


def test_recall_motion_blur(scene):
    """Measured frontier (2026-08, r03): 3 px 0.93, 5 px 0.61, 7 px 0.08 —
    the ~4-5 px tag data cells stop resolving past ~1 cell of smear, which
    the reference detector family shares (video supplies plenty of sharp
    frames; blurred ones drop out via MIN_CORNERS)."""
    board, imgs, vis = scene
    assert _recall(board, _motion_blur(imgs, length=3), vis, "motion-blur-3px") >= 0.90
    assert _recall(board, _motion_blur(imgs, length=5), vis, "motion-blur-5px") >= 0.50


def test_recall_heavy_vignette(scene):
    board, imgs, vis = scene
    assert _recall(board, _vignette(imgs), vis, "vignette-0.65") >= 0.95


def test_recall_board_warp(scene):
    board, imgs, vis = scene
    assert _recall(board, _board_warp(imgs), vis, "warp-2px") >= 0.95


def test_recall_combined(scene):
    board, imgs, vis = scene
    stressed = _vignette(_motion_blur(_board_warp(imgs), length=3), 0.5)
    assert _recall(board, stressed, vis, "combined") >= 0.80
