"""Tracking recall under HIGH-ACCELERATION camera shake.

The wave predictor seeds each frame from a quadratic (3-frame) fit; a
shake whose per-frame acceleration exceeds the refine capture radius
defeats pure extrapolation, so recall then rests on the in-wave assist
(same-frame neighbor homography) and, failing that, the audit fallback.
This pins the end guarantee — per-frame detections are a superset of the
cold detector's — in the regime where the predictor itself is at its
worst (tests/test_track.py covers smooth and discontinuous motion; this
covers the violent-but-continuous middle ground).
"""

import numpy as np
import pytest

from ccrs_jax.board import create_default_6x6_board
from ccrs_jax.detect import TagDetector, get_family
from ccrs_jax.models import GenericModel
from ccrs_jax.testdata import render_board_image, smooth_sequence_poses


@pytest.fixture(scope="module")
def shake_video():
    """16 frames of smooth motion + alternating high-frequency shake:
    ~6-10 px/frame^2 corner acceleration at image center (measured vs the
    3-4 px/frame^2 of the handheld bench regime)."""
    board = create_default_6x6_board()
    fam = get_family("t36h11")
    model = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    n = 16
    poses = smooth_sequence_poses(n, board, seed=7, keyframe_every=8)
    rng = np.random.default_rng(11)
    # zig-zag rotational shake: sign alternates every frame, so the
    # quadratic predictor's fitted velocity/acceleration is always wrong
    shake = np.zeros_like(poses)
    amp = 0.012  # rad — ~ 2.3 px at f=191, flipping sign = ~5 px swings
    for f in range(n):
        shake[f, :2] = amp * (1 if f % 2 == 0 else -1) * (1 + 0.5 * rng.random(2))
    poses = poses + shake
    imgs = np.stack(
        [
            render_board_image(model, board, fam, p[:3], p[3:], noise=1.5, seed=f)
            for f, p in enumerate(poses)
        ]
    )
    return board, imgs


def test_shake_recall_superset(shake_video):
    board, imgs = shake_video
    cold = TagDetector("t36h11", track=False).detect_batch(imgs, board=board)
    trk = TagDetector("t36h11", track=True).detect_batch(imgs, board=board)
    assert len(cold) == len(trk) == imgs.shape[0]
    n_cold = sum(len(c) for c in cold)
    n_trk = sum(len(t) for t in trk)
    for f, (c, t) in enumerate(zip(cold, trk)):
        missing = set(c) - set(t)
        assert not missing, f"frame {f}: tracking dropped tags {missing}"
        for tid in c:
            np.testing.assert_allclose(t[tid], c[tid], atol=0.2)
    # sanity: the scene is hard but not degenerate
    assert n_cold >= imgs.shape[0] * 20, n_cold
    assert n_trk >= n_cold
