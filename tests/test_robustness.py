"""Harsh-imaging robustness: vignetting + illumination gradient + gamma +
low contrast + heavy sensor noise must still calibrate to sub-pixel."""

import jax.random as jr
import numpy as np
import pytest

from ccrs_jax.board import create_default_6x6_board
from ccrs_jax.calib import init_and_calibrate_one_camera, validation
from ccrs_jax.calib.frames import FrameBatch
from ccrs_jax.detect import TagDetector, get_family
from ccrs_jax.models import GenericModel, zeros_like_model
from ccrs_jax.testdata import default_sequence_poses, render_board_image
from ccrs_jax.types import CalibParams


@pytest.mark.slow
def test_calibration_under_harsh_imaging():
    board = create_default_6x6_board()
    fam = get_family("t36h11")
    gt = GenericModel("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512)
    poses = default_sequence_poses(16, board, seed=31)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:512, 0:512]
    vign = 1.0 - 0.55 * (((xx - 256) ** 2 + (yy - 256) ** 2) / (2 * 256**2))
    grad = 0.75 + 0.5 * xx / 511.0
    imgs = []
    for f, p in enumerate(poses):
        im = render_board_image(
            gt, board, fam, p[:3], p[3:], noise=0.0, blur_sigma=1.0
        ).astype(np.float32)
        im = (im * vign * grad) ** 0.9
        im = im * 0.55 + 20
        im += rng.normal(size=im.shape) * 4.0
        imgs.append(np.clip(im, 0, 255).astype(np.uint8))

    det = TagDetector("t36h11")
    dets = det.detect_batch(np.stack(imgs), board=board)
    batch = FrameBatch.from_detections(dets, list(range(16)), board, 512, 512)
    assert batch.frame_ok().sum() >= 12

    res = init_and_calibrate_one_camera(
        board, batch, zeros_like_model("eucm"), CalibParams(), jr.PRNGKey(0)
    )
    assert res is not None
    model, rtvecs = res
    assert abs(model.params[0] - gt.params[0]) / gt.params[0] < 0.01
    _, median = validation(board, batch, model, rtvecs)
    assert median < 0.5, f"median {median}"
