"""Full init->convert->BA pipeline across every camera model family
(BASELINE.json configs 2-4 cover UCM/KB4/OPENCV5/EUCMT/FTHETA)."""

import jax
import numpy as np
import pytest

from ccrs_jax.board import create_default_6x6_board
from ccrs_jax.calib import init_and_calibrate_one_camera, validation
from ccrs_jax.models import GenericModel, zeros_like_model
from ccrs_jax.types import CalibParams

from synthetic import make_synthetic_batch

GT = {
    "ucm": GenericModel("ucm", [190.5, 190.2, 255.2, 256.1, 0.63], 512, 512),
    "eucmt": GenericModel(
        "eucmt",
        [190.9, 190.87, 254.94, 256.86, 0.628, 1.046, 0.0012, -0.0008],
        512,
        512,
    ),
    "opencv5": GenericModel(
        "opencv5", [420.0, 421.0, 258.0, 254.0, -0.25, 0.06, 0.0008, -0.0005, -0.007],
        512, 512,
    ),
    "ftheta": GenericModel(
        "ftheta", [190.4, 190.1, 255.5, 255.9, 0.015, -0.006, 0.002, -0.0004, 0.0001],
        512, 512,
    ),
}


@pytest.mark.parametrize("name", list(GT))
def test_pipeline_recovers_model(name):
    gt = GT[name]
    board = create_default_6x6_board()
    import zlib

    batch, _ = make_synthetic_batch(
        gt, board, n_frames=16, seed=zlib.crc32(name.encode()) % 1000
    )
    result = init_and_calibrate_one_camera(
        board, batch, zeros_like_model(name), CalibParams(), jax.random.PRNGKey(7)
    )
    assert result is not None, f"{name}: pipeline failed"
    model, rtvecs = result
    avg99, median = validation(board, batch, model, rtvecs)
    assert median < 1e-4, f"{name}: median {median}"
    np.testing.assert_allclose(
        model.params[:2], gt.params[:2], rtol=5e-4, err_msg=name
    )


def test_pipeline_one_focal_eucmt():
    gt = GT["eucmt"].copy()
    p = gt.params.copy()
    p[1] = p[0]
    gt.set_params(p)
    board = create_default_6x6_board()
    batch, _ = make_synthetic_batch(gt, board, n_frames=12, seed=5)
    result = init_and_calibrate_one_camera(
        board, batch, zeros_like_model("eucmt"),
        CalibParams(one_focal=True), jax.random.PRNGKey(2),
    )
    assert result is not None
    model, rtvecs = result
    assert model.params[0] == model.params[1]
    _, median = validation(board, batch, model, rtvecs)
    assert median < 1e-4
