"""CLI end-to-end test: rendered dataset on disk -> `ccrs` run -> artifacts.

The counterpart of the reference's CI acceptance run (the full
binary on a real dataset, .github/workflows/rust.yml) with synthetic data
(no network) and exact ground truth to assert against.
"""

import json
import os

import numpy as np
import pytest

from ccrs_jax.cli import main
from ccrs_jax.models import GenericModel
from ccrs_jax.testdata import write_euroc_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    model = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    write_euroc_dataset(str(root / "dataset"), model, n_frames=22, seed=3, noise=1.5)
    return root, model


@pytest.mark.slow
def test_cli_full_run(dataset, tmp_path, monkeypatch):
    root, gt = dataset
    out = tmp_path / "out"
    monkeypatch.chdir(tmp_path)  # default_board_config.json goes to cwd
    main(
        [
            str(root / "dataset"),
            "--model", "eucm",
            "--output-folder", str(out),
            "--no-rerun",
            "--seed", "1",
        ]
    )
    # artifact set identical to the reference (bin:278-342)
    assert (out / "cam0.json").exists()
    assert (out / "cam0_poses.json").exists()
    assert (out / "extrinsics.json").exists()
    assert (out / "report.txt").exists()
    assert os.path.exists("default_board_config.json")

    blob = json.loads((out / "cam0.json").read_text())
    assert "EUCM" in blob
    p = blob["EUCM"]
    assert abs(p["fx"] - gt.params[0]) / gt.params[0] < 0.01
    assert abs(p["alpha"] - gt.params[4]) < 0.02

    report = (out / "report.txt").read_text()
    assert report.startswith("Calibrate with extrinsics: true")
    med = float(report.split("median  reprojection error:")[1].split("px")[0])
    assert med < 0.3, f"median reprojection {med}"

    poses = json.loads((out / "cam0_poses.json").read_text())
    assert len(poses) >= 15
    first = next(iter(poses.values()))
    assert set(first) == {"rvec", "tvec"}


@pytest.mark.slow
def test_cli_chunked_speculation_fires(dataset, tmp_path, monkeypatch):
    """The CLI's streaming (chunked) loader must fire the speculative
    calibration and the final solve must consume the warm seed — the
    benched architecture IS the product path.  A
    silent spec-disable (e.g. a batch-shape gate regression) fails here,
    not just as an unexplained fps drop."""
    import ccrs_jax.dataloader as dl
    from ccrs_jax.calib.pipeline import calibrate_camera_with_retries as ccwr

    root, gt = dataset
    out = tmp_path / "out_spec"
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(dl, "DETECT_BATCH", 8)  # force multi-chunk feeds
    main(
        [
            str(root / "dataset"),
            "--model", "eucm",
            "--output-folder", str(out),
            "--no-rerun",
            "--seed", "1",
        ]
    )
    assert ccwr.last_warm_offered, "speculation never produced a warm seed"
    assert ccwr.last_spec_used, "final solve did not consume the warm seed"
    # and the result matches the no-spec run's optimum (same ground truth
    # gates as test_cli_full_run)
    blob = json.loads((out / "cam0.json").read_text())["EUCM"]
    assert abs(blob["fx"] - gt.params[0]) / gt.params[0] < 0.01
    assert abs(blob["alpha"] - gt.params[4]) < 0.02


def test_cli_bad_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        main([str(tmp_path / "nope"), "--no-rerun"])


@pytest.mark.slow
def test_cli_custom_board_5x9(tmp_path, monkeypatch):
    """Non-default board config (the reference ships board_config5x9.json):
    render a 5x9 grid, calibrate via --board-config."""
    import json as _json

    from ccrs_jax.board import Board, BoardConfig
    from ccrs_jax.detect import get_family
    from ccrs_jax.testdata import write_euroc_dataset

    cfg = BoardConfig(tag_size_meter=0.088, tag_spacing=0.3, tag_rows=5,
                      tag_cols=9, first_id=0)
    (tmp_path / "board.json").write_text(_json.dumps(cfg.to_json()))
    gt = GenericModel("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512)
    write_euroc_dataset(
        str(tmp_path / "dataset"), gt, n_frames=24, seed=8, noise=1.5,
        board=Board(cfg), family=get_family("t36h11"),
    )
    out = tmp_path / "out"
    monkeypatch.chdir(tmp_path)
    main(
        [
            str(tmp_path / "dataset"), "--model", "eucm",
            "--board-config", str(tmp_path / "board.json"),
            "--output-folder", str(out), "--no-rerun", "--seed", "2",
        ]
    )
    blob = json.loads((out / "cam0.json").read_text())
    # 2% focal tolerance: a wide 5x9 board on a 512px fisheye leaves ~1/3
    # of tags visible per frame, so the focal/distortion correlation
    # biases fx by ~+1% at median reprojection 0.13 px (measured 0.99 to
    # 1.16% across solver-neutral refinement variants — a 1% assert was a
    # coin flip on this geometry; the well-posed 6x6 suite holds 0.2%).
    assert abs(blob["EUCM"]["fx"] - gt.params[0]) / gt.params[0] < 0.02
    report = (out / "report.txt").read_text()
    med = float(report.split("median  reprojection error:")[1].split("px")[0])
    assert med < 0.3, med
