"""Stereo CLI end-to-end: 2-camera rendered dataset -> joint calibration ->
extrinsics recovered (the cam_num>1 path of the reference binary)."""

import json

import numpy as np
import pytest

from ccrs_jax.cli import main
from ccrs_jax.models import GenericModel
from ccrs_jax.testdata import default_rig_extrinsics, write_euroc_dataset
from ccrs_jax.types import RvecTvec


@pytest.mark.slow
def test_cli_stereo_run(tmp_path, monkeypatch):
    gt = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    rig = default_rig_extrinsics(2)
    write_euroc_dataset(
        str(tmp_path / "dataset"), gt, n_frames=14, cam_num=2,
        extrinsics=rig, seed=6, noise=1.5,
    )
    out = tmp_path / "out"
    monkeypatch.chdir(tmp_path)
    main(
        [
            str(tmp_path / "dataset"),
            "--model", "eucm",
            "--cam-num", "2",
            "--output-folder", str(out),
            "--no-rerun",
            "--seed", "3",
        ]
    )
    for cam in (0, 1):
        blob = json.loads((out / f"cam{cam}.json").read_text())
        p = blob["EUCM"]
        assert abs(p["fx"] - gt.params[0]) / gt.params[0] < 0.01, p
    ext = json.loads((out / "extrinsics.json").read_text())
    rt1 = RvecTvec.from_json(ext["rtvecs"][1])
    np.testing.assert_allclose(rt1.rvec, rig[1][:3], atol=2e-3)
    np.testing.assert_allclose(rt1.tvec, rig[1][3:], atol=2e-3)
    report = (out / "report.txt").read_text()
    assert report.startswith("Calibrate with extrinsics: true")
    meds = [float(s.split("px")[0]) for s in report.split("median  reprojection error:")[1:]]
    assert all(m < 0.3 for m in meds), meds
