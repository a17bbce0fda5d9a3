"""Dataset loader tests: layouts, timestamps, subsampling, caching."""

import os

import numpy as np
import pytest

from ccrs_jax.board import create_default_6x6_board
from ccrs_jax.dataloader import load_euroc, load_general
from ccrs_jax.detect import TagDetector, get_family
from ccrs_jax.models import GenericModel
from ccrs_jax.pngio import write_png
from ccrs_jax.testdata import default_sequence_poses, render_board_image


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("dl")
    board = create_default_6x6_board()
    fam = get_family("t36h11")
    model = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    poses = default_sequence_poses(6, board, seed=4)
    d_euroc = root / "euroc" / "mav0" / "cam0" / "data"
    d_gen = root / "gen" / "x" / "cam0" / "imgs"
    d_euroc.mkdir(parents=True)
    d_gen.mkdir(parents=True)
    for f, p in enumerate(poses):
        img = render_board_image(model, board, fam, p[:3], p[3:], noise=1.0, seed=f)
        t_ns = 5_000_000_000 + f * 50_000_000
        write_png(str(d_euroc / f"{t_ns}.png"), img)
        write_png(str(d_gen / f"img_{f:03d}.png"), img)
    return root, board


def test_load_euroc_timestamps_and_detection(dataset):
    root, board = dataset
    det = TagDetector("t36h11")
    batches = load_euroc(str(root / "euroc"), det, board)
    assert len(batches) == 1
    b = batches[0]
    assert b.n_frames == 6
    # filename-ns timestamps, sorted
    assert b.time_ns[0] == 5_000_000_000
    assert np.all(np.diff(b.time_ns) == 50_000_000)
    assert b.frame_ok().sum() >= 5
    assert (b.width, b.height) == (512, 512)


def test_load_euroc_start_step(dataset):
    root, board = dataset
    det = TagDetector("t36h11")
    b = load_euroc(str(root / "euroc"), det, board, start_idx=1, step=2)[0]
    assert b.n_frames == 3
    assert b.time_ns[0] == 5_050_000_000


def test_load_general_synthetic_timestamps(dataset):
    root, board = dataset
    det = TagDetector("t36h11")
    b = load_general(str(root / "gen"), det, board)[0]
    assert b.n_frames == 6
    assert list(b.time_ns) == [i * 100_000_000 for i in range(6)]


def test_detection_cache_roundtrip(dataset, tmp_path):
    root, board = dataset
    det = TagDetector("t36h11")
    cache = str(tmp_path / "cache")
    b1 = load_euroc(str(root / "euroc"), det, board, cache_dir=cache)[0]
    assert len(os.listdir(cache)) == 1
    b2 = load_euroc(str(root / "euroc"), det, board, cache_dir=cache)[0]
    np.testing.assert_array_equal(b1.p2d, b2.p2d)
    np.testing.assert_array_equal(b1.mask, b2.mask)
    assert b1.width == b2.width and b1.height == b2.height


def test_missing_folder_empty_batch(dataset):
    root, board = dataset
    det = TagDetector("t36h11")
    b = load_euroc(str(root / "nope"), det, board)[0]
    assert b.n_frames == 0


def test_recorder_deferred_logging_gets_final_detections(dataset):
    """The streaming session defers Rerun frame logging to after
    finalize: an ACTIVE recorder must receive one call per frame, in
    timestamp order, with the image and the AUDITED detections; an
    inactive recorder must receive none (and the loader must not retain
    frames for it)."""

    class FakeRecorder:
        def __init__(self, active):
            self.active = active
            self.calls = []

        def log_camera_image(self, cam_idx, t_ns, img, dets):
            self.calls.append((cam_idx, t_ns, img, dets))

    root, board = dataset
    rec = FakeRecorder(active=True)
    det = TagDetector("t36h11")
    batches = load_euroc(str(root / "euroc"), det, board, recorder=rec)
    assert len(rec.calls) == 6
    assert [c[1] for c in rec.calls] == sorted(c[1] for c in rec.calls)
    for _, _, img, dets in rec.calls:
        assert img is not None and img.shape == (512, 512)
        assert len(dets) >= 20  # audited, near-full-board detections
    # detections logged must match the returned batch's corner data
    b = batches[0]
    assert b.frame_ok().sum() >= 5

    off = FakeRecorder(active=False)
    load_euroc(str(root / "euroc"), TagDetector("t36h11"), board, recorder=off)
    assert off.calls == []


def test_spec_factory_hook_lifecycle(dataset):
    """spec_factory must be called once per camera with the sorted times
    and frame size, its hook registered for the detect run, and the
    detector's hook cleared afterwards."""
    root, board = dataset
    det = TagDetector("t36h11")
    seen = {}

    def factory(cam_idx, times, width, height):
        seen["args"] = (cam_idx, list(times), width, height)

        def hook(results):
            seen["fired"] = len(results)

        return hook

    load_euroc(str(root / "euroc"), det, board, spec_factory=factory)
    assert seen["args"][0] == 0
    assert seen["args"][2:] == (512, 512)
    assert seen["args"][1] == sorted(seen["args"][1])
    assert det.on_provisional is None  # cleared after the sequence


_OPTIONAL_IMAGE_MODULES = ("cv2", "imageio", "imageio.v3", "PIL", "PIL.Image")


def test_cli_loads_png_dataset_without_optional_image_packages(
    dataset, monkeypatch
):
    """The CLI's loading path reads PNG datasets with nothing beyond numpy,
    zlib and the native helper: OpenCV, imageio and Pillow are blocked."""
    import sys

    from ccrs_jax import cli

    for name in _OPTIONAL_IMAGE_MODULES:
        monkeypatch.setitem(sys.modules, name, None)  # import raises
    monkeypatch.setenv("CCRS_PREWARM", "0")
    root, board = dataset
    args = cli.build_parser().parse_args([str(root / "euroc")])
    batches = cli.load_feature_data(args, TagDetector("t36h11"), board, None)
    assert batches[0].n_frames == 6
    assert batches[0].frame_ok().sum() >= 5


def test_jpeg_without_a_decoder_fails_clearly(tmp_path, monkeypatch):
    import sys

    from ccrs_jax.dataloader import _imread

    for name in _OPTIONAL_IMAGE_MODULES:
        monkeypatch.setitem(sys.modules, name, None)
    p = tmp_path / "x.jpg"
    p.write_bytes(b"\xff\xd8\xff")
    with pytest.raises(RuntimeError, match="JPEG input needs"):
        _imread(str(p))
