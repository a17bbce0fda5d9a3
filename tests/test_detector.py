"""AprilGrid detector tests: synthetic ground truth + the reference's real
bundled images (data/euroc.png, data/tum_vi_with_chart.png)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from ccrs_jax.board import create_default_6x6_board
from ccrs_jax.detect import TagDetector, get_family
from ccrs_jax.models import GenericModel
from ccrs_jax.pngio import read_png
from ccrs_jax.solve import se3
from ccrs_jax.testdata import front_view_base, gt_corners, render_board_image

EUROC_PNG = "/root/reference/data/euroc.png"
TUMVI_PNG = "/root/reference/data/tum_vi_with_chart.png"


def _load_gray(path):
    if not os.path.exists(path):
        pytest.skip(f"reference image {path} is not available")
    return read_png(path)  # detector normalizes dtype/channels itself


@pytest.fixture(scope="module")
def synth_view():
    board = create_default_6x6_board()
    fam = get_family("t36h11")
    model = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    base = jnp.asarray(front_view_base())
    rv, _ = se3.compose(jnp.asarray([0.15, -0.1, 0.05]), jnp.zeros(3), base, jnp.zeros(3))
    rvec = np.asarray(rv)
    R = np.asarray(se3.exp_so3(jnp.asarray(rvec)))
    t = np.array([0.0, 0.0, 0.5]) - R @ board.p3d.mean(0)
    img = render_board_image(model, board, fam, rvec, t)
    p2d, vis = gt_corners(model, board, rvec, t)
    return img, p2d, vis


def test_synthetic_detection_accuracy(synth_view):
    img, p2d, vis = synth_view
    det = TagDetector("t36h11")
    tags = det.detect(img)
    assert len(tags) >= 28, f"only {len(tags)} tags"
    errs = []
    for tid, cs in tags.items():
        assert 0 <= tid < 36
        for c in range(4):
            cid = tid * 4 + c
            if vis[cid]:
                errs.append(np.linalg.norm(cs[c] - p2d[cid]))
    errs = np.array(errs)
    assert errs.mean() < 0.15, f"mean corner err {errs.mean()}"
    assert errs.max() < 0.8, f"max corner err {errs.max()}"


def test_refine_improves_accuracy(synth_view):
    img, p2d, vis = synth_view

    def err_of(refine):
        tags = TagDetector("t36h11", refine=refine).detect(img)
        errs = [
            np.linalg.norm(cs[c] - p2d[tid * 4 + c])
            for tid, cs in tags.items()
            for c in range(4)
            if vis[tid * 4 + c]
        ]
        return np.mean(errs)

    assert err_of(True) < err_of(False)


def test_euroc_real_image():
    """All 36 board tags on the reference's bundled EuRoC frame (the
    OpenCV aruco detector finds 31 on this image)."""
    img = _load_gray(EUROC_PNG)
    tags = TagDetector("t36h11").detect(img)
    assert len(tags) >= 33, f"{len(tags)} tags on euroc.png"
    assert set(tags) <= set(range(36))


def test_tumvi_real_image():
    img = _load_gray(TUMVI_PNG)
    tags = TagDetector("t36h11").detect(img)
    assert len(tags) >= 25, f"{len(tags)} tags on tum_vi_with_chart.png"


def _degrade_variants(img):
    """(name, degraded image) pairs: JPEG q60 re-encode, 0.75x downscale,
    gamma-1.8 + sigma-6 sensor noise — the decode-robustness regimes the
    synthetic renders don't cover."""
    cv2 = pytest.importorskip("cv2")

    if img.dtype != np.uint8:  # tum_vi_with_chart.png is 16-bit
        img = (img.astype(np.float64) / 257.0).clip(0, 255).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 60])
    assert ok
    jpg = cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE)
    small = cv2.resize(img, None, fx=0.75, fy=0.75, interpolation=cv2.INTER_AREA)
    rng = np.random.default_rng(0)
    g = 255.0 * (img.astype(np.float64) / 255.0) ** 1.8
    gn = np.clip(g + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    return [("jpeg60", jpg), ("down075", small), ("gamma_noise", gn)]


@pytest.mark.parametrize(
    "path,floors",
    [
        # measured recall: euroc 36/36/36; tumvi 31/27/34 (floors carry
        # margin for noise-seed / codec-version drift)
        (EUROC_PNG, {"jpeg60": 34, "down075": 34, "gamma_noise": 34}),
        (TUMVI_PNG, {"jpeg60": 28, "down075": 24, "gamma_noise": 29}),
    ],
    ids=["euroc", "tumvi"],
)
def test_real_image_degraded_recall(path, floors):
    """Recall floors on degraded variants of the two bundled reference
    images — decode robustness pinned by real imagery, not only
    synthetic renders (ref anchor: /root/reference/data/euroc.png,
    examples/test_pnp.rs:23-24)."""
    pytest.importorskip("cv2")
    img = _load_gray(path)
    det = TagDetector("t36h11")
    for name, variant in _degrade_variants(img):
        n = len(det.detect(variant))
        assert n >= floors[name], f"{name}: {n} < floor {floors[name]}"


def test_batch_matches_single(synth_view):
    img, _, _ = synth_view
    det = TagDetector("t36h11")
    single = det.detect(img)
    batched = det.detect_batch(np.stack([img, img]))
    assert set(single) == set(batched[0]) == set(batched[1])
    for tid in single:
        np.testing.assert_allclose(batched[0][tid], single[tid], atol=1e-5)


def test_empty_image():
    img = np.full((240, 320), 128, np.uint8)
    assert TagDetector("t36h11").detect(img) == {}


def test_rotated_image_decodes(synth_view):
    """Rotating the view 90 deg must still decode the same ids with the
    rotation-resolved canonical corner order."""
    img, _, _ = synth_view
    det = TagDetector("t36h11")
    base = det.detect(img)
    rot = np.rot90(img).copy()
    tags_rot = det.detect(rot)
    common = set(base) & set(tags_rot)
    assert len(common) >= 0.8 * len(base)
    H = img.shape[0]
    for tid in list(common)[:10]:
        # (x,y) in rotated image maps back: np.rot90 (CCW): x' = y, y' = H-1-x
        back = np.stack(
            [H - 1 - tags_rot[tid][:, 1], tags_rot[tid][:, 0]], axis=1
        )
        np.testing.assert_allclose(back, base[tid], atol=1.0)


@pytest.mark.parametrize("famname", ["t16h5", "t25h9", "t36h11b1"])
def test_other_families_end_to_end(famname):
    """Every distributable family detects its own rendered board with
    subpixel accuracy (guards the sub-cell board rasterization: families
    with non-integral pitch-in-cells rendered ~1 px off before)."""
    board = create_default_6x6_board()
    fam = get_family(famname)
    model = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    base = jnp.asarray(front_view_base())
    rv, _ = se3.compose(
        jnp.asarray([0.12, -0.08, 0.04]), jnp.zeros(3), base, jnp.zeros(3)
    )
    rvec = np.asarray(rv)
    R = np.asarray(se3.exp_so3(jnp.asarray(rvec)))
    t = np.array([0.0, 0.0, 0.5]) - R @ board.p3d.mean(0)
    img = render_board_image(model, board, fam, rvec, t)
    p2d, vis = gt_corners(model, board, rvec, t)
    # production path: board-assisted recovery on (the CLI always has the
    # board; b1's 1-cell border is ~4 px here and needs the second pass)
    tags = TagDetector(famname).detect_batch(np.asarray(img)[None], board=board)[0]
    n_board_tags = min(36, fam.n_codes)
    assert len(tags) >= 0.75 * n_board_tags, f"{len(tags)}/{n_board_tags}"
    assert all(0 <= t < n_board_tags for t in tags)
    errs = np.array(
        [
            np.linalg.norm(cs[c] - p2d[tid * 4 + c])
            for tid, cs in tags.items()
            for c in range(4)
            if vis[tid * 4 + c]
        ]
    )
    assert errs.mean() < 0.2, f"mean corner err {errs.mean()}"


def test_non_square_board_with_first_id():
    """The reference's bundled 5x9 board config (data/board_config5x9.json)
    plus a nonzero first_id: ids map through board.p3d correctly and no
    out-of-board ids appear."""
    from ccrs_jax.board import Board, BoardConfig

    cfg = BoardConfig(0.088, 0.3, 5, 9, 36)
    board = Board.from_config(cfg) if hasattr(Board, "from_config") else Board(cfg)
    fam = get_family("t36h11")
    model = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    base = jnp.asarray(front_view_base())
    rv, _ = se3.compose(
        jnp.asarray([0.1, -0.06, 0.03]), jnp.zeros(3), base, jnp.zeros(3)
    )
    rvec = np.asarray(rv)
    R = np.asarray(se3.exp_so3(jnp.asarray(rvec)))
    t = np.array([0.0, 0.0, 0.8]) - R @ board.p3d.mean(0)
    img = render_board_image(model, board, fam, rvec, t)
    p2d, vis = gt_corners(model, board, rvec, t)
    dets = TagDetector("t36h11").detect_batch(np.asarray(img)[None], board=board)[0]
    assert len(dets) >= 0.85 * 45
    assert all(36 <= tid < 36 + 45 for tid in dets)
    errs = np.array(
        [
            np.linalg.norm(c2 - p2d[(tid - 36) * 4 + c])
            for tid, cs in dets.items()
            for c, c2 in enumerate(cs)
            if vis[(tid - 36) * 4 + c]
        ]
    )
    assert errs.mean() < 0.35  # ~40 px tags at this range


def test_device_resident_matches_host(synth_view):
    """detect_batch(images=None, dev_images=...) (patch-based refinement,
    no whole-image download) must agree with the host-image path."""
    img, _, _ = synth_view
    board = create_default_6x6_board()
    det = TagDetector("t36h11")
    imgs = np.stack([img, img]).astype(np.float32)
    host = det.detect_batch(imgs, board=board)
    dev = det.detect_batch(None, board=board, dev_images=jnp.asarray(imgs))
    for h, d in zip(host, dev):
        assert set(h) == set(d)
        for tid in h:
            # uint8 patch quantization perturbs subpixel refinement by a
            # hair; anything < 0.05 px is far below detector noise
            np.testing.assert_allclose(d[tid], h[tid], atol=0.05)


def test_patch_refine_matches_full_image(synth_view):
    """Patch-local native refinement == full-image native refinement."""
    from ccrs_jax.detect.patches import extract_patches
    from ccrs_jax.detect.quads import (
        refine_corners_native,
        refine_corners_patches_native,
    )

    img, p2d, vis = synth_view
    imgs = np.stack([img, img]).astype(np.float32)
    sel = np.flatnonzero(vis)[:40]
    corners = p2d[sel].astype(np.float32) + 0.8  # offset like a raw quad fit
    qframe = (np.arange(sel.size) % 2).astype(np.int32)

    full = refine_corners_native(
        imgs, np.stack([corners, corners])[..., :].reshape(2, -1, 2)
    )
    full = np.stack([full[f, i] for i, f in enumerate(qframe)])

    patches, local, offset = extract_patches(
        jnp.asarray(imgs), jnp.asarray(corners), jnp.asarray(qframe)
    )
    ref_local = refine_corners_patches_native(np.asarray(patches), np.asarray(local))
    patched = ref_local + np.asarray(offset)
    np.testing.assert_allclose(patched, full, atol=1e-4)


def test_board_assist_recovers_tags(synth_view):
    from ccrs_jax.board import create_default_6x6_board

    img, p2d, vis = synth_view
    board = create_default_6x6_board()
    det = TagDetector("t36h11")
    plain = det.detect(img)
    assisted = det.detect_batch(np.asarray(img)[None], board=board)[0]
    assert len(assisted) >= len(plain)
    # recovered corners must still be accurate
    errs = [
        np.linalg.norm(cs[c] - p2d[tid * 4 + c])
        for tid, cs in assisted.items()
        for c in range(4)
        if vis[tid * 4 + c]
    ]
    assert np.mean(errs) < 0.25 and np.max(errs) < 2.0


def test_host_dilation_matches_device():
    """_dilate_white_host == reduce_window(OR, 3x3, SAME) on the device."""
    import jax
    import jax.numpy as jnp

    from ccrs_jax.detect.detector import _dilate_white_host

    rng = np.random.default_rng(3)
    b1 = (rng.uniform(size=(3, 40, 48)) < 0.6).astype(np.uint8)
    host = _dilate_white_host(b1)
    dev = jax.lax.reduce_window(
        jnp.asarray(b1, bool), False, jax.lax.bitwise_or,
        (1, 3, 3), (1, 1, 1), "SAME",
    ).astype(np.uint8)
    np.testing.assert_array_equal(host, np.asarray(dev))


def test_fixed_chunk_padding_matches_natural(synth_view, monkeypatch):
    """The fixed-shape plan pads small batches up to the chunk size;
    the same tags must decode with corners within the refine noise floor
    (different batch shapes change XLA fusion order, so the iterative
    subpixel refine reassociates float sums — ~1e-3 px, same bound as
    the mixed-plan equivalence test)."""
    img, p2d, vis = synth_view
    det_nat = TagDetector("t36h11")
    ref = det_nat.detect_batch(np.asarray(img)[None])

    from ccrs_jax.utils import backend

    monkeypatch.setattr(backend, "pad_to_fixed_shapes", lambda: True)
    det_pad = TagDetector("t36h11")
    det_pad.chunk = 8  # keep the padded batch small on CPU
    padded = det_pad.detect_batch(np.asarray(img)[None])
    assert len(padded) == 1
    assert set(padded[0]) == set(ref[0])
    for tid in ref[0]:
        np.testing.assert_allclose(padded[0][tid], ref[0][tid], atol=5e-3)


def test_chunk_plan():
    from ccrs_jax.detect.detector import _chunk_plan

    # accelerator: mixed 64+8 plan bounds padding waste by small-1
    assert _chunk_plan(534, 64, 8, cpu=False) == [64] * 8 + [8] * 3
    assert _chunk_plan(102, 64, 8, cpu=False) == [64] + [8] * 5
    assert _chunk_plan(64, 64, 8, cpu=False) == [64]
    assert _chunk_plan(5, 64, 8, cpu=False) == [8]
    assert _chunk_plan(0, 64, 8, cpu=False) == []  # empty batch: zero chunks
    # forced single size (legacy cold_chunk sweeps)
    assert _chunk_plan(21, 64, 8, cpu=False, forced=8) == [8] * 3
    # cpu: natural sizes
    assert _chunk_plan(21, 64, 8, cpu=True) == [21]
    assert sum(_chunk_plan(130, 64, 8, cpu=True)) == 130


def test_mixed_chunk_plan_matches_natural(synth_view, monkeypatch):
    """A batch covered by heterogeneous chunk sizes (16 + 4 + 4 with
    repeat-padding) must produce identical detections to the natural
    whole-batch path."""
    img, p2d, vis = synth_view
    imgs = np.stack([np.asarray(img)] * 5)
    det_nat = TagDetector("t36h11", track=False)
    ref = det_nat.detect_batch(imgs)

    from ccrs_jax.utils import backend

    monkeypatch.setattr(backend, "pad_to_fixed_shapes", lambda: True)
    det_mix = TagDetector("t36h11", track=False)
    det_mix.chunk = 4
    det_mix.cold_chunk = 2
    out = det_mix.detect_batch(imgs)  # plan: [4, 2] covering 5 -> pad 6
    assert len(out) == 5
    for r, o in zip(ref, out):
        assert set(o) == set(r)
        for tid in r:
            # sub-millipixel: chunk shape changes XLA fusion order and the
            # iterative refine amplifies the reassociation noise slightly
            np.testing.assert_allclose(o[tid], r[tid], atol=5e-3)


def test_padded_tail_chunk_with_assist_work(monkeypatch):
    """A padded tail chunk (nb < chunk size) whose frames have assist
    work (missing tags on a partially-visible board) must not crash the
    fused assist decode: the candidate buffers must span the PADDED
    chunk, not just the real frames (regression: vmap mismatch 5 vs 8)."""
    monkeypatch.setenv("CCRS_FORCE_CHUNK_PLAN", "1")
    board = create_default_6x6_board()
    fam = get_family("t36h11")
    model = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    base = jnp.asarray(front_view_base())
    rv, _ = se3.compose(
        jnp.asarray([0.55, -0.35, 0.1]), jnp.zeros(3), base, jnp.zeros(3)
    )
    rvec = np.asarray(rv)
    R = np.asarray(se3.exp_so3(jnp.asarray(rvec)))
    # shifted well off-center: part of the board leaves the view, so the
    # frames keep >= MIN_TAGS_FOR_ASSIST detections but miss tags
    t = np.array([0.13, 0.1, 0.38]) - R @ board.p3d.mean(0)
    img = render_board_image(model, board, fam, rvec, t)
    imgs = np.stack([img] * 5)  # 5 real frames -> one 8-chunk, 3 padded
    det = TagDetector("t36h11", track=False)
    res = det.detect_batch(imgs, board=board)
    assert len(res) == 5
    n = len(res[0])
    assert 8 <= n < board.n_tags, f"need a partial board, got {n} tags"
    for r in res[1:]:
        assert set(r) == set(res[0])
