"""On-device quad extraction (detect/ccl.py) vs the native C++ extractor."""

import numpy as np
import jax.numpy as jnp
import pytest

from ccrs_jax.detect.ccl import extract_quads_device, label_components
from ccrs_jax.detect.quads import extract_quads_batch


def _match(qa, qb, tol):
    """Greedy corner-set match: every quad in qa has a quad in qb whose
    corners (as sets, order-free) are within tol."""
    used = set()
    for a in qa:
        ca = np.sort(a.round(0), axis=0)
        found = None
        for j, b in enumerate(qb):
            if j in used:
                continue
            cb = np.sort(b.round(0), axis=0)
            if np.abs(ca - cb).max() <= tol:
                found = j
                break
        if found is None:
            return False
        used.add(found)
    return True


def test_labels_shapes():
    img = np.ones((1, 64, 64), np.uint8)
    img[0, 5:20, 5:20] = 0  # solid square
    img[0, 30:50, 30:50] = 0  # ring below
    img[0, 33:47, 33:47] = 1  # hollow it
    img[0, 5:20, 25:40] = 0  # second solid, row-adjacent (diagonal gap)
    lab = np.asarray(label_components(jnp.asarray(img)))[0]
    black = img[0] == 0
    labs = lab[black]
    # three distinct components, each internally uniform
    assert len(set(labs.tolist())) == 3
    # the ring (hollow) must still be ONE component
    ring = lab[30:50, 30:50][img[0, 30:50, 30:50] == 0]
    assert len(set(ring.tolist())) == 1
    # white pixels keep the out-of-range sentinel
    assert (lab[~black] == 64 * 64).all()


def test_labels_4_connectivity():
    # diagonal-touching squares must NOT merge (4-connectivity, like the
    # native BFS in quadproc.cpp)
    img = np.ones((1, 32, 32), np.uint8)
    img[0, 4:10, 4:10] = 0
    img[0, 10:16, 10:16] = 0  # touches only at the (9,9)/(10,10) diagonal
    lab = np.asarray(label_components(jnp.asarray(img)))[0]
    assert len(set(lab[img[0] == 0].tolist())) == 2


def test_toy_quads_match_native():
    img = np.ones((2, 128, 128), np.uint8)
    img[0, 10:40, 10:40] = 0
    img[0, 60:90, 50:100] = 0
    yy, xx = np.mgrid[0:128, 0:128]
    img[0][(np.abs(xx - 100) + np.abs(yy - 25)) <= 12] = 0  # diamond
    img[0, 120:122, 5:7] = 0  # speck: filtered by min size
    img[1, 30:70, 30:75] = 0

    qd, vd = extract_quads_device(jnp.asarray(img))
    qd, vd = np.asarray(qd), np.asarray(vd)
    qn, cn = extract_quads_batch(img)
    for b in range(2):
        dev = [qd[b, i] for i in np.flatnonzero(vd[b])]
        nat = [qn[b, i] for i in range(cn[b])]
        assert len(dev) == len(nat), (b, len(dev), len(nat))
        assert _match(nat, dev, tol=1.5)


def test_border_touching_rejected():
    img = np.ones((1, 64, 64), np.uint8)
    img[0, 0:20, 10:30] = 0  # touches top border
    img[0, 30:50, 10:30] = 0  # interior
    qd, vd = extract_quads_device(jnp.asarray(img))
    assert int(np.asarray(vd).sum()) == 1


def test_rotated_quads_all_angles():
    # corners must be recovered within ~1.5 px for arbitrary rotations
    from ccrs_jax.solve import se3

    for deg in (10, 30, 60, 75):
        a = np.deg2rad(deg)
        R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        corners = (np.array([[-20, -14], [20, -14], [20, 14], [-20, 14]]) @ R.T) + 64
        yy, xx = np.mgrid[0:128, 0:128]
        pts = np.stack([xx, yy], -1).reshape(-1, 2)

        def inside(p):
            ok = np.ones(len(p), bool)
            for i in range(4):
                e = corners[(i + 1) % 4] - corners[i]
                ok &= (np.cross(e, p - corners[i]) >= 0)
            return ok

        img = np.ones((1, 128, 128), np.uint8)
        img[0].reshape(-1)[inside(pts)] = 0
        qd, vd = extract_quads_device(jnp.asarray(img))
        qd, vd = np.asarray(qd)[0], np.asarray(vd)[0]
        assert vd.sum() == 1, deg
        got = np.sort(qd[np.flatnonzero(vd)[0]], axis=0)
        want = np.sort(corners, axis=0)
        assert np.abs(got - want).max() < 2.0, (deg, got, want)


@pytest.mark.slow
def test_e2e_device_quads_decode_like_native():
    """threshold -> device CCL -> decode finds the same tags as the
    native-extraction path on a rendered board frame."""
    from ccrs_jax.board import create_default_6x6_board
    from ccrs_jax.detect import get_family
    from ccrs_jax.detect.decode import refine_decode_fused
    from ccrs_jax.detect.threshold import adaptive_threshold, pad_to_tile
    from ccrs_jax.models import GenericModel
    from ccrs_jax.testdata import front_view_base, render_board_image

    from ccrs_jax.solve import se3

    board = create_default_6x6_board()
    fam = get_family("t36h11")
    model = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    rv, _ = se3.compose(
        jnp.asarray([0.15, -0.1, 0.05]), jnp.zeros(3),
        jnp.asarray(front_view_base()), jnp.zeros(3),
    )
    rvec = np.asarray(rv)
    R = np.asarray(se3.exp_so3(jnp.asarray(rvec)))
    t = np.array([0.0, 0.0, 0.5]) - R @ board.p3d.mean(0)
    img = render_board_image(model, board, fam, rvec, t, noise=1.0, seed=0)
    dev = jnp.asarray(img[None].astype(np.float32))
    padded, H, W = pad_to_tile(dev)
    binary = np.asarray(adaptive_threshold(padded))[:, :H, :W]

    def decode_set(quads, qvalid):
        n = quads.shape[0]
        out = refine_decode_fused(
            fam, dev, jnp.asarray(quads, jnp.float32),
            jnp.zeros(n, jnp.int32), jnp.asarray(qvalid),
        )
        ids = np.asarray(out["tag_id"])
        ok = np.asarray(out["valid"])
        return set(ids[ok].tolist())

    qd, vd = extract_quads_device(jnp.asarray(binary))
    dev_ids = decode_set(np.asarray(qd)[0], np.asarray(vd)[0])

    qn, cn = extract_quads_batch(binary)
    vn = np.arange(qn.shape[1]) < cn[0]
    nat_ids = decode_set(qn[0], vn)

    assert len(nat_ids) >= 30  # sanity: the frame is detectable
    missing = nat_ids - dev_ids
    assert not missing, f"device path missed tags {sorted(missing)}"


def test_wide_image_packing():
    """Regression (r02 advisor): extreme-point packing overflowed int32 for
    images wider than ~1447 px; coordinates are now centered on the image
    midpoint, giving true sqrt(W^2+H^2) < 4096 support (2048 included)."""
    W, H = 1600, 256
    img = np.ones((1, H, W), np.uint8)
    img[0, 60:140, 1480:1560] = 0  # square near the right edge
    img[0, 60:140, 40:120] = 0  # and one near the left edge
    quads, valid = extract_quads_device(jnp.asarray(img), max_quads=8)
    quads = np.asarray(quads)[0][np.asarray(valid)[0]]
    assert quads.shape[0] == 2
    ref, cnt = extract_quads_batch(img, max_quads=8)
    assert _match(quads, ref[0, : cnt[0]], tol=2.0)
