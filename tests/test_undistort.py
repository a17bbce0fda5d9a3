"""Undistortion tests: straight board edges must become straight lines
after remapping through the estimated pinhole."""

import numpy as np

from ccrs_jax.board import create_default_6x6_board
from ccrs_jax.detect import TagDetector, get_family
from ccrs_jax.models import GenericModel
from ccrs_jax.models.undistort import (
    estimate_new_camera_matrix_for_undistort,
    init_undistort_map,
    remap,
)
from ccrs_jax.testdata import default_sequence_poses, render_board_image


def test_undistort_map_pinhole_consistency():
    m = GenericModel("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512)
    K = estimate_new_camera_matrix_for_undistort(m, 1.0, (512, 512))
    assert K[0, 0] > 0 and K[0, 2] > 0
    xmap, ymap = init_undistort_map(m, K, (512, 512))
    assert xmap.shape == (512, 512)
    # undistorted pixel (u,v) pulls from model.project(K^-1 (u,v,1))
    u, v = 300, 200
    ray = np.linalg.inv(K) @ np.array([u, v, 1.0])
    p2d, valid = m.project(ray[None, :])
    assert valid[0]
    np.testing.assert_allclose([xmap[v, u], ymap[v, u]], p2d[0], atol=1e-4)


def test_undistortion_straightens_detected_rows():
    """Detected (distorted) corners, pushed through unproject + the
    estimated pinhole K, must become collinear per board row."""
    board = create_default_6x6_board()
    fam = get_family("t36h11")
    m = GenericModel("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512)
    pose = default_sequence_poses(1, board, seed=5)[0]
    img = render_board_image(m, board, fam, pose[:3], pose[3:])
    tags = TagDetector("t36h11").detect(img)
    assert len(tags) >= 15
    K = estimate_new_camera_matrix_for_undistort(m, 0.5, (512, 512))

    def undistort_pts(pts):
        rays, valid = m.unproject(pts)
        assert valid.all()
        mn = rays[:, :2] / rays[:, 2:3]
        return mn * K[0, 0] + K[:2, 2]

    worst = 0.0
    for row in range(6):
        row_tags = [t for t in sorted(tags) if row * 6 <= t < (row + 1) * 6]
        if len(row_tags) < 3:
            continue
        pts = undistort_pts(np.stack([tags[t][0] for t in row_tags]))
        A = np.stack([pts[:, 0], np.ones(len(pts))], 1)
        coef, *_ = np.linalg.lstsq(A, pts[:, 1], rcond=None)
        worst = max(worst, float(np.abs(A @ coef - pts[:, 1]).max()))
    assert worst < 0.6, f"rows not straight after undistortion: {worst:.2f}px"

    # and the remap itself: output pixel pulls the mapped source pixel
    xmap, ymap = init_undistort_map(m, K, (512, 512))
    und = remap(img, xmap, ymap)
    assert und.shape == img.shape and und.dtype == img.dtype
    v, u = 250, 260
    x, y = xmap[v, u], ymap[v, u]
    x0, y0 = int(x), int(y)
    fx, fy = x - x0, y - y0
    expected = (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )
    assert abs(float(und[v, u]) - expected) <= 1.0


def test_remap_color_roundtrip_shapes():
    m = GenericModel("ucm", [200, 200, 128, 128, 0.6], 256, 256)
    K = estimate_new_camera_matrix_for_undistort(m, 0.0, (128, 128))
    xmap, ymap = init_undistort_map(m, K, (128, 128))
    img = np.random.default_rng(0).integers(0, 255, (256, 256, 3), np.uint8)
    out = remap(img, xmap, ymap)
    assert out.shape == (128, 128, 3) and out.dtype == np.uint8
