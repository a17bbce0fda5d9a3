"""Example: detect -> PnP -> undistort (counterpart of the reference's
examples/test_pnp.rs).

Detects AprilGrid tags in a fisheye frame, solves the board pose through a
known UCM model, prints reprojection consistency, and writes an
undistorted view.

Usage:
  python examples/test_pnp.py [image.png]
(defaults to the EuRoC frame bundled with the reference checkout if
present, else renders a synthetic frame)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

EUROC = "/root/reference/data/euroc.png"


def main():
    import jax.numpy as jnp

    from ccrs_jax.board import create_default_6x6_board
    from ccrs_jax.pngio import read_png, write_png
    from ccrs_jax.detect import TagDetector, get_family
    from ccrs_jax.models import GenericModel
    from ccrs_jax.models.undistort import (
        estimate_new_camera_matrix_for_undistort,
        init_undistort_map,
        remap,
    )
    from ccrs_jax.solve.pnp import solve_pnp_planar
    from ccrs_jax.types import RvecTvec

    board = create_default_6x6_board()
    if len(sys.argv) > 1:
        img = read_png(sys.argv[1])
        model = GenericModel("ucm", [471.019, 470.243, 367.122, 246.741, 0.67485], 752, 480)
    elif os.path.exists(EUROC):
        img = read_png(EUROC)
        # the calibrated EuRoC cam0 UCM (reference examples/test_pnp.rs:14)
        model = GenericModel("ucm", [471.019, 470.243, 367.122, 246.741, 0.67485], 752, 480)
    else:
        from ccrs_jax.testdata import default_sequence_poses, render_board_image

        model = GenericModel("ucm", [471.019, 470.243, 367.122, 246.741, 0.67485], 752, 480)
        pose = default_sequence_poses(1, board, seed=2)[0]
        img = render_board_image(model, board, get_family("t36h11"), pose[:3], pose[3:])

    tags = TagDetector("t36h11").detect(img)
    print(f"detected {len(tags)} tags")

    # gather 3D-2D correspondences, unproject, PnP
    p3ds, p2ds = [], []
    for tid, corners in tags.items():
        for c in range(4):
            cid = tid * 4 + c
            if 0 <= cid < board.n_corners:
                p3ds.append(board.p3d[cid])
                p2ds.append(corners[c])
    p3ds, p2ds = np.asarray(p3ds, dtype=np.float64), np.asarray(p2ds, dtype=np.float64)
    rays, valid = model.unproject(p2ds)
    obs = rays[:, :2] / rays[:, 2:3]
    r, t = solve_pnp_planar(
        jnp.asarray(p3ds), jnp.asarray(obs), jnp.asarray(valid.astype(np.float64))
    )
    print("r", np.asarray(r))
    print("t", np.asarray(t))

    # reprojection check
    rt = RvecTvec(np.asarray(r), np.asarray(t))
    proj, _ = model.project(rt.transform(p3ds))
    err = np.linalg.norm(proj - p2ds, axis=1)
    print(f"reprojection err: mean {err.mean():.3f} px, max {err.max():.3f} px")

    new_wh = 1024
    K = estimate_new_camera_matrix_for_undistort(model, 1.0, (new_wh, new_wh))
    xmap, ymap = init_undistort_map(model, K, (new_wh, new_wh))
    out = remap(img, xmap, ymap)
    write_png("remaped_euroc.png", out.astype(np.uint8))
    print("wrote remaped_euroc.png")


if __name__ == "__main__":
    main()
