"""Example: model conversion + undistortion (counterpart of the
reference's examples/convert_model.rs).

Loads a calibrated EUCM from JSON, grid-fits a UCM to it, writes
``ucm.json``, and undistorts an image through the converted model.

Usage:
  python examples/convert_model.py [model.json [image.png]]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

REF_JSON = "/root/reference/data/eucm.json"
REF_IMG = "/root/reference/data/tum_vi_with_chart.png"


def main():
    from ccrs_jax.calib import convert_model
    from ccrs_jax.pngio import read_png, write_png
    from ccrs_jax.models import model_from_json, model_to_json, zeros_like_model
    from ccrs_jax.models.undistort import (
        estimate_new_camera_matrix_for_undistort,
        init_undistort_map,
        remap,
    )

    json_path = sys.argv[1] if len(sys.argv) > 1 else REF_JSON
    source = model_from_json(json_path)
    print(f"source: {source.name} {source.params}")

    target = zeros_like_model("ucm", int(source.width), int(source.height))
    convert_model(source, target, 0)
    model_to_json("ucm.json", target)
    print(f"converted UCM: {target.params}")

    img_path = sys.argv[2] if len(sys.argv) > 2 else REF_IMG
    if os.path.exists(img_path):
        img = read_png(img_path)
        if img.dtype == np.uint16:
            img = (img / 257).astype(np.uint8)
        new_wh = 1024
        K = estimate_new_camera_matrix_for_undistort(target, 1.0, (new_wh, new_wh))
        xmap, ymap = init_undistort_map(target, K, (new_wh, new_wh))
        out = remap(img, xmap, ymap)
        write_png("remaped_ucm.png", out.astype(np.uint8))
        print("wrote remaped_ucm.png")


if __name__ == "__main__":
    main()
