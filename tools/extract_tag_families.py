"""Regenerate the AprilTag family code tables bundled with ccrs_jax.

The tables are extracted from OpenCV's predefined aruco dictionaries
(`cv2.aruco.DICT_APRILTAG_*`) by rendering every marker image and reading
the data cells — the rendered image is ground truth by construction, so no
assumptions about OpenCV's internal byte packing are needed.

Families (matching the reference CLI surface,
/root/reference/src/bin/camera_calibration.rs:31-33):
  t16h5, t25h9, t36h11, t36h11b1 (same codes as t36h11, 1-px border layout).
  t25h7 is NOT shipped by OpenCV (dropped upstream for poor hamming
  properties); ccrs_jax raises a clear error for it unless the user supplies
  a custom code table.

Usage: python tools/extract_tag_families.py
Writes: ccrs_jax/detect/data/tag_families.npz
"""

import os

import cv2
import numpy as np

OUT = os.path.join(os.path.dirname(__file__), "..", "ccrs_jax", "detect", "data", "tag_families.npz")

FAMS = {
    "t16h5": (cv2.aruco.DICT_APRILTAG_16h5, 4),
    "t25h9": (cv2.aruco.DICT_APRILTAG_25h9, 5),
    "t36h11": (cv2.aruco.DICT_APRILTAG_36h11, 6),
}


def extract(dict_key: int, marker_size: int) -> np.ndarray:
    d = cv2.aruco.getPredefinedDictionary(dict_key)
    n = d.bytesList.shape[0]
    side = marker_size + 2
    codes = np.zeros((n, marker_size * marker_size), np.uint8)
    for i in range(n):
        img = cv2.aruco.generateImageMarker(d, i, side)
        codes[i] = (img[1 : side - 1, 1 : side - 1] > 128).astype(np.uint8).ravel()
    return codes


def main():
    out = {}
    for name, (key, ms) in FAMS.items():
        codes = extract(key, ms)
        out[f"{name}_codes"] = codes
        out[f"{name}_size"] = np.int32(ms)
        print(f"{name}: {codes.shape[0]} codes, {ms}x{ms} bits")
    np.savez_compressed(OUT, **out)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
