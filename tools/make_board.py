"""Generate a printable AprilGrid board image (counterpart of the
reference's bundled data/defualt_tag36h11_6x6_start_id_0.pdf).

Renders the board texture (tags + Kalibr corner squares) at print
resolution and writes a PNG (plus a single-page PDF when PIL supports it).

Usage:
  python tools/make_board.py out_board.png [--rows 6 --cols 6 --tag-size 0.088 --spacing 0.3 --first-id 0 --dpi 300]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out", help="output .png (a .pdf is written alongside)")
    ap.add_argument("--family", default="t36h11")
    ap.add_argument("--rows", type=int, default=6)
    ap.add_argument("--cols", type=int, default=6)
    ap.add_argument("--tag-size", type=float, default=0.088, help="meters")
    ap.add_argument("--spacing", type=float, default=0.3)
    ap.add_argument("--first-id", type=int, default=0)
    ap.add_argument("--dpi", type=int, default=300)
    args = ap.parse_args()

    from ccrs_jax.board import Board, BoardConfig
    from ccrs_jax.detect import get_family
    from ccrs_jax.testdata import board_pattern_image

    cfg = BoardConfig(args.tag_size, args.spacing, args.rows, args.cols, args.first_id)
    board = Board(cfg)
    fam = get_family(args.family)
    tex, (ox, oy), scale = board_pattern_image(board, fam)
    tex = np.asarray(tex)
    # one texel in meters -> pixels at the requested dpi.  px_per_cell must
    # be an integer, so the ACTUAL dpi is adjusted to keep the printed tag
    # size exact (rounding at texel granularity would otherwise scale the
    # whole board by several percent).
    cell_m = 1.0 / scale
    px_per_cell = max(1, int(round(cell_m * args.dpi / 0.0254)))
    dpi_eff = px_per_cell * 0.0254 / cell_m
    img = np.kron(tex, np.ones((px_per_cell, px_per_cell), np.float32))
    # The texture is stored as seen from the camera side (print on the -z
    # board face); flip horizontally so the PRINTED sheet, viewed directly,
    # is the physical board.
    img = img[:, ::-1]
    out8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)

    from ccrs_jax.pngio import write_png

    write_png(args.out, out8)
    w_m = out8.shape[1] * 0.0254 / dpi_eff
    print(
        f"wrote {args.out}: {out8.shape[1]}x{out8.shape[0]} px; print at "
        f"{dpi_eff:.2f} dpi for an exact {args.tag_size} m tag "
        f"({w_m:.3f} m wide)"
    )
    try:
        from PIL import Image

        pdf = os.path.splitext(args.out)[0] + ".pdf"
        Image.fromarray(out8).save(pdf, resolution=dpi_eff)
        print(f"wrote {pdf}")
    except Exception as e:  # pragma: no cover
        print(f"(pdf skipped: {e})")


if __name__ == "__main__":
    main()
