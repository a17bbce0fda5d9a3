"""Tracked detection of the smoke's 512x512 EUCM video on every visible
device against the same code on the host CPU backend, and both against the
rendered ground truth.

With several GPUs visible the detector frame-shards the video over them
(``TagDetector._shard_frames``), so on a four-GPU host this compares the
sharded run with the CPU directly.  Exits non-zero when the tag sets differ
on any frame or a common corner moves more than ``--corner-px``.

Usage (from the root of a checkout, one process for all the cards):
  python tools/detect_vs_cpu.py [--frames 534] [--save results.npz]
"""

import argparse
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

#: TRACKED_CORNER_PX of tests/test_gpu.py, which gives its reason
CORNER_PX = 2e-2
EUCM_512 = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]


def as_arrays(results, n_tags):
    c = np.zeros((len(results), n_tags, 4, 2), np.float32)
    m = np.zeros((len(results), n_tags), bool)
    for f, r in enumerate(results):
        for t, cc in r.items():
            c[f, t], m[f, t] = cc, True
    return c, m


def detect_like_cli(det, video, board, batch=192):
    """Tracked detection the way the CLI's loader drives it: a session fed
    in chunks of ``batch``, the tail padded with repeats of the last frame
    (so 534 frames become 576, which four devices divide)."""
    import jax.numpy as jnp

    session = det.begin_tracked(board, n_frames=len(video))
    for o in range(0, len(video), batch):
        chunk = video[o:o + batch]
        n_valid = len(chunk)
        pad = np.repeat(chunk[-1:], batch - n_valid, axis=0)
        session.feed(jnp.asarray(np.concatenate([chunk, pad])), n_valid)
    return session.finalize()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=534)
    ap.add_argument("--corner-px", type=float, default=CORNER_PX)
    ap.add_argument("--save", help="write both runs' corners to this .npz")
    args = ap.parse_args()
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    import jax

    from ccrs_jax.board import create_default_6x6_board
    from ccrs_jax.detect import TagDetector, get_family
    from ccrs_jax.models import GenericModel
    from ccrs_jax.testdata import (gt_corners, render_frames_device,
                                   smooth_sequence_poses)

    logging.basicConfig(level=logging.WARNING)
    logging.getLogger("ccrs_jax.detect.detector").setLevel(logging.INFO)
    devs = jax.devices()
    print(f"devices: {len(devs)} x {devs[0].platform} {devs[0].device_kind}")
    board = create_default_6x6_board()
    n = board.n_tags
    gt = GenericModel("eucm", EUCM_512, 512, 512)
    poses = smooth_sequence_poses(args.frames, board, seed=11)
    video = np.asarray(render_frames_device(gt, board, get_family("t36h11"),
                                            poses, noise=1.5, seed=11))
    truth = np.stack([gt_corners(gt, board, p[:3], p[3:])[0]
                      for p in poses]).reshape(len(poses), n, 4, 2)

    runs = {}
    for name in ("devices", "cpu"):
        t0 = time.perf_counter()
        if name == "cpu":
            with jax.default_device(jax.devices("cpu")[0]):
                res = detect_like_cli(TagDetector("t36h11", shard=False),
                                      video, board)
        else:
            res = detect_like_cli(TagDetector("t36h11"), video, board)
        c, m = runs[name] = as_arrays(res, n)
        err = np.linalg.norm(c - truth, axis=-1).max(-1)[m]
        print(f"{name}: {time.perf_counter() - t0:.1f} s, {int(m.sum())} tags;"
              f" worst corner off ground truth: median {np.median(err):.4f} px,"
              f" {int((err > 1).sum())} tags > 1 px, {int((err > 2).sum())}"
              " tags > 2 px")
    (ca, ma), (cb, mb) = runs["devices"], runs["cpu"]
    sets = np.flatnonzero((ma != mb).any(1))
    d = np.abs(ca - cb).max(axis=(2, 3)) * (ma & mb)
    print(f"devices vs cpu: {int((ma != mb).sum())} tags found by one run "
          f"only, on frames {sets.tolist()}; common corners within "
          f"{d.max():.3e} px (bound {args.corner_px}); tags > 5e-3 px apart "
          f"on frames {np.flatnonzero((d > 5e-3).any(1)).tolist()}")
    if args.save:
        np.savez_compressed(args.save, devices_c=ca, devices_m=ma, cpu_c=cb,
                            cpu_m=mb, truth=truth)
    return 0 if sets.size == 0 and d.max() <= args.corner_px else 1


if __name__ == "__main__":
    sys.exit(main())
