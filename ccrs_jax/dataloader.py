"""Dataset loaders: EuRoC and general folder layouts.

Rebuilds ``load_euroc`` / ``load_others`` (``src/data_loader.rs:95-214``)
around the batch-first detector: instead of rayon-parallel per-image
detection, images are decoded on host worker threads while the detector
consumes them in fixed-size batches on the device (decode overlaps
detection).  Frame order, timestamp conventions (filename ns for EuRoC,
idx * 1e8 for general), start/step subsampling, and the MIN_CORNERS filter
match the reference.
"""

from __future__ import annotations

import concurrent.futures as cf
import glob
import logging
import os
import time
from typing import List

import numpy as np

from .board import Board
from .calib.frames import MIN_CORNERS, FrameBatch
from .detect import TagDetector
from .pngio import read_png

log = logging.getLogger(__name__)

# streaming upload chunk: decoded frames upload to the device in batches
# of this size while later images decode (the TrackedSession buffers
# them; detection runs once over the whole sequence at finalize, so the
# chunk size only sets upload granularity and the fixed shape the tail
# pads to).  CCRS_DETECT_BATCH overrides.
DETECT_BATCH = int(os.environ.get("CCRS_DETECT_BATCH", "192"))
_EXTS = (".png", ".jpg")


def _imread(path: str) -> np.ndarray:
    """PNGs through the package's own codec; JPEGs through OpenCV or
    imageio, whichever is installed."""
    if path.lower().endswith(".png"):
        return read_png(path)
    try:
        import cv2
    except ImportError:
        pass
    else:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise OSError(f"cannot read {path}")
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        return img
    try:
        import imageio.v3 as iio
    except ImportError:
        raise RuntimeError(
            f"cannot read {path}: JPEG input needs opencv-python or imageio "
            "installed (PNG datasets need neither)"
        ) from None
    return iio.imread(path)


def _list_images(pattern: str, start_idx: int, step: int) -> List[str]:
    paths = sorted(p for p in glob.glob(pattern, recursive=True)
                   if p.endswith(_EXTS))
    return paths[start_idx::step]


def _path_timestamp(path: str) -> int:
    """Filename (sans extension) as nanoseconds; 0 if unparsable
    (``src/data_loader.rs:20-29``)."""
    stem = os.path.splitext(os.path.basename(path))[0]
    try:
        return int(stem)
    except ValueError:
        return 0


def _detect_sequence(
    paths: List[str],
    times_ns: List[int],
    detector: TagDetector,
    board: Board,
    recorder=None,
    cam_idx: int = 0,
    prewarm_cb=None,
    spec_factory=None,
) -> FrameBatch:
    """Decode + detect a whole sequence, overlapping host IO with device
    detection; returns a timestamp-sorted FrameBatch.

    ``prewarm_cb(width, height, n_frames)``, when given, runs ONCE on a
    background thread as soon as the first image reveals the frame size —
    the CLI uses it to overlap detector + calibration graph compiles with
    image decoding (each graph compiles on first use).

    ``spec_factory(cam_idx, times_ns_sorted, width, height)``, when
    given, is called once (same moment as prewarm_cb) and must return an
    ``on_provisional`` hook (or None) — the CLI uses it to register a
    SpeculativeCalib so calibration overlaps the detection audits
    (calib/pipeline.SpeculativeCalib; the hook fires once per sequence
    from the tracked session's finalize with every frame's provisional
    detections).

    Detection goes through a TrackedSession (detect/tracked.py): decoded
    chunks upload asynchronously while later images decode, then ONE
    whole-batch tracked detection runs at finalize — so a chunked
    dataset run costs exactly what the whole-batch bench composition
    costs instead of paying per-chunk anchor/audit fixed costs.
    """
    if not paths:
        return FrameBatch(
            np.zeros(0, np.int64), np.zeros((0, board.n_corners, 2)),
            np.zeros((0, board.n_corners), bool), 0, 0,
        )
    order = np.argsort(np.asarray(times_ns, dtype=np.int64), kind="stable")
    paths = [paths[i] for i in order]
    times_ns = [times_ns[i] for i in order]
    # each camera is an independent video: don't track across the boundary
    detector.reset_tracking()
    session = detector.begin_tracked(board, n_frames=len(paths))
    # deferred Rerun logging retains every frame's pixels until the
    # session finalizes — only do that when the recorder actually records
    if recorder is not None and not getattr(recorder, "active", True):
        recorder = None

    detections = []
    rec_meta = []  # (t_ns, img) retained for deferred Rerun logging
    width = height = None
    try:
        from tqdm import tqdm

        progress = tqdm(
            total=len(paths), desc=f"cam{cam_idx} detect", unit="img", leave=False
        )
    except ImportError:  # pragma: no cover
        progress = None
    with cf.ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4)) as pool:
        futures = [pool.submit(_imread, p) for p in paths]
        chunk_imgs, chunk_meta = [], []
        # one-chunk upload pipeline: jnp.asarray enqueues the host->device
        # transfer asynchronously, so uploading chunk i+1 BEFORE detecting
        # chunk i overlaps the transfer with the device/host detection
        # work.  Only the common grayscale-uint8
        # case pre-uploads; anything else converts host-side first.
        pending: list = []
        import jax
        import jax.numpy as jnp

        from .utils.backend import pad_to_fixed_shapes

        fixed = pad_to_fixed_shapes()

        def submit():
            nonlocal chunk_imgs, chunk_meta
            if not chunk_imgs:
                return
            raw = np.stack(chunk_imgs)
            # pad a ragged TAIL chunk to DETECT_BATCH under the fixed-shape
            # plan by repeating the last frame (results truncated below):
            # the tracked path's frame gathers key compiled graphs on the
            # batch length, and a dataset-dependent remainder shape would
            # compile afresh on the final chunk.  Small datasets (< one
            # chunk) keep their natural size — the CLI prewarm hint warms
            # exactly that layout.
            if fixed and 0 < len(chunk_imgs) < DETECT_BATCH < len(paths):
                pad = DETECT_BATCH - len(chunk_imgs)
                raw = np.concatenate([raw, np.repeat(raw[-1:], pad, 0)])
            if not (raw.ndim == 3 and raw.dtype == np.uint8):
                # color / 16-bit / float input: grayscale on host (the
                # session needs dtype-homogeneous device chunks)
                from .detect.detector import _to_gray_f32

                raw = np.stack([_to_gray_f32(im) for im in raw])
            dev = jnp.asarray(raw)  # async h2d enqueue
            pending.append((dev, chunk_meta))  # raw dropped: ~50-200 MB/chunk
            chunk_imgs, chunk_meta = [], []

        def process_one():
            dev, meta = pending.pop(0)
            if session is not None:
                session.feed(dev, n_valid=len(meta))
            else:
                dets = detector.detect_batch(None, board=board, dev_images=dev)
                detections.extend(dets[: len(meta)])
            if recorder is not None:
                rec_meta.extend(meta)
            if progress is not None:
                progress.update(len(meta))

        for t_ns, fut in zip(times_ns, futures):
            img = fut.result()
            if width is None:
                height, width = img.shape[:2]
                if spec_factory is not None:
                    try:
                        detector.on_provisional = spec_factory(
                            cam_idx, list(times_ns), width, height
                        )
                    except Exception:  # pragma: no cover - spec is optional
                        log.exception("spec_factory failed; running cold")
                if prewarm_cb is not None:
                    from threading import Thread

                    Thread(
                        target=prewarm_cb,
                        args=(width, height, len(paths)),
                        daemon=True,
                    ).start()
            chunk_imgs.append(img)
            chunk_meta.append((t_ns, img) if recorder is not None else (t_ns, None))
            if len(chunk_imgs) >= DETECT_BATCH:
                submit()
                while len(pending) > 1:
                    process_one()
        submit()
        while pending:
            process_one()
        if session is not None:
            detections = session.finalize()
    if progress is not None:
        progress.close()
    if spec_factory is not None:
        detector.on_provisional = None
    if recorder is not None:
        for (t_ns, img), det in zip(rec_meta, detections):
            recorder.log_camera_image(cam_idx, t_ns, img, det)

    return FrameBatch.from_detections(
        detections, times_ns, board, width, height, MIN_CORNERS
    )


def _cache_path(cache_dir, cam_idx, paths, detector, board):
    """Detection-cache key: file list+mtimes+detector family+board shape."""
    import hashlib

    h = hashlib.sha1()
    for p in paths:
        try:
            h.update(f"{p}:{os.path.getmtime(p)};".encode())
        except OSError:
            h.update(f"{p}:?;".encode())
    h.update(f"{detector.family.name}:{board.n_corners}:{board.first_corner_id}".encode())
    return os.path.join(cache_dir, f"cam{cam_idx}_{h.hexdigest()[:16]}.npz")


def _detect_or_load(paths, times, detector, board, recorder, cam_idx, cache_dir,
                    prewarm_cb=None, spec_factory=None):
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cpath = _cache_path(cache_dir, cam_idx, paths, detector, board)
        if os.path.exists(cpath):
            log.info("cam%d: loading cached detections from %s", cam_idx, cpath)
            return FrameBatch.load(cpath)
    batch = _detect_sequence(
        paths, times, detector, board, recorder, cam_idx, prewarm_cb,
        spec_factory,
    )
    if cache_dir:
        batch.save(cpath)
    return batch


def load_euroc(
    root: str,
    detector: TagDetector,
    board: Board,
    start_idx: int = 0,
    step: int = 1,
    cam_num: int = 1,
    recorder=None,
    cache_dir: str = None,
    prewarm_cb=None,
    spec_factory=None,
) -> List[FrameBatch]:
    """EuRoC layout: {root}/mav0/cam{i}/data/* (``src/data_loader.rs:95``)."""
    out = []
    for cam_idx in range(cam_num):
        t0 = time.perf_counter()
        paths = _list_images(
            os.path.join(root, "mav0", f"cam{cam_idx}", "data", "*"), start_idx, step
        )
        times = [_path_timestamp(p) for p in paths]
        batch = _detect_or_load(
            paths, times, detector, board, recorder, cam_idx, cache_dir,
            prewarm_cb if cam_idx == 0 else None, spec_factory,
        )
        log.info(
            "cam%d: %d images, %d usable frames, %.3fs",
            cam_idx, len(paths), int(batch.frame_ok().sum()), time.perf_counter() - t0,
        )
        out.append(batch)
    return out


def load_general(
    root: str,
    detector: TagDetector,
    board: Board,
    start_idx: int = 0,
    step: int = 1,
    cam_num: int = 1,
    recorder=None,
    cache_dir: str = None,
    prewarm_cb=None,
    spec_factory=None,
) -> List[FrameBatch]:
    """General layout: {root}/**/cam{i}/**/* with synthetic timestamps
    idx * 1e8 ns (``src/data_loader.rs:160-214``)."""
    out = []
    for cam_idx in range(cam_num):
        paths = _list_images(
            os.path.join(root, "**", f"cam{cam_idx}", "**", "*"), start_idx, step
        )
        times = [i * 100_000_000 for i in range(len(paths))]
        out.append(
            _detect_or_load(
                paths, times, detector, board, recorder, cam_idx, cache_dir,
                prewarm_cb if cam_idx == 0 else None, spec_factory,
            )
        )
    return out
