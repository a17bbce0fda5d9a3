#!/usr/bin/env python
"""Headline benchmark: end-to-end detect+calibrate throughput.

Measures the full pipeline (batched AprilGrid detection -> init -> LM
bundle adjustment -> validation) on TUM-VI-like synthetic sequences
(EUCM fisheye, default 6x6 board, rendered with noise), since the
zero-egress environment cannot download the reference's TUM-VI acceptance
dataset (BASELINE.md).  Two resolutions run:

- 512x512  — the TUM-VI 512 regime (data/eucm.json parameters); its fps
  is the HEADLINE value.
- 1024x1024 — the CI acceptance-dataset regime
  (dataset-calib-cam1_1024_16, /root/reference/.github/workflows/rust.yml
  "Test on dataset"): 2x-scaled intrinsics, the large-tag dual-erosion
  path.  Reported as fps_1024 with its own correctness gate.

Prints ONE JSON line:
  value        = 512 frames/sec over the measured (post-warmup) run
  fps_1024 / warmup_sec / stages_sec = diagnostics (acceptance-geometry
                 throughput, first-run compile+cache time, per-stage
                 wall-clock of the best 512 timed run).

A correctness gate runs per resolution: the recovered EUCM parameters
must match the ground truth (focal within 1%, median reprojection
< 0.3 px), so the numbers can't be gamed by skipping work.
"""

import contextlib
import json
import os
import sys
import time

import numpy as np

# headline runs the full north-star length (534-frame TUM-VI calib-cam1
# regime, BASELINE.json); BENCH_FRAMES=48 for quick iteration
N_FRAMES = int(os.environ.get("BENCH_FRAMES", "534"))
N_FRAMES_1024 = int(os.environ.get("BENCH_FRAMES_1024", "128"))


def run_config(size: int, n_frames: int, collect_stages: bool):
    import jax.random as jr

    from ccrs_jax.utils.host import cpu_scope

    def key(seed):
        # PRNG key creation on the local CPU (utils/host.py)
        with cpu_scope():
            return jr.PRNGKey(seed)

    from ccrs_jax.board import create_default_6x6_board
    from ccrs_jax.calib import validation
    from ccrs_jax.calib.pipeline import calibrate_camera_with_retries
    from ccrs_jax.calib.frames import FrameBatch
    from ccrs_jax.detect import TagDetector, get_family
    from ccrs_jax.models import GenericModel, zeros_like_model
    from ccrs_jax.testdata import (
        render_board_image,
        render_frames_device,
        smooth_sequence_poses,
    )
    from ccrs_jax.types import CalibParams
    from ccrs_jax.utils import profiling

    board = create_default_6x6_board()
    fam = get_family("t36h11")
    s = size / 512.0
    gt = GenericModel(
        "eucm",
        [190.9 * s, 190.87 * s, 254.94 * s, 256.86 * s, 0.628, 1.046],
        size, size,
    )

    print(f"[{size}] rendering {n_frames} frames...", file=sys.stderr)
    t_start = time.perf_counter()
    detector = TagDetector("t36h11")
    # overlap the detect-graph compiles with the render
    from threading import Thread

    from ccrs_jax.calib.prewarm import prewarm_calibration

    warm_thread = Thread(
        target=lambda: detector.prewarm(size, size, board, n_frames=n_frames),
        daemon=True,
    )
    warm_thread.start()
    # calib graphs (fused init + full-batch BA) compile on their own thread
    calib_thread = Thread(
        target=lambda: prewarm_calibration(
            board, n_frames, "eucm", CalibParams(), size, size,
            speculative=True,
        ),
        daemon=True,
    )
    calib_thread.start()
    # continuous handheld-video trajectory — the regime of the reference's
    # own acceptance dataset (TUM-VI calib video); see smooth_sequence_poses
    poses = smooth_sequence_poses(n_frames, board, seed=11)
    # device-resident frames: rendered on device and never downloaded — the
    # detect stage's only host traffic is thresholded bitmaps + decode
    # outputs
    imgs, dev_imgs = None, None
    if os.environ.get("BENCH_HOST_IMAGES", "") != "1":
        dev_imgs = render_frames_device(gt, board, fam, poses, noise=1.5, seed=11)
        dev_imgs.block_until_ready()

    def render_host():
        return np.stack(
            [
                render_board_image(gt, board, fam, p[:3], p[3:], noise=1.5, seed=f)
                for f, p in enumerate(poses)
            ]
        )

    if dev_imgs is None:
        imgs = render_host()
    t_render = time.perf_counter()
    warm_thread.join()
    calib_thread.join()
    print(
        f"[{size}] render+prewarm: render done +{t_render - t_start:.1f}s, "
        f"prewarm joined +{time.perf_counter() - t_start:.1f}s",
        file=sys.stderr,
    )
    times = list(range(n_frames))

    def pipeline(key):
        from ccrs_jax.calib.pipeline import SpeculativeCalib

        # each run is an independent dataset pass: drop the video carry
        detector.reset_tracking()
        # speculative calibration overlaps the detector's audit sweeps;
        # the final solve warm-starts from it but still runs to full
        # convergence on the final detections (gated identically)
        spec = SpeculativeCalib(
            board, times, zeros_like_model("eucm"), CalibParams(), key,
            size, size,
        )
        detector.on_provisional = spec.on_provisional
        dets = detector.detect_batch(imgs, board=board, dev_images=dev_imgs)
        batch = FrameBatch.from_detections(dets, times, board, size, size)
        # the product retry ladder (random frame re-pick on failure), same
        # as the CLI: the best-two-frame heuristic can land on a pair that
        # is focal-degenerate (pure-translation-like), which the reference
        # handles identically (bin/camera_calibration.rs:217-242)
        result = calibrate_camera_with_retries(
            board, batch, zeros_like_model("eucm"), CalibParams(), key,
            warm_provider=spec.take,
        )
        assert result is not None, "calibration failed"
        return batch, result

    # warmup: populate all jit caches (detector graphs, RANSAC, PnP, BA).
    # Stage-attributed: warmup - timed-run stage time = first-call
    # compile/load latency per stage (the prewarm coverage gap).
    print(f"[{size}] warmup run (compiles)...", file=sys.stderr)
    if collect_stages:
        profiling.enable()
        profiling.reset()
    t0 = time.perf_counter()
    batch, (model, rtvecs) = pipeline(key(0))
    warm = time.perf_counter() - t0
    print(f"[{size}] warmup: {warm:.1f}s", file=sys.stderr)
    if collect_stages:
        wstages = profiling.totals()
        for name in sorted(wstages, key=lambda k: -wstages[k]):
            print(
                f"  warmup stage {name:24s} {wstages[name]:7.3f}s",
                file=sys.stderr,
            )

    # timed runs: best of 5
    if collect_stages:
        profiling.enable()
    elapsed = float("inf")
    stages = {}
    for rep in range(5 if collect_stages else 3):
        profiling.reset()
        t0 = time.perf_counter()
        batch, (model, rtvecs) = pipeline(key(1))
        dt = time.perf_counter() - t0
        print(f"[{size}] timed run {rep}: {dt:.2f}s", file=sys.stderr)
        if dt < elapsed:
            elapsed = dt
            stages = profiling.totals()
    if os.environ.get("CCRS_TIMING_SPANS"):
        # span timeline of the LAST rep (diagnostic: shows the critical
        # path through the overlapped stages; reset() clears per rep)
        sp = profiling.spans()
        if sp:
            t_base = min(s[2] for s in sp)
            for name, thr, a, b in sorted(sp, key=lambda s: s[2]):
                print(
                    f"  span {a - t_base:7.3f} -> {b - t_base:7.3f} "
                    f"({b - a:6.3f}s) {name} [{thr}]",
                    file=sys.stderr,
                )
    profiling.reset()
    for name in sorted(stages, key=lambda k: -stages[k]):
        print(f"  stage {name:24s} {stages[name]:7.3f}s", file=sys.stderr)
    if getattr(detector, "stats", None):
        print(f"  detector stats: {detector.stats}", file=sys.stderr)

    # speculation observability: the timed runs' gains depend on the
    # provisional hook firing and the warm seed being consumed; a silent
    # regression must fail the bench, not just shave fps
    from ccrs_jax.calib.pipeline import calibrate_camera_with_retries as _ccwr

    spec_offered = bool(getattr(_ccwr, "last_warm_offered", False))
    spec_used = bool(getattr(_ccwr, "last_spec_used", False))
    print(
        f"[{size}] speculation: offered={spec_offered} used={spec_used}",
        file=sys.stderr,
    )
    if collect_stages and os.environ.get("BENCH_NO_SPEC_ASSERT", "") != "1":
        # the 534-frame noisy regime always has audit rounds to overlap;
        # zero-audit batches (where the lazy fire correctly skips) only
        # occur at the clean short regimes (the 1024 config)
        assert spec_offered, "speculation never produced a warm seed"

    # correctness gate
    with contextlib.redirect_stdout(sys.stderr):
        avg99, median = validation(board, batch, model, rtvecs)
    focal_err = abs(model.params[0] - gt.params[0]) / gt.params[0]
    assert focal_err < 0.01, f"[{size}] focal off by {focal_err:.2%}"
    assert median < 0.3, f"[{size}] median reprojection {median:.3f} px"
    print(
        f"[{size}] gate ok: focal err {focal_err:.2%}, median {median:.4f} px",
        file=sys.stderr,
    )

    # interchange-precision gate (BASELINE.json: RMS within 1e-6 px of the
    # f64 reference): re-run the final BA on the HOST CPU backend in true
    # f64 and require the accelerator solution's RMS to match.  If the
    # accelerator result were off-optimum, the host polish would move the
    # RMS.
    if collect_stages and os.environ.get("BENCH_SKIP_F64GATE", "") != "1":
        import jax

        from ccrs_jax.calib.single import calib_camera
        from ccrs_jax.calib.validate import reprojection_errors

        def rms_of(m, rt):
            per = reprojection_errors(board, batch, m, rt)
            errs = np.concatenate([e for _, e, _ in per])
            return float(np.sqrt(np.mean(errs**2)))

        rms_dev = rms_of(model, rtvecs)
        with jax.default_device(jax.devices("cpu")[0]):
            cpu_res = calib_camera(
                board, batch, model, xy_same_focal=False,
                disabled_distortions=0, fixed_focal=False,
            )
        assert cpu_res is not None, f"[{size}] host f64 re-solve failed"
        rms_cpu = rms_of(*cpu_res)
        drift = abs(rms_dev - rms_cpu)
        assert drift < 1e-6, f"[{size}] f64 interchange drift {drift:.2e} px"
        print(
            f"[{size}] f64 gate ok: |rms_dev - rms_cpu| = {drift:.2e} px",
            file=sys.stderr,
        )

    # Honest host-image number: the same frames fed from
    # host memory, paying the host->device upload every real dataset run
    # pays (PNG decode is excluded: it overlaps detection on loader
    # threads in the product path, dataloader.py).  Reported alongside the
    # device-resident headline; the upload part of the gap is measured
    # below as the JSON's upload_sec key.
    fps_host = None
    upload_sec = None
    if (
        collect_stages
        and dev_imgs is not None
        and os.environ.get("BENCH_SKIP_HOST", "") != "1"
    ):
        import jax.numpy as jnp

        host_imgs = np.asarray(dev_imgs).astype(np.uint8)

        # Measure the raw host->device upload of the full batch once, so
        # the fps_host-vs-headline gap decomposes into measured upload
        # time vs pipeline time.  The pipeline overlaps
        # this transfer with its own dispatch work (jnp.asarray is an
        # async enqueue), so the gap can be smaller than this number.
        t0 = time.perf_counter()
        up = jnp.asarray(host_imgs)
        up.block_until_ready()
        upload_sec = time.perf_counter() - t0
        del up
        mb = host_imgs.nbytes / 1e6
        print(
            f"[{size}] host->device upload: {upload_sec:.2f}s for "
            f"{mb:.0f} MB ({mb / upload_sec:.0f} MB/s)",
            file=sys.stderr,
        )

        def pipeline_host(key):
            # the PRODUCT composition for host-resident frames: chunked
            # async uploads feeding a TrackedSession whose finalize runs
            # ONE whole-batch detection (detect/tracked.py) — the exact
            # code path the CLI loader drives.
            from ccrs_jax.calib.pipeline import SpeculativeCalib
            from ccrs_jax.dataloader import DETECT_BATCH

            detector.reset_tracking()
            spec = SpeculativeCalib(
                board, times, zeros_like_model("eucm"), CalibParams(), key,
                size, size,
            )
            detector.on_provisional = spec.on_provisional
            # n_frames hint: same preallocated-buffer placement path the
            # CLI loader drives (peak HBM O(sequence + chunk) there)
            session = detector.begin_tracked(board, n_frames=n_frames)
            devs, sizes = [], []
            for off in range(0, n_frames, DETECT_BATCH):
                chunk = host_imgs[off : off + DETECT_BATCH]
                nv = chunk.shape[0]
                if nv < DETECT_BATCH and n_frames > DETECT_BATCH:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], DETECT_BATCH - nv, 0)]
                    )
                devs.append(jnp.asarray(chunk))  # async h2d enqueue
                sizes.append(nv)
            for d, nv in zip(devs, sizes):
                session.feed(d, n_valid=nv)
            dets = session.finalize()
            batch = FrameBatch.from_detections(dets, times, board, size, size)
            result = calibrate_camera_with_retries(
                board, batch, zeros_like_model("eucm"), CalibParams(), key,
                warm_provider=spec.take,
            )
            assert result is not None, "host-path calibration failed"
            return batch, result

        pipeline_host(key(0))  # warm any host-path-only graphs
        best = float("inf")
        for rep in range(2):
            t0 = time.perf_counter()
            pipeline_host(key(1))
            dt = time.perf_counter() - t0
            print(f"[{size}] host-image run {rep}: {dt:.2f}s", file=sys.stderr)
            best = min(best, dt)
        fps_host = n_frames / best

    # Product-path number: drive the REAL CLI entry
    # point (python -m ccrs_jax == cli.main) end-to-end on an on-disk
    # EuRoC-layout dataset of the same frames and report fps_cli next to
    # the headline, with the same ground-truth gates.  The CLI pays PNG
    # decode (overlapped with detection on loader threads), the
    # host->device upload, the streaming tracked session, speculative
    # calibration, and artifact writing — regressions in the product
    # composition become visible here.
    fps_cli = None
    spec_used_cli = None
    if (
        collect_stages
        and dev_imgs is not None
        and os.environ.get("BENCH_SKIP_CLI", "") != "1"
    ):
        import contextlib as _ctx
        import shutil
        import tempfile

        from ccrs_jax import cli as cli_mod

        tmpd = tempfile.mkdtemp(prefix="ccrs_bench_cli_")
        try:
            ddir = os.path.join(tmpd, "dataset", "mav0", "cam0", "data")
            os.makedirs(ddir)
            frames_u8 = np.asarray(dev_imgs).astype(np.uint8)
            t0 = time.perf_counter()
            from ccrs_jax.pngio import write_png

            for i in range(n_frames):
                write_png(
                    os.path.join(ddir, f"{10_000_000_000 + i * 100_000_000}.png"),
                    frames_u8[i],
                )
            print(
                f"[{size}] cli dataset written in "
                f"{time.perf_counter() - t0:.1f}s",
                file=sys.stderr,
            )

            # keep the CLI's default-board-config artifact inside the
            # tmpdir (setup_board otherwise writes
            # default_board_config.json into the bench's CWD)
            from ccrs_jax.board import BoardConfig
            from ccrs_jax.io import object_to_json

            bcfg_path = os.path.join(tmpd, "board_config.json")
            object_to_json(bcfg_path, BoardConfig().to_json())

            def run_cli(tag, prewarm=False):
                # timed in-process runs skip the prewarm: every graph is
                # already compiled, and the dummy executions contend with
                # chunk-1 detection (a FRESH process keeps it — that's
                # what it's for)
                prev_prewarm = os.environ.get("CCRS_PREWARM")
                os.environ["CCRS_PREWARM"] = "1" if prewarm else "0"
                t0 = time.perf_counter()
                try:
                    with _ctx.redirect_stdout(sys.stderr):
                        cli_mod.main(
                            [
                                os.path.join(tmpd, "dataset"),
                                "--model", "eucm",
                                "--board-config", bcfg_path,
                                "--output-folder", os.path.join(tmpd, tag),
                                "--no-rerun",
                                "--seed", "11",
                            ]
                        )
                finally:
                    # restore the caller's value (don't clobber an
                    # exported CCRS_PREWARM=0 for the rest of the process)
                    if prev_prewarm is None:
                        os.environ.pop("CCRS_PREWARM", None)
                    else:
                        os.environ["CCRS_PREWARM"] = prev_prewarm
                return time.perf_counter() - t0

            # CLI-only graph shapes load/compile here (prewarm on: this
            # is the fresh-process composition, and it also warms the
            # prewarm path's own graphs)
            dt = run_cli("warm", prewarm=True)
            print(f"[{size}] cli warmup run: {dt:.2f}s", file=sys.stderr)
            best_cli = float("inf")
            for rep in range(2):
                dt = run_cli(f"timed{rep}")
                print(f"[{size}] cli run {rep}: {dt:.2f}s", file=sys.stderr)
                best_cli = min(best_cli, dt)
            fps_cli = n_frames / best_cli
            spec_used_cli = bool(getattr(_ccwr, "last_spec_used", False))
            # same gates as the headline, on the CLI's own artifacts
            blob = json.load(
                open(os.path.join(tmpd, "timed1", "cam0.json"))
            )[gt.name.upper()]
            cli_focal_err = abs(blob["fx"] - gt.params[0]) / gt.params[0]
            assert cli_focal_err < 0.01, f"[cli] focal off {cli_focal_err:.2%}"
            rep_txt = open(
                os.path.join(tmpd, "timed1", "report.txt")
            ).read()
            cli_med = float(
                rep_txt.split("median  reprojection error:")[1].split("px")[0]
            )
            assert cli_med < 0.3, f"[cli] median reprojection {cli_med:.3f} px"
            print(
                f"[{size}] cli gate ok: focal err {cli_focal_err:.2%}, "
                f"median {cli_med:.4f} px, spec_used={spec_used_cli}",
                file=sys.stderr,
            )
        finally:
            shutil.rmtree(tmpd, ignore_errors=True)

    extras = {}
    if fps_host is not None:
        extras["fps_host"] = round(fps_host, 2)
    if upload_sec is not None:
        # separately-measured diagnostic (a synchronous whole-batch
        # upload no timed run performs) — its OWN key, never mixed into
        # the timed-run stage totals
        extras["upload_sec"] = round(upload_sec, 3)
    if fps_cli is not None:
        extras["fps_cli"] = round(fps_cli, 2)
        extras["spec_used_cli"] = spec_used_cli
    if collect_stages:
        extras["spec_offered"] = spec_offered
        extras["spec_used"] = spec_used
    return n_frames / elapsed, warm, stages, extras


def run():
    fps_512, warm, stages, extras = run_config(512, N_FRAMES, collect_stages=True)
    fps_1024 = warm_1024 = None
    if os.environ.get("BENCH_SKIP_1024", "") != "1":
        fps_1024, warm_1024, _, _ = run_config(
            1024, N_FRAMES_1024, collect_stages=False
        )
    out = {
        "metric": "end-to-end detect+calibrate throughput (512x512 EUCM AprilGrid, TUM-VI-like synthetic video, %d frames)" % N_FRAMES,
        "value": round(fps_512, 2),
        "unit": "frames/sec",
        "warmup_sec": round(warm, 1),
        "stages_sec": {k: round(v, 3) for k, v in sorted(stages.items())},
    }
    out.update(extras)
    if fps_1024 is not None:
        out["fps_1024"] = round(fps_1024, 2)
        out["warmup_1024"] = round(warm_1024, 1)
    return out


if __name__ == "__main__":
    result = run()
    print(json.dumps(result))
