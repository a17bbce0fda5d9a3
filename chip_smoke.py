#!/usr/bin/env python3
"""Smoke test of the calibration system on the GPU, through its entry points.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 chip_smoke.py               # one GPU: phases (a)-(d)
    python3 chip_smoke.py --devices 4   # four GPUs: phases (b)+(c) on all
                                        # four, then again on one, compared

Phases:
  (a) device: JAX must see GPUs; prints the card's name and power limit.
  (b) mono: a TUM-VI-like 512x512 EUCM video of the default 6x6 AprilGrid,
      534 frames rendered on the device and written as PNGs, calibrated by
      ``ccrs_jax.cli.main`` twice (cold, then warm).  Gates: focal error
      < 1 %, median reprojection < 0.3 px, speculation used, and the f64
      interchange gate (RMS within 1e-6 px of a host-CPU f64 re-solve).
  (c) stereo: the 1024x1024 two-camera regime of the reference's CI
      dataset (2x intrinsics, ``default_rig_extrinsics(2)``), 200 frames a
      camera, through ``--cam-num 2``.  Gates: focal and median per camera,
      and the extrinsic error against ground truth.
  (d) comparisons on the card at the widths of (b): the gpu-marked tests
      (tests/test_gpu.py: over the whole 534-frame video, tracked and cold
      detection and the threshold bitmaps against the same code on the
      host CPU backend; DEFAULT- against HIGHEST-precision code scores),
      per-stage sampling times at the tracking-wave shape, and the
      threshold's device time from a ``jax.profiler`` trace.

Any failed phase exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import logging
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")

#: EUCM ground truth of the TUM-VI 512 regime (bench.py), scaled by size/512
EUCM_512 = (190.9, 190.87, 254.94, 256.86, 0.628, 1.046)
FOCAL_REL = 0.01  # focal error gate (bench.py)
MEDIAN_PX = 0.3  # median reprojection gate (bench.py)
F64_DRIFT_PX = 1e-6  # interchange gate (BASELINE.json)
# Four cards against one: sharding changes fusion order, which reassociates
# f32 sums; the CLI's detections are tracked, so the bound is that of the
# tracked comparison with the CPU (TRACKED_CORNER_PX in tests/test_gpu.py,
# which gives its reason).  Spread over ~10^5 observations, such corner
# shifts move the least-squares optimum by orders of magnitude less than
# the intrinsic and extrinsic bounds.
CORNER_PX = 2e-2
INTR_REL_4V1 = 1e-4
EXT_4V1 = 1e-5


class SmokeFailure(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class Config:
    mono_size: int = 512
    mono_frames: int = 534
    stereo_size: int = 1024
    stereo_frames: int = 200
    wave_batch: int = 72  # sampling timing shape: 72 frames x 36 quads
    wave_quads: int = 36
    reps: int = 5
    trace: bool = True
    # Extrinsics against ground truth: every run of phase (c) on an H100
    # 80GB HBM3 read 2.3e-5 to 2.44e-5 rad and 1.2e-5 to 1.28e-5 m (five
    # runs, one and four cards); the rendered frames' sensor noise and blur
    # set that floor.  The bounds are 5x the largest reading: a rig solve
    # that got several times worse fails.
    ext_rot_rad: float = 1.2e-4
    ext_trans_m: float = 6.5e-5


FULL = Config()
#: the test-only dry run on the CPU: same code path, tiny sizes
TINY = Config(
    mono_size=384, mono_frames=24, stereo_size=384, stereo_frames=16,
    wave_batch=2, wave_quads=8, reps=1, trace=False,
    # 16 frames at 384^2 constrain the rig far less: the CPU dry run reads
    # 4.6e-4 rad and 1.0e-4 m
    ext_rot_rad=2e-3, ext_trans_m=5e-4,
)


def say(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def phase(name):
    say(f"== phase {name}")
    t0 = time.perf_counter()
    yield
    say(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------- (a)
def nvidia_smi_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def device_phase(require_gpu: bool, expect_devices: int | None):
    import jax

    devs = jax.devices()
    if require_gpu:
        check(
            all(d.platform == "gpu" for d in devs),
            f"JAX found no GPU (devices: {[d.platform for d in devs]})",
        )
        for ln in nvidia_smi_lines():
            say(f"card: {ln}")
    say(f"jax {jax.__version__}; {len(devs)} x {devs[0].platform} "
        f"{devs[0].device_kind}")
    if expect_devices is not None:
        check(len(devs) == expect_devices,
              f"expected {expect_devices} devices, JAX sees {len(devs)}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# ------------------------------------------------------- shared helpers
class _Records(logging.Handler):
    """Collects the package's log records: errors (a swallowed prewarm or
    speculation failure) fail the run; mesh messages are reported."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def take(self):
        out, self.records = self.records, []
        return out


def eucm(size):
    from ccrs_jax.models import GenericModel

    s = size / 512.0
    p = list(EUCM_512)
    return GenericModel("eucm", [p[0] * s, p[1] * s, p[2] * s, p[3] * s,
                                 p[4], p[5]], size, size)


def write_pngs(frames: np.ndarray, cam_dir: str):
    """frames (F, H, W) uint8 -> EuRoC-layout PNGs, written in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from ccrs_jax.pngio import write_png

    d = os.path.join(cam_dir, "data")
    os.makedirs(d, exist_ok=True)
    names = [os.path.join(d, f"{10_000_000_000 + i * 100_000_000}.png")
             for i in range(len(frames))]
    with ThreadPoolExecutor(min(16, os.cpu_count() or 4)) as pool:
        list(pool.map(lambda a: write_png(a[0], a[1], level=1),
                      zip(names, frames)))


def run_cli(dataset, out, args, records):
    """One ``ccrs`` run; returns (wall seconds, the mesh each stage used).
    Fails on any error the CLI logged and carried on from."""
    from ccrs_jax import cli

    shutil.rmtree(out, ignore_errors=True)
    if "--detection-cache" in args:  # detect afresh; the cache is for reading
        shutil.rmtree(args[args.index("--detection-cache") + 1],
                      ignore_errors=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        cli.main([dataset, "--output-folder", out, "--no-rerun",
                  "--seed", "11", *args])
    dt = time.perf_counter() - t0
    recs = records.take()
    errs = [r for r in recs if r.levelno >= logging.ERROR]
    check(not errs, "the run logged errors: "
          + "; ".join(r.getMessage() for r in errs))
    return dt, sorted({r.getMessage() for r in recs
                       if "mesh" in r.getMessage()})


def read_median(out, cam):
    rep = open(os.path.join(out, "report.txt")).read()
    part = rep.split(f"cam{cam}:")[1]
    return float(part.split("median  reprojection error:")[1].split("px")[0])


def gate_camera(out, cam, gt, tag):
    blob = json.load(open(os.path.join(out, f"cam{cam}.json")))["EUCM"]
    ferr = abs(blob["fx"] - gt.params[0]) / gt.params[0]
    med = read_median(out, cam)
    say(f"[{tag}] cam{cam}: focal error {ferr:.4%}, median reprojection "
        f"{med:.4f} px")
    check(ferr < FOCAL_REL, f"[{tag}] cam{cam} focal off by {ferr:.2%}")
    check(med < MEDIAN_PX, f"[{tag}] cam{cam} median {med:.3f} px")
    return blob


def load_detections(cache, cam):
    from ccrs_jax.calib.frames import FrameBatch

    (path,) = glob.glob(os.path.join(cache, f"cam{cam}_*.npz"))
    return FrameBatch.load(path)


def f64_gate(board, batch, out, tag):
    """Re-solve the final bundle adjustment on the host CPU backend in f64
    from the run's own result; the RMS must not move."""
    import jax

    from ccrs_jax.calib.single import calib_camera
    from ccrs_jax.calib.validate import reprojection_errors
    from ccrs_jax.models.base import model_from_json
    from ccrs_jax.types import RvecTvec

    model = model_from_json(os.path.join(out, "cam0.json"))
    poses = json.load(open(os.path.join(out, "cam0_poses.json")))
    rtvecs = {int(k): RvecTvec.from_json(v) for k, v in poses.items()}

    def rms(m, rt):
        errs = np.concatenate([e for _, e, _ in
                               reprojection_errors(board, batch, m, rt)])
        return float(np.sqrt(np.mean(errs ** 2)))

    with jax.default_device(jax.devices("cpu")[0]):
        res = calib_camera(board, batch, model, xy_same_focal=False,
                           disabled_distortions=0, fixed_focal=False)
    check(res is not None, f"[{tag}] host f64 re-solve failed")
    drift = abs(rms(model, rtvecs) - rms(*res))
    say(f"[{tag}] f64 interchange: |rms_dev - rms_cpu| = {drift:.3e} px")
    check(drift <= F64_DRIFT_PX, f"[{tag}] f64 drift {drift:.2e} px")


def board_config(work):
    from ccrs_jax.board import BoardConfig
    from ccrs_jax.io import object_to_json

    path = os.path.join(work, "board_config.json")
    object_to_json(path, BoardConfig().to_json())
    return path


# ---------------------------------------------------------------- (b)
def mono_phase(cfg, work, records, reuse=False):
    from ccrs_jax.board import create_default_6x6_board
    from ccrs_jax.calib.pipeline import calibrate_camera_with_retries
    from ccrs_jax.detect import get_family
    from ccrs_jax.testdata import render_frames_device, smooth_sequence_poses

    board = create_default_6x6_board()
    gt = eucm(cfg.mono_size)
    ds = os.path.join(work, "mono")
    frames = None
    if not (reuse and os.path.exists(os.path.join(ds, "done"))):
        t0 = time.perf_counter()
        poses = smooth_sequence_poses(cfg.mono_frames, board, seed=11)
        dev = render_frames_device(gt, board, get_family("t36h11"), poses,
                                   noise=1.5, seed=11)
        frames = np.asarray(dev)
        shutil.rmtree(ds, ignore_errors=True)
        write_pngs(frames, os.path.join(ds, "mav0", "cam0"))
        open(os.path.join(ds, "done"), "w").close()
        say(f"[mono] {cfg.mono_frames} frames {cfg.mono_size}^2 rendered and "
            f"written in {time.perf_counter() - t0:.1f} s")
    bcfg = board_config(work)
    res = {"cams": {}}
    for run in ("cold", "warm"):
        out = os.path.join(work, f"mono_{run}")
        cache = os.path.join(work, f"mono_{run}_det")
        env_prewarm = os.environ.get("CCRS_PREWARM")
        if run == "warm":
            # graphs are compiled already; the prewarm's dummy runs would
            # only contend with the first detection (bench.py does the same)
            os.environ["CCRS_PREWARM"] = "0"
        try:
            dt, meshes = run_cli(
                ds, out, ["--model", "eucm", "--board-config", bcfg,
                          "--detection-cache", cache], records)
        finally:
            if env_prewarm is None:
                os.environ.pop("CCRS_PREWARM", None)
            else:
                os.environ["CCRS_PREWARM"] = env_prewarm
        say(f"[mono] {run} run: {dt:.2f} s "
            f"({cfg.mono_frames / dt:.1f} frames/s)")
        for m in meshes:
            say(f"[mono] {m}")
        check(calibrate_camera_with_retries.last_spec_used,
              f"[mono] {run} run: speculation was not used")
        blob = gate_camera(out, 0, gt, "mono")
    say("[mono] speculation used: True")
    batch = load_detections(cache, 0)
    f64_gate(board, batch, out, "mono")
    res["cams"][0] = {"params": blob, "p2d": batch.p2d, "mask": batch.mask}
    return res, frames


# ---------------------------------------------------------------- (c)
def stereo_phase(cfg, work, records, reuse=False):
    from ccrs_jax.board import create_default_6x6_board
    from ccrs_jax.detect import get_family
    from ccrs_jax.testdata import (default_rig_extrinsics,
                                   render_frames_device, smooth_sequence_poses)
    from ccrs_jax.types import Extrinsics, RvecTvec, rodrigues

    board = create_default_6x6_board()
    gt = eucm(cfg.stereo_size)
    ext_gt = default_rig_extrinsics(2)
    ds = os.path.join(work, "stereo")
    say(f"[stereo] {cfg.stereo_frames} frames a camera: a cut of the "
        "~2,900-frame reference sequence to fit the smoke's time")
    cam0_frames = None
    if not (reuse and os.path.exists(os.path.join(ds, "done"))):
        t0 = time.perf_counter()
        poses0 = smooth_sequence_poses(cfg.stereo_frames, board, seed=11)
        shutil.rmtree(ds, ignore_errors=True)
        t10 = RvecTvec(ext_gt[1][:3], ext_gt[1][3:])
        for cam in range(2):
            poses = poses0 if cam == 0 else np.stack([
                np.concatenate([(c := t10.compose(RvecTvec(p[:3], p[3:]))).rvec,
                                c.tvec]) for p in poses0])
            frames = np.asarray(render_frames_device(
                gt, board, get_family("t36h11"), poses, noise=1.5,
                seed=11 + cam))
            if cam == 0:
                cam0_frames = frames
            write_pngs(frames, os.path.join(ds, "mav0", f"cam{cam}"))
        open(os.path.join(ds, "done"), "w").close()
        say(f"[stereo] 2 x {cfg.stereo_frames} frames {cfg.stereo_size}^2 "
            f"rendered and written in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(work, "stereo_out")
    cache = os.path.join(work, "stereo_det")
    dt, meshes = run_cli(ds, out, ["--model", "eucm", "--cam-num", "2",
                                   "--board-config", board_config(work),
                                   "--detection-cache", cache], records)
    say(f"[stereo] run: {dt:.2f} s (cold for this geometry)")
    for m in meshes:
        say(f"[stereo] {m}")
    res = {"cams": {}}
    for cam in range(2):
        blob = gate_camera(out, cam, gt, "stereo")
        b = load_detections(cache, cam)
        res["cams"][cam] = {"params": blob, "p2d": b.p2d, "mask": b.mask}
    ext = Extrinsics.from_json(
        json.load(open(os.path.join(out, "extrinsics.json")))).rtvecs[1]
    R_err = rodrigues(ext.rvec) @ rodrigues(ext_gt[1][:3]).T
    rot = float(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    trans = float(np.linalg.norm(ext.tvec - ext_gt[1][3:]))
    say(f"[stereo] extrinsic error: rotation {rot:.2e} rad (bound "
        f"{cfg.ext_rot_rad}), translation {trans:.2e} m (bound "
        f"{cfg.ext_trans_m})")
    check(rot < cfg.ext_rot_rad and trans < cfg.ext_trans_m,
          "[stereo] extrinsics off ground truth")
    res["ext"] = np.concatenate([ext.rvec, ext.tvec])
    return res, cam0_frames


# ---------------------------------------------------------------- (d)
def _median_time(fn, reps):
    fn()  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


class _Outcomes:
    """pytest plugin: which tests passed, and which did anything else."""

    def __init__(self):
        self.passed, self.other = [], []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed.append(report.nodeid)
        elif report.failed or report.skipped:
            self.other.append(f"{report.nodeid} {report.outcome} "
                              f"({report.when})")


def run_gpu_tests():
    """The gpu-marked tests (tests/test_gpu.py: tracked and cold detection
    and the threshold bitmaps against the host CPU backend, DEFAULT-
    against HIGHEST-precision code scores), in this process: a second
    process could not open the card beside this one."""
    import pytest

    os.environ["CCRS_TESTS_ON_GPU"] = "1"
    outcomes = _Outcomes()
    rc = pytest.main(
        [os.path.join(ROOT, "tests", "test_gpu.py"), "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "--rootdir", ROOT],
        plugins=[outcomes],
    )
    for t in outcomes.passed:
        say(f"[gpu tests] passed: {t}")
    check(rc == 0 and outcomes.passed and not outcomes.other,
          f"gpu tests: exit {rc}, not passed: {outcomes.other}")


def sampling_times(cfg, size):
    """Per-stage device times of the detector's sampling at the tracking
    wave shape (host clock around block_until_ready, median of reps)."""
    import jax
    import jax.numpy as jnp

    from ccrs_jax.detect import get_family
    from ccrs_jax.detect.decode import _decode_core_dense, refine_decode_fused_dense
    from ccrs_jax.detect.sample import build_klt_maps, refine_corners_maps, unsharp_batch

    B, M = cfg.wave_batch, cfg.wave_quads
    fam = get_family("t36h11")
    rng = np.random.default_rng(5)
    imgs = jnp.asarray(rng.integers(0, 256, (B, size, size), np.uint8))
    cen = rng.uniform(0.2 * size, 0.8 * size, (B, M, 1, 2))
    sq = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
    quads = jnp.asarray((cen + sq * 0.03 * size).astype(np.float32))
    qv = jnp.ones((B, M), bool)
    f = jnp.asarray(imgs, jnp.float32)
    maps = jax.jit(build_klt_maps)(f)
    sharp = jax.jit(unsharp_batch)(f)
    stages = {
        "klt_maps": lambda: jax.jit(build_klt_maps)(f).block_until_ready(),
        "refine": lambda: jax.jit(refine_corners_maps)(
            maps, quads.reshape(B, M * 4, 2)).block_until_ready(),
        "unsharp": lambda: jax.jit(unsharp_batch)(f).block_until_ready(),
        "decode": lambda: jax.jit(_decode_core_dense, static_argnums=0)(
            fam, sharp, quads, qv)["valid"].block_until_ready(),
        "refine_decode": lambda: refine_decode_fused_dense(
            fam, imgs, quads, qv)["valid"].block_until_ready(),
    }
    out = {k: _median_time(fn, cfg.reps) for k, fn in stages.items()}
    say(f"[timing] sampling at {B}x{size}^2, {B * M * 4} corners: "
        + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in out.items()))
    return out


def _busy_ns(events):
    """Union of [start, end) intervals, in ns."""
    total, end = 0.0, -1.0
    for s, e in sorted(events):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_busy_ns(trace_dir, module_substr):
    """Device time of one jitted function, from a jax.profiler trace: the
    union of the intervals of GPU events whose HLO module matches."""
    from jax.profiler import ProfileData

    (path,) = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                        recursive=True)
    pd = ProfileData.from_file(path)
    events, lines = [], set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Module" in line.name or "Step" in line.name:
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                if module_substr in str(stats.get("hlo_module", "")):
                    events.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                    lines.add(line.name)
    check(events, f"no device events of {module_substr} in the trace")
    return _busy_ns(events), len(events), sorted(lines)


def threshold_trace(frames, scale, tag, work):
    """Trace threshold_front over a frame set in the detector's chunks and
    report its device time and its share of the card's HBM bandwidth."""
    import jax
    import jax.numpy as jnp

    from ccrs_jax.detect.detector import _chunk_plan
    from ccrs_jax.detect.threshold import threshold_front

    dev = jnp.asarray(frames)
    B, H, W = dev.shape
    sizes = _chunk_plan(B, 64, 8, cpu=False)
    offs = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    chunks = []
    for o, c in zip(offs, sizes):
        sel = np.minimum(np.arange(o, o + c), B - 1).astype(np.int32)
        chunks.append(jnp.take(dev, jnp.asarray(sel), axis=0))
    for ch in chunks:  # compile both chunk shapes outside the trace
        threshold_front(ch, scale).block_until_ready()
    tdir = os.path.join(work, f"trace_{tag}")
    shutil.rmtree(tdir, ignore_errors=True)
    with jax.profiler.trace(tdir):
        outs = [threshold_front(ch, scale) for ch in chunks]
        jax.block_until_ready(outs)
    busy, n_ev, lines = device_busy_ns(tdir, "threshold_front")
    n = int(sum(sizes))
    sh, sw = H // scale, W // scale
    nbytes = n * H * W + n * sh * sw // 8  # frames in, packed bits out
    rate = nbytes / (busy * 1e-9)
    say(f"[trace] threshold {tag} ({n} frames {H}x{W}, scale {scale}): "
        f"device time {busy / 1e6:.3f} ms in {n_ev} events on {lines}; "
        f"{nbytes / 1e6:.1f} MB at least -> {rate / 1e9:.0f} GB/s = "
        f"{rate / 3.35e12:.1%} of the H100 SXM's 3.35 TB/s")
    return busy


# ---------------------------------------------------------------- main
def run_phases(cfg, require_gpu=True, expect_devices=None, compare=True,
               reuse=False, work=WORK):
    """Phases (a)-(d) in this process; returns (device, results)."""
    import ccrs_jax  # noqa: F401  (fails here in a bare copy of the script)

    with phase("a: device"):
        device = device_phase(require_gpu, expect_devices)
    records = _Records()
    pkg_log = logging.getLogger("ccrs_jax")
    pkg_log.addHandler(records)
    mesh_logs = [logging.getLogger(n) for n in
                 ("ccrs_jax.detect.detector", "ccrs_jax.calib.multi")]
    levels = [lg.level for lg in mesh_logs]
    for lg in mesh_logs:
        lg.setLevel(logging.INFO)
    if not reuse:
        shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(work)  # the CLI writes default_board_config.json to the cwd
    try:
        with phase(f"b: mono {cfg.mono_size}^2 EUCM"):
            mono, mono_frames = mono_phase(cfg, work, records, reuse)
        with phase(f"c: stereo {cfg.stereo_size}^2 EUCM"):
            stereo, stereo_frames = stereo_phase(cfg, work, records, reuse)
        if compare:
            with phase("d: comparisons on the card"):
                if require_gpu:
                    run_gpu_tests()
                else:
                    say("[gpu tests] not run (no GPU)")
                sampling_times(cfg, cfg.mono_size)
                sampling_times(cfg, cfg.stereo_size)
                if cfg.trace:
                    threshold_trace(mono_frames, 1, "512", work)
                    threshold_trace(stereo_frames, 2, "1024", work)
                else:
                    say("[trace] threshold device time: not measured "
                        "(no GPU)")
    finally:
        os.chdir(cwd)
        pkg_log.removeHandler(records)
        for lg, lv in zip(mesh_logs, levels):
            lg.setLevel(lv)
    return device, {"mono": mono, "stereo": stereo}


def _dump(results, path):
    flat = {}
    for ph, r in results.items():
        for cam, c in r["cams"].items():
            for k in ("p2d", "mask"):
                flat[f"{ph}/{cam}/{k}"] = c[k]
            flat[f"{ph}/{cam}/params"] = np.array(
                [c["params"][k] for k in sorted(c["params"])])
        if "ext" in r:
            flat[f"{ph}/ext"] = r["ext"]
    np.savez(path, **flat)


def compare_runs(a_path, b_path):
    """Four cards against one: same tags, corners within CORNER_PX,
    intrinsics and extrinsics within their bounds.  Reports every
    difference before failing."""
    a, b = np.load(a_path), np.load(b_path)
    check(sorted(a.files) == sorted(b.files), "result sets differ")
    bad = []
    for k in sorted(a.files):
        if k.endswith("/mask"):
            diff = a[k] != b[k]
            frames = np.flatnonzero(diff.any(axis=1))
            say(f"[4v1] {k}: {int(diff.sum())} of {diff.size} corners found "
                f"by one run only, on {frames.size} frames "
                f"{frames[:20].tolist()}")
            if diff.any():
                bad.append(f"{k}: detected corners differ")
        elif k.endswith("/p2d"):
            m = a[k.replace("p2d", "mask")] & b[k.replace("p2d", "mask")]
            d = float(np.abs(a[k][m] - b[k][m]).max()) if m.any() else 0.0
            say(f"[4v1] {k}: common corners within {d:.2e} px "
                f"(bound {CORNER_PX})")
            if d > CORNER_PX:
                bad.append(f"{k}: corners differ by {d:.2e} px")
        elif k.endswith("/params"):
            rel = float(np.max(np.abs(a[k] - b[k]) / np.abs(b[k])))
            say(f"[4v1] {k}: intrinsics within {rel:.2e} relative "
                f"(bound {INTR_REL_4V1})")
            if rel > INTR_REL_4V1:
                bad.append(f"{k}: intrinsics differ by {rel:.2e}")
        else:
            d = float(np.abs(a[k] - b[k]).max())
            say(f"[4v1] {k}: extrinsics within {d:.2e} (bound {EXT_4V1})")
            if d > EXT_4V1:
                bad.append(f"{k}: extrinsics differ by {d:.2e}")
    check(not bad, "; ".join(bad))


def four_device_launcher():
    """--devices 4: phases (b)+(c) on four cards, then in a second process
    on one card (never beside the first), then the comparison.  This
    process never opens a card itself."""
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    dumps = {n: os.path.join(WORK, f"result_{n}dev.npz") for n in (4, 1)}
    dev_json = os.path.join(WORK, "device_4dev.json")
    for n in (4, 1):
        env = dict(os.environ)
        if n == 1:
            env["CUDA_VISIBLE_DEVICES"] = "0"
        say(f"== {n}-device run")
        rc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child-run",
             dumps[n], "--devices", str(n)], env=env,
        ).returncode
        check(rc == 0, f"the {n}-device run failed (exit {rc})")
    with phase("e: four cards against one"):
        compare_runs(dumps[4], dumps[1])
    with open(dev_json) as f:
        return json.load(f)


def main(argv=None):
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        # the f64 interchange gate and the comparisons need the host backend
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    ap.add_argument("--child-run", metavar="NPZ", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    try:
        if args.devices == 4 and not args.child_run:
            device = four_device_launcher()
        elif args.child_run:
            device, results = run_phases(
                FULL, expect_devices=args.devices, compare=False, reuse=True)
            _dump(results, args.child_run)
            if args.devices == 4:
                with open(os.path.join(WORK, "device_4dev.json"), "w") as f:
                    json.dump(device, f)
            return 0
        else:
            device, _ = run_phases(FULL, expect_devices=1)
            shutil.rmtree(WORK, ignore_errors=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
