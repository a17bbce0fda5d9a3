"""Per-camera calibration orchestration.

Rebuilds ``init_and_calibrate_one_camera`` (``src/util.rs:831-911``) and the
retry ladder of ``calibrate_all_cameras``
(``src/bin/camera_calibration.rs:205-246``): pick two init frames, attempt
closed-form init up to 10 times (fresh PRNG key each attempt), convert the
fitted UCM to the target model, then run the full bundle adjustment.
Randomness is reproducible: every retry derives from one threaded JAX key.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import jax
import numpy as np

from ..board import Board
from ..models import GenericModel
from ..utils.profiling import stage
from ..utils.host import cpu_scope
from ..types import CalibParams, RvecTvec
from .convert import convert_model
from .frames import FrameBatch
from .initialize import find_best_two_frames, try_init_camera
from .single import calib_camera

log = logging.getLogger(__name__)

MAX_INIT_ATTEMPTS = 10  # src/util.rs:855
MAX_TRIALS = 3  # bin/camera_calibration.rs:217

import os

#: frame cap for the SPECULATIVE solve (SpeculativeCalib subsamples its
#: provisional batch down to at most this many frames).  Two reasons:
#: (1) the detector's audit sweeps enqueue their decode/assist graphs on
#: the same device as the speculative BA graph, so a smaller spec solve
#: shortens the window in which they contend.  (2) the seed does not
#: need every frame: the final solve re-initializes missing poses with
#: its in-graph PnP (warm_valid=0 falls back) and re-polishes everything.
SPEC_MAX_FRAMES = int(os.environ.get("CCRS_SPEC_MAX_FRAMES", "192"))


def spec_stride(n_frames: int) -> int:
    """Subsample stride the speculative solve uses for ``n_frames``
    (shared with calib.prewarm so the spec-shaped BA graph is warmed)."""
    return max(1, -(-n_frames // SPEC_MAX_FRAMES))


def fill_poses_lerp(poses: np.ndarray, valid: np.ndarray) -> bool:
    """Fill invalid rows of a (F, 6) rvec|tvec pose array by per-component
    lerp between the valid neighbors, IN PLACE; rows outside the valid
    range clamp to the nearest.  Returns True when every row is filled.

    Axis-angle double cover: consecutive valid rvecs can land on opposite
    representatives (``r`` vs ``(1 - 2*pi/|r|) * r``), and lerping across
    such a flip produces a garbage rotation (measured: a seed bad enough
    to exhaust the final LM's 60-iteration f32 budget).  Each valid rvec
    is first re-branched to the representative nearest its predecessor.
    """
    idx = np.flatnonzero(valid)
    if len(idx) < 2:
        return False
    r = poses[idx, :3].copy()
    for k in range(1, len(idx)):
        n = float(np.linalg.norm(r[k]))
        if n > 1e-9:
            alt = r[k] * (1.0 - 2.0 * np.pi / n)
            if np.sum((alt - r[k - 1]) ** 2) < np.sum(
                (r[k] - r[k - 1]) ** 2
            ):
                r[k] = alt
    poses[idx, :3] = r
    allf = np.arange(poses.shape[0])
    for d in range(6):
        poses[:, d] = np.interp(allf, idx, poses[idx, d])
    return True


def init_and_calibrate_one_camera(
    board: Board,
    batch: FrameBatch,
    target_model: GenericModel,
    calib_params: CalibParams,
    key,
    random_pick_two_frames: bool = False,
    rng=None,
    warm=None,
    polish_iters: int = 12,
    pose_init_f32: bool = False,
    out: Optional[dict] = None,
) -> Optional[Tuple[GenericModel, Dict[int, RvecTvec]]]:
    """``warm``: optional (model, poses (F,6), pose_valid (F,),
    init_frames) from a speculative calibration on provisional
    detections (SpeculativeCalib) — skips init+convert and seeds the
    final BA, which still runs to full convergence on ``batch``.
    ``polish_iters``: f64 polish budget passed to the BA (the
    speculative solve truncates it; its output is only a seed).
    ``pose_init_f32``: f32 PnP init (seed-quality solves only; see
    calib_camera).
    ``out``: optional dict filled with per-attempt metadata —
    ``init_frames`` (the two keyframes used) and ``gated`` ((median,
    result) when the sanity gate rejected a converged solve).  PER-CALL
    state, not function attributes: SpeculativeCalib runs this function
    on a daemon thread per camera, so shared attributes let cam1's
    speculative solve cross-contaminate cam0's retry ladder (one camera
    could return another camera's gated calibration)."""
    if out is None:
        out = {}
    if warm is not None:
        final_model, warm_poses, warm_valid, init_frames = warm
        out["init_frames"] = init_frames
        one_focal = calib_params.one_focal or (
            calib_params.fixed_focal is not None
        )
        fixed_focal = calib_params.fixed_focal is not None
        # when the warm seed covers EVERY frame, the final solve drops
        # its in-graph PnP init, the largest part of the warm solve (see
        # _calib_camera_device skip_pose_init); a gate failure still falls
        # back to the cold ladder with full PnP semantics
        skip = bool(np.all(np.asarray(warm_valid) > 0))
        with stage("calib/ba"):
            result = calib_camera(
                board, batch, final_model,
                xy_same_focal=one_focal,
                disabled_distortions=calib_params.disabled_distortion_num,
                fixed_focal=fixed_focal,
                warm_poses=warm_poses, warm_valid=warm_valid,
                skip_pose_init=skip,
            )
        return _gate_result(board, batch, result, out)

    frame0, frame1 = find_best_two_frames(batch, random_pick_two_frames, rng)
    log.info("init frames: %d, %d", frame0, frame1)
    # recorded for the caller's Rerun keyframe markers
    # (/cam{i}/keyframe{j}, matching src/util.rs:898-908)
    out["init_frames"] = (frame0, frame1)

    initial_camera = None
    with stage("calib/init"):
        for i in range(MAX_INIT_ATTEMPTS):
            with cpu_scope():
                key, sub = jax.random.split(key)
            initial_camera = try_init_camera(
                board, batch, frame0, frame1, sub, calib_params.fixed_focal
            )
            if initial_camera is not None:
                break
            log.info("initialization attempt %d failed, retrying", i)
            if i >= 2:
                # Robustness improvement over the reference (which burns
                # all 10 attempts on the same pair, util.rs:855-863): a
                # deterministic failure mode — e.g. a focal-degenerate
                # near-pure-translation pair — cannot be fixed by a new
                # RANSAC key, so re-pick the frames after 3 failures.
                if rng is None:
                    rng = np.random.default_rng(
                        int(jax.random.randint(sub, (), 0, 2**31 - 1))
                    )
                frame0, frame1 = find_best_two_frames(batch, True, rng)
                log.info("re-picked init frames: %d, %d", frame0, frame1)
    if initial_camera is None or initial_camera.params[0] == 0.0:
        log.warning("calibration failed: could not initialize UCM")
        return None

    final_model = target_model.copy()
    final_model.set_w_h(round(initial_camera.width), round(initial_camera.height))
    with stage("calib/convert"):
        convert_model(initial_camera, final_model, calib_params.disabled_distortion_num)
    log.info("converted to %s: %s", final_model.name, final_model.params)

    if calib_params.fixed_focal is not None:
        p = final_model.params.copy()
        p[0] = p[1] = calib_params.fixed_focal
        final_model.set_params(p)
        one_focal, fixed_focal = True, True
    else:
        one_focal, fixed_focal = calib_params.one_focal, False

    with stage("calib/ba"):
        result = calib_camera(
            board,
            batch,
            final_model,
            xy_same_focal=one_focal,
            disabled_distortions=calib_params.disabled_distortion_num,
            fixed_focal=fixed_focal,
            polish_iters=polish_iters,
            pose_init_f32=pose_init_f32,
        )
    return _gate_result(board, batch, result, out)


def _gate_result(board, batch, result, out):
    """Sanity gate (improvement over the reference, which only retries on
    solver failure): a "converged" solution with huge reprojection error
    usually means the init was degenerate — report failure so the retry
    ladder picks new frames instead of shipping garbage.  The gated
    result is still attached so the caller can fall back to the best
    attempt when every retry fails (e.g. the requested model simply
    cannot fit the data — pinned distortion on a fisheye)."""
    if result is None:
        return None
    from .validate import reprojection_errors

    model, rtvecs = result
    with stage("calib/sanity-gate"):
        per_frame = reprojection_errors(board, batch, model, rtvecs)
    if per_frame:
        errs = np.concatenate([e for _, e, _ in per_frame])
        med = float(np.median(errs))
        if med > 2.0:
            log.warning("calibration sanity check failed (median %.2f px)", med)
            out["gated"] = (med, result)
            return None
    return result


def calibrate_camera_with_retries(
    board: Board,
    batch: FrameBatch,
    target_model: GenericModel,
    calib_params: CalibParams,
    key,
    seed: int = 0,
    warm_provider=None,
) -> Tuple[GenericModel, Dict[int, RvecTvec]]:
    """<=3 trials; retries pick random init frames
    (bin/camera_calibration.rs:217-242).

    ``warm_provider``: optional zero-arg callable returning a warm tuple
    (see init_and_calibrate_one_camera) or None — typically
    ``SpeculativeCalib.take``.  Only trial 0 uses it; if the warm-seeded
    solve fails the sanity gate, the retry ladder continues cold exactly
    as before.

    If every trial is rejected only by the reprojection sanity gate (the
    solve converged but the requested model cannot represent the data,
    e.g. pinned distortion on a fisheye), the best gated attempt is
    returned with a warning — matching the reference's behavior of
    emitting the result and letting report.txt carry the bad numbers.
    Raises only when no trial produced a solution at all."""
    rng = np.random.default_rng(seed)
    best_gated = None
    warm = warm_provider() if warm_provider is not None else None
    # observability: did a speculative warm seed exist, and did the
    # returned solution come from the warm-seeded trial?  bench.py
    # reports these as spec_used; a silent speculation-disable regression
    # then fails the bench assert instead of showing up only as fps
    calibrate_camera_with_retries.last_warm_offered = warm is not None
    calibrate_camera_with_retries.last_spec_used = False
    # the warm attempt is a BONUS trial: if it fails the gate, the full
    # cold ladder still runs exactly as without speculation
    trials = ([None] if warm is not None else []) + list(range(MAX_TRIALS))
    for trial in trials:
        if trial is None:
            sub = key  # warm path skips init: don't consume a split, so
            # the cold ladder draws EXACTLY as it would without
            # speculation (speculation may change timing, never results)
        else:
            with cpu_scope():
                key, sub = jax.random.split(key)
        attempt: dict = {}
        result = init_and_calibrate_one_camera(
            board, batch, target_model, calib_params, sub,
            random_pick_two_frames=trial is not None and trial > 0, rng=rng,
            warm=warm if trial is None else None, out=attempt,
        )
        if result is not None:
            if trial is None:
                calibrate_camera_with_retries.last_spec_used = True
            calibrate_camera_with_retries.last_init_frames = attempt.get(
                "init_frames"
            )
            return result
        gated = attempt.get("gated")
        if gated is not None and (best_gated is None or gated[0] < best_gated[0]):
            # remember the trial's init frames with the attempt: the
            # keyframe markers (cli.py log_keyframes) must describe the
            # attempt actually returned, not the last one tried
            best_gated = gated + (attempt.get("init_frames"),)
    if best_gated is not None:
        log.warning(
            "all %d trials failed the sanity gate; returning the best "
            "attempt (median %.2f px) — the chosen model/options likely "
            "cannot represent this camera",
            MAX_TRIALS, best_gated[0],
        )
        calibrate_camera_with_retries.last_init_frames = best_gated[2]
        return best_gated[1]
    raise RuntimeError(f"Failed to calibrate camera after {MAX_TRIALS} trials")


# per-RETURN metadata of the ladder (the keyframes of the attempt that
# was returned, consumed by cli.py's Rerun markers).  Safe as a function
# attribute: the ladder runs only on the caller's thread, serially per
# camera — unlike init_and_calibrate_one_camera, which speculation also
# runs on daemon threads (hence its per-call ``out`` dict).
calibrate_camera_with_retries.last_init_frames = None
calibrate_camera_with_retries.last_warm_offered = False
calibrate_camera_with_retries.last_spec_used = False


class SpeculativeCalib:
    """Overlap calibration with the detector's audit rounds.

    The wave-tracking detector produces PROVISIONAL per-frame detections
    before its cold audit sweeps run (``TagDetector.on_provisional``);
    the audits only correct a handful of frames, so a calibration solved
    on the provisional data lands within the final optimum's convergence
    basin.  This class runs init + convert + full BA on a background
    thread while the audits' sweeps proceed, then hands the
    result to ``calibrate_camera_with_retries(warm_provider=...)`` as a
    warm start: the FINAL solve still runs on the FINAL detections to
    full convergence (same solver, same gates), it just starts a few
    LM steps from the optimum instead of from scratch.

    The thread mostly waits on the device (GIL released), so it
    interleaves with the audits' host bookkeeping.

    Usage:
        spec = SpeculativeCalib(board, times, target_model, params, key, w, h)
        detector.on_provisional = spec.on_provisional
        dets = detector.detect_batch(...)
        batch = FrameBatch.from_detections(dets, ...)
        result = calibrate_camera_with_retries(
            board, batch, model, params, key, warm_provider=spec.take)
    """

    def __init__(
        self, board, times, target_model, calib_params, key, width, height
    ):
        self._args = (board, times, target_model, calib_params, key,
                      width, height)
        self._thread = None
        self._warm = None

    def on_provisional(self, results) -> None:
        """Detector hook: ``results`` is the provisional detection list
        (one {tag_id: corners} dict per frame).  Snapshot and solve on a
        daemon thread."""
        import threading

        if self._thread is not None:  # one speculation per batch
            return
        if len(results) != len(self._args[1]):
            # partial batch (e.g. a chunked/streaming detect call): the
            # provisional frame indices wouldn't map to the full batch
            return
        snapshot = [dict(r) for r in results]
        self._thread = threading.Thread(
            target=self._run, args=(snapshot,), daemon=True
        )
        self._thread.start()

    def _run(self, results) -> None:
        from ..utils.profiling import stage_prefix

        board, times, target_model, calib_params, key, w, h = self._args
        try:
            # derive the init key EXACTLY as the retry ladder's trial 0
            # does (calibrate_camera_with_retries splits once per cold
            # trial): the speculation must compute the same init the
            # cold path would — same RANSAC draws, same convergence
            # basin — just earlier.  A raw-key spec init was measured
            # landing in a DIFFERENT (and once wrong-but-under-the-gate)
            # basin on a 22-frame dataset.
            with cpu_scope():
                _, key = jax.random.split(key)
            F_all = len(results)
            # subsample to <= SPEC_MAX_FRAMES (see its docstring: shrinks
            # the device-contention window the audits queue behind, and
            # the final solve PnP-inits the skipped frames' poses anyway)
            stride = spec_stride(F_all)
            sub_idx = range(0, F_all, stride)
            with stage_prefix("spec/"):
                batch = FrameBatch.from_detections(
                    [results[i] for i in sub_idx],
                    [times[i] for i in sub_idx], board, w, h,
                )
                # truncated f64 polish: the speculative output is only a
                # SEED for the final solve, which re-polishes in full —
                # the polish is the f64 (expensive) stage, and 2
                # iterations keep the seed well inside the final solve's
                # convergence basin while roughly halving the spec solve
                attempt: dict = {}
                res = init_and_calibrate_one_camera(
                    board, batch, target_model, calib_params, key,
                    polish_iters=2, pose_init_f32=True, out=attempt,
                )
            if res is None:
                return
            model, rtvecs = res
            poses = np.zeros((F_all, 6), np.float64)
            valid = np.zeros((F_all,), np.float64)
            for i, rt in rtvecs.items():
                poses[i * stride, :3] = rt.rvec
                poses[i * stride, 3:] = rt.tvec
                valid[i * stride] = 1.0
            # fill the unsolved frames (subsample-skipped AND spec-solve
            # failures) by rvec-continuity-safe lerp between the solved
            # neighbors (fill_poses_lerp).  A FULL-coverage warm seed
            # lets the final solve skip its in-graph PnP init, which is
            # 0.48 s of the 0.60 s warm-solve floor at 534 frames
            # (calib_camera skip_pose_init); the lerp seed costs a few
            # extra f32 LM iterations, a fraction of that.
            #
            # ONLY short gaps may be filled: the lerp is trustworthy
            # across a subsample stride of smooth video, but when the
            # provisional detections left long runs of unsolved frames
            # (e.g. fast motion defeating the tracker mid-segment — the
            # audits repair those frames AFTER this solve), linear
            # interpolation across many frames of handheld motion
            # produces garbage seeds, and with the PnP skipped the final
            # LM converged to a WRONG basin under the 2 px sanity gate
            # (measured: 22-frame CLI dataset, fx 196.6 vs 191.1, alpha
            # 0.14 vs 0.62, median 0.38 px).  Long-gap frames keep
            # valid=0 — the final solve PnP-inits them exactly as the
            # cold path would.
            idx = np.flatnonzero(valid)
            max_gap = 3 * stride
            gaps_ok = (
                len(idx) >= 2
                and idx[0] <= max_gap
                and (F_all - 1 - idx[-1]) <= max_gap
                and int(np.diff(idx).max()) <= max_gap
            )
            if gaps_ok and fill_poses_lerp(poses, valid):
                valid[:] = 1.0
            init_frames = attempt.get("init_frames")
            if init_frames is not None:
                # map the sub-batch keyframe indices back to full-batch
                # frame numbers (the Rerun keyframe markers use these)
                init_frames = tuple(f * stride for f in init_frames)
            self._warm = (model, poses, valid, init_frames)
        except Exception:  # pragma: no cover - speculation must not fail
            log.exception("speculative calibration failed; running cold")

    def take(self):
        """Join the speculation thread and return the warm tuple (or
        None when the speculation never started or failed)."""
        if self._thread is not None:
            self._thread.join()
        return self._warm
