"""ccrs-compatible command-line interface.

Mirrors the reference CLI surface and pipeline
(``src/bin/camera_calibration.rs:25-344``): same positional dataset path,
same flags and defaults, same output artifact set
(``default_board_config.json``, ``results/<timestamp>/{logging.rrd,
cam{i}.json, cam{i}_poses.json, extrinsics.json, report.txt}``).

Run as ``python -m ccrs_jax <dataset> --model eucm ...`` (or the ``ccrs``
console script when installed).
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from datetime import datetime
from typing import Dict, List

import numpy as np

from .board import Board, BoardConfig
from .calib import validation
from .calib.frames import FrameBatch
from .calib.multi import calib_all_camera_with_extrinsics, init_camera_extrinsic
from .calib.pipeline import calibrate_camera_with_retries
from .dataloader import load_euroc, load_general
from .detect import FAMILY_NAMES, TagDetector
from .utils.backend import PLATFORMS, select_platform
from .utils.host import cpu_scope
from .io import object_from_json, object_to_json, write_report
from .models import MODEL_NAMES, model_to_json, zeros_like_model
from .types import CalibParams, Extrinsics, RvecTvec
from .visualization import Recorder

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ccrs",
        description="camera intrinsic calibration from AprilGrid images",
    )
    p.add_argument("path", help="path to image folder")
    # t25h7 is accepted for reference-CLI parity but requires a
    # user-supplied code table (families.family_from_table docstring)
    p.add_argument(
        "--tag-family", default="t36h11", choices=FAMILY_NAMES + ["t25h7"]
    )
    p.add_argument(
        "--tag-family-table",
        default=None,
        metavar="NPZ",
        help="custom code table for the tag family (required for t25h7, "
        "whose canonical table cannot be regenerated offline; keys: codes "
        "[+ size/border/max_hamming])",
    )
    p.add_argument("-m", "--model", default="eucm", choices=list(MODEL_NAMES))
    p.add_argument("--start-idx", type=int, default=0)
    p.add_argument("--step", type=int, default=1)
    p.add_argument("--max-images", type=int, default=600)
    p.add_argument("--cam-num", type=int, default=1)
    p.add_argument("--board-config", default=None)
    p.add_argument("-o", "--output-folder", default=None)
    p.add_argument("--dataset-format", default="euroc", choices=["euroc", "general"])
    p.add_argument("--one-focal", action="store_true")
    p.add_argument("--disabled-distortion-num", type=int, default=0)
    p.add_argument("--fixed-focal", type=float, default=None)
    p.add_argument("--seed", type=int, default=0, help="PRNG seed (RANSAC/retries)")
    p.add_argument("--no-rerun", action="store_true", help="skip .rrd logging")
    p.add_argument(
        "--export-camchain",
        action="store_true",
        help="also write a Kalibr camchain.yaml (eucm/ucm/kb4/opencv5)",
    )
    p.add_argument(
        "--detection-cache",
        default=None,
        metavar="DIR",
        help="cache detections under DIR (keyed by file list/mtimes) so "
        "re-runs skip re-detection",
    )
    p.add_argument(
        "--platform",
        default="auto",
        choices=list(PLATFORMS),
        help="JAX backend to run on (auto = JAX's default: the GPU when "
        "one is present); a named platform that JAX cannot run on is an error",
    )
    p.add_argument(
        "--no-speculate",
        action="store_true",
        help="disable speculative calibration (the solve that overlaps "
        "detection audits; results are identical either way, speculation "
        "only changes timing — CCRS_SPECULATE=0 is equivalent)",
    )
    return p


def setup_board(args) -> Board:
    if args.board_config:
        return Board.from_config(BoardConfig.from_json(object_from_json(args.board_config)))
    config = BoardConfig()
    object_to_json("default_board_config.json", config.to_json())
    return Board.from_config(config)


def setup_output_folder(args) -> str:
    folder = args.output_folder or datetime.now().strftime("results/%Y%m%d_%H_%M_%S")
    os.makedirs(folder, exist_ok=True)
    return folder


def _cam_calib_params(args, cam_idx: int) -> CalibParams:
    """Per-camera CalibParams; --fixed-focal applies to cam0 only
    (``src/bin/camera_calibration.rs:218``)."""
    return CalibParams(
        fixed_focal=args.fixed_focal if cam_idx == 0 else None,
        disabled_distortion_num=args.disabled_distortion_num,
        one_focal=args.one_focal,
    )


def load_feature_data(
    args, detector, board, recorder, specs=None, cam_keys=None
) -> List[FrameBatch]:
    """Detect features for every camera.

    ``specs``/``cam_keys``: optional dict + per-camera PRNG keys enabling
    SPECULATIVE calibration — a SpeculativeCalib per camera is registered
    on the detector so the init+BA solve overlaps the detection audit
    sweeps, and the warm result is stored in ``specs[cam_idx]`` for
    ``calibrate_all_cameras`` to consume (the benched architecture; the
    final solve still runs on the final detections to full convergence).
    """
    print("Start loading images and detecting charts.")
    t0 = time.perf_counter()
    loader = load_euroc if args.dataset_format == "euroc" else load_general

    def prewarm_cb(width, height, n_frames):
        # overlap detector + calibration graph compiles with image
        # decoding (each graph compiles on first use).  CCRS_PREWARM=0
        # opts out — in a process whose graphs are ALREADY compiled (e.g.
        # bench.py's repeated in-process cli runs) the prewarm's dummy
        # executions only contend with the first chunk's detection.
        if os.environ.get("CCRS_PREWARM", "1") == "0":
            return
        from .calib.prewarm import prewarm_calibration

        try:
            from .dataloader import DETECT_BATCH

            # the loader streams DETECT_BATCH-frame upload chunks, but
            # the TrackedSession runs ONE whole-batch detection at
            # finalize whose wave-row/wave-count graph shapes key on the
            # PADDED sequence length (tail padded to a DETECT_BATCH
            # multiple on multi-chunk datasets) — warm THAT layout, not
            # the chunk's, or the first detection pays the compiles the
            # prewarm exists to hide
            if n_frames > DETECT_BATCH:
                n_detect = -(-n_frames // DETECT_BATCH) * DETECT_BATCH
            else:
                n_detect = n_frames
            detector.prewarm(height, width, board, n_frames=n_detect)
            prewarm_calibration(
                board,
                min(n_frames, args.max_images),
                args.model,
                _cam_calib_params(args, 0),
                width,
                height,
                speculative=specs is not None,
                n_frames_spec=n_frames,
            )
        except Exception:  # pragma: no cover - warmup must never kill a run
            log.exception("prewarm failed (continuing; first solve pays loads)")

    spec_factory = None
    if specs is not None:
        from .calib.pipeline import SpeculativeCalib

        def spec_factory(cam_idx, times, width, height):
            spec = SpeculativeCalib(
                board, times, zeros_like_model(args.model),
                _cam_calib_params(args, cam_idx), cam_keys[cam_idx],
                width, height,
            )
            specs[cam_idx] = spec
            return spec.on_provisional

    batches = loader(
        args.path, detector, board, args.start_idx, args.step, args.cam_num,
        recorder, cache_dir=args.detection_cache, prewarm_cb=prewarm_cb,
        spec_factory=spec_factory,
    )
    dt = time.perf_counter() - t0
    print(f"detecting feature took {dt:.6f} sec")
    if batches and batches[0].n_frames:
        print(f"total: {batches[0].n_frames} images")
        print(f"avg: {dt / batches[0].n_frames} sec")
    for cam_idx, b in enumerate(batches):
        if b.n_frames == 0:
            raise SystemExit(
                f"no images found for cam{cam_idx} under {args.path!r} "
                f"(dataset format: {args.dataset_format})"
            )
        if not b.frame_ok().any():
            raise SystemExit(
                f"no frame of cam{cam_idx} has >= 24 detected corners; "
                "check --tag-family and --board-config"
            )
    return [b.truncate(args.max_images) for b in batches]


def _warm_adapter(spec, batch):
    """Wrap SpeculativeCalib.take for a batch that may have been
    TRUNCATED after detection (--max-images, matching the reference's
    truncate-after-detect, ``src/bin/camera_calibration.rs:190-191``):
    clip the warm pose rows to the batch length."""
    if spec is None:
        return None

    def provider():
        warm = spec.take()
        if warm is None:
            return None
        model, poses, valid, init_frames = warm
        F = batch.n_frames
        if len(poses) < F:  # pragma: no cover - defensive
            return None
        return (model, poses[:F], valid[:F], init_frames)

    return provider


def calibrate_all_cameras(args, board, batches, recorder, cam_keys, specs=None):
    intrinsics, cam_rtvecs = [], []
    for cam_idx, batch in enumerate(batches):
        calib_params = _cam_calib_params(args, cam_idx)
        warm_provider = _warm_adapter(
            (specs or {}).get(cam_idx), batch
        )
        try:
            result = calibrate_camera_with_retries(
                board, batch, zeros_like_model(args.model), calib_params,
                cam_keys[cam_idx], seed=args.seed + cam_idx,
                warm_provider=warm_provider,
            )
        except RuntimeError as e:
            raise SystemExit(f"cam{cam_idx}: {e}")
        model, rtvecs = result
        init_frames = calibrate_camera_with_retries.last_init_frames
        if init_frames is not None:
            # /cam{i}/keyframe{j} markers for the two init frames
            # (src/util.rs:898-908); a warm-start's init frames can sit
            # past a --max-images truncation — skip those markers
            recorder.log_keyframes(
                cam_idx,
                [
                    int(batch.time_ns[f])
                    for f in init_frames
                    if 0 <= f < batch.n_frames
                ],
            )
        intrinsics.append(model)
        cam_rtvecs.append(rtvecs)
    return intrinsics, cam_rtvecs


def save_and_validate_results(
    args, output_folder, board, batches, intrinsics, cam_rtvecs, t_cam_i_0, recorder
):
    joint = calib_all_camera_with_extrinsics(
        board,
        intrinsics,
        t_cam_i_0,
        cam_rtvecs,
        batches,
        xy_same_focal=args.one_focal or args.fixed_focal is not None,
        disabled_distortions=args.disabled_distortion_num,
        cam0_fixed_focal=args.fixed_focal is not None,
    )
    rep_rms = []
    if joint is not None:
        cam_models, t_i_0, board_rtvecs = joint
        for cam_idx, model in enumerate(cam_models):
            model_to_json(f"{output_folder}/cam{cam_idx}.json", model)
            new_rtvecs: Dict[int, RvecTvec] = {
                f: t_i_0[cam_idx].compose(t_0_b) for f, t_0_b in board_rtvecs.items()
            }
            object_to_json(
                f"{output_folder}/cam{cam_idx}_poses.json",
                {str(f): rt.to_json() for f, rt in sorted(new_rtvecs.items())},
            )
            recorder.log_camera_transform(
                cam_idx, np.linalg.inv(t_i_0[cam_idx].to_matrix())
            )
            rep = validation(
                board, batches[cam_idx], model, new_rtvecs, recorder, cam_idx
            )
            rep_rms.append(rep)
            print(f"Cam {cam_idx} final params with extrinsic")
        write_report(f"{output_folder}/report.txt", True, rep_rms)
        object_to_json(f"{output_folder}/extrinsics.json", Extrinsics(t_i_0))
        if args.export_camchain:
            from .export import write_camchain

            try:
                write_camchain(f"{output_folder}/camchain.yaml", cam_models, t_i_0)
                print(f"wrote {output_folder}/camchain.yaml")
            except ValueError as e:
                print(f"camchain export skipped: {e}")
        return cam_models, t_i_0
    # joint solve failed: fall back to per-camera results
    for cam_idx, (model, rtvecs) in enumerate(zip(intrinsics, cam_rtvecs)):
        rep = validation(board, batches[cam_idx], model, rtvecs, recorder, cam_idx)
        rep_rms.append(rep)
        model_to_json(f"{output_folder}/cam{cam_idx}.json", model)
        object_to_json(
            f"{output_folder}/cam{cam_idx}_poses.json",
            {str(f): rt.to_json() for f, rt in sorted(rtvecs.items())},
        )
    write_report(f"{output_folder}/report.txt", False, rep_rms)
    if args.export_camchain:
        from .export import write_camchain

        try:
            write_camchain(f"{output_folder}/camchain.yaml", intrinsics)
            print(f"wrote {output_folder}/camchain.yaml")
        except ValueError as e:
            print(f"camchain export skipped: {e}")
    return intrinsics, None


def main(argv=None):
    logging.basicConfig(
        level=os.environ.get("CCRS_LOG", "WARNING").upper(),
        format="%(levelname)s %(name)s: %(message)s",
    )
    args = build_parser().parse_args(argv)
    import jax

    select_platform(args.platform)

    if args.tag_family_table:
        from .detect.families import family_from_table

        family = family_from_table(args.tag_family, args.tag_family_table)
    else:
        family = args.tag_family  # get_family raises helpfully for t25h7
    detector = TagDetector(family)
    board = setup_board(args)
    output_folder = setup_output_folder(args)
    recorder = Recorder(
        None if args.no_rerun else f"{output_folder}/logging.rrd"
    )

    import contextlib

    from .utils.profiling import with_profiler

    profile_dir = os.environ.get("CCRS_PROFILE_DIR")
    ctx = with_profiler(profile_dir) if profile_dir else contextlib.nullcontext()
    with ctx:
        # per-camera keys are derived UP FRONT so the speculative solve
        # (registered before detection) and the final solve share a key,
        # exactly as the bench composition does (bench.py pipeline())
        with cpu_scope():
            key = jax.random.PRNGKey(args.seed)
            key, sub = jax.random.split(key)
            cam_keys = list(jax.random.split(sub, max(args.cam_num, 1)))
        # speculative calibration overlaps the final detection audits
        # (the benched architecture, now the product path);
        # CCRS_SPECULATE=0 opts out
        speculate = (
            not args.no_speculate
            and os.environ.get("CCRS_SPECULATE", "1") != "0"
        )
        specs = {} if speculate else None
        batches = load_feature_data(
            args, detector, board, recorder, specs=specs, cam_keys=cam_keys
        )
        intrinsics, cam_rtvecs = calibrate_all_cameras(
            args, board, batches, recorder, cam_keys, specs=specs
        )
        t_cam_i_0 = init_camera_extrinsic(cam_rtvecs)
        for t in t_cam_i_0:
            print(f"r {t.rvec} t {t.tvec}")
        save_and_validate_results(
            args, output_folder, board, batches, intrinsics, cam_rtvecs,
            t_cam_i_0, recorder,
        )
    print(f"results written to {output_folder}")


if __name__ == "__main__":
    main()
