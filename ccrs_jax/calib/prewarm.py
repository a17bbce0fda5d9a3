"""Warmup helper: compile every calibration device graph up front.

Each jit graph pays its compile (or a persistent-cache load) the first
time it runs.  The calibration
side of the pipeline owns two big graphs — the fused init attempt
(`initialize._try_init_device`, which internally warms the 2-frame UCM BA)
and the full-batch single-camera BA (`single._calib_camera_device`) — and
their shapes are known the moment the dataset size and target model are:
``(F, N)`` residual tensors with ``F = n_frames`` and ``N = board
corners``.  Running both on dummy data from a background thread while the
host decodes/renders images overlaps those compiles with useful work, the
same trick as ``TagDetector.prewarm`` (the thread mostly waits in the
compiler, releasing the GIL).

Reference anchor: the reference has no equivalent (its CPU solver needs no
warmup); this exists purely for the accelerator deployment model.
"""

from __future__ import annotations

import numpy as np

from ..board import Board
from ..models import GenericModel
from ..types import CalibParams


def prewarm_calibration(
    board: Board,
    n_frames: int,
    target_model: GenericModel | str,
    calib_params: CalibParams | None = None,
    width: int = 512,
    height: int = 512,
    speculative: bool = False,
    n_frames_spec: int | None = None,
) -> None:
    """Execute the init + BA device graphs on dummy data of the real shapes.

    Safe to skip or run concurrently with detection — the first real solve
    simply pays the loads itself if this hasn't finished.  Dummy data makes
    the solvers converge to garbage quickly (stall exits); only the graph
    load matters.

    ``speculative``: also warm the SpeculativeCalib-only executables (the
    subsampled f32-PnP seed solve and the skip_pose_init warm-path final
    solve) — each is a compile of its own, so callers that never
    speculate skip them.  ``n_frames_spec``: the frame
    count the SPECULATION sees (the CLI speculates on the full detected
    sequence but truncates the final batch to --max-images, so the two
    shapes can differ); defaults to ``n_frames``.
    """
    import jax
    import jax.numpy as jnp

    from ..models import zeros_like_model
    from ..models.projections import project_fn, unproject_fn
    from .initialize import _try_init_device
    from .single import (
        _calib_camera_device,
        build_bounds,
        disabled_free_mask,
    )
    from ..solve.lm import reduce_params

    if calib_params is None:
        calib_params = CalibParams()
    if isinstance(target_model, str):
        target_model = zeros_like_model(target_model)
    model = target_model.copy()
    model.set_w_h(width, height)

    N = board.n_corners
    p3d = np.asarray(board.p3d, dtype=np.float64)
    rng = np.random.default_rng(0)

    # --- fused init graph (also loads the 2-frame UCM BA inside it) ------
    q = rng.uniform(-0.9, 0.9, (2, N, 2))
    p2d2 = rng.uniform(0, width, (2, N, 2))
    masks2 = np.ones((2, N), bool)
    from ..utils.host import cpu_scope

    with cpu_scope():
        key0 = jax.random.PRNGKey(0)
    # numpy operands: the jit transfers them without eager one-op graphs
    params, ok = _try_init_device(
        key0,
        q[0],
        q[1],
        masks2[0],
        p3d,
        p2d2,
        masks2,
        np.float64(max(width, height) / 2.0),
        np.asarray([width, height], np.float64),
        fixed_focal=calib_params.fixed_focal,
    )
    ok.block_until_ready()

    # --- full-batch single-camera BA graph --------------------------------
    one_focal = (
        calib_params.one_focal or calib_params.fixed_focal is not None
    )
    # plausible params so projections stay finite on the dummy data
    cam = model.copy()
    p = cam.params.copy()
    if p[0] == 0.0:
        p[0] = p[1] = 0.4 * max(width, height)
        p[2], p[3] = width / 2.0, height / 2.0
        if cam.name in ("ucm", "eucm", "eucmt"):
            p[4] = 0.6
        if cam.name in ("eucm", "eucmt"):
            p[5] = 1.0
        cam.set_params(p)
    from ..utils.host import cpu_scope as _cs

    with _cs():
        theta0 = np.asarray(reduce_params(jnp.asarray(cam.params), one_focal))
    lo, hi = build_bounds(cam, one_focal)
    free = disabled_free_mask(
        cam, one_focal, calib_params.disabled_distortion_num
    )
    theta0 = np.where(free == 0.0, 0.0, theta0)
    lo = np.where(free == 0.0, -np.inf, lo)
    hi = np.where(free == 0.0, np.inf, hi)
    # polish 12 = the final solve at full F; polish 2 = the speculative
    # seed solve, which SUBSAMPLES its batch to <= SPEC_MAX_FRAMES
    # (calib/pipeline.SpeculativeCalib) — distinct executables, distinct
    # (F, N) shapes
    from .pipeline import spec_stride

    n_spec = n_frames if n_frames_spec is None else n_frames_spec
    F_spec = len(range(0, n_spec, spec_stride(n_spec)))
    # (F, polish, skip_pose_init, f32-PnP) rows: the cold full-PnP final
    # solve always warms; the no-PnP warm-path final and the subsampled
    # f32-PnP seed solve only exist when the caller speculates
    variants = [(n_frames, 12, False, False)]
    if speculative:
        variants += [
            (n_frames, 12, True, False),
            (F_spec, 2, False, True),
        ]
    for F, pi, skip, p32 in variants:
        p2d = rng.uniform(0, width, (F, N, 2))
        mask = np.ones((F, N), bool)
        res, fv = _calib_camera_device(
            unproject_fn(cam.name),
            project_fn(cam.name),
            theta0,
            np.asarray(cam.params, np.float64),
            p2d,
            mask,
            p3d,
            lo,
            hi,
            np.asarray(free, np.float64),
            np.zeros((F, 6), np.float64),
            np.ones((F,), np.float64) if skip else np.zeros((F,), np.float64),
            one_focal=one_focal,
            polish_iters=pi,
            skip_pose_init=skip,
            pose_init_f32=p32,
        )
        res.cost.block_until_ready()
