"""Synthetic AprilGrid dataset renderer.

Renders photorealistic-enough calibration images by inverse-mapping every
output pixel through a camera model onto the board plane (supersampled for
anti-aliasing), entirely in JAX.  Used by the test-suite and ``bench.py``
(the environment has no network access, so the TUM-VI acceptance dataset of
the reference CI — .github/workflows/rust.yml — is replaced by synthetic
sequences with exact ground truth), and by ``python -m ccrs_jax.testdata``
to materialize a EuRoC-layout dataset on disk for CLI runs.

Ground truth: the rendered corner positions are exactly
``project(params, T_cam_board . p3d_corner)``.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .board import Board, BoardConfig
from .detect.families import TagFamily, get_family
from .models import GenericModel
from .models.projections import project_fn, unproject_fn
from .solve import se3
from .utils.backend import PLATFORMS, select_platform
from .utils.host import cpu_scope, on_cpu


def board_pattern_image(
    board: Board, family: TagFamily, corner_squares: bool = True
):
    """Rasterize the board layout into a cell-resolution lookup table.

    Returns (tex, origin, scale): tex is a (Hc, Wc) float array of cell
    intensities (1 white, 0 black) covering the board's bounding box with
    ``total_size`` cells per tag edge; world (x, y) maps to texel
    ``(x - ox) * scale``, ``(oy - y) * scale``.
    """
    from fractions import Fraction

    cfg = board.config
    T = family.total_size
    s = cfg.tag_size_meter
    pitch = s * (1.0 + cfg.tag_spacing)
    # Sub-cell rasterization factor: the tag pitch is T*(1+spacing) cells
    # and the corner squares are spacing*T cells — both must land on the
    # texel grid EXACTLY or tags render up to half a cell (~px) off their
    # ground-truth positions (t36h11's T=10 happened to make 0.3*10
    # integral, which masked this for the default family).
    frac = Fraction(cfg.tag_spacing * T).limit_denominator(64)
    sub = min(frac.denominator, 20)
    cell = s / (T * sub)  # fine texel size (meters)
    Tf = T * sub  # tag side in texels
    # texture covers [ -pitch*0.5, cols*pitch + 0.5*pitch ] etc. with margin
    margin_cells = int(np.ceil((pitch - s) / cell)) + Tf
    Wc = int(np.ceil((cfg.tag_cols - 1) * pitch / cell)) + Tf + 2 * margin_cells
    Hc = int(np.ceil((cfg.tag_rows - 1) * pitch / cell)) + Tf + 2 * margin_cells
    tex = np.ones((Hc, Wc), np.float32)
    ox = -margin_cells * cell
    oy = margin_cells * cell  # world y of texture row 0 (y decreases with row)
    for r in range(cfg.tag_rows):
        for c in range(cfg.tag_cols):
            tag_id = cfg.first_id + r * cfg.tag_cols + c
            if tag_id >= family.n_codes:
                continue
            bits = family.codes[tag_id].reshape(family.size, family.size)
            x0 = c * pitch
            y0 = -r * pitch
            ci0 = int(round((ox * -1 + x0) / cell))
            ri0 = int(round((oy - y0) / cell))
            for i in range(T):
                for j in range(T):
                    inner = (
                        family.border <= i < T - family.border
                        and family.border <= j < T - family.border
                    )
                    if inner:
                        # The print faces the board's -z side (front view
                        # R = rot_z(pi), see front_view_base); painting the
                        # canonical pattern on that face means its (x, y)
                        # layout in board coordinates is x-mirrored.
                        jj = (family.size - 1) - (j - family.border)
                        v = float(bits[i - family.border, jj])
                    else:
                        v = 0.0
                    tex[
                        ri0 + i * sub : ri0 + (i + 1) * sub,
                        ci0 + j * sub : ci0 + (j + 1) * sub,
                    ] = v
    # Kalibr-style corner squares: black squares of side tag_spacing * s in
    # every inter-tag gap intersection (they diagonally touch tag corners —
    # real EuRoC/TUM-VI boards have these, and they turn each tag corner
    # into a checkerboard saddle point).
    gap_cells = int(round(cfg.tag_spacing * T * sub))
    if corner_squares and gap_cells > 0:
        for r in range(cfg.tag_rows + 1):
            for c in range(cfg.tag_cols + 1):
                # square spans [c*pitch - gap, c*pitch] x [-r*pitch, -r*pitch + gap]
                x_left = c * pitch - cfg.tag_spacing * s
                y_top = -r * pitch + cfg.tag_spacing * s
                ci0 = int(round((x_left - ox) / cell))
                ri0 = int(round((oy - y_top) / cell))
                tex[ri0 : ri0 + gap_cells, ci0 : ci0 + gap_cells] = 0.0
    # plain numpy: callers feed it to jits (which transfer it once); a jnp
    # return would make every downstream .astype an eager one-op device
    # graph (a compile each)
    return tex, (ox, oy), 1.0 / cell


@partial(jax.jit, static_argnames=("proj_name", "width", "height", "ss"))
def _render(
    proj_name, params, rvec, tvec, tex, ox, oy, scale,
    width: int, height: int, ss: int = 3,
    white: float = 220.0, black: float = 35.0, bg: float = 128.0,
):
    unproj = unproject_fn(proj_name)
    # supersampled pixel grid (keep the offsets in the render dtype — under
    # x64 a bare arange would silently upcast the whole render to f64)
    off = ((jnp.arange(ss) + 0.5) / ss - 0.5).astype(params.dtype)
    uu, vv = jnp.meshgrid(
        jnp.arange(width, dtype=params.dtype), jnp.arange(height, dtype=params.dtype)
    )
    R = se3.exp_so3(rvec)
    Rinv = R.T
    t_board = -(Rinv @ tvec)

    def sample(du, dv):
        pix = jnp.stack([uu + du, vv + dv], axis=-1).reshape(-1, 2)
        ray, valid = unproj(params, pix)
        # board frame: X = s * Rinv d + t_board with X_z = 0
        d = ray @ Rinv.T
        denom = jnp.where(jnp.abs(d[:, 2]) > 1e-12, d[:, 2], 1e-12)
        sscale = -t_board[2] / denom
        X = sscale[:, None] * d + t_board
        infront = (sscale > 0) & valid
        tx = (X[:, 0] - ox) * scale
        ty = (oy - X[:, 1]) * scale
        Hc, Wc = tex.shape
        inside = (tx >= 0) & (tx < Wc) & (ty >= 0) & (ty < Hc) & infront
        txi = jnp.clip(tx.astype(jnp.int32), 0, Wc - 1)
        tyi = jnp.clip(ty.astype(jnp.int32), 0, Hc - 1)
        cellv = tex[tyi, txi]
        val = jnp.where(inside, black + (white - black) * cellv, bg)
        return val

    acc = jnp.zeros(width * height, dtype=params.dtype)
    for du in off:
        for dv in off:
            acc = acc + sample(du, dv)
    img = acc / (ss * ss)
    return img.reshape(height, width)


def render_board_image(
    model: GenericModel,
    board: Board,
    family: TagFamily,
    rvec,
    tvec,
    ss: int = 3,
    noise: float = 0.0,
    seed: int = 0,
    blur_sigma: float = 0.7,
    corner_squares: bool = True,
):
    """Render one frame; returns (H, W) uint8.

    ``blur_sigma`` models the camera PSF (real calibration footage is never
    pixel-sharp; a slight blur also makes bilinear bit sampling behave like
    it does on real images).  ``corner_squares`` draws the Kalibr-style
    black squares in the tag gaps (real EuRoC/TUM-VI t36h11 boards have
    them; classic 1-cell-border prints like t36h11b1 don't)."""
    tex, (ox, oy), scale = board_pattern_image(board, family, corner_squares)
    img = _render(
        model.name,
        jnp.asarray(model.params),
        jnp.asarray(rvec, dtype=jnp.float64),
        jnp.asarray(tvec, dtype=jnp.float64),
        tex.astype(np.float64),
        ox,
        oy,
        scale,
        int(model.width),
        int(model.height),
        ss,
    )
    img = np.asarray(img)
    if blur_sigma > 0:
        from scipy.ndimage import gaussian_filter

        img = gaussian_filter(img, blur_sigma)
    if noise > 0:
        rng = np.random.default_rng(seed)
        img = img + rng.normal(size=img.shape) * noise
    return np.clip(img, 0, 255).astype(np.uint8)


@partial(jax.jit, static_argnames=("proj_name", "width", "height", "ss"))
def _render_seq(
    proj_name, params, poses, tex, ox, oy, scale,
    width: int, height: int, ss: int, kern, noise, key,
):
    def one(pose):
        return _render(
            proj_name, params, pose[:3], pose[3:], tex, ox, oy, scale,
            width, height, ss,
        )

    imgs = jax.lax.map(one, poses)  # sequential: bounds compile-time memory

    # separable Gaussian PSF (matches render_board_image's host blur)
    r = kern.shape[0] // 2
    p = jnp.pad(imgs, ((0, 0), (r, r), (0, 0)), mode="symmetric")
    imgs = sum(kern[i] * p[:, i : i + height, :] for i in range(kern.shape[0]))
    p = jnp.pad(imgs, ((0, 0), (0, 0), (r, r)), mode="symmetric")
    imgs = sum(kern[i] * p[:, :, i : i + width] for i in range(kern.shape[0]))

    imgs = imgs + jax.random.normal(key, imgs.shape, imgs.dtype) * noise
    # quantize to integer gray levels like a real 8-bit sensor; uint8
    # OUTPUT so device-rendered batches hit the same detect graphs as
    # real uploaded datasets (a f32 batch compiled a second full family
    # of threshold/refine/wave graphs, which prewarm did not cover)
    return jnp.round(jnp.clip(imgs, 0, 255)).astype(jnp.uint8)


def render_frames_device(
    model: GenericModel,
    board: Board,
    family: TagFamily,
    poses,
    ss: int = 3,
    noise: float = 2.0,
    seed: int = 0,
    blur_sigma: float = 0.7,
):
    """Render a whole pose sequence ON DEVICE; returns (F, H, W) uint8
    with no host round-trip — feed it to
    ``TagDetector.detect_batch(None, board, dev_images=...)`` so the only
    host traffic of the detect stage is thresholded bits + decode outputs.

    Rendering runs in f32 (the output is 8-bit-quantized anyway); ground
    truth still comes from ``gt_corners`` in f64.
    """
    tex, (ox, oy), scale = board_pattern_image(board, family)
    radius = max(1, int(4.0 * blur_sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / blur_sigma) ** 2)
    # all operands prepared in numpy and the PRNG key on the local CPU:
    # eager jnp casts here would each compile a one-op device graph
    # (utils/host.py)
    kern = (k / k.sum()).astype(np.float32)
    f32 = np.float32
    with cpu_scope():
        key = jax.random.PRNGKey(seed)
    return _render_seq(
        model.name,
        np.asarray(model.params, f32),
        np.asarray(poses, f32),
        tex.astype(f32),
        f32(ox), f32(oy), f32(scale),
        int(model.width), int(model.height), ss,
        kern, f32(noise), key,
    )


@on_cpu
def gt_corners(model: GenericModel, board: Board, rvec, tvec):
    """Exact projected corner positions + visibility mask."""
    R = np.asarray(se3.exp_so3(jnp.asarray(rvec, dtype=jnp.float64)))
    pc = board.p3d @ R.T + np.asarray(tvec)
    p2d, valid = project_fn(model.name)(
        jnp.asarray(model.params), jnp.asarray(pc, dtype=jnp.float64)
    )
    p2d = np.asarray(p2d)
    valid = np.asarray(valid) & (pc[:, 2] > 0)
    inside = (
        (p2d[:, 0] >= 0)
        & (p2d[:, 0] < model.width)
        & (p2d[:, 1] >= 0)
        & (p2d[:, 1] < model.height)
    )
    return p2d, valid & inside


def front_view_base():
    """Base board->camera rotation for a camera FACING the printed side.

    Measured on the reference's real EuRoC/TUM-VI frames: viewed from the
    front, board +x points LEFT and +y points UP (tag ids increase
    leftward, rows downward, patterns upright), i.e. the print is on the
    board's -z face and the front view is R0 = rot_z(pi) = diag(-1,-1,1).
    Any other base renders a mirrored board that no detector can decode.
    """
    return np.array([0.0, 0.0, np.pi])


@on_cpu
def smooth_sequence_poses(
    n_frames: int,
    board: Board,
    seed: int = 0,
    keyframe_every: int = 16,
    span_scale=1.0,
):
    """Continuous handheld-VIDEO pose trajectory (front side in view).

    ``default_sequence_poses`` draws every frame independently — useful for
    pose diversity, but unlike any real calibration recording.  The
    reference's acceptance data (TUM-VI ``dataset-calib-cam1``,
    /root/reference/.github/workflows/rust.yml "Test on dataset") is smooth
    ~20 fps handheld video, which is what the detector's tracking fast
    path exploits; this generator models that regime: diverse keyposes
    every ``keyframe_every`` frames, interpolated with quaternion slerp
    (rotation) and cubic-smoothstep blending (translation), yielding a few
    px/frame of corner motion like the real footage.
    """
    n_keys = max(2, -(-n_frames // keyframe_every) + 1)
    keys = default_sequence_poses(n_keys, board, seed, span_scale)
    try:
        from scipy.spatial.transform import Rotation, Slerp

        rots = Rotation.from_rotvec(keys[:, :3])
        slerp = Slerp(np.arange(n_keys, dtype=np.float64), rots)
    except ImportError:  # pragma: no cover - scipy is in the env
        slerp = None
    poses = []
    for f in range(n_frames):
        u = f / keyframe_every
        k = min(int(u), n_keys - 2)
        t = u - k
        t = t * t * (3.0 - 2.0 * t)  # smoothstep: C1 at keyframes
        tv = (1 - t) * keys[k, 3:] + t * keys[k + 1, 3:]
        if slerp is not None:
            rv = slerp(k + t).as_rotvec()
        else:  # nearest-key fallback
            rv = keys[k if t < 0.5 else k + 1, :3]
        poses.append(np.concatenate([rv, tv]))
    return np.stack(poses)


@on_cpu
def default_sequence_poses(n_frames: int, board: Board, seed: int = 0, span_scale=1.0):
    """Handheld-like pose sweep keeping the board in view (front side)."""
    rng = np.random.default_rng(seed)
    span = float(
        (board.p3d[:, :2].max(0) - board.p3d[:, :2].min(0)).max()
    ) * span_scale
    center = board.p3d.mean(0)
    base = jnp.asarray(front_view_base())
    poses = []
    while len(poses) < n_frames:
        pert = rng.normal(size=3) * np.array([0.3, 0.3, 0.5])
        rv, _ = se3.compose(
            jnp.asarray(pert), jnp.zeros(3), base, jnp.zeros(3)
        )
        rvec = np.asarray(rv)
        dist = rng.uniform(0.55, 1.15) * span
        offset = rng.normal(size=2) * 0.25 * span
        R = np.asarray(se3.exp_so3(jnp.asarray(rvec)))
        t = np.array([offset[0], offset[1], dist]) - R @ center
        pc = board.p3d @ R.T + t
        if (pc[:, 2] <= 0.05 * span).any():
            continue
        poses.append(np.concatenate([rvec, t]))
    return np.stack(poses)


def write_euroc_dataset(
    out_dir: str,
    model: GenericModel,
    n_frames: int = 40,
    cam_num: int = 1,
    extrinsics=None,
    board: Board = None,
    family: TagFamily = None,
    seed: int = 0,
    noise: float = 2.0,
):
    """Materialize a EuRoC-layout dataset ({root}/mav0/cam{i}/data/*.png)
    of rendered frames; returns (poses (F,6), model)."""
    from .pngio import write_png

    board = board or Board(BoardConfig())
    family = family or get_family("t36h11")
    poses = default_sequence_poses(n_frames, board, seed=seed)
    if cam_num > 1 and extrinsics is None:
        extrinsics = default_rig_extrinsics(cam_num)
    for ci in range(cam_num):
        d = os.path.join(out_dir, "mav0", f"cam{ci}", "data")
        os.makedirs(d, exist_ok=True)
        for f in range(n_frames):
            rvec, tvec = poses[f, :3], poses[f, 3:]
            if extrinsics is not None and ci > 0:
                r_i0, t_i0 = extrinsics[ci][:3], extrinsics[ci][3:]
                with cpu_scope():
                    composed = se3.compose(
                        jnp.asarray(r_i0), jnp.asarray(t_i0),
                        jnp.asarray(rvec), jnp.asarray(tvec),
                    )
                rvec, tvec = [
                    np.asarray(v)
                    for v in composed
                ]
            img = render_board_image(
                model, board, family, rvec, tvec, noise=noise, seed=seed * 1000 + f
            )
            t_ns = 10_000_000_000 + f * 100_000_000
            write_png(os.path.join(d, f"{t_ns}.png"), img)
    return poses, model


def default_rig_extrinsics(cam_num: int):
    """T_cam_i<-cam0 for a simple horizontal rig (11 cm baseline steps,
    slight convergence), row 0 identity; rows are (rvec|tvec)."""
    out = [np.zeros(6)]
    for i in range(1, cam_num):
        out.append(
            np.array([0.0, -0.02 * i, 0.005 * i, -0.11 * i, 0.002 * i, 0.004 * i])
        )
    return np.stack(out)


def _main():
    import argparse

    ap = argparse.ArgumentParser(description="render a synthetic EuRoC dataset")
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--cam-num", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--platform",
        default="auto",
        choices=list(PLATFORMS),
        help="JAX backend to render on (auto = JAX's default)",
    )
    args = ap.parse_args()
    select_platform(args.platform)
    model = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    poses, _ = write_euroc_dataset(
        os.path.join(args.out_dir, "dataset"),
        model,
        n_frames=args.frames,
        cam_num=args.cam_num,
        seed=args.seed,
    )
    print(f"wrote {args.frames} frames to {args.out_dir}/dataset (EuRoC layout)")


if __name__ == "__main__":
    _main()
