"""ctypes bridge to the native quad extractor.

The native stage handles the irregular work (CCL/contours/poly fit); see
``ccrs_jax/native/quadproc.cpp``.  ``ccrs_jax.native.load`` builds the
library on first use.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import load as _load

MAX_QUADS = 160
MIN_AREA = 25
MIN_FILL = 0.6


def extract_quads_batch(
    binary: np.ndarray,
    max_quads: int = MAX_QUADS,
    min_area: int = MIN_AREA,
    min_fill: float = MIN_FILL,
):
    """Extract candidate dark quads from a batch of binary images.

    Args:
      binary: (B, H, W) uint8, 1 = white, 0 = black.

    Returns:
      quads: (B, max_quads, 4, 2) float32 corner coords (x, y), clockwise
        in image coordinates; rows past counts[b] are undefined.
      counts: (B,) int32 number of quads per image.
    """
    lib = _load()
    binary = np.ascontiguousarray(binary, dtype=np.uint8)
    B, H, W = binary.shape
    quads = np.zeros((B, max_quads, 8), np.float32)
    counts = np.zeros(B, np.int32)
    lib.quadproc_extract_batch(
        binary.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        B, H, W,
        quads.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        max_quads, min_area, ctypes.c_float(min_fill),
    )
    return quads.reshape(B, max_quads, 4, 2), counts


def refine_corners_native(
    images: np.ndarray,
    corners: np.ndarray,
    win: int = 4,
    iters: int = 6,
    counts: np.ndarray = None,
    group: int = 1,
) -> np.ndarray:
    """Native cornerSubPix-style refinement (math mirrors detect/refine.py,
    which is the reference implementation; this one runs the scattered tiny
    gathers where they belong — on the host cores, OpenMP over corners).

    Args:
      images: (B, H, W) float32 grayscale.
      corners: (B, M, 2) float32 initial positions.
      counts: optional (B,) — only the first counts[b]*group rows of image
        b are real; padding rows are skipped (the detector's quad buffers
        are heavily padded, and this host stage runs on few cores).
      group: corners per counted unit (4 for quads).

    Returns refined (B, M, 2) float32.
    """
    lib = _load()
    images = np.ascontiguousarray(images, dtype=np.float32)
    B, H, W = images.shape
    M = corners.shape[1]
    out = np.ascontiguousarray(corners, dtype=np.float32).copy()
    if counts is None:
        flat = out.reshape(-1, 2)
        idx = np.repeat(np.arange(B, dtype=np.int32), M)
    else:
        n_real = np.minimum(np.asarray(counts) * group, M)
        sel_b = np.repeat(np.arange(B), n_real)
        sel_m = np.concatenate([np.arange(n) for n in n_real]).astype(np.int64)
        flat = np.ascontiguousarray(out[sel_b, sel_m], dtype=np.float32)
        idx = sel_b.astype(np.int32)
    if flat.shape[0]:
        lib.refine_corners_native(
            images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            B, H, W,
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            flat.shape[0], win, iters,
        )
    if counts is None:
        return flat.reshape(B, M, 2)
    out[sel_b, sel_m] = flat
    return out


def refine_corners_patches_native(
    patches: np.ndarray, local: np.ndarray, win: int = 4, iters: int = 6
) -> np.ndarray:
    """Refine patch-local corner coordinates (patches extracted on device;
    see detect.patches).  patches: (n, P, P) f32; local: (n, 2) f32."""
    lib = _load()
    patches = np.ascontiguousarray(patches, dtype=np.float32)
    out = np.ascontiguousarray(local, dtype=np.float32).copy()
    n, P, _ = patches.shape
    if n:
        lib.refine_corners_patches(
            patches.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, P,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            win, iters,
        )
    return out
