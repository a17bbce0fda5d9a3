"""The native helper library (``quadproc.cpp``), built on first use.

The library is compiled with g++ into ``build/`` next to the source, under
a name keyed on a hash of the source and the compiler flags, so an edited
source or changed flags always rebuild and a stale binary is never loaded.
A file lock makes concurrent first uses (test workers, loader threads of
several processes) build once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "quadproc.cpp")
_BUILD_DIR = os.path.join(_DIR, "build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17")

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libquadproc-{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(so):  # another process built it meanwhile
            return
        partial = so + ".partial"
        res = subprocess.run(
            ["g++", *_FLAGS, _SRC, "-o", partial], capture_output=True, text=True
        )
        if res.returncode != 0:
            raise RuntimeError(f"building {_SRC} failed:\n{res.stderr}")
        os.replace(partial, so)


def _declare(lib) -> None:
    c_int, c_float = ctypes.c_int, ctypes.c_float
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.quadproc_extract_batch.argtypes = [
        u8p, c_int, c_int, c_int,  # bins, B H W
        f32p, ctypes.POINTER(c_int),  # quads, counts
        c_int, c_int, c_float,  # max_quads, min_area, min_fill
    ]
    lib.quadproc_extract_batch.restype = None
    lib.refine_corners_native.argtypes = [
        f32p, c_int, c_int, c_int,  # imgs, B H W
        f32p, i32p,  # corners (n,2) in/out, img_idx (n,)
        c_int, c_int, c_int,  # n, win, iters
    ]
    lib.refine_corners_native.restype = None
    lib.refine_corners_patches.argtypes = [
        f32p, c_int, c_int,  # patches (n,P,P), n, P
        f32p, c_int, c_int,  # corners_local (n,2) in/out, win, iters
    ]
    lib.refine_corners_patches.restype = None
    lib.png_unfilter.argtypes = [u8p, c_int, c_int, c_int, u8p]
    lib.png_unfilter.restype = c_int


def load():
    """The loaded library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            _declare(lib)
            _lib = lib
        return _lib
