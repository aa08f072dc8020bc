"""Native host-side runtime: the C++ PCD reader and voxel counter, via ctypes.

The card owns the compute; this module owns the host data plane: a threaded
C++ loader (``pcd_io.cc``, this package's own copy) that parses PCD scans and
pads them straight into the fixed-shape dataset buckets
(``utils/cloud.BUCKETS``).  It is built with g++ at first use into
``build/pcr_tpu_torch/native/<hash of source and flags>/``, beside the CUDA
kernels, never next to the source.  Every entry point has a pure-Python
fallback in ``utils/pcd.py``, which the callers select when g++ is missing or
``PCR_DISABLE_NATIVE=1``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "pcd_io.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "pcr_tpu_torch" / "native"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]
LIB_NAME = "libpcr_io.so"

_lock = threading.Lock()
_lib = None
_lib_failed = False


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _build(out: Path) -> bool:
    """Compile into a private file and rename it into place, so concurrent
    builds (test workers, a script and its subprocess) never load a torn one."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def load_library():
    """Build (if needed) and load the native library; None on any failure."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get("PCR_DISABLE_NATIVE") == "1":
            _lib_failed = True
            return None
        out = library_path()
        if not out.exists() and not _build(out):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            _lib_failed = True
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        i64p = ctypes.POINTER(ctypes.c_long)
        lib.pcr_read_pcd.restype = ctypes.c_long
        lib.pcr_read_pcd.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                     ctypes.c_float, f32p, u8p, f32p, u8p]
        lib.pcr_read_pcd_batch.restype = ctypes.c_long
        lib.pcr_read_pcd_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_long,
            ctypes.c_float, f32p, u8p, f32p, u8p, i64p, ctypes.c_int]
        lib.pcr_count_voxels.restype = ctypes.c_long
        lib.pcr_count_voxels.argtypes = [f32p, ctypes.c_long, ctypes.c_float]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def read_pcd_padded(path: str, capacity: int, pad_coord: float,
                    want_colors: bool = True):
    """Parse one PCD into padded host arrays.

    Returns (points (cap,3) f32, mask (cap,) bool, colors (cap,3) f32 | None,
    count).  Raises RuntimeError on parse errors (callers may fall back)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native PCD reader unavailable")
    cap = int(capacity)
    points = np.empty((cap, 3), np.float32)
    mask = np.empty((cap,), np.uint8)
    colors = np.empty((cap, 3), np.float32) if want_colors else None
    has_colors = ctypes.c_ubyte(0)
    n = lib.pcr_read_pcd(os.fsencode(path), cap, ctypes.c_float(pad_coord), _f32p(points),
                         _u8p(mask), _f32p(colors) if colors is not None else None,
                         ctypes.byref(has_colors))
    if n < 0:
        raise RuntimeError(f"native PCD parse failed ({n}) for {path}")
    if not has_colors.value:
        colors = None
    return points, mask.astype(bool), colors, int(n)


def read_pcd_batch_padded(paths: list[str], capacity: int, pad_coord: float,
                          want_colors: bool = True, n_threads: int | None = None):
    """Threaded batch parse into one contiguous (B, cap, 3) buffer.

    Returns (points, mask, colors | None, counts)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native PCD reader unavailable")
    B, cap = len(paths), int(capacity)
    points = np.empty((B, cap, 3), np.float32)
    mask = np.empty((B, cap), np.uint8)
    colors = np.empty((B, cap, 3), np.float32) if want_colors else None
    counts = np.empty((B,), np.int64)
    has_colors = np.zeros((B,), np.uint8)
    arr = (ctypes.c_char_p * B)(*[os.fsencode(p) for p in paths])
    if n_threads is None:
        n_threads = min(max(os.cpu_count() or 1, 1), 8)
    rc = lib.pcr_read_pcd_batch(
        arr, B, cap, ctypes.c_float(pad_coord), _f32p(points), _u8p(mask),
        _f32p(colors) if colors is not None else None, _u8p(has_colors),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), int(n_threads))
    if rc != 0:
        bad = [p for p, c in zip(paths, counts) if c < 0]
        raise RuntimeError(f"native PCD batch parse failed ({rc}) for {bad[:3]}")
    if not has_colors.any():
        colors = None
    else:
        # the reader fills only the padding rows of a file without rgb; a
        # mixed batch gives such a file zero colors, as the padding has
        colors[has_colors == 0] = 0.0
    return points, mask.astype(bool), colors, counts


def count_voxels(points: np.ndarray, voxel: float) -> int:
    """Exact occupied-voxel count (the planner's hot loop); raises if unavailable."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    pts = np.ascontiguousarray(points, np.float32)
    return int(lib.pcr_count_voxels(_f32p(pts), pts.shape[0], ctypes.c_float(voxel)))
