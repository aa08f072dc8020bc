"""Build and load the hand-written CUDA kernels (``pcr_tpu_torch/csrc``).

The sources have a plain C interface; ``nvcc`` compiles each for ``sm_90a``
(all at once, one process a source) and links them into one shared library,
loaded with ctypes.  The build happens on first use,
into ``build/pcr_tpu_torch/<hash of flags and sources>/`` beside the package,
so a checkout builds everything it needs and a changed source never loads a
stale library.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "pcr_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]
LIB_NAME = "libpcr_tpu_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of each C entry point (pointers and the stream as c_void_p);
# every launching entry point returns cudaGetLastError() after its launch.
SIGNATURES = {
    "pcr_nn1_band": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "pcr_slab_starts": [_P, _P, _I, _P, _I, _I, _I, _I, _F, _P, _P],
    "pcr_nn1": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "pcr_outlier_stats": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _P, _P, _P],
    "pcr_survivor_moments": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "pcr_moments": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _P],
    "pcr_spfh": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _P, _P, _P],
    "pcr_fpfh": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "pcr_gnc": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P, _P, _P],
    "pcr_block_thomas": [_P, _P, _P, _I, _P, _P, _P, _P],
    "pcr_nn1_mutual": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "pcr_edge_blocks": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    "pcr_assemble_band": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P],
    "pcr_assemble_dense": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    "pcr_gicp_move": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _P, _P, _P],
    "pcr_gicp_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _F, _F, _P, _P],
    "pcr_gicp_update": [_P, _I, _P, _P, _F, _F, _P],
    "pcr_knn_morton": [_P, _P, _I, _P, _I, _P, _P, _P, _P],
    "pcr_knn_select": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "pcr_voxel_counts": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P],
    # bytes of shared memory a block of K4, K5, K6 asks for at a band
    "pcr_moments_smem": [_I],
    "pcr_spfh_smem": [_I],
    "pcr_fpfh_smem": [_I],
    # partial rows (blocks) of K10's gicp_rows over a number of rows
    "pcr_gicp_rows_blocks": [_I],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the library unless this exact build exists; returns its path.
    Concurrent builds each write a private file and rename it into place."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [out.with_name(f"{src.stem}.{os.getpid()}.o") for src in sources]  # nvcc reads .o
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objs)]
    failed = []
    for src, proc in zip(sources, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_name(f"{LIB_NAME}.{tag}")
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every entry
    point's argtypes and restype declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
