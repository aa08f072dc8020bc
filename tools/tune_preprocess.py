#!/usr/bin/env python3
"""Block geometry and bisection levels a pass of kernels K2 and K3
(``pcr_tpu_torch/csrc/preprocess.cu``), measured on one GPU.

    python3 tools/tune_preprocess.py

preprocess.cu fixes four constants: lanes a query (team), warps a block,
queries a team takes in turn, and bisection levels a pass.  This script
compiles the same source once for each geometry in VARIANTS (a small file
that includes it and exports its launch templates at that geometry, one
nvcc a file, all at once), then, at each of the 5 stage-2 pyramid scales of
chip_smoke.py's circuit (scan 0, as its kernel phase), runs every geometry
on the tensors ``preprocess_scale_fused`` hands K2 and K3, holds each
result to the plain versions with chip_smoke's checks (found, tau and
counts bit-equal), and prints the median time of 20 launches (CUDA events)
of each kernel at each scale, their sum over the scales, and what ptxas
reports for the geometry (registers, spill bytes).
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (team, warps, queries a team, levels a pass)
VARIANTS = ([(t, 8, 1, m) for t in (8, 16, 32) for m in (1, 2, 3, 4, 5)]
            + [(32, 4, 1, m) for m in (2, 3)] + [(32, 8, q, m) for q in (2, 4) for m in (2, 3)]
            + [(16, 4, 1, m) for m in (2, 3)] + [(16, 8, 2, m) for m in (2, 3)])

TEMPLATE = """#include "preprocess.cu"
extern "C" int tune_k2(const int* starts, const float* q, const float* r, int n_pad,
                       int q_tile, int band, int k1, float log_lo, float log_hi,
                       float* mean_d, unsigned char* found, float* tau_out,
                       cudaStream_t stream) {{
  return launch_outlier_stats<{0}, {1}, {2}, {3}>(starts, q, r, n_pad, q_tile, band, k1,
                                                  log_lo, log_hi, mean_d, found, tau_out,
                                                  stream);
}}
extern "C" int tune_k3(const int* starts, const float* q, const float* r,
                       const unsigned char* keep, const float* tau0, const float* center,
                       int n_pad, int q_tile, int band, int normal_k, float* out,
                       cudaStream_t stream) {{
  return launch_survivor_moments<{0}, {1}, {2}, {3}>(starts, q, r, keep, tau0, center,
                                                     n_pad, q_tile, band, normal_k, out,
                                                     stream);
}}
"""


NAMES = ("team", "warps", "qpt", "levels")
EXPORTS = {"tune_k2": "pcr_outlier_stats", "tune_k3": "pcr_survivor_moments"}


def tag(v, names=NAMES) -> str:
    return "_".join(f"{n}{int(x)}" for n, x in zip(names, v))


def build_variants(source: str, template: str, variants, exports: dict, names=NAMES) -> dict:
    """{variant: (ctypes library, ptxas summary)}.  For each variant, a file
    that includes csrc/``source`` and ``template`` formatted with the
    variant is compiled (one nvcc a file, all at once); ``exports`` maps each
    function the template exports to the entry point of build.SIGNATURES
    whose signature it has."""
    from pcr_tpu_torch.ops.kernels import build

    src = (build.CSRC / source).read_bytes() + (build.CSRC / "common.cuh").read_bytes()
    out_dir = build.BUILD_ROOT.parent / "tune" / hashlib.sha256(src).hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for v in variants:
        cu = out_dir / f"{tag(v, names)}.cu"
        cu.write_text(template.format(*(str(x).lower() for x in v)))
        procs[v] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(build.CSRC),
             "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for v, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag(v, names)}:\n{err}")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", err)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", err))
        lib = ctypes.CDLL(str(out_dir / f"{tag(v, names)}.so"))
        for name, sig in exports.items():
            getattr(lib, name).argtypes = build.SIGNATURES[sig]
            getattr(lib, name).restype = ctypes.c_int
        libs[v] = (lib, f"max {max(regs)} registers, {spills} spill bytes")
    return libs


def run_k2(lib, inp):
    import torch

    from pcr_tpu_torch.ops.kernels import common
    from pcr_tpu_torch.ops.kernels import feature_kernels as fk

    starts, q, r, hint = inp.k2_args
    n_pad = q.shape[0]
    mean_d = torch.empty(n_pad, dtype=torch.float32, device=q.device)
    found = torch.empty(n_pad, dtype=torch.bool, device=q.device)
    tau = torch.empty(n_pad, dtype=torch.float32, device=q.device)
    lo, hi = fk._log_bounds(hint, 0.05, 100.0)
    err = lib.tune_k2(starts.data_ptr(), q.data_ptr(), r.data_ptr(), n_pad, 1024, inp.band,
                      31, lo, hi, mean_d.data_ptr(), found.data_ptr(), tau.data_ptr(),
                      common.stream_of(q))
    if err:
        raise RuntimeError(f"K2 launch failed with error {err}")
    return mean_d, found, tau


def run_k3(lib, inp):
    import torch

    from pcr_tpu_torch.ops.kernels import common

    starts, q, r, keep, tau0, center = inp.k3_args
    out = torch.empty((q.shape[0], 10), dtype=torch.float32, device=q.device)
    err = lib.tune_k3(starts.data_ptr(), q.data_ptr(), r.data_ptr(), keep.data_ptr(),
                      tau0.data_ptr(), center.data_ptr(), q.shape[0], 1024, inp.band, 20,
                      out.data_ptr(), common.stream_of(q))
    if err:
        raise RuntimeError(f"K3 launch failed with error {err}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_preprocess: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pcr_tpu_torch.models import multiscale
    from pcr_tpu_torch.ops.kernels import feature_kernels as fk
    from pcr_tpu_torch.utils import cloud

    print(chip_smoke.gpu_line())
    libs = build_variants("preprocess.cu", TEMPLATE, VARIANTS, EXPORTS)
    dev = torch.device("cuda", 0)
    scans, _, _ = chip_smoke.make_circuit()
    clouds = [cloud.from_numpy(s, chip_smoke.CAPACITY, device=dev) for s in scans]
    scales = multiscale.create_scales(5)
    caps = cloud.plan_scale_caps(clouds, scales)
    times = {v: [] for v in libs}
    for v_size, cap in zip(scales, caps):
        inp = chip_smoke.preprocess_inputs(clouds[0], v_size, cap)
        S_p = fk.survivor_moments_reference(*inp.k3_args, q_tile=1024, band=inp.band)
        label = f"scale {v_size:.1f} m"
        for v, (lib, _) in libs.items():
            chip_smoke.check_k2_result(f"{label} {tag(v)}", run_k2(lib, inp), inp.k2_plain)
            chip_smoke.check_k3_result(f"{label} {tag(v)}", run_k3(lib, inp), S_p)
            times[v].append((chip_smoke.cuda_ms(lambda: run_k2(lib, inp), 20),
                             chip_smoke.cuda_ms(lambda: run_k3(lib, inp), 20)))
        print(f"{label}: {cap} rows, band {inp.band}; every geometry bit-equal")
    print("geometry | K2 ms at " + " / ".join(f"{v:.1f}" for v in scales)
          + " m (sum) | K3 ms (sum) | ptxas")
    for v, rows in sorted(times.items(), key=lambda kv: sum(a + b for a, b in kv[1])):
        k2, k3 = [a for a, _ in rows], [b for _, b in rows]
        print(f"{tag(v)} | " + " / ".join(f"{t:.4f}" for t in k2) + f" ({sum(k2):.4f}) | "
              + " / ".join(f"{t:.4f}" for t in k3) + f" ({sum(k3):.4f}) | {libs[v][1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
