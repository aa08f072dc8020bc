#!/usr/bin/env python3
"""Geometry of kernel K7 (``pcr_tpu_torch/csrc/nn1.cu``), measured on one GPU.

    python3 tools/tune_nn1.py [--parent DIR]

nn1.cu fixes six constants: threads a block, queries a thread, refs a
group (one compare-and-record a group), ref rows staged at a time, the
blocks a SM its launch bounds ask for and the refs a loop body takes; the
wrapper (``nn_kernels.
nn1_splits``) picks the number of ref ranges that fills NN1_WAVES waves of
the card's resident blocks.  This script compiles the same source once for
each combination in VARIANTS (a small file that includes it and exports its
launch template and occupancy at that combination, one nvcc a file, all at
once), then, at the shapes chip_smoke.py gives K7 on its circuit (the
finest-scale brute GICP pair, 21504 x 21504, and the gate's 32768-row
clouds), runs every combination at each wave count in WAVES on the same
tensors, holds each result to the plain version (d2 bit-equal, rows equal),
and prints the median time of 20 launches (CUDA events, behind chip_smoke's
device spin) at each shape, their sum, the blocks a SM and what ptxas
reports (registers of the file's kernels, spill bytes).

It also prints the card's SM clock sampled by nvidia-smi while this
checkout's K7 runs back to back at 21504 x 21504 for about two seconds, the
issue floor at that clock (9 instructions a pair: the 8 rounded d2
operations and one FMNMX, over 132 SMs x 128 lanes), the instruction mix of
this checkout's K7 partial kernel as cuobjdump disassembles it, and its
times from the finest queries over 1/3, 1/2, 2/3 and all of the gate's refs
(the same ref ranges each time) fitted as a fixed time plus cycles a pair.

Last, it times probes: copies of this checkout's nn1.cu whose inner-loop
line (PROBE_LINE) is replaced by another instruction mix (PROBES: FADD in
place of the FMNMX, an FMA-contracted d2, d2 without products).  Their
results are wrong by design and are not checked; their times, on random
refs at 21504 and 32768 rows, say what an instruction of the mix costs on
the card.

``--parent DIR``: also compile DIR/pcr_tpu_torch/csrc/nn1.cu (another
checkout, e.g. the parent commit unpacked with ``git archive`` into build/)
and time it, with its own ref-range rule (``parent_splits``), beside this
checkout's kernel as the wrapper launches it, in turns (parent, this, this,
parent) at both shapes.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tune_preprocess import build_variants, tag  # noqa: E402  (tools/, beside this file)

NAMES = ("threads", "qpt", "group", "chunk", "minb", "unroll")
# tune_k7_blocks (no arguments, returns int: ctypes' defaults) is called as is
EXPORTS = {"tune_k7": "pcr_nn1"}
# (threads a block, queries a thread, refs a group, ref rows staged at a time,
# launch-bounds blocks a SM, refs a loop body)
VARIANTS = [(128, 8, 8, 512, 0, 8), (128, 8, 8, 512, 8, 8), (256, 8, 8, 512, 0, 8),
            (256, 8, 8, 512, 4, 8), (64, 8, 8, 512, 0, 8), (128, 8, 8, 256, 0, 8),
            (128, 4, 8, 512, 0, 8), (128, 6, 16, 512, 0, 16), (128, 8, 16, 512, 0, 16),
            (128, 8, 16, 512, 0, 4), (128, 8, 32, 512, 0, 8)]
# nn1.cu's own combination, whose occupancy must be the wrapper's
# NN1_BLOCKS_PER_SM
SHIPPED = tuple(int(re.search(rf"constexpr int {c} = (\d+);", (
    ROOT / "pcr_tpu_torch" / "csrc" / "nn1.cu").read_text()).group(1))
    for c in ("kThreads", "kQueries", "kGroup", "kChunk", "kMinBlocks", "kUnroll"))
WAVES = (1, 2)
MIN_SPLIT_ROWS = 256
FLOOR_INSTRUCTIONS = 9

TEMPLATE = """#include "nn1.cu"
extern "C" int tune_k7(const float* q, const float* r, int nq, int nr, int splits,
                       float* part_d, int* part_row, float* out_d, int* out_row,
                       cudaStream_t stream) {{
  return launch_nn1<{0}, {1}, {2}, {3}, {4}, {5}>(q, r, nq, nr, splits, part_d, part_row,
                                                  out_d, out_row, stream);
}}
extern "C" int tune_k7_blocks() {{
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, nn1_partial_kernel<{0}, {1}, {2}, {3}, {4}, {5}>, {0}, 0);
  return err == cudaSuccess ? blocks : -1;
}}
"""


PROBE_LINE = "gm[u] = fminf(gm[u], pcr::sqdist(qx[u], qy[u], qz[u], p.x, p.y, p.z));"
_D = ("const float dx = __fsub_rn(qx[u], p.x), dy = __fsub_rn(qy[u], p.y), "
      "dz = __fsub_rn(qz[u], p.z); ")
# name -> (issued instructions a pair, replacement of PROBE_LINE)
PROBES = {
    "the kernel: 8 rounded d2 operations + FMNMX": (9, PROBE_LINE),
    "FADD in place of the FMNMX": (
        9, "gm[u] = __fadd_rn(gm[u], pcr::sqdist(qx[u], qy[u], qz[u], p.x, p.y, p.z));"),
    "FMA-contracted d2 (3 FADD, FMUL, 2 FFMA) + FMNMX": (
        7, "{" + _D + "gm[u] = fminf(gm[u], fmaf(dz, dz, fmaf(dy, dy, __fmul_rn(dx, dx))));}"),
    "d2 without products (5 FADD) + FMNMX": (
        6, "{" + _D + "gm[u] = fminf(gm[u], __fadd_rn(__fadd_rn(dx, dy), dz));}"),
}


def probe_times() -> None:
    """Times of PROBES (wrong results, unchecked) on random refs."""
    import torch

    import chip_smoke
    from pcr_tpu_torch.ops.kernels import build
    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    src = (build.CSRC / "nn1.cu").read_text()
    if PROBE_LINE not in src:
        raise RuntimeError("nn1.cu's inner loop no longer has PROBE_LINE")
    out = build.BUILD_ROOT.parent / "tune" / "probes"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (_, line)) in enumerate(PROBES.items()):
        cu = out / f"probe{i}.cu"
        cu.write_text(src.replace(PROBE_LINE, line))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC), "-o",
             str(cu.with_suffix(".so")), str(cu)], stderr=subprocess.PIPE, text=True)
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for probe {name}:\n{err}")
        lib = ctypes.CDLL(str(out / f"probe{i}.so"))
        lib.pcr_nn1.argtypes = build.SIGNATURES["pcr_nn1"]
        lib.pcr_nn1.restype = ctypes.c_int
        libs[name] = lib
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for n in (21504, 32768):
        q, r = (torch.rand((n, 3), generator=gen, device="cuda") * 60 - 30 for _ in range(2))
        for name, lib in libs.items():
            splits = nk.nn1_splits(n, n, nk.nn1_slots(0))
            ms = chip_smoke.cuda_ms(lambda: run_k7(lib.pcr_nn1, q, r, splits), 20)
            print(f"probe {n}^2, {name} ({PROBES[name][0]} instructions a pair): {ms:.4f} ms")


def splits_for(nq: int, nr: int, block_queries: int, slots: int, waves: int) -> int:
    """``nn_kernels.nn1_splits``'s rule at another geometry."""
    q_blocks = -(-nq // block_queries)
    return max(1, min(waves * slots // q_blocks, nr // MIN_SPLIT_ROWS))


def sm_clock_mhz(fn, seconds: float = 2.0) -> float:
    """Median SM clock (MHz) that nvidia-smi reads every 100 ms while
    ``fn()`` runs back to back for about ``seconds``."""
    import time

    import torch

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    readings = [float(x) for x in out.split()[1:]]   # the first reading may precede the load
    return statistics.median(readings)


def sass_mix(lib_path: Path) -> str:
    """Opcode counts of the K7 partial kernel in ``lib_path`` (cuobjdump)."""
    from pcr_tpu_torch.ops.kernels import build

    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts: dict[str, int] = {}
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "nn1_partial_kernel" in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                op = m.group(1).split(".")[0]
                counts[op] = counts.get(op, 0) + 1
    return ", ".join(f"{op} {n}" for op, n in sorted(counts.items(), key=lambda kv: -kv[1])[:16])


def parent_splits(nq: int, nr: int, sm: int) -> int:
    """The ref-range rule of the one-query-a-thread K7 (128 threads a block,
    8 blocks a SM, ranges of at least 2048 rows)."""
    return max(1, min(-(-sm * 8 // -(-nq // 128)), nr // 2048))


def run_k7(fn, q, r, splits: int):
    import torch

    from pcr_tpu_torch.ops.kernels import common

    nq, nr = q.shape[0], r.shape[0]
    part_d = torch.empty(splits * nq, dtype=torch.float32, device=q.device)
    part_row = torch.empty(splits * nq, dtype=torch.int32, device=q.device)
    d = torch.empty(nq, dtype=torch.float32, device=q.device)
    rows = torch.empty(nq, dtype=torch.int32, device=q.device)
    err = fn(q.data_ptr(), r.data_ptr(), nq, nr, splits, part_d.data_ptr(), part_row.data_ptr(),
             d.data_ptr(), rows.data_ptr(), common.stream_of(q))
    if err:
        raise RuntimeError(f"K7 launch failed with error {err}")
    return d, rows


def build_parent(parent: Path):
    """ctypes handle of the other checkout's pcr_nn1."""
    from pcr_tpu_torch.ops.kernels import build

    csrc = parent / "pcr_tpu_torch" / "csrc"
    out = build.BUILD_ROOT.parent / "tune" / "parent_nn1.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(csrc), "-o",
                    str(out), str(csrc / "nn1.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    lib.pcr_nn1.argtypes = build.SIGNATURES["pcr_nn1"]
    lib.pcr_nn1.restype = ctypes.c_int
    return lib.pcr_nn1


def shapes(dev):
    """(label, q, r) of chip_smoke's K7 shapes on its circuit."""
    import torch

    import chip_smoke
    from pcr_tpu_torch.models import multiscale
    from pcr_tpu_torch.utils import cloud, se3
    from pcr_tpu_torch.utils.cloud import PAD_COORD

    scans, gt, _ = chip_smoke.make_circuit()
    clouds = [cloud.from_numpy(s, chip_smoke.CAPACITY, device=dev) for s in scans]
    caps = cloud.plan_scale_caps(clouds, multiscale.create_scales(5))
    T = torch.as_tensor(gt[0], dtype=torch.float32, device=dev)

    def qr(src, tgt):
        q = se3.transform_points(T, src.points).contiguous()
        return q, torch.where(tgt.mask[:, None], tgt.points, PAD_COORD).contiguous()

    fine = (multiscale.build_pyramid(clouds[1], 5, caps)[-1],
            multiscale.build_pyramid(clouds[0], 5, caps)[-1])
    return [("finest brute GICP", *qr(*fine)), ("gate", *qr(clouds[1], clouds[0]))]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="another checkout to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_nn1: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    print(chip_smoke.gpu_line())
    dev = torch.device("cuda", 0)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    cases = shapes(dev)
    plain = {label: nk.nn1_reference(q, r) for label, q, r in cases}
    if args.parent is not None:
        parent = build_parent(args.parent)
        times = {"parent": [[] for _ in cases], "this": [[] for _ in cases]}
        for i, (label, q, r) in enumerate(cases):
            d_p, i_p = plain[label]
            ps = parent_splits(q.shape[0], r.shape[0], sm)
            runs = {"parent": lambda: run_k7(parent, q, r, ps), "this": lambda: nk.nn1(q, r)}
            for name, fn in runs.items():
                d, rows = fn()
                if not (torch.equal(d, d_p) and torch.equal(rows, i_p)):
                    raise AssertionError(f"K7 {name} at {label}: differs from the plain version")
            for name in ("parent", "this", "this", "parent"):
                times[name][i].append(chip_smoke.cuda_ms(runs[name], 20))
        for i, (label, q, r) in enumerate(cases):
            print(f"{label} ({q.shape[0]} q x {r.shape[0]} refs): parent "
                  f"{statistics.median(times['parent'][i]):.4f} ms "
                  f"({parent_splits(q.shape[0], r.shape[0], sm)} splits), this "
                  f"{statistics.median(times['this'][i]):.4f} ms "
                  f"({nk.nn1_splits(q.shape[0], r.shape[0], nk.nn1_slots(0))} splits); turns "
                  f"parent, this, "
                  f"this, parent: {times['parent'][i][0]:.4f} / {times['this'][i][0]:.4f} / "
                  f"{times['this'][i][1]:.4f} / {times['parent'][i][1]:.4f}")
    from pcr_tpu_torch.ops.kernels import build

    label, q, r = cases[0]
    mhz = sm_clock_mhz(lambda: nk.nn1(q, r))
    pairs = q.shape[0] * r.shape[0]
    print(f"SM clock while K7 runs at {label}: {mhz:.0f} MHz; issue floor "
          f"{pairs * FLOOR_INSTRUCTIONS / (sm * 128 * mhz * 1e6) * 1e3:.4f} ms "
          f"({FLOOR_INSTRUCTIONS} instructions a pair); at 1980 MHz "
          f"{pairs * FLOOR_INSTRUCTIONS / (sm * 128 * 1980e6) * 1e3:.4f} ms")
    print(f"K7 partial kernel instruction mix (static): {sass_mix(build.library_path())}")
    # this checkout's K7 from the finest queries over growing prefixes of the
    # gate's refs, each with the same ref ranges (a full wave): time = fixed +
    # per pair
    r_all = cases[1][2]
    sizes = [r_all.shape[0] * k // 6 for k in (2, 3, 4, 6)]
    ts = [chip_smoke.cuda_ms(lambda n=n: nk.nn1(q, r_all[:n]), 20) for n in sizes]
    splits = {nk.nn1_splits(q.shape[0], n, nk.nn1_slots(0)) for n in sizes}
    slope, fixed = np.polyfit([q.shape[0] * n for n in sizes], ts, 1)
    print(f"K7 at {q.shape[0]} q x " + ", ".join(f"{n} refs {t:.4f} ms" for n, t in zip(sizes, ts))
          + f" ({sorted(splits)} ref splits): fixed {fixed * 1e3:.1f} us + "
          f"{slope * 1e-3 * mhz * 1e6 * sm * 128:.2f} cycles a pair on each of {sm} x 128 lanes")
    libs = build_variants("nn1.cu", TEMPLATE, VARIANTS, EXPORTS, NAMES)
    results = {}
    for v, (lib, _) in libs.items():
        slots = sm * lib.tune_k7_blocks()
        if v == SHIPPED and slots != nk.nn1_slots(0):
            raise AssertionError(f"nn1.cu's blocks a SM are {slots // sm}, not the wrapper's "
                                 f"NN1_BLOCKS_PER_SM = {nk.NN1_BLOCKS_PER_SM}")
        for waves in WAVES:
            row = []
            for label, q, r in cases:
                nq, nr = q.shape[0], r.shape[0]
                splits = splits_for(nq, nr, v[0] * v[1], slots, waves)
                d, rows = run_k7(lib.tune_k7, q, r, splits)
                if not (torch.equal(d, plain[label][0]) and torch.equal(rows, plain[label][1])):
                    raise AssertionError(f"K7 {label} {tag(v, NAMES)}: differs from the plain "
                                         f"version")
                row.append(chip_smoke.cuda_ms(lambda: run_k7(lib.tune_k7, q, r, splits), 20))
            results[(v, waves)] = (row, slots // sm)
    print("every combination bit-equal at " + ", ".join(
        f"{label} ({q.shape[0]} q x {r.shape[0]} refs)" for label, q, r in cases))
    print("combination | waves | blocks a SM | K7 ms at " + " / ".join(c[0] for c in cases)
          + " | sum | ptxas")
    for (v, waves), (row, per_sm) in sorted(results.items(), key=lambda kv: sum(kv[1][0])):
        print(f"{tag(v, NAMES)} | {waves} | {per_sm} | " + " / ".join(f"{t:.4f}" for t in row)
              + f" | {sum(row):.4f} | {libs[v][1]}")
    probe_times()
    return 0


if __name__ == "__main__":
    sys.exit(main())
