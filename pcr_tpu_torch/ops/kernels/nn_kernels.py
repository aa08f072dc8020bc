"""K1 — banded 1-NN — and K7 — brute-force 1-NN (CUDA sources:
``pcr_tpu_torch/csrc/band_nn.cu`` and ``pcr_tpu_torch/csrc/nn1.cu``).

K1 replaces ``pcr_tpu/ops/pallas/nn_kernels.py:nn1_band_pallas``.  Each tile
of ``q_tile`` sorted queries scans one contiguous slab of ``2*band`` sorted
reference rows starting at its element offset ``starts_el[tile]``; the result
is the exact squared distance of the nearest slab row and its ABSOLUTE sorted
row (first minimum on ties).

K7 replaces ``pcr_tpu/ops/pallas/nn_kernels.py:nn1_pallas``: for every query
the exact squared distance of the nearest row of the whole reference and that
row (first minimum on ties).  Masked refs are parked at PAD_COORD by the
caller, so the kernel takes no mask.

Bound on the H100: issue rate, ~10 ALU ops per (query, candidate) pair with
each candidate row read once per block from L2.  K1 stages the slab as
float4 rows in shared memory (one 16-byte load a row) and splits each
query's slab rows over several lanes by residue, so that the 10240-32768
queries of the main path fill the card's 132 SMs with warps; each thread
takes a few queries, so one shared load serves several pairs.  Each lane
keeps the first minimum of its rows and the lanes' minima merge by shuffles,
lexicographically on (d2, row): the slab's first minimum, as torch.min.
K7 gives each thread several queries (one shared load of a ref row serves
them all), folds each query's distances to a group of refs with a min and
records, once a group, the group that improved the running minimum; each
query's first minimum row is then re-scored within its recorded group.  The
ref rows are split over several blocks per query block (too few query blocks
would leave most SMs idle), staged through double-buffered shared memory, and
the partial minima merge in a second small kernel.  Unlike the TPU kernels
both compute d2 directly as (q - r)^2, so no re-score is needed for
precision.
"""

from __future__ import annotations

import torch

from . import build, common

LAUNCHES = {"nn1_band": 0, "nn1": 0}
# K7's geometry (csrc/nn1.cu's kThreads, kQueries, kGroup, kMinBlocks: its
# launch bounds hold the partial kernel to 64 registers, so 8 blocks fit an
# SM), the waves of resident blocks it fills and the fewest rows of a ref
# range; chosen on the H100 by tools/tune_nn1.py
NN1_THREADS = 128
NN1_QUERIES = 8
NN1_GROUP = 8
NN1_BLOCKS_PER_SM = 8
NN1_WAVES = 1
NN1_MIN_SPLIT_ROWS = 256


def nn1_band_reference(starts_el: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
                       *, q_tile: int, band: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: (d2 (nq_pad,) f32, row (nq_pad,) int32)."""
    n_tiles = starts_el.shape[0]
    d2 = common.sqdist_tiles(q.view(n_tiles, q_tile, 3), common.slabs(starts_el, r, band))
    dmin, best = torch.min(d2, dim=-1)
    rows = starts_el[:, None].to(torch.int32) + best.to(torch.int32)
    return dmin.reshape(-1), rows.reshape(-1)


def nn1_band(starts_el: torch.Tensor, q: torch.Tensor, r: torch.Tensor, *,
             q_tile: int, band: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Banded 1-NN of every sorted query in its tile's slab.

    starts_el: (n_tiles,) int32 slab start per tile (element offset);
    q: (n_tiles*q_tile, 3) f32 sorted queries; r: (nr_pad, 3) f32 sorted refs.
    Returns (d2 (nq_pad,) f32, absolute sorted row (nq_pad,) int32).
    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    n_tiles = starts_el.shape[0]
    common.check_tiling(q.shape[0], q_tile, n_tiles, band, r.shape[0])
    if not common.on_cuda(starts_el, q, r):
        return nn1_band_reference(starts_el, q, r, q_tile=q_tile, band=band)
    common.check(starts_el, "starts_el", torch.int32, (n_tiles,))
    common.check(q, "q", torch.float32, (n_tiles * q_tile, 3))
    common.check(r, "r", torch.float32, (r.shape[0], 3))
    nq_pad = n_tiles * q_tile
    out_d = torch.empty(nq_pad, dtype=torch.float32, device=q.device)
    out_row = torch.empty(nq_pad, dtype=torch.int32, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.pcr_nn1_band(starts_el.data_ptr(), q.data_ptr(), r.data_ptr(),
                               nq_pad, q_tile, band, out_d.data_ptr(),
                               out_row.data_ptr(), common.stream_of(q))
    build.check_launch("nn1_band", err)
    LAUNCHES["nn1_band"] += 1
    return out_d, out_row


def nn1_reference(q: torch.Tensor, r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7: (d2 (nq,) f32, row (nq,) int32), over
    groups of queries whose (group, nr) distance temporaries stay bounded."""
    nq, nr = q.shape[0], r.shape[0]
    d_out = torch.empty(nq, dtype=torch.float32, device=q.device)
    i_out = torch.empty(nq, dtype=torch.int32, device=q.device)
    for g in common.tile_groups(nq, nr, budget=1 << 24):
        dmin, best = torch.min(common.sqdist_tiles(q[None, g], r[None])[0], dim=-1)
        d_out[g] = dmin
        i_out[g] = best.to(torch.int32)
    return d_out, i_out


def nn1_slots(index: int) -> int:
    """K7's partial-kernel blocks resident on card ``index`` at once: its
    SMs times NN1_BLOCKS_PER_SM."""
    return torch.cuda.get_device_properties(index).multi_processor_count * NN1_BLOCKS_PER_SM


def nn1_splits(nq: int, nr: int, slots: int) -> int:
    """How many contiguous ref ranges K7 splits each query block's work into:
    as many as fill NN1_WAVES waves of the card's ``slots`` resident blocks
    without starting another, each range at least NN1_MIN_SPLIT_ROWS rows."""
    q_blocks = -(-nq // (NN1_THREADS * NN1_QUERIES))
    return max(1, min(NN1_WAVES * slots // q_blocks, nr // NN1_MIN_SPLIT_ROWS))


def nn1_split_rows(nr: int, splits: int) -> int:
    """Rows of each of K7's ref ranges (the last may hold fewer): whole
    groups of NN1_GROUP, as csrc/nn1.cu's launcher computes them."""
    rows = -(-nr // splits)
    return -(-rows // NN1_GROUP) * NN1_GROUP


def nn1(q: torch.Tensor, r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Brute-force nearest ref row of every query.

    q: (nq, 3) f32 queries; r: (nr, 3) f32 refs (masked rows parked at
    PAD_COORD by the caller), nr >= 1.  Returns (exact d2 (nq,) f32, row
    (nq,) int32), the first minimum on ties.  CPU tensors run the plain
    version; CUDA tensors launch the kernel.
    """
    if r.shape[0] < 1:
        raise ValueError("nn1 needs at least one ref row")
    if not common.on_cuda(q, r):
        return nn1_reference(q, r)
    common.check(q, "q", torch.float32, (q.shape[0], 3))
    common.check(r, "r", torch.float32, (r.shape[0], 3))
    nq, nr = q.shape[0], r.shape[0]
    out_d = torch.empty(nq, dtype=torch.float32, device=q.device)
    out_row = torch.empty(nq, dtype=torch.int32, device=q.device)
    if nq == 0:
        return out_d, out_row
    splits = nn1_splits(nq, nr, nn1_slots(q.device.index or 0))
    part_d = torch.empty(splits * nq, dtype=torch.float32, device=q.device)
    part_row = torch.empty(splits * nq, dtype=torch.int32, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.pcr_nn1(q.data_ptr(), r.data_ptr(), nq, nr, splits, part_d.data_ptr(),
                          part_row.data_ptr(), out_d.data_ptr(), out_row.data_ptr(),
                          common.stream_of(q))
    build.check_launch("nn1", err)
    LAUNCHES["nn1"] += 1
    return out_d, out_row
