"""K1 — banded 1-NN (CUDA source: ``pcr_tpu_torch/csrc/band_nn.cu``).

Replaces ``pcr_tpu/ops/pallas/nn_kernels.py:nn1_band_pallas``.  Each tile of
``q_tile`` sorted queries scans one contiguous slab of ``2*band`` sorted
reference rows starting at its element offset ``starts_el[tile]``; the result
is the exact squared distance of the nearest slab row and its ABSOLUTE sorted
row (first minimum on ties).

Bound on the H100: issue rate, ~10 ALU ops per (query, slab row) with each
slab row read once per block from L2.  The kernel keeps one query per thread
with its running minimum in registers and streams the slab through shared
memory in block-sized chunks, so the band width does not set the shared
memory size.  Unlike the TPU kernel it computes d2 directly as (q - r)^2, so
no re-score is needed for precision.
"""

from __future__ import annotations

import torch

from . import build, common

LAUNCHES = {"nn1_band": 0}


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
