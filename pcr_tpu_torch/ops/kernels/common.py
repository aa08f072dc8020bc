"""Argument checks and the shared plain-version helpers of the kernel wrappers."""

from __future__ import annotations

import torch

REAL_D2_MAX = 1.0e10   # any query-candidate pair with d2 above this involves a sentinel
BIG = 3.0e38           # the d2 of a masked pair (ops/knn, ops/band_nn)
SENTINEL = 1.0e6       # the coordinates of a masked or padding row in the band sweep (ops/band_nn)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if the tensors are on a CUDA device, False if on the CPU; raises
    for anything else or for a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"tensors must all be on the CPU or on one CUDA device, got "
                     f"{[str(t.device) for t in tensors]}")


def axis_coord(pts: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """pts[:, axis] for a 0-dim device ``axis``, without a host sync."""
    return pts.gather(1, axis.view(1, 1).expand(pts.shape[0], 1))[:, 0]


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` has ``dtype``, ``shape`` and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_tiling(n_rows: int, q_tile: int, n_tiles: int, band: int,
                 nr_pad: int) -> None:
    """The launch geometry every slab kernel assumes (slab starts themselves
    come clipped to [0, nr_pad - 2*band] from their callers)."""
    if n_rows != n_tiles * q_tile:
        raise ValueError(f"{n_rows} query rows != {n_tiles} tiles x {q_tile}")
    if 2 * band > nr_pad:
        raise ValueError(f"slab of 2*{band} rows exceeds the {nr_pad} ref rows")


def slabs(starts_el: torch.Tensor, r: torch.Tensor, band: int) -> torch.Tensor:
    """(n_tiles, 2*band, 3) contiguous slab rows of the sorted refs."""
    rows = starts_el.long()[:, None] + torch.arange(2 * band, device=r.device)[None, :]
    return r[rows]


def sqdist_tiles(q: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    """(T, TQ, 3) x (T, S, 3) -> (T, TQ, S) squared distances as
    ((dx*dx + dy*dy) + dz*dz), one rounding per operation — the order the
    CUDA kernels use, so the two agree bit for bit."""
    d = None
    for a in range(3):
        diff = q[:, :, None, a] - slab[:, None, :, a]
        d = diff * diff if d is None else d + diff * diff
    return d


def chunk_sqdist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(Tq, D) x (C, D) -> (Tq, C) squared distances by the expanded
    formula, one matmul: max((|q|^2 + |r|^2) - 2 q.r, 0)."""
    qn = torch.sum(q * q, dim=-1, keepdim=True)
    rn = torch.sum(r * r, dim=-1)
    return torch.clamp(qn + rn[None, :] - 2.0 * (q @ r.T), min=0.0)


def tile_groups(n_tiles: int, tile_elems: int, budget: int = 1 << 22) -> list[slice]:
    """Consecutive groups of tiles whose (tiles, q_tile, slab) temporaries
    hold about ``budget`` elements: the plain versions loop over these rather
    than materialise every tile's pair temporaries at once."""
    step = max(1, budget // max(tile_elems, 1))
    return [slice(g, min(g + step, n_tiles)) for g in range(0, n_tiles, step)]


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
