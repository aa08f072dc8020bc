"""Voxel-grid downsampling as sort + segment-mean (port of pcr_tpu/ops/voxel.py).

Voxel index = floor((p - min_valid) / voxel); output point = centroid of the
voxel's points, compacted to a masked prefix in lexicographic voxel order.
The JAX package's two-key ``lax.sort`` becomes one stable sort on a combined
int64 key, and its ``segment_sum`` a sorted-segment reduce, whose sums run in
a fixed order (no float atomics).
"""

from __future__ import annotations

import torch

from ..utils.cloud import Cloud, PAD_COORD

_AXIS_CELLS = 2**15          # (i, j) pack at 15 bits each, as in the JAX key
_IMAX = 2**31 - 1            # padding key: sorts last


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor,
                     voxel_size: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Downsample (N, 3) masked points; returns (points (N, 3), mask (N,)).

    The output occupies a prefix of the same shape (count = occupied voxels);
    padding is parked at PAD_COORD.
    """
    n = points.shape[0]
    dev = points.device
    v = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    pmin = torch.where(mask[:, None], points, 3e38).amin(dim=0)
    ijk = torch.floor((points - pmin) / v).to(torch.int32).clamp(0, _AXIS_CELLS - 1)
    key_hi = torch.where(mask, ijk[:, 0] * _AXIS_CELLS + ijk[:, 1], _IMAX).to(torch.int64)
    key_lo = torch.where(mask, ijk[:, 2], _IMAX).to(torch.int64)
    key = key_hi * 2**31 + key_lo          # lexicographic (hi, lo), < 2**62
    s_key, order = torch.sort(key, stable=True)
    s_pts = points[order]
    s_mask = mask[order]

    new_seg = torch.ones(n, dtype=torch.bool, device=dev)
    new_seg[1:] = s_key[1:] != s_key[:-1]
    new_seg &= s_mask
    seg_id = torch.cumsum(new_seg.to(torch.int64), dim=0) - 1
    seg_id = torch.where(s_mask, seg_id, n - 1)   # padding into the last bucket

    w = s_mask.to(torch.float32)
    lengths = torch.bincount(seg_id, minlength=n)
    sums = torch.segment_reduce(s_pts * w[:, None], "sum", lengths=lengths, axis=0)
    counts = torch.segment_reduce(w, "sum", lengths=lengths, axis=0)
    n_voxels = torch.sum(new_seg.to(torch.int64))
    out_mask = torch.arange(n, device=dev) < n_voxels
    means = torch.where((counts[:, None] > 0) & out_mask[:, None],
                        sums / torch.clamp(counts[:, None], min=1.0), PAD_COORD)
    return means, out_mask


def voxel_downsample_cloud(c: Cloud, voxel_size: float) -> Cloud:
    pts, mask = voxel_downsample(c.points, c.mask, voxel_size)
    return Cloud(points=pts, mask=mask)
