"""Fixed-shape, masked point-cloud containers (port of pcr_tpu/utils/cloud.py).

A ``Cloud`` is a padded (N, 3) float32 point tensor with an (N,) bool validity
mask.  Padded points are parked at the far-away ``PAD_COORD`` sentinel so
distance kernels never select them, and every kernel still consults the mask.
``stack_clouds`` makes a batched Cloud with a leading dimension B ((B, N, 3)
points, (B, N) mask), which ``cloud[b]`` indexes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Sentinel coordinate for padding: far enough that no real neighbour query can
# reach it, small enough to keep squared distances finite in float32.
PAD_COORD = 1.0e6

# Per-dataset bucket sizes: the smallest multiple of 256 that holds every scan.
BUCKETS = {"NCLT": 32768, "Facade": 90112, "Courtyard": 245760}


def round_up(n: int, multiple: int = 256) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass
class Cloud:
    """Padded point cloud: points (N, 3) f32, mask (N,) bool, optional attrs."""

    points: torch.Tensor
    mask: torch.Tensor
    normals: torch.Tensor | None = None      # (N, 3)
    covariances: torch.Tensor | None = None  # (N, 3, 3)

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def count(self) -> torch.Tensor:
        """Number of valid points (0-dim tensor on the cloud's device)."""
        return torch.sum(self.mask.to(torch.int32), dim=-1)

    def __getitem__(self, b: int) -> "Cloud":
        """Cloud b of a batched Cloud (leading dimension B)."""
        def take(x):
            return None if x is None else x[b]

        return Cloud(points=self.points[b], mask=self.mask[b], normals=take(self.normals),
                     covariances=take(self.covariances))


def _placement(device: torch.device | str | None) -> torch.device:
    """``device``, or the card when it is None; without a card the caller
    must ask for the CPU (no silent fallback)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build a cloud on the CPU")
    return torch.device("cuda")


def from_numpy(points: np.ndarray, capacity: int | None = None,
               device: torch.device | str | None = None) -> Cloud:
    """Pad host points (n, 3) to ``capacity`` (default: round_up(n)), on
    ``device`` (default: the CUDA card)."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    cap = capacity or round_up(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")
    pts = np.full((cap, 3), PAD_COORD, dtype=np.float32)
    pts[:n] = points
    mask = np.zeros((cap,), dtype=bool)
    mask[:n] = True
    return from_arrays(pts, mask, device=device)


def from_arrays(points, mask, normals=None, covariances=None,
                device: torch.device | str | None = None) -> Cloud:
    """Build a Cloud from the numpy leaves of a ``pcr_tpu`` Cloud (or any
    array-likes of the same shapes), placed on ``device`` (default: the CUDA
    card).  This is how state crosses between the two packages: the rows are
    taken as they are."""
    device = _placement(device)

    def put(x, dtype):
        if x is None:
            return None
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)   # a copy

    return Cloud(points=put(points, np.float32), mask=put(mask, bool),
                 normals=put(normals, np.float32),
                 covariances=put(covariances, np.float32))


def compact(c: Cloud, capacity: int) -> Cloud:
    """Permute valid points to the front and slice to a smaller capacity.

    When more than ``capacity`` points are valid, the survivors are a UNIFORM
    stride over the valid set (not a prefix), which keeps spatial coverage.
    ``capacity >= c.capacity`` is a no-op.
    """
    if capacity >= c.capacity:
        return c
    order = torch.argsort((~c.mask).to(torch.uint8), stable=True)  # valid first
    n_valid = c.count()
    ar = torch.arange(capacity, dtype=torch.int32, device=c.device)
    strided = torch.minimum(
        torch.floor(ar.to(torch.float32)
                    * (n_valid.to(torch.float32) / capacity)).to(torch.int32),
        torch.clamp(n_valid - 1, min=0),
    )
    idx = torch.where(n_valid > capacity, strided, ar)
    order = order[idx.long()]

    def take(x):
        return None if x is None else x[order]

    msk = c.mask[order]
    pts = torch.where(msk[:, None], c.points[order], PAD_COORD)
    return Cloud(points=pts, mask=msk, normals=take(c.normals),
                 covariances=take(c.covariances))


def pad_rows(x: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """Append rows filled with ``fill`` until ``x`` has ``rows`` rows."""
    if rows == x.shape[0]:
        return x
    return torch.cat([x, x.new_full((rows - x.shape[0],) + tuple(x.shape[1:]), fill)])


def pad_to(c: Cloud, capacity: int) -> Cloud:
    """Pad a cloud up to a larger capacity: appended slots get mask=False and
    PAD_COORD points (zeros for the other attributes)."""
    if capacity == c.capacity:
        return c
    if capacity < c.capacity:
        raise ValueError(f"pad_to({capacity}) below capacity {c.capacity}")

    def take(x, fill):
        return None if x is None else pad_rows(x, capacity, fill)

    return Cloud(points=take(c.points, PAD_COORD), mask=take(c.mask, False),
                 normals=take(c.normals, 0.0), covariances=take(c.covariances, 0.0))


def bucket_capacity(c: Cloud, granularity: int = 4096) -> int:
    """Tightest granularity-multiple capacity holding the cloud's valid points."""
    nv = int(c.count())
    return min(c.capacity, max(granularity, -(-nv // granularity) * granularity))


def plan_scale_caps(clouds: list[Cloud], scales: list[float],
                    bucket: int = 1024, margin: int = 64) -> tuple[int, ...]:
    """Host-side capacity planner for the multiscale pyramid: for each voxel
    scale count the occupied voxels of every cloud (the ops/voxel convention
    ``floor((p - min_valid) / v)``) and round the worst case plus ``margin``
    up to a ``bucket`` multiple, capped at the clouds' capacity."""
    full_cap = clouds[0].capacity
    valid_pts = [c.points.detach().cpu().numpy()[c.mask.detach().cpu().numpy()]
                 for c in clouds]
    caps = []
    for v in scales:
        worst = 0
        for pts in valid_pts:
            ijk = np.floor((pts - pts.min(axis=0)) / np.float32(v)).astype(np.int64)
            key = (ijk[:, 0] << 42) + (ijk[:, 1] << 21) + ijk[:, 2]
            worst = max(worst, int(np.unique(key).size))
        caps.append(min(-(-(worst + margin) // bucket) * bucket, full_cap))
    return tuple(caps)


def stack_clouds(clouds: list[Cloud]) -> Cloud:
    """Stack same-capacity clouds into a batched Cloud with leading dim B;
    an attribute is kept only when every cloud has it."""
    def stack(xs):
        return None if any(x is None for x in xs) else torch.stack(xs)

    return Cloud(points=torch.stack([c.points for c in clouds]),
                 mask=torch.stack([c.mask for c in clouds]),
                 normals=stack([c.normals for c in clouds]),
                 covariances=stack([c.covariances for c in clouds]))
