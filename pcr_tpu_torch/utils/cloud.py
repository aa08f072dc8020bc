"""Fixed-shape, masked point-cloud containers (port of pcr_tpu/utils/cloud.py).

A ``Cloud`` is a padded (N, 3) float32 point tensor with an (N,) bool validity
mask.  Padded points are parked at the far-away ``PAD_COORD`` sentinel so
distance kernels never select them, and every kernel still consults the mask.
``stack_clouds`` makes a batched Cloud with a leading dimension B ((B, N, 3)
points, (B, N) mask), which ``cloud[b]`` indexes.

Loading: ``load_dataset`` reads a dataset's PCD scans (the threaded C++
reader of ``pcr_tpu_torch.native``, or ``utils/pcd`` without it) into clouds
on a device; ``load_dataset_host`` keeps them on the host as CPU tensors,
pinned when the target is a CUDA card; ``LazyClouds`` holds host clouds and
uploads a scan's valid rows on first use, keeping the most recent few on the
device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from . import trace

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
    colors: torch.Tensor | None = None       # (N, 3) in [0, 1]

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def count(self) -> torch.Tensor:
        """Number of valid points (0-dim tensor on the cloud's device)."""
        return torch.sum(self.mask.to(torch.int32), dim=-1)

    def with_(self, **kwargs) -> "Cloud":
        return replace(self, **kwargs)

    def masked_points(self) -> torch.Tensor:
        """Points with padding parked at the sentinel coordinate."""
        return torch.where(self.mask[..., None], self.points, PAD_COORD)

    def __getitem__(self, b: int) -> "Cloud":
        """Cloud b of a batched Cloud (leading dimension B)."""
        def take(x):
            return None if x is None else x[b]

        return Cloud(points=self.points[b], mask=self.mask[b], normals=take(self.normals),
                     covariances=take(self.covariances), colors=take(self.colors))


def _placement(device: torch.device | str | None) -> torch.device:
    """``device``, or the card when it is None; without a card the caller
    must ask for the CPU (no silent fallback)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build a cloud on the CPU")
    return torch.device("cuda")


def from_numpy(points: np.ndarray, capacity: int | None = None,
               colors: np.ndarray | None = None,
               device: torch.device | str | None = None) -> Cloud:
    """Pad host points (n, 3) [and colors (n, 3)] to ``capacity`` (default:
    round_up(n)), on ``device`` (default: the CUDA card)."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    cap = capacity or round_up(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")
    pts = np.full((cap, 3), PAD_COORD, dtype=np.float32)
    pts[:n] = points
    mask = np.zeros((cap,), dtype=bool)
    mask[:n] = True
    cols = None
    if colors is not None:
        cols = np.zeros((cap, 3), dtype=np.float32)
        cols[:n] = colors
    return from_arrays(pts, mask, colors=cols, device=device)


def from_arrays(points, mask, normals=None, covariances=None, colors=None,
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
                 covariances=put(covariances, np.float32), colors=put(colors, np.float32))


def load_cloud(path: str, capacity: int | None = None,
               device: torch.device | str | None = None) -> Cloud:
    """Read a PCD file into a padded Cloud on ``device`` (default: the CUDA
    card).  Uses the C++ reader (``pcr_tpu_torch.native``) when it is there
    and a capacity is given; the pure-Python parser otherwise."""
    from .. import native

    if capacity is not None and native.available():
        try:
            pts, mask, cols, _ = native.read_pcd_padded(path, capacity, PAD_COORD)
            return from_arrays(pts, mask, colors=cols, device=device)
        except RuntimeError:
            pass
    from . import pcd

    data = pcd.read_pcd(path)
    return from_numpy(data.points, capacity=capacity, colors=data.colors, device=device)


def available_indices(dataset: str) -> list[int]:
    """Scan indices whose PCD files exist (Courtyard ships 2 of its 8 scans)."""
    from . import poses_io

    return [i for i in range(poses_io.CIRCUIT_SIZES[dataset])
            if os.path.exists(poses_io.reference_cloud_path(dataset, i))]


def _scan_paths(dataset: str, indices) -> list[str]:
    """The PCD paths of ``indices`` (default: the whole circuit); a missing
    scan raises a FileNotFoundError that lists the indices on disk."""
    from . import poses_io

    if indices is None:
        indices = range(poses_io.CIRCUIT_SIZES[dataset])
    paths = [poses_io.reference_cloud_path(dataset, i) for i in indices]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"{dataset}: {len(missing)} of {len(paths)} requested scans are "
            f"not on disk (e.g. {os.path.basename(missing[0])}); available "
            f"indices: {available_indices(dataset)} — pass indices=[...]")
    return paths


def load_dataset_host(dataset: str, indices=None, capacity: int | None = None,
                      device: torch.device | str | None = None) -> list[Cloud]:
    """Parse a dataset's scans into host clouds padded to the dataset bucket
    (or ``capacity``): CPU tensors, with no device traffic, pinned when the
    target ``device`` (default: the CUDA card) is a card, so that uploads
    from them can be non-blocking.  The hot path is the native threaded batch
    reader; without it each scan goes through ``utils/pcd``."""
    from .. import native

    paths = _scan_paths(dataset, indices)
    pin = _placement(device).type == "cuda"
    cap = capacity or BUCKETS[dataset]

    def host(x):
        if x is None:
            return None
        t = torch.from_numpy(x)
        return t.pin_memory() if pin else t

    if native.available():
        try:
            pts, mask, cols, _ = native.read_pcd_batch_padded(paths, cap, PAD_COORD)
            pts, mask, cols = host(pts), host(mask), host(cols)
            return [Cloud(points=pts[b], mask=mask[b], colors=None if cols is None else cols[b])
                    for b in range(len(paths))]
        except RuntimeError:
            pass
    from . import pcd

    out = []
    for p in paths:
        data = pcd.read_pcd(p)
        n = len(data.points)
        if n > cap:
            raise ValueError(f"capacity {cap} < point count {n} ({p})")
        pts = np.full((cap, 3), PAD_COORD, np.float32)
        pts[:n] = data.points
        cols = None
        if data.colors is not None:
            cols = np.zeros((cap, 3), np.float32)
            cols[:n] = data.colors
        out.append(Cloud(points=host(pts), mask=host(np.arange(cap) < n), colors=host(cols)))
    return out


def _upload(h: Cloud, device: torch.device) -> Cloud:
    """Every row of a host cloud onto ``device`` (non-blocking from pinned
    memory)."""
    def put(x):
        return None if x is None else x.to(device, non_blocking=True)

    return Cloud(points=put(h.points), mask=put(h.mask), normals=put(h.normals),
                 covariances=put(h.covariances), colors=put(h.colors))


@trace.spanned("data.load")
def load_dataset(dataset: str, indices=None, capacity: int | None = None,
                 device: torch.device | str | None = None) -> list[Cloud]:
    """Load a dataset's scans padded to the dataset bucket (or ``capacity``)
    onto ``device`` (default: the CUDA card): ``load_dataset_host``, then one
    upload a scan.  Missing scans raise a FileNotFoundError that lists what
    is on disk instead of failing mid-parse."""
    host = load_dataset_host(dataset, indices, capacity, device=device)
    place = _placement(device)
    return [_upload(h, place) for h in host]


def _upload_prefix(h: Cloud, device: torch.device, granularity: int = 2048) -> Cloud:
    """Upload a host cloud's VALID rows only and re-pad on the device.

    The loaders put the valid rows first, so an NCLT scan (~21k valid rows in
    the 32768 bucket) ships ~2/3 of its rows and no mask: the mask is
    ``arange < n_valid`` on the device.  The prefix rounds up to
    ``granularity`` rows (host PAD_COORD rows, masked off); points re-pad to
    PAD_COORD, the other attributes to zero, as the loaders pad them, so the
    result equals the full upload.  A host cloud whose mask has interior
    holes takes the full upload.  The host rows are views of the host cloud,
    which the caller keeps, and pinned blocks are not reused while a copy
    from them is in flight, so a non-blocking copy never reads freed or
    rewritten memory."""
    n_valid = int(h.mask.sum())
    if n_valid and not bool(h.mask[:n_valid].all()):
        return _upload(h, device)
    cap = h.capacity
    rows = min(cap, round_up(max(n_valid, 1), granularity))

    def put(x, fill):
        if x is None:
            return None
        return pad_rows(x[:rows].to(device, non_blocking=True), cap, fill)

    return Cloud(points=put(h.points, PAD_COORD),
                 mask=torch.arange(cap, device=device) < n_valid,
                 normals=put(h.normals, 0.0), covariances=put(h.covariances, 0.0),
                 colors=put(h.colors, 0.0))


class LazyClouds:
    """Host-resident dataset with lazy per-scan upload (a sliding LRU).

    ``load_dataset`` uploads every padded scan up front (~380 MB for the 901
    NCLT scans at the 32768 bucket) before any compute.  This container keeps
    the dataset on the host and uploads a scan's valid rows on its first
    ``[i]`` (``_upload_prefix``, non-blocking), keeping the ``keep`` most
    recently used on ``device`` (default: the CUDA card): the circuit runners
    touch scans in a sliding window, so uploads stream inside the compute
    loop.  Iteration yields the HOST clouds, which ``bucket_capacity`` reads
    with no device traffic and ``plan_scale_caps`` uploads to its own buffer,
    outside the LRU; indexing returns device clouds for the compute path.
    """

    def __init__(self, host_clouds: list[Cloud], keep: int = 8,
                 device: torch.device | str | None = None):
        self._host = host_clouds
        self._keep = max(int(keep), 2)
        self._device = _placement(device)
        self._cache: dict[int, Cloud] = {}
        self._order: list[int] = []

    def __len__(self) -> int:
        return len(self._host)

    @property
    def device(self) -> torch.device:
        """The device that ``[i]`` uploads to."""
        return self._device

    def __iter__(self):
        return iter(self._host)

    def host(self, i: int) -> Cloud:
        return self._host[i]

    def __getitem__(self, i: int) -> Cloud:
        i = int(i)
        if i in self._cache:
            self._order.remove(i)
            self._order.append(i)
            return self._cache[i]
        dev = _upload_prefix(self._host[i], self._device)
        self._cache[i] = dev
        self._order.append(i)
        while len(self._order) > self._keep:
            del self._cache[self._order.pop(0)]
        return dev


def load_dataset_lazy(dataset: str, indices=None, capacity: int | None = None,
                      keep: int = 8, device: torch.device | str | None = None) -> LazyClouds:
    """Host-parse the dataset and wrap it in a LazyClouds streamer."""
    return LazyClouds(load_dataset_host(dataset, indices, capacity, device=device), keep=keep,
                      device=device)


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
                 covariances=take(c.covariances), colors=take(c.colors))


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
                 normals=take(c.normals, 0.0), covariances=take(c.covariances, 0.0),
                 colors=take(c.colors, 0.0))


def bucket_capacity(c: Cloud, granularity: int = 4096) -> int:
    """Tightest granularity-multiple capacity holding the cloud's valid points.
    A host cloud (CPU tensors, as LazyClouds iterates) is read on the host,
    with no device sync."""
    nv = int(c.count())
    return min(c.capacity, max(granularity, -(-nv // granularity) * granularity))


def plan_scale_caps(clouds, scales: list[float], bucket: int = 1024,
                    margin: int = 64) -> tuple[int, ...]:
    """Capacity planner for the multiscale pyramid: for each voxel scale
    count the occupied voxels of every cloud (the ops/voxel convention
    ``floor((p - min_valid) / v)``) and round the worst case plus ``margin``
    up to a ``bucket`` multiple, capped at the clouds' capacity.

    The counts are taken where the clouds live.  Clouds on a CUDA card, and
    a ``LazyClouds`` whose device is one, are counted there by
    ``feature_kernels.voxel_counts`` (one launch a chunk of clouds) and read
    back as one (clouds, scales) table: no cloud is copied to the host, and a
    LazyClouds' scans are uploaded chunk by chunk into one reused buffer,
    outside its LRU.  CPU clouds are counted on the host, in the native
    library when it is there, else in numpy.  Both routes give the same
    counts, so the same caps."""
    first = next(iter(clouds))   # never uploads a LazyClouds scan
    device = clouds.device if isinstance(clouds, LazyClouds) else first.device
    route = "card" if device.type == "cuda" else "host"
    with trace.span("data.plan_caps", route=route, clouds=len(clouds)):
        counts = (_card_counts(clouds, scales) if route == "card"
                  else _host_counts(clouds, scales))
        return tuple(min(-(-(int(worst) + margin) // bucket) * bucket, first.capacity)
                     for worst in counts.max(axis=0))


def _host_counts(clouds, scales: list[float]) -> np.ndarray:
    """(clouds, scales) occupied-voxel counts on the host: every cloud read
    as it is (a copy from its device), then one native count (or numpy's
    unique) a (cloud, scale)."""
    from .. import native

    use_native = native.available()
    valid_pts = [c.points.detach().cpu().numpy()[c.mask.detach().cpu().numpy()]
                 for c in clouds]
    counts = np.zeros((len(valid_pts), len(scales)), dtype=np.int64)
    for s, v in enumerate(scales):
        for k, pts in enumerate(valid_pts):
            if use_native:
                counts[k, s] = native.count_voxels(pts, v)
            else:
                ijk = np.floor((pts - pts.min(axis=0)) / np.float32(v)).astype(np.int64)
                key = (ijk[:, 0] << 42) + (ijk[:, 1] << 21) + ijk[:, 2]
                counts[k, s] = int(np.unique(key).size)
    return counts


def _valid_rows(h: Cloud) -> torch.Tensor:
    """A host cloud's valid points: a view of its prefix when the mask is
    one (as the loaders give it), else a gather."""
    n_valid = int(h.mask.sum())
    if bool(h.mask[:n_valid].all()):
        return h.points[:n_valid]
    return h.points[h.mask]


def _card_counts(clouds, scales: list[float]) -> np.ndarray:
    """(clouds, scales) occupied-voxel counts on the card (see
    ``plan_scale_caps``), with one blocking read of the table."""
    from ..ops.kernels import feature_kernels

    if isinstance(clouds, LazyClouds):
        host = list(clouds)
        cap = max(h.capacity for h in host)
        chunks = feature_kernels.voxel_chunks(len(host), cap, len(scales))
        most = max(c.stop - c.start for c in chunks)
        buf = torch.empty((most * cap, 3), dtype=torch.float32, device=clouds.device)
        tables = []
        for c in chunks:
            # the stream orders these copies after the previous chunk's launch
            views, off = [], 0
            for h in host[c]:
                rows = _valid_rows(h)
                views.append(buf[off:off + rows.shape[0]])
                views[-1].copy_(rows, non_blocking=True)
                off += rows.shape[0]
            tables.append(feature_kernels.voxel_counts(views, [None] * len(views), scales))
        table = torch.cat(tables)
    else:
        table = feature_kernels.voxel_counts([c.points.contiguous() for c in clouds],
                                             [c.mask.contiguous() for c in clouds], scales)
    with trace.span("sync", site="plan_caps"):
        return table.cpu().numpy()


def stack_clouds(clouds: list[Cloud]) -> Cloud:
    """Stack same-capacity clouds into a batched Cloud with leading dim B;
    an attribute is kept only when every cloud has it."""
    def stack(xs):
        return None if any(x is None for x in xs) else torch.stack(xs)

    return Cloud(points=torch.stack([c.points for c in clouds]),
                 mask=torch.stack([c.mask for c in clouds]),
                 normals=stack([c.normals for c in clouds]),
                 covariances=stack([c.covariances for c in clouds]),
                 colors=stack([c.colors for c in clouds]))
