"""K1 — banded 1-NN —, K7 — brute-force 1-NN —, K11 — mutual 1-NN in
feature space — and K13 — exact k-NN of 3-D points (CUDA sources:
``pcr_tpu_torch/csrc/band_nn.cu``, ``pcr_tpu_torch/csrc/nn1.cu``,
``pcr_tpu_torch/csrc/mutual_nn.cu`` and ``pcr_tpu_torch/csrc/knn.cu``).

K1 replaces ``pcr_tpu/ops/pallas/nn_kernels.py:nn1_band_pallas``.  Each tile
of ``q_tile`` sorted queries scans one contiguous slab of ``2*band`` sorted
reference rows starting at its element offset ``starts_el[tile]``; the result
is the exact squared distance of the nearest slab row and its ABSOLUTE sorted
row (first minimum on ties).  The starts come from ``slab_starts``, one
block a tile on the card (``ops/band_nn.slab_starts``' rule: the tile's
extent along the sweep axis, three binary searches in the refs' sorted axis
coordinates, the centred-slab choice); K10's ``gicp_move`` takes its starts
with the same device code.

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

K11 is not a Pallas kernel: it replaces the ``jax.lax.scan`` of
``pcr_tpu/ops/knn.py:nn1_mutual`` (FGR's mutual matching in 33-dim FPFH
space), which XLA compiles into one program.  Both directions come from one
sweep: for every (a-row, b-row) pair the expanded d2 of ``_chunk_sqdist``,
max((|a|^2 + |b|^2) - 2 a.b, 0), BIG where either row is masked, and for
each row and each column the smallest index among its minimal d2.  Each
thread keeps an 8 x 8 tile of 33-term dot products in registers (no
distance reaches memory); partial minima merge as uint64 keys (d2's bits
above the index) with an integer atomicMin, so the result does not depend
on the order of the blocks.  Its dot products are summed in another order
than the plain version's cuBLAS product, so on near-ties the two may pick
different rows, within the expanded form's rounding; on exact ties they
pick the same.
"""

from __future__ import annotations

import torch

from ...utils import trace
from ...utils.cloud import pad_rows
from . import build, common

LAUNCHES = {"nn1_band": 0, "slab_starts": 0, "nn1": 0, "nn1_mutual": 0, "knn_select": 0}
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
MUTUAL_DIM = 33        # K11's feature width (csrc/mutual_nn.cu's kDim): FPFH
KNN_MAX_K = 256        # the largest k K13 takes (csrc/knn.cu's kMaxK)
KNN_MIN_TILE = 64      # the fewest ref rows of a K13 tile at any geometry tools/tune_knn.py tries


def slab_limits(r: torch.Tensor, ra: torch.Tensor, axis: torch.Tensor,
                band: int) -> tuple[int, int]:
    """(nr, max_blk) of the sorted refs ``r`` (nr_pad, 3) f32 with their
    axis coordinates ``ra`` (nr,) f32 along the 0-dim int64 ``axis``: a slab
    starts at most max_blk bands in."""
    nr = ra.shape[0]
    common.check(ra, "ra", torch.float32, (nr,))
    common.check(axis, "axis", torch.int64, ())
    return nr, max(r.shape[0] // band - 2, 0)


def slab_starts_reference(q: torch.Tensor, r: torch.Tensor, ra: torch.Tensor,
                          axis: torch.Tensor, max_dist: float, *, q_tile: int,
                          band: int) -> torch.Tensor:
    """Plain PyTorch version of ``slab_starts``: the rule of
    ``ops/band_nn.slab_starts``."""
    n_tiles = q.shape[0] // q_tile
    qa = common.axis_coord(q, axis).view(n_tiles, q_tile)
    real = qa < common.SENTINEL / 2          # masked and padding rows sit at SENTINEL
    tile_min = qa.amin(dim=1)
    tile_max = torch.where(real, qa, -common.BIG).amax(dim=1)
    max_blk = max(r.shape[0] // band - 2, 0)
    ours = torch.clamp(torch.searchsorted(ra, tile_min - max_dist) // band, 0, max_blk) * band
    lo = torch.searchsorted(ra, tile_min)
    hi = torch.searchsorted(ra, tile_max, right=True)
    centred = torch.clamp((lo + hi) // 2 - band, 0, max_blk * band)

    def level_rows(start):
        return torch.clamp(torch.minimum(hi, start + 2 * band) - torch.maximum(lo, start), min=0)

    level = hi - lo
    centre = (level_rows(ours) < level) & (level_rows(centred) == level) & real.any(dim=1)
    return torch.where(centre, centred, ours).to(torch.int32)


def slab_starts(q: torch.Tensor, r: torch.Tensor, ra: torch.Tensor, axis: torch.Tensor,
                max_dist: float, *, q_tile: int, band: int) -> torch.Tensor:
    """Each query tile's slab start in the sorted refs ``r`` (nr_pad, 3) f32,
    whose axis coordinates along the 0-dim int64 ``axis`` are ``ra`` (nr,)
    f32, for the sorted queries ``q`` (n_tiles * q_tile, 3) f32, masked and
    padding rows at SENTINEL: (n_tiles,) int32, K1's ``starts_el``.  CPU
    tensors run the plain version; CUDA tensors launch the kernel."""
    rows = q.shape[0]
    n_tiles = rows // q_tile
    common.check_tiling(rows, q_tile, n_tiles, band, r.shape[0])
    if not common.on_cuda(q, r, ra, axis):
        return slab_starts_reference(q, r, ra, axis, max_dist, q_tile=q_tile, band=band)
    common.check(q, "q", torch.float32, (rows, 3))
    nr, max_blk = slab_limits(r, ra, axis, band)
    starts = torch.empty(n_tiles, dtype=torch.int32, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.pcr_slab_starts(q.data_ptr(), ra.data_ptr(), nr, axis.data_ptr(), n_tiles,
                                  q_tile, band, max_blk, max_dist, starts.data_ptr(),
                                  common.stream_of(q))
    build.check_launch("slab_starts", err)
    LAUNCHES["slab_starts"] += 1
    trace.shape("slab_starts", n_tiles, rows, nr, q_tile, band)
    return starts


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
    trace.shape("nn1_band", n_tiles, nq_pad, r.shape[0], q_tile, band)
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
    trace.shape("nn1", nq, nr)
    return out_d, out_row


def nn1_mutual_reference(a: torch.Tensor, a_mask: torch.Tensor, b: torch.Tensor,
                         b_mask: torch.Tensor, *, q_tile: int = 2048):
    """Plain PyTorch version of K11: one sweep over the (q_tile, Nb)
    distance tiles, each giving its rows' argmin (a->b) and updating a
    carried column minimum (b->a).

    Ties: the first index inside a tile, and a later tile replaces the
    carried column minimum only when strictly smaller.  Returns (ij (Na,),
    ji (Nb,)) int64; rows with no valid partner get index 0.
    """
    na, nb = a.shape[0], b.shape[0]
    na_pad = -(-na // q_tile) * q_tile
    ap = pad_rows(a, na_pad, 0.0)
    amask = pad_rows(a_mask, na_pad, False)
    col_d = torch.full((nb,), common.BIG, dtype=torch.float32, device=a.device)
    col_i = torch.zeros(nb, dtype=torch.int64, device=a.device)
    rows = []
    for t0 in range(0, na_pad, q_tile):
        d2 = common.chunk_sqdist(ap[t0:t0 + q_tile], b)
        d2 = torch.where(amask[t0:t0 + q_tile, None] & b_mask[None, :], d2, common.BIG)
        rows.append(torch.argmin(d2, dim=1))
        cmin, carg = torch.min(d2, dim=0)
        take = cmin < col_d
        col_d = torch.where(take, cmin, col_d)
        col_i = torch.where(take, carg + t0, col_i)
    return torch.cat(rows)[:na], col_i


def nn1_mutual(a: torch.Tensor, a_mask: torch.Tensor, b: torch.Tensor, b_mask: torch.Tensor,
               *, q_tile: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """Mutual nearest neighbours of a (na, D) and b (nb, D) f32 rows with
    bool masks: (ij (na,), ji (nb,)), the smallest index among the minimal
    expanded d2 of each row and of each column, 0 for a row with no valid
    partner.  CPU tensors run the plain version (over ``q_tile``-row tiles;
    int64 indices); CUDA tensors launch the kernel (int32 indices), which
    takes D = 33, the FPFH width."""
    na, nb = a.shape[0], b.shape[0]
    if na < 1 or nb < 1:
        raise ValueError(f"nn1_mutual needs rows on both sides, got {na} and {nb}")
    if not common.on_cuda(a, a_mask, b, b_mask):
        return nn1_mutual_reference(a, a_mask, b, b_mask, q_tile=q_tile)
    common.check(a, "a", torch.float32, (na, MUTUAL_DIM))
    common.check(b, "b", torch.float32, (nb, MUTUAL_DIM))
    common.check(a_mask, "a_mask", torch.bool, (na,))
    common.check(b_mask, "b_mask", torch.bool, (nb,))
    # the squared norms as the plain version computes them
    an = torch.sum(a * a, dim=-1)
    bn = torch.sum(b * b, dim=-1)
    row_key = torch.empty(na, dtype=torch.int64, device=a.device)
    col_key = torch.empty(nb, dtype=torch.int64, device=a.device)
    ij = torch.empty(na, dtype=torch.int32, device=a.device)
    ji = torch.empty(nb, dtype=torch.int32, device=a.device)
    lib = build.library()
    with torch.cuda.device(a.device):
        err = lib.pcr_nn1_mutual(a.data_ptr(), an.data_ptr(), a_mask.data_ptr(), na,
                                 b.data_ptr(), bn.data_ptr(), b_mask.data_ptr(), nb,
                                 row_key.data_ptr(), col_key.data_ptr(), ij.data_ptr(),
                                 ji.data_ptr(), common.stream_of(a))
    build.check_launch("nn1_mutual", err)
    LAUNCHES["nn1_mutual"] += 1
    trace.shape("nn1_mutual", na, nb)
    return ij, ji


def knn_select_reference(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor,
                         k: int, *, exclude_self: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K13, over groups of queries whose (group, nr)
    distance temporaries stay bounded: every d2 by the kernel's rounded
    formula, BIG for a masked ref and, with ``exclude_self``, for the
    query's own row; each row's k smallest (d2, index) keys (d2's bits above
    the index), ascending.  Slots past nr take (BIG, 0).  Returns (d2 (nq,
    k) f32, index (nq, k) int64)."""
    nq, nr = query.shape[0], ref.shape[0]
    kk = min(k, nr)
    d_out = torch.full((nq, k), common.BIG, dtype=torch.float32, device=query.device)
    i_out = torch.zeros((nq, k), dtype=torch.int64, device=query.device)
    col = torch.arange(nr, device=query.device)
    for g in common.tile_groups(nq, nr, budget=1 << 24):
        d2 = common.sqdist_tiles(query[None, g], ref[None])[0]
        drop = ~ref_mask[None, :]
        if exclude_self:
            drop = drop | (col[None, :] == torch.arange(g.start, g.stop,
                                                        device=query.device)[:, None])
        d2 = torch.where(drop, common.BIG, d2).contiguous()
        key = (d2.view(torch.int32).to(torch.int64) << 32) | col
        top = torch.topk(key, kk, dim=1, largest=False, sorted=True).values
        d_out[g, :kk] = (top >> 32).to(torch.int32).view(torch.float32)
        i_out[g, :kk] = top & 0xFFFFFFFF
    return d_out, i_out


def knn_select(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor, k: int, *,
               exclude_self: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest valid refs of every query row.

    query (nq, 3), ref (nr, 3) f32, ref_mask (nr,) bool, nr >= 1.  Returns
    (d2 (nq, k) f32, index (nq, k) int64): each row's k smallest (d2, index)
    keys, ascending, ties to the smaller index; with ``exclude_self`` a
    query's own row (index i for query i) never counts; slots past the
    valid refs hold BIG and the smallest indices among the masked refs and
    the query's own row, ascending.  It takes D = 3, float32 and
    1 <= k <= KNN_MAX_K and refuses anything else, on either device; then
    CPU tensors run the plain version and CUDA tensors launch the kernel.
    On the card the refs (and, unless ``query is ref``, the queries) are
    first ordered along a Morton curve in the valid refs' box.
    """
    nq, nr = query.shape[0], ref.shape[0]
    if nr < 1:
        raise ValueError("knn_select needs at least one ref row")
    common.check(query, "query", torch.float32, (nq, 3))
    common.check(ref, "ref", torch.float32, (nr, 3))
    common.check(ref_mask, "ref_mask", torch.bool, (nr,))
    if not 1 <= k <= KNN_MAX_K:
        raise ValueError(f"knn_select takes 1 <= k <= {KNN_MAX_K}, got {k}")
    if not common.on_cuda(query, ref, ref_mask):
        return knn_select_reference(query, ref, ref_mask, k, exclude_self=exclude_self)
    dev = query.device
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int64, device=dev)
    if nq == 0:
        return out_d, out_i
    self_order = query is ref
    lo_hi = torch.empty(6, dtype=torch.float32, device=dev)
    rcode = torch.empty(nr, dtype=torch.int32, device=dev)
    qcode = rcode if self_order else torch.empty(nq, dtype=torch.int32, device=dev)
    rows = torch.empty((nr, 4), dtype=torch.float32, device=dev)
    box = torch.empty(-(-nr // KNN_MIN_TILE) * 6, dtype=torch.float32, device=dev)
    lib = build.library()
    stream = common.stream_of(query)
    with torch.cuda.device(dev):
        err = lib.pcr_knn_morton(ref.data_ptr(), ref_mask.data_ptr(), nr,
                                 None if self_order else query.data_ptr(), nq,
                                 lo_hi.data_ptr(), rcode.data_ptr(), qcode.data_ptr(), stream)
        build.check_launch("knn_select", err)
        rperm = torch.argsort(rcode, stable=True)
        qperm = rperm if self_order else torch.argsort(qcode, stable=True)
        n_valid = ref_mask.sum(dtype=torch.int32)
        err = lib.pcr_knn_select(query.data_ptr(), qperm.data_ptr(), nq, ref.data_ptr(),
                                 rperm.data_ptr(), n_valid.data_ptr(), ref_mask.data_ptr(), nr,
                                 k, int(exclude_self), rows.data_ptr(), box.data_ptr(),
                                 out_d.data_ptr(), out_i.data_ptr(), stream)
    build.check_launch("knn_select", err)
    LAUNCHES["knn_select"] += 1
    trace.shape("knn_select", nq, nr, k)
    return out_d, out_i
