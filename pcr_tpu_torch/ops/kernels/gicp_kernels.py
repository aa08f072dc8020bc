"""K10 — the band GICP's Gauss-Newton iteration around K1 (CUDA source:
``pcr_tpu_torch/csrc/gicp.cu``).

Not a Pallas kernel: K10 is the port's counterpart of the body of the
``jax.lax.while_loop`` of ``pcr_tpu/models/gicp.py:_gicp_band_sorted``, which
``pcr_tpu`` compiles into one XLA program.  ``models/gicp._gicp_band_sorted``
runs one iteration as

  1. ``gicp_move``: the sorted source rows moved by T, masked rows at
     SENTINEL (``q_sp``), and each query tile's slab start by the rule of
     ``ops/band_nn.slab_starts`` (with the device code of
     ``nn_kernels.slab_starts``, which it equals bit for bit);
  2. K1 (``nn_kernels.nn1_band``): each row's nearest slab row;
  3. ``gicp_rows``: per row the packed target gather, d, d2, valid, the
     plane-disk metric M = (2I - a(m m^T + u u^T))^-1 with u = R n_p, the
     robust weight and G = [skew(p) | -I]; summed into rows of 30 sums
     (``SUMS``);
  4. with a process group, the rows summed into one and the group's
     all-reduce of it;
  5. ``gicp_update``: the rows merged, fitness and rmse, H damped by
     1e-6 (tr H / 6 + 1), the 6x6 Cholesky solve (xi = 0 without a
     correspondence), T <- exp(xi) T and Open3D's convergence test against
     the previous fitness and rmse, written in place to T and ``state``.

The host reads ``state[3]``, the done flag, once an iteration.  On the card
the iteration is four launches (``gicp_move``, K1, ``gicp_rows``,
``gicp_update``) where the plain versions below issue ~275: their bodies are
the loop's former ``corr_step`` and ``step`` split at the same seams, the CPU
path and the oracle.
"""

from __future__ import annotations

import torch

from ...utils import se3, trace
from ...utils.linalg import solve6_cholesky
from . import build, common, nn_kernels
from .common import BIG, SENTINEL

LAUNCHES = {"gicp_move": 0, "gicp_rows": 0, "gicp_update": 0}
# One row of sums: H on and below the diagonal (row by row, as
# torch.tril_indices(6, 6)), g, n_corr, n_src, sum of the valid d2; padded
# with zeros to ROW_FLOATS.  The counts are whole numbers, exact in float32.
SUMS = 30
ROW_FLOATS = 32
LOSSES = {"l2": 0, "l1": 1, "gm": 2}


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(det.abs() > 1e-30, det, 1e-30)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], dim=-1),
            torch.stack([A21, A22, A23], dim=-1),
            torch.stack([A31, A32, A33], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def robust_weight(loss: str, r: torch.Tensor, k: float) -> torch.Tensor:
    """Robust-kernel weight as a function of the euclidean residual norm."""
    if loss == "l2":
        return torch.ones_like(r)
    if loss == "l1":
        return 1.0 / torch.clamp(r, min=1e-8)
    if loss == "gm":  # Geman-McClure, Open3D GMLoss(k)
        return k / torch.square(k + r * r)
    raise ValueError(f"unknown loss {loss!r}")


def initial_state(device) -> torch.Tensor:
    """The loop's state before its first iteration: [fitness, rmse, n_corr,
    done] with fitness and rmse at -1 (Open3D's first test always fails)."""
    return torch.tensor([-1.0, -1.0, 0.0, 0.0], dtype=torch.float32, device=device)


def gicp_move_reference(T: torch.Tensor, pts: torch.Tensor, mask: torch.Tensor, index,
                        max_dist: float, *, q_tile: int,
                        band: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``gicp_move``."""
    q_sp = torch.where(mask[:, None], se3.transform_points(T, pts), SENTINEL).contiguous()
    return q_sp, nn_kernels.slab_starts_reference(q_sp, index.r_sorted, index.ra_sorted,
                                                  index.axis, max_dist, q_tile=q_tile,
                                                  band=band)


def gicp_move(T: torch.Tensor, pts: torch.Tensor, mask: torch.Tensor, index, max_dist: float,
              *, q_tile: int, band: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The sorted source rows ``pts`` (n_tiles * q_tile, 3) f32 with ``mask``
    (same rows) moved by the pose T (4, 4), masked rows at SENTINEL, and each
    query tile's slab start in the sorted refs of ``index`` (an
    ``ops/band_nn.BandIndex``) at ``max_dist`` (``nn_kernels.slab_starts``).
    Returns (q_sp (rows, 3) f32, starts (n_tiles,) int32).  CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    rows = pts.shape[0]
    n_tiles = rows // q_tile
    common.check_tiling(rows, q_tile, n_tiles, band, index.r_sorted.shape[0])
    if not common.on_cuda(T, pts, mask, index.ra_sorted, index.axis):
        return gicp_move_reference(T, pts, mask, index, max_dist, q_tile=q_tile, band=band)
    common.check(T, "T", torch.float32, (4, 4))
    common.check(pts, "pts", torch.float32, (rows, 3))
    common.check(mask, "mask", torch.bool, (rows,))
    nr, max_blk = nn_kernels.slab_limits(index.r_sorted, index.ra_sorted, index.axis, band)
    q_sp = torch.empty((rows, 3), dtype=torch.float32, device=pts.device)
    starts = torch.empty(n_tiles, dtype=torch.int32, device=pts.device)
    lib = build.library()
    with torch.cuda.device(pts.device):
        err = lib.pcr_gicp_move(T.data_ptr(), pts.data_ptr(), mask.data_ptr(),
                                index.ra_sorted.data_ptr(), nr, index.axis.data_ptr(), n_tiles,
                                q_tile, band, max_blk, max_dist, q_sp.data_ptr(),
                                starts.data_ptr(), common.stream_of(pts))
    build.check_launch("gicp_move", err)
    LAUNCHES["gicp_move"] += 1
    trace.shape("gicp_move", n_tiles, rows, nr, q_tile, band)
    return q_sp, starts


def gicp_rows_reference(q_sp: torch.Tensor, normals: torch.Tensor, mask: torch.Tensor,
                        d2: torch.Tensor, rows: torch.Tensor, tgt_pack: torch.Tensor,
                        T: torch.Tensor, *, nr: int, max_d2: float, a: float, loss: str,
                        gm_k: float) -> torch.Tensor:
    """Plain PyTorch version of ``gicp_rows``: one row of sums, (1, ROW_FLOATS)."""
    i_s = torch.clamp(rows.long(), 0, nr - 1)
    d2a = torch.where(d2 <= max_d2, d2, BIG)
    p = q_sp
    pack = tgt_pack[i_s]                                  # (N, 8) one gather
    q, m = pack[:, :3], pack[:, 3:6]
    d = q - p
    d2 = torch.sum(d * d, dim=1)
    valid = mask & (d2a < BIG) & (d2 <= max_d2)
    eye3 = torch.eye(3, dtype=torch.float32, device=p.device)
    u = normals @ T[:3, :3].T                             # R n_p
    C = 2.0 * eye3 - a * (m[:, :, None] * m[:, None, :] + u[:, :, None] * u[:, None, :])
    M = inv3(C)
    r_norm = torch.sqrt(torch.clamp(d2, min=1e-16))
    w = robust_weight(loss, r_norm, gm_k) * valid.to(torch.float32)
    G = torch.cat([se3.skew(p), (-eye3).expand(p.shape[0], 3, 3)], dim=-1)   # (N, 3, 6)
    MG = M @ G
    wG = G * w[:, None, None]
    H = torch.einsum("nij,nik->jk", wG, MG)
    g = torch.einsum("nij,ni->j", wG, (M @ d[:, :, None])[:, :, 0])
    r, c = torch.tril_indices(6, 6, device=p.device)
    metrics = torch.stack([torch.sum(valid.to(torch.float32)),
                           torch.sum(mask.to(torch.float32)),
                           torch.sum(torch.where(valid, d2, 0.0))])
    pad = torch.zeros(ROW_FLOATS - SUMS, dtype=torch.float32, device=p.device)
    return torch.cat([H[r, c], g, metrics, pad])[None]


def gicp_rows(q_sp: torch.Tensor, normals: torch.Tensor, mask: torch.Tensor, d2: torch.Tensor,
              rows: torch.Tensor, tgt_pack: torch.Tensor, T: torch.Tensor, *, nr: int,
              max_d2: float, a: float, loss: str, gm_k: float) -> torch.Tensor:
    """The sums of the normal equations and of the metrics over the sorted
    rows at the pose T (4, 4): ``q_sp``, ``normals`` (rows, 3) f32 and
    ``mask`` (rows,) bool of the source, K1's ``d2`` (rows,) f32 and slab
    ``rows`` (rows,) int32, the packed sorted target ``tgt_pack`` (nr_pad, 8)
    [q | n | 0 0] of which the first ``nr`` rows are real; correspondences
    within ``max_d2``, the plane-disk covariances' ``a`` = 1 - eps, weighted
    by ``loss`` ('l2', 'l1', 'gm' with ``gm_k``).  Returns rows of sums
    (n, ROW_FLOATS) f32 whose sum is the iteration's: one a block of the
    kernel, one for the plain version.  CPU tensors run the plain version;
    CUDA tensors launch the kernel."""
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}")
    n = q_sp.shape[0]
    if not common.on_cuda(q_sp, normals, mask, d2, rows, tgt_pack, T):
        return gicp_rows_reference(q_sp, normals, mask, d2, rows, tgt_pack, T, nr=nr,
                                   max_d2=max_d2, a=a, loss=loss, gm_k=gm_k)
    common.check(q_sp, "q_sp", torch.float32, (n, 3))
    common.check(normals, "normals", torch.float32, (n, 3))
    common.check(mask, "mask", torch.bool, (n,))
    common.check(d2, "d2", torch.float32, (n,))
    common.check(rows, "rows", torch.int32, (n,))
    common.check(tgt_pack, "tgt_pack", torch.float32, (tgt_pack.shape[0], 8))
    common.check(T, "T", torch.float32, (4, 4))
    if not 1 <= nr <= tgt_pack.shape[0]:
        raise ValueError(f"nr {nr} outside the {tgt_pack.shape[0]} packed target rows")
    lib = build.library()
    out = torch.empty((lib.pcr_gicp_rows_blocks(n), ROW_FLOATS), dtype=torch.float32,
                      device=q_sp.device)
    with torch.cuda.device(q_sp.device):
        err = lib.pcr_gicp_rows(q_sp.data_ptr(), normals.data_ptr(), mask.data_ptr(),
                                d2.data_ptr(), rows.data_ptr(), tgt_pack.data_ptr(),
                                T.data_ptr(), n, nr, max_d2, LOSSES[loss], gm_k, a,
                                out.data_ptr(), common.stream_of(q_sp))
    build.check_launch("gicp_rows", err)
    LAUNCHES["gicp_rows"] += 1
    trace.shape("gicp_rows", n, tgt_pack.shape[0])
    return out


def _check_sums(sums: torch.Tensor) -> None:
    if sums.dim() != 2 or sums.shape[0] < 1:
        raise ValueError(f"sums must be (n >= 1, {ROW_FLOATS}), got {tuple(sums.shape)}")
    common.check(sums, "sums", torch.float32, (sums.shape[0], ROW_FLOATS))


def gicp_update_reference(sums: torch.Tensor, T: torch.Tensor, state: torch.Tensor,
                          relative_fitness: float, relative_rmse: float) -> None:
    """Plain PyTorch version of ``gicp_update`` (T and state in place)."""
    s = sums.sum(dim=0)
    r, c = torch.tril_indices(6, 6, device=s.device)
    H = torch.zeros((6, 6), dtype=torch.float32, device=s.device)
    H[r, c] = s[:21]
    H[c, r] = s[:21]
    g = s[21:27]
    n_corr, n_src, sum_d2 = s[27], s[28], s[29]
    fitness = n_corr / torch.clamp(n_src, min=1.0)
    rmse = torch.sqrt(sum_d2 / torch.clamp(n_corr, min=1.0))
    H = H + 1e-6 * (torch.trace(H) / 6.0 + 1.0) * torch.eye(6, dtype=H.dtype, device=H.device)
    xi = torch.where(n_corr > 0, -solve6_cholesky(H, g), 0.0)
    done = ((((fitness - state[0]).abs() < relative_fitness)
             & ((rmse - state[1]).abs() < relative_rmse)) | (n_corr == 0))
    T.copy_(se3.compose(se3.se3_exp(xi), T))
    state.copy_(torch.stack([fitness, rmse, n_corr, done.to(torch.float32)]))


def gicp_update(sums: torch.Tensor, T: torch.Tensor, state: torch.Tensor,
                relative_fitness: float, relative_rmse: float) -> None:
    """One Gauss-Newton update from the rows of sums (n, ROW_FLOATS) f32 of
    ``gicp_rows`` (or one merged, all-reduced row): T (4, 4) f32 becomes
    exp(xi) T and ``state`` (4,) f32, [fitness, rmse, n_corr, done] of the
    previous iteration on entry (``initial_state`` before the first), those
    of this one, measured at the pose T had on entry; done is Open3D's test,
    or no correspondence.  Both in place.  CPU tensors run the plain version;
    CUDA tensors launch the kernel."""
    _check_sums(sums)
    common.check(T, "T", torch.float32, (4, 4))
    common.check(state, "state", torch.float32, (4,))
    if not common.on_cuda(sums, T, state):
        return gicp_update_reference(sums, T, state, relative_fitness, relative_rmse)
    lib = build.library()
    with torch.cuda.device(T.device):
        err = lib.pcr_gicp_update(sums.data_ptr(), sums.shape[0], T.data_ptr(), state.data_ptr(),
                                  relative_fitness, relative_rmse, common.stream_of(T))
    build.check_launch("gicp_update", err)
    LAUNCHES["gicp_update"] += 1
    trace.shape("gicp_update", sums.shape[0])
