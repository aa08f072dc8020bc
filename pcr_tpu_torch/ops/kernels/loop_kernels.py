"""K8 — FGR's 300-step graduated non-convexity — and K9 — the pose graph's
block-Thomas solve (CUDA source: ``pcr_tpu_torch/csrc/loops.cu``).

Neither replaces a Pallas kernel: each is the port's counterpart of one
``jax.lax.scan`` that ``pcr_tpu`` compiles, under ``jax.jit``, into one XLA
program.

K8 ``gnc`` replaces the scan of ``pcr_tpu/models/fgr.py:fgr_from_correspondences``
(the ``iteration_number`` steps at its line 166): per pair, over fixed,
normalised correspondences (p_k, q_k) with weights w_k, every step
  * every fourth step, mu <- mu / division_factor while mu > delta^2;
  * pt = T p, r = q - pt, l = (mu / (mu + |r|^2))^2 w;
  * H = sum l G^T G, g = sum l G^T r with G = [skew(pt) | -I];
  * H += 1e-6 (tr H / 6 + 1) I, xi = -H^-1 g by Cholesky (0 when the pair
    has fewer than 3 correspondences), T <- exp(xi) T.
K9 ``block_thomas`` replaces the two scans of
``pcr_tpu/models/global_refine/pose_graph.py:_block_thomas_solve`` (lines
173 and 180): forward elimination S = D_j - U_{j-1}^T C_{j-1},
[C_j | d_j] = S^-1 [U_j | rhs_j - U_{j-1}^T d_{j-1}], then back substitution
x_j = d_j - C_j x_{j+1}.

On the card the plain versions below are a Python loop of small launches:
~120 device events a GNC step (~36,000 a pair) and ~21 a Thomas step
(18,903 a solve at m = 900), so both are bound by the host's launches.
Neither loop reads the device, so each kernel runs its whole loop in one
launch.  What bounds them then is latency: every step depends on the last.
K8 takes one block a pair: it compacts the rows of nonzero weight once (in
shared memory where they fit; a masked row adds exact zeros), and each step
reduces the closed-form sums of G^T G (l, l pt, l pt pt^T: 10 sums) and of
G^T r (6) over the block in a fixed order, and one thread solves the 6x6
system and updates T.  K9 takes one warp: the 6x13 augmented step is
eliminated with partial pivoting (the largest |a| of the column, the first
on ties, as LAPACK's getrf) in shared memory, the next step's blocks are
loaded while this one is eliminated, and C_j, d_j go to global memory for
the back substitution in the same launch.  All arithmetic is float32, every
sum in a fixed order, so the same inputs give the same bits, run after run.

The plain versions are the loops the port ran before the kernels, moved
here unchanged: the CPU path and the oracle.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import se3, trace
from ...utils.linalg import solve6_cholesky
from . import build, common

LAUNCHES = {"gnc": 0, "block_thomas": 0}
GNC_ROW_FLOATS = 8     # a compacted row of K8's staging buffer: (p, w), (q, 0)


def gnc_reference(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor, mu0: float,
                  delta: torch.Tensor, enough: torch.Tensor, iteration_number: int,
                  division_factor: float, decrease_mu: bool) -> torch.Tensor:
    """Plain PyTorch version of K8: the GNC over normalised correspondences
    p, q (..., N, 3) with weights w (..., N); mu starts at ``mu0``, ``delta``
    (...) is the normalised stop scale, ``enough`` (...) whether a pair has
    at least 3 correspondences.  Returns the normalised poses (..., 4, 4)."""
    dev = p.device
    batch = w.shape[:-1]
    mu = torch.full(batch, mu0, dtype=torch.float32, device=dev)
    T = torch.eye(4, dtype=torch.float32, device=dev).expand(batch + (4, 4))
    minus_eye = (-torch.eye(3, dtype=torch.float32, device=dev)).expand(p.shape[:-1] + (3, 3))
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    enough = enough[..., None]

    for it in range(iteration_number):
        if decrease_mu and it % 4 == 0:
            mu = torch.where(mu > delta * delta, mu / division_factor, mu)
        pt = se3.transform_points(T, p)
        r = q - pt
        l = torch.square(mu[..., None] / (mu[..., None] + torch.sum(r * r, dim=-1))) * w
        G = torch.cat([se3.skew(pt), minus_eye], dim=-1)   # (..., N, 3, 6)
        lG = G * l[..., None, None]
        H = torch.einsum("...nij,...nik->...jk", lG, G)
        g = torch.einsum("...nij,...ni->...j", lG, r)
        trace = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
        H = H + (1e-6 * (trace / 6.0 + 1.0))[..., None, None] * eye6
        xi = torch.where(enough, -solve6_cholesky(H, g), 0.0)
        T = se3.compose(se3.se3_exp(xi), T)
    return T


def gnc(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor, mu0: float, delta: torch.Tensor,
        enough: torch.Tensor, iteration_number: int, division_factor: float,
        decrease_mu: bool) -> torch.Tensor:
    """FGR's GNC over fixed, normalised correspondences, one pair (p, q
    (N, 3), w (N,), delta and enough 0-dim) or a batch of B pairs (a leading
    B on each).  f32 p, q, w, delta; bool enough; all contiguous.  Returns
    the normalised poses, (4, 4) or (B, 4, 4).  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    batch = tuple(w.shape[:-1])
    if len(batch) > 1:
        raise ValueError(f"gnc takes one pair or one batch dimension, got w of {tuple(w.shape)}")
    n = w.shape[-1]
    common.check(p, "p", torch.float32, batch + (n, 3))
    common.check(q, "q", torch.float32, batch + (n, 3))
    common.check(w, "w", torch.float32, batch + (n,))
    common.check(delta, "delta", torch.float32, batch)
    common.check(enough, "enough", torch.bool, batch)
    if iteration_number < 0:
        raise ValueError(f"iteration_number must be >= 0, got {iteration_number}")
    if not common.on_cuda(p, q, w, delta, enough):
        return gnc_reference(p, q, w, mu0, delta, enough, iteration_number,
                             division_factor, decrease_mu)
    n_pairs = batch[0] if batch else 1
    out = torch.empty(batch + (4, 4), dtype=torch.float32, device=p.device)
    if n_pairs == 0:
        return out
    scratch = torch.empty((n_pairs, n, GNC_ROW_FLOATS), dtype=torch.float32, device=p.device)
    lib = build.library()
    with torch.cuda.device(p.device):
        err = lib.pcr_gnc(p.data_ptr(), q.data_ptr(), w.data_ptr(), delta.data_ptr(),
                          enough.data_ptr(), n_pairs, n, iteration_number, ctypes.c_float(mu0),
                          ctypes.c_float(division_factor), int(bool(decrease_mu)),
                          scratch.data_ptr(), out.data_ptr(), common.stream_of(p))
    build.check_launch("gnc", err)
    LAUNCHES["gnc"] += 1
    trace.shape("gnc", n_pairs, n, iteration_number)
    return out


def block_thomas_reference(D: torch.Tensor, U: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K9: solve the SPD block-tridiagonal system
    with diagonal blocks D (m, 6, 6), super-diagonal blocks U (m-1, 6, 6)
    (block j to j+1; the sub-diagonal is U^T) and rhs (m, 6).  Forward
    elimination and back substitution, one 6x7 solve a step: O(m), against
    the O(m^3) dense solve."""
    m = D.shape[0]
    C = D.new_zeros((6, 6))
    d = D.new_zeros(6)
    Cs, ds = [], []
    for j in range(m):
        if j > 0:
            L = U[j - 1].T                            # sub-diagonal block
            S, r = D[j] - L @ C, rhs[j] - L @ d
        else:
            S, r = D[0], rhs[0]
        B = torch.cat([U[j], r[:, None]], dim=1) if j < m - 1 else r[:, None]
        sol = torch.linalg.solve_ex(S, B)[0]          # no error check: no sync
        C, d = sol[:, :-1], sol[:, -1]
        Cs.append(C)
        ds.append(d)
    xs = [ds[m - 1]]
    for j in range(m - 2, -1, -1):
        xs.append(ds[j] - Cs[j] @ xs[-1])
    return torch.stack(xs[::-1])


def block_thomas(D: torch.Tensor, U: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The block-tridiagonal solve of ``block_thomas_reference``: f32,
    contiguous D (m, 6, 6), U (m-1, 6, 6) and rhs (m, 6), m >= 1.  Returns x
    (m, 6).  CPU tensors run the plain version; CUDA tensors launch the
    kernel."""
    m = D.shape[0] if D.dim() == 3 else -1
    if m < 1:
        raise ValueError(f"block_thomas needs D of shape (m, 6, 6), m >= 1, got {tuple(D.shape)}")
    common.check(D, "D", torch.float32, (m, 6, 6))
    common.check(U, "U", torch.float32, (m - 1, 6, 6))
    common.check(rhs, "rhs", torch.float32, (m, 6))
    if not common.on_cuda(D, U, rhs):
        return block_thomas_reference(D, U, rhs)
    x = torch.empty((m, 6), dtype=torch.float32, device=D.device)
    Cs = torch.empty((m, 6, 6), dtype=torch.float32, device=D.device)
    ds = torch.empty((m, 6), dtype=torch.float32, device=D.device)
    lib = build.library()
    with torch.cuda.device(D.device):
        err = lib.pcr_block_thomas(D.data_ptr(), U.data_ptr(), rhs.data_ptr(), m,
                                   Cs.data_ptr(), ds.data_ptr(), x.data_ptr(),
                                   common.stream_of(D))
    build.check_launch("block_thomas", err)
    LAUNCHES["block_thomas"] += 1
    trace.shape("block_thomas", m)
    return x
