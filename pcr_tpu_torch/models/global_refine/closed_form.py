"""Closed-form global refinement: SLERP, LUM, SLERP+LUM (port of
pcr_tpu/models/global_refine/closed_form.py).

The three circuit-refinement methods of the reference's stage 3:

  * ``slerp_adjust_quaternions`` / ``refine_slerp``: accumulate the relative
    quaternions forward and backward around the closed circuit and slerp the
    two estimates of each node's absolute rotation at t = i/n;
  * ``refine_lum``: Lu & Milios linear least squares on the rotated relative
    translations.  A^T A is tridiag(-1, 2, -1) (x) I_3, so the normal
    equations are solved by the Thomas algorithm in O(n) instead of the
    reference's dense inverse (the same solution);
  * ``refine_slerp_lum``: the SLERP-adjusted rotations rotate the LUM
    observations (the reference repository's own contribution).

Placement: the pipeline passes numpy, so on the main path these run on the
host in float64, exactly as in the JAX package (the reference's numbers need
f64: ~900-link f32 chains drift).  Torch tensors stay on their device in
their own dtype: the quaternion chain runs as a doubling scan
(``se3._inclusive_scan``, in place of ``jax.lax.associative_scan``) and the
Thomas solve as two sequential loops (in place of two ``lax.scan``s).
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import quaternion as quat
from ...utils import se3, trace


_host, _cat = se3._host, se3._cat


def _full(like, shape, value: float):
    """``shape`` filled with ``value`` in ``like``'s namespace, dtype and device."""
    if _host(like):
        return np.full(shape, value, like.dtype)
    return like.new_full(shape, value)


def _zeros3(like):
    return _full(like, (1, 3), 0.0)


# ---------------------------------------------------------------------------
# SLERP circuit adjustment
# ---------------------------------------------------------------------------

def slerp_adjust_quaternions(q_rel):
    """(n, 4) relative circuit quaternions -> (n, 4) adjusted absolute ones.

    Forward accumulation a_i = q_{i-1} * ... * q_0 (i = 1..n-1) and backward
    c_i = a_i * closure^-1; node i's absolute rotation is slerp(a_i, c_i,
    t = i/n), with the identity at node 0 (the reference's scheme).

    Numpy inputs take the sequential float64 host path (normalised each
    step, as in the JAX package); tensors take a doubling scan."""
    n = q_rel.shape[0]
    if _host(q_rel):
        q64 = np.asarray(q_rel, np.float64)
        fwd = np.empty_like(q64)
        acc = q64[0]
        fwd[0] = acc
        for i in range(1, n):
            acc = quat.qnormalize(quat.qmul(q64[i], acc))
            fwd[i] = acc
        a, q_closure = fwd[:-1], fwd[-1]
        c = quat.qmul(a, quat.qinv(q_closure)[None, :])
        adjusted = quat.slerp(a, c, np.arange(1, n, dtype=np.float64) / n)
        return np.concatenate([np.array([[1.0, 0.0, 0.0, 0.0]]), adjusted], axis=0)
    # fwd[i] = q_i * q_{i-1} * ... * q_0
    fwd = se3._inclusive_scan(q_rel, lambda a, b: quat.qmul(b, a))
    a, q_closure = fwd[:-1], fwd[-1]
    c = quat.qmul(a, quat.qinv(q_closure)[None, :])
    t = torch.arange(1, n, dtype=q_rel.dtype, device=q_rel.device) / n
    adjusted = quat.slerp(a, c, t)
    return torch.cat([quat.qidentity(q_rel.dtype, q_rel.device)[None], adjusted])


def _rel_quaternions(T_rel):
    """Relative rotations -> quaternions; float64 on the host."""
    R = se3.rot(T_rel)
    return quat.from_rotation_matrix(np.asarray(R, np.float64) if _host(T_rel) else R)


def _rotated_translations(R, T_rel):
    """Lb_i = R[i] @ t_i over the circuit's n relative poses."""
    einsum = np.einsum if _host(T_rel) else torch.einsum
    return einsum("nij,nj->ni", R[: T_rel.shape[0]], se3.trans(T_rel))


@trace.spanned("stage3.slerp")
def refine_slerp(T_rel):
    """The reference's ``reconstruir_Ts_para_origem_SLERP``: adjust rotations
    by circuit SLERP, then chain the raw translations with the adjusted
    rotations (node i holds the translation accumulated before step i).
    Returns (n, 4, 4) absolute poses, node 0 = identity."""
    n = T_rel.shape[0]
    R_adj = quat.as_rotation_matrix(slerp_adjust_quaternions(_rel_quaternions(T_rel)))
    rotated = _rotated_translations(R_adj, T_rel)              # R_adj[0] = I
    t_cum = se3._cumsum(rotated)
    return se3.make_pose(R_adj, _cat([_zeros3(t_cum), t_cum[: n - 1]]))


# ---------------------------------------------------------------------------
# LUM translation adjustment
# ---------------------------------------------------------------------------

def _thomas_block_tridiag(diag, rhs, weights=None):
    """Solve (A^T P A) X = rhs, A the circuit incidence operator.

    A^T P A is tridiagonal with diagonal (w_j + w_{j+1}) and off-diagonal
    -w_{j+1}, all scalar multiples of I_3, so the 3 coordinates decouple.
    diag: (m,) main-diagonal scalars; rhs: (m, 3).  Forward elimination and
    back substitution, sequential in O(m), for numpy and tensors alike."""
    m = rhs.shape[0]
    if weights is None:
        off = _full(rhs, (m - 1,), -1.0)
    else:
        off = -weights[1:m]
    cs, ds = [], []
    c_prev, d_prev = 0.0, 0.0 * rhs[0]
    for j in range(m):
        denom = diag[j] - (off[j - 1] * c_prev if j > 0 else 0.0)
        cj = off[j] / denom if j < m - 1 else 0.0
        dj = (rhs[j] - (off[j - 1] * d_prev if j > 0 else 0.0)) / denom
        cs.append(cj)
        ds.append(dj)
        c_prev, d_prev = cj, dj
    X = [None] * m
    X[m - 1] = ds[m - 1]
    for j in range(m - 2, -1, -1):
        X[j] = ds[j] - cs[j] * X[j + 1]
    return np.stack(X) if _host(rhs) else torch.stack(X)


def _as_weights(weights, like):
    if _host(like):
        return np.asarray(weights, dtype=like.dtype)
    return torch.as_tensor(weights, dtype=like.dtype, device=like.device)


def _lum_solve(T_rel, R_abs, weights=None):
    """Shared LUM core: observations Lb_i = R_abs[i] @ t_i, then the
    tridiagonal normal-equation solve.  R_abs[0] must be the identity.
    Returns (n-1, 3): the adjusted translations of nodes 1..n-1."""
    n = T_rel.shape[0]
    Lb = _rotated_translations(R_abs, T_rel)
    if weights is None:
        rhs = Lb[: n - 1] - Lb[1:]                           # A^T Lb
        return _thomas_block_tridiag(_full(rhs, (n - 1,), 2.0), rhs)
    w = _as_weights(weights, Lb)
    rhs = w[: n - 1, None] * Lb[: n - 1] - w[1:, None] * Lb[1:]
    return _thomas_block_tridiag(w[: n - 1] + w[1:], rhs, weights=w)


def lum_posterior_variance(T_rel, X, R_abs, weights=None) -> float:
    """A-posteriori variance factor sigma0^2 = V^T P V / 3 of the LUM solve
    (3 = the circuit's redundancy).  V from the tridiagonal structure, A
    never materialised: V_0 = Lb_0 - X_0, V_i = Lb_i - (X_i - X_{i-1}),
    V_{n-1} = Lb_{n-1} + X_{n-2}."""
    Lb = _rotated_translations(R_abs, T_rel)
    z = _zeros3(Lb)
    Xp = _cat([z, X, z])                                     # X_{-1} = X_{n-1} = 0
    V = Lb - (Xp[1:] - Xp[:-1])
    w = _full(Lb, (Lb.shape[0],), 1.0) if weights is None else _as_weights(weights, Lb)
    return float((w * (V * V).sum(-1)).sum() / 3.0)


@trace.spanned("stage3.lum")
def refine_lum(T_rel, weights=None, return_sigma0: bool = False):
    """The reference's ``reconstruir_Ts_para_origem_LUM`` (and its weighted
    variant): rotations by the plain reversed-order forward chain,
    translations by LUM least squares.  Returns (n, 4, 4) absolute poses;
    with ``return_sigma0`` the pair (poses, a-posteriori variance factor)."""
    R_abs = se3.chain_rotations_ref(se3.rot(T_rel))          # R_abs[0] = I
    X = _lum_solve(T_rel, R_abs, weights)
    poses = se3.make_pose(R_abs, _cat([_zeros3(X), X]))
    if return_sigma0:
        return poses, lum_posterior_variance(T_rel, X, R_abs, weights)
    return poses


@trace.spanned("stage3.slerp_lum")
def refine_slerp_lum(T_rel, weights=None):
    """The reference's ``reconstruir_Ts_para_origem_SLERP_LUM``: the
    SLERP-adjusted rotations rotate the LUM observations.  Returns (n, 4, 4)."""
    R_adj = quat.as_rotation_matrix(slerp_adjust_quaternions(_rel_quaternions(T_rel)))
    X = _lum_solve(T_rel, R_adj, weights)
    return se3.make_pose(R_adj, _cat([_zeros3(X), X]))
