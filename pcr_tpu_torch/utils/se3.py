"""SE(3) / SO(3) utilities (port of pcr_tpu/utils/se3.py).

Same conventions as the JAX package:
  * twists are ordered (omega[3], t[3]) — rotation first;
  * ``compose_ref`` is the reference's nonstandard composition
    (R20 = R21 @ R10, t20 = R10 t21 + t10);
  * ``relative_to_absolute`` chains rotations in reversed order, prepends the
    identity and drops the final loop-closure pose.

Host numpy inputs run in float64 (pose chains of ~900 links need it); torch
inputs stay on their device in their own dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(*arrays) -> bool:
    """True iff every input is a host numpy array (float64 path)."""
    return all(isinstance(a, np.ndarray) for a in arrays)


# ---------------------------------------------------------------------------
# Basic pose algebra
# ---------------------------------------------------------------------------

def make_pose(R, t):
    """Assemble (..., 4, 4) homogeneous poses from (..., 3, 3) R and (..., 3) t."""
    if _host(R, t):
        batch = np.broadcast_shapes(R.shape[:-2], t.shape[:-1])
        out = np.zeros(batch + (4, 4), np.result_type(R, t))
    else:
        batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
        out = R.new_zeros(batch + (4, 4))
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def rot(T):
    return T[..., :3, :3]


def trans(T):
    return T[..., :3, 3]


def _matvec(M, v):
    """(..., 3, 3) @ (..., 3) -> (..., 3) for numpy or torch."""
    return (M @ v[..., None])[..., 0]


def invert(T):
    """Closed-form SE(3) inverse."""
    R_inv = rot(T).swapaxes(-1, -2) if _host(T) else rot(T).transpose(-1, -2)
    return make_pose(R_inv, -_matvec(R_inv, trans(T)))


def compose(T_a, T_b):
    """Standard composition T_a @ T_b."""
    return T_a @ T_b


def compose_ref(T21, T10):
    """The reference's nonstandard composition: R20 = R21 @ R10 (reversed
    w.r.t. the standard convention) while t20 = R10 @ t21 + t10."""
    return make_pose(rot(T21) @ rot(T10), _matvec(rot(T10), trans(T21)) + trans(T10))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) pose to (N, 3) points."""
    return pts @ rot(T).transpose(-1, -2) + trans(T)[..., None, :]


# ---------------------------------------------------------------------------
# so(3)/se(3) exp & log
# ---------------------------------------------------------------------------

def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zeros = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zeros, -z, y], dim=-1),
            torch.stack([z, zeros, -x], dim=-1),
            torch.stack([-y, x, zeros], dim=-1),
        ],
        dim=-2,
    )


def _eye3_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with small-angle-safe coefficients."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-32))
    use_taylor = theta2 < 1e-12
    a = torch.where(use_taylor, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(use_taylor, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    K = skew(omega)
    return _eye3_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def _quat_from_rotation_matrix(R: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) with w >= 0, by the branch-free
    Shepperd scheme of pcr_tpu/utils/quaternion.from_rotation_matrix."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    dens = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(dens, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)              # (..., 4, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    return torch.where(q[..., :1] < 0, -q, q)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3) via the quaternion: omega = 2 atan2(|q_v|, q_w) q_v/|q_v|."""
    q = _quat_from_rotation_matrix(R)
    qw, qv = q[..., 0], q[..., 1:]
    vn = torch.linalg.norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(vn, qw)
    small = vn < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=1e-32),
                        theta / torch.clamp(vn, min=1e-32))
    return scale[..., None] * qv


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exp map; xi = (omega, t) ordering, (..., 6) -> (..., 4, 4)."""
    omega, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-32))
    use_taylor = theta2 < 1e-12
    R = so3_exp(omega)
    a = torch.where(use_taylor, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    b = torch.where(use_taylor, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    K = skew(omega)
    V = _eye3_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)
    return make_pose(R, _matvec(V, v))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Log map, (..., 4, 4) -> (..., 6) with (omega, t) ordering."""
    omega = so3_log(rot(T))
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-32))
    use_taylor = theta2 < 1e-12
    K = skew(omega)
    half_theta = theta / 2.0
    cot = torch.where(
        use_taylor,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_theta * torch.cos(half_theta)
         / torch.clamp(torch.sin(half_theta), min=1e-32))
        / torch.clamp(theta2, min=1e-32),
    )
    V_inv = _eye3_like(K) - 0.5 * K + cot[..., None, None] * (K @ K)
    return torch.cat([omega, _matvec(V_inv, trans(T))], dim=-1)


# ---------------------------------------------------------------------------
# Reference pose-chain conventions
# ---------------------------------------------------------------------------

def relative_to_absolute(T_rel):
    """The reference's ``relative_to_absolute_poses``.

    Input: (n, 4, 4) relative poses [T10, T21, ..., T_{n,n-1}] (the last is
    usually the loop closure).  Output: (n, 4, 4) absolute poses with the
    identity prepended and the final (closure) pose dropped.  Rotations chain
    in REVERSED order, R_abs[i] = R_i @ ... @ R_0, and translations accumulate
    as t_abs[i+1] = R_abs[i] @ t_{i+1} + t_abs[i].  Numpy inputs chain in
    float64, as in the JAX package.
    """
    n = T_rel.shape[0]
    if _host(T_rel):
        T_rel = np.asarray(T_rel, np.float64)
        out = np.empty((n, 4, 4))
        acc_R, acc_t = np.eye(3), np.zeros(3)
    else:
        out = T_rel.new_empty((n, 4, 4))
        acc_R = torch.eye(3, dtype=T_rel.dtype, device=T_rel.device)
        acc_t = T_rel.new_zeros(3)
    out[0] = make_pose(acc_R, acc_t)
    for i in range(n - 1):
        # t_abs[i+1] = R_cum[i-1] @ t_i + t_abs[i]  (R_cum[-1] = I)
        acc_t = _matvec(acc_R, trans(T_rel[i])) + acc_t
        acc_R = rot(T_rel[i]) @ acc_R
        out[i + 1] = make_pose(acc_R, acc_t)
    return out


def pose_errors(T_a, T_b):
    """The reference's ``subtract_squared_poses``: per pose
    d_R = ||R_a - R_b||_F * sqrt(2)/2 and d_t = ||t_a - t_b||_2."""
    d = T_a - T_b
    if _host(T_a, T_b):
        d_R = np.sqrt(np.sum(d[..., :3, :3] ** 2, axis=(-2, -1))) / 2.0 * np.sqrt(2.0)
        return d_R, np.linalg.norm(d[..., :3, 3], axis=-1)
    d_R = torch.sqrt(torch.sum(d[..., :3, :3] ** 2, dim=(-2, -1))) / 2.0 * np.sqrt(2.0)
    return d_R, torch.linalg.norm(d[..., :3, 3], dim=-1)
