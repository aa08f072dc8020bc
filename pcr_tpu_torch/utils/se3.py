"""SE(3) / SO(3) utilities (port of pcr_tpu/utils/se3.py).

Same conventions as the JAX package:
  * twists are ordered (omega[3], t[3]) — rotation first;
  * ``compose_ref`` is the reference's nonstandard composition
    (R20 = R21 @ R10, t20 = R10 t21 + t10);
  * ``relative_to_absolute`` chains rotations in reversed order, prepends the
    identity and drops the final loop-closure pose.

Host numpy inputs run in float64 (pose chains of ~900 links need it; the
chains run sequentially there, as in the JAX package); torch inputs stay on
their device in their own dtype, and their chains run as doubling scans.
"""

from __future__ import annotations

import numpy as np
import torch

from . import quaternion


def _host(*arrays) -> bool:
    """True iff every input is a host numpy array (float64 path)."""
    return all(isinstance(a, np.ndarray) for a in arrays)


# ---------------------------------------------------------------------------
# Basic pose algebra
# ---------------------------------------------------------------------------

def make_pose(R, t):
    """Assemble (..., 4, 4) homogeneous poses from (..., 3, 3) R and (..., 3) t.
    The tensor path is built without in-place writes, so that it runs under
    ``torch.func`` transforms (the pose graph's Jacobians)."""
    if _host(R, t):
        batch = np.broadcast_shapes(R.shape[:-2], t.shape[:-1])
        out = np.zeros(batch + (4, 4), np.result_type(R, t))
        out[..., :3, :3] = R
        out[..., :3, 3] = t
        out[..., 3, 3] = 1.0
        return out
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


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


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3) via the quaternion: omega = 2 atan2(|q_v|, q_w) q_v/|q_v|."""
    q = quaternion.from_rotation_matrix(R)
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

def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def _inclusive_scan(x: torch.Tensor, combine) -> torch.Tensor:
    """out[i] = x[0] (+) x[1] (+) ... (+) x[i] along dim 0 for an associative
    ``combine(earlier, later)``: the Hillis-Steele doubling scan, ceil(log2 n)
    batched steps (the counterpart of ``jax.lax.associative_scan``; the
    products are grouped differently, so f32 results agree to round-off)."""
    out, d = x, 1
    while d < x.shape[0]:
        out = torch.cat([out[:d], combine(out[:-d], out[d:])])
        d *= 2
    return out


def _rev_matmul_scan(Rs):
    """cum[i] = R_i @ R_{i-1} @ ... @ R_0.

    Numpy inputs take a sequential float64 host path (circuit chains of ~900
    rotation products drift by tens of metres in float32); tensors take the
    doubling scan in their own dtype."""
    if _host(Rs):
        out = np.empty((len(Rs), 3, 3))
        acc = np.eye(3)
        for i in range(len(Rs)):
            acc = np.float64(Rs[i]) @ acc
            out[i] = acc
        return out
    return _inclusive_scan(Rs, lambda a, b: b @ a)


def _cat(xs):
    return np.concatenate(xs, axis=0) if _host(*xs) else torch.cat(xs, dim=0)


def _cumsum(x):
    return np.cumsum(x, axis=0) if _host(x) else torch.cumsum(x, dim=0)


def _eye_like(T, k: int):
    return np.eye(k) if _host(T) else torch.eye(k, dtype=T.dtype, device=T.device)


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
    R_cum = _rev_matmul_scan(rot(T_rel))
    ts = trans(T_rel)
    # d[0] = t_0, d[i] = R_cum[i-1] @ t_i
    t_cum = _cumsum(_cat([ts[:1], _matvec(R_cum[:-1], ts[1:])]))
    poses = make_pose(R_cum, t_cum)                  # poses[i] is node i+1
    return _cat([_eye_like(poses, 4)[None], poses[: n - 1]])


def relative_to_absolute_standard(T_rel):
    """The STANDARD SE(3) chain of the same relative poses: A_0 = I and
    A_{i+1} = A_i @ rel_i (rel_i maps frame i+1 -> i), so A_i maps frame
    i -> frame 0.  Open3D's pose graph, and the port's, are consistent with
    this chain; the reference's own ``relative_to_absolute`` composes
    rotations in reversed order and differs from it by ~55 m over the
    901-scan NCLT circuit.  Numpy inputs chain sequentially in float64."""
    n = T_rel.shape[0]
    if _host(T_rel):
        out = np.empty((n, 4, 4))
        acc = np.eye(4)
        out[0] = acc
        for i in range(n - 1):
            acc = acc @ np.float64(T_rel[i])
            out[i + 1] = acc
        return out
    cum = _inclusive_scan(T_rel, lambda a, b: a @ b)
    return torch.cat([_eye_like(T_rel, 4)[None], cum[: n - 1]])


def chain_rotations_ref(Rs):
    """The reference's forward rotation accumulation used by LUM: out[0] = I
    and out[i] = R_{i-1} @ ... @ R_0."""
    cum = _rev_matmul_scan(Rs)
    return _cat([_eye_like(cum, 3)[None], cum[:-1]])


def absolute_to_relative(T_abs):
    """The reference's ``poses_absolutas_para_relativas``:
    relatives[i] = compose_ref(T_abs[i+1], invert(T_abs[i])), i = 0..n-2."""
    return compose_ref(T_abs[1:], invert(T_abs[:-1]))


def absolute_to_relative_circuit(T_abs):
    """Implied circuit relatives of a trajectory, the wraparound edge
    included: rel[k] = inv(A_k) @ A_{(k+1)%n}, mapping frame k+1 -> k
    (standard composition)."""
    return compose(invert(T_abs), _cat([T_abs[1:], T_abs[:1]]))


def loop_closure_error(T_rel):
    """The circuit's closure pose in the reference's convention: all n
    relative poses accumulated (identity for a perfect circuit)."""
    Rs, ts = rot(T_rel), trans(T_rel)
    R_cum = _rev_matmul_scan(Rs)
    rotated = _matvec(R_cum[:-1], ts[1:])
    t_closure = ts[0] + (np.sum(rotated, axis=0) if _host(rotated) else rotated.sum(dim=0))
    return make_pose(R_cum[-1], t_closure)


def pose_errors(T_a, T_b):
    """The reference's ``subtract_squared_poses``: per pose
    d_R = ||R_a - R_b||_F * sqrt(2)/2 and d_t = ||t_a - t_b||_2."""
    d = T_a - T_b
    if _host(T_a, T_b):
        d_R = np.sqrt(np.sum(d[..., :3, :3] ** 2, axis=(-2, -1))) / 2.0 * np.sqrt(2.0)
        return d_R, np.linalg.norm(d[..., :3, 3], axis=-1)
    d_R = torch.sqrt(torch.sum(d[..., :3, :3] ** 2, dim=(-2, -1))) / 2.0 * np.sqrt(2.0)
    return d_R, torch.linalg.norm(d[..., :3, 3], dim=-1)


def interpolate(T1, T2, t):
    """SLERP on rotations and lerp on translations (the reference's
    ``interpolar_duas_T``)."""
    q = quaternion.slerp(quaternion.from_rotation_matrix(rot(T1)),
                         quaternion.from_rotation_matrix(rot(T2)), t)
    if _host(T1, T2):
        t = np.asarray(t)
    else:
        t = torch.as_tensor(t, dtype=T1.dtype, device=T1.device)
    tr = (1.0 - t)[..., None] * trans(T1) + t[..., None] * trans(T2)
    return make_pose(quaternion.as_rotation_matrix(q), tr)
