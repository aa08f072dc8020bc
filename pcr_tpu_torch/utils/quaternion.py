"""Quaternion algebra (port of pcr_tpu/utils/quaternion.py).

Replaces the ``numpy-quaternion`` C extension the reference uses:
``from_rotation_matrix`` / ``as_rotation_matrix`` / Hamilton product /
inverse / ``slerp``.  Every function is batched over leading dimensions.

Like the JAX package, each function dispatches on its inputs: host numpy
arrays stay numpy (and so can run in float64, which quaternion chains of
~900 links need), torch tensors stay on their device in their own dtype.

Convention: q = (w, x, y, z), Hamilton product, unit quaternions act as
rotations R(q) p.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(*arrays) -> bool:
    """numpy iff every array input is host numpy (Python scalars ignored)."""
    arrs = [a for a in arrays if not isinstance(a, (int, float))]
    return bool(arrs) and all(isinstance(a, np.ndarray) for a in arrs)


def _stack(xs, host: bool):
    return np.stack(xs, axis=-1) if host else torch.stack(xs, dim=-1)


def qmul(q1, q2):
    """Hamilton product q1 * q2; shapes broadcast over leading dims, last dim 4."""
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return _stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], _host(q1, q2))


def qconj(q):
    if _host(q):
        return q * np.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def qinv(q):
    """Inverse; for unit quaternions this is the conjugate."""
    if _host(q):
        return qconj(q) / np.sum(q * q, axis=-1, keepdims=True)
    return qconj(q) / torch.sum(q * q, dim=-1, keepdim=True)


def qnormalize(q, eps: float = 1e-12):
    if _host(q):
        return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), eps)
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def qidentity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def from_rotation_matrix(R):
    """Unit quaternion (w >= 0) from rotation matrices, batched over leading dims.

    The branch-free Shepperd scheme: all four candidate quaternions are
    formed from the diagonal and off-diagonal elements and the one with the
    largest denominator is kept (numerically stable at every angle)."""
    host = _host(R)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate 4*q*|q_k| vectors (k = w, x, y, z)
    qw = _stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], host)
    qx = _stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], host)
    qy = _stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], host)
    qz = _stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], host)
    # denominators 4*q_k^2 of each branch
    dens = _stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                   1.0 - m00 - m11 + m22], host)
    if host:
        best = np.argmax(dens, axis=-1)
        cands = np.stack([qw, qx, qy, qz], axis=-2)            # (..., 4 branches, 4)
        q = qnormalize(np.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :])
        return np.where(q[..., :1] < 0, -q, q)
    best = torch.argmax(dens, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = qnormalize(torch.gather(cands, -2, idx)[..., 0, :])
    return torch.where(q[..., :1] < 0, -q, q)


def as_rotation_matrix(q):
    """Rotation matrices from (possibly batched) unit quaternions."""
    q = qnormalize(q)
    w, x, y, z = (q[..., i] for i in range(4))
    r = _stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], _host(q))
    return r.reshape(tuple(q.shape[:-1]) + (3, 3))


def slerp(q1, q2, t):
    """Spherical linear interpolation from q1 (t=0) to q2 (t=1).

    Shortest path (sign-corrected), as the reference's
    ``quaternion.slerp(q1, q2, 0, 1, t_out=t)``; normalised lerp where the
    quaternions are nearly parallel."""
    if _host(q1, q2):
        t = np.asarray(t)
        dot = np.sum(q1 * q2, axis=-1, keepdims=True)
        q2 = np.where(dot < 0, -q2, q2)
        theta = np.arccos(np.clip(np.abs(dot), -1.0, 1.0))
        sin_theta = np.sin(theta)
        near = sin_theta < 1e-6
        safe_sin = np.where(near, 1.0, sin_theta)
        w1 = np.where(near, 1.0 - t[..., None], np.sin((1.0 - t[..., None]) * theta) / safe_sin)
        w2 = np.where(near, t[..., None], np.sin(t[..., None] * theta) / safe_sin)
        return qnormalize(w1 * q1 + w2 * q2)
    t = torch.as_tensor(t, dtype=q1.dtype, device=q1.device)
    dot = torch.sum(q1 * q2, dim=-1, keepdim=True)
    q2 = torch.where(dot < 0, -q2, q2)
    theta = torch.arccos(torch.clamp(torch.abs(dot), -1.0, 1.0))
    sin_theta = torch.sin(theta)
    near = sin_theta < 1e-6
    safe_sin = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    w1 = torch.where(near, 1.0 - t[..., None], torch.sin((1.0 - t[..., None]) * theta) / safe_sin)
    w2 = torch.where(near, t[..., None], torch.sin(t[..., None] * theta) / safe_sin)
    return qnormalize(w1 * q1 + w2 * q2)


def rotate(q, v):
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    qv, w = q[..., 1:], q[..., :1]
    if _host(q, v):
        t = 2.0 * np.cross(qv, v)
        return v + w * t + np.cross(qv, t)
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + w * t + torch.linalg.cross(qv, t)
