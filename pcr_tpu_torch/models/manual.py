"""Point-to-point transform estimation and the manual-registration maths
(port of pcr_tpu/models/manual.py).

The reference's interactive picking (``registro_manual``) is bound to an
Open3D window; what lies under it is the Umeyama/Kabsch closed form
(``TransformationEstimationPointToPoint``): given >= 3 picked
correspondences, the rigid transform.  Headless callers pass index pairs
instead of clicks.

Host numpy inputs compute in float64 with numpy; tensors compute in float32
on their own device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import se3


def estimate_point_to_point(source_pts, target_pts, weights=None):
    """Kabsch/Umeyama closed form: the rigid T minimising sum w ||T p - q||^2
    over matched rows of ``source_pts`` and ``target_pts`` (N, 3).  Returns
    (4, 4): float64 numpy for numpy input, else a float32 tensor on the
    input's device."""
    if isinstance(source_pts, np.ndarray):
        p = np.asarray(source_pts, np.float64)
        q = np.asarray(target_pts, np.float64)
        w = np.ones(p.shape[0]) if weights is None else np.asarray(weights, np.float64)
        w = w / np.sum(w)
        mu_p, mu_q = np.einsum("n,ni->i", w, p), np.einsum("n,ni->i", w, q)
        H = np.einsum("n,ni,nj->ij", w, p - mu_p, q - mu_q)
        U, _, Vt = np.linalg.svd(H)
        # reflection guard: det(V U^T) = -1 flips the smallest singular direction
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
        return se3.make_pose(R, mu_q - R @ mu_p)
    p = torch.as_tensor(source_pts, dtype=torch.float32)
    q = torch.as_tensor(target_pts, dtype=torch.float32, device=p.device)
    w = (torch.ones(p.shape[0], dtype=p.dtype, device=p.device) if weights is None
         else torch.as_tensor(weights, dtype=p.dtype, device=p.device))
    w = w / torch.sum(w)
    mu_p, mu_q = torch.einsum("n,ni->i", w, p), torch.einsum("n,ni->i", w, q)
    H = torch.einsum("n,ni,nj->ij", w, p - mu_p, q - mu_q)
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    R = Vt.T @ torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d])) @ U.T
    return se3.make_pose(R, mu_q - R @ mu_p)


def manual_registration(source_pts, target_pts, picked_src, picked_tgt) -> np.ndarray:
    """``registro_manual``'s maths with picked index lists instead of clicks:
    the float64 closed form over the picked rows; needs >= 3 matched picks."""
    picked_src = np.asarray(picked_src)
    picked_tgt = np.asarray(picked_tgt)
    if len(picked_src) < 3 or len(picked_src) != len(picked_tgt):
        raise ValueError("need >= 3 matched picks on each cloud")
    return estimate_point_to_point(
        np.asarray(source_pts)[picked_src], np.asarray(target_pts)[picked_tgt])


def random_rotation_matrix(deflection: float = 1.0, rng=None) -> np.ndarray:
    """Householder-on-sphere random rotation (``rand_rotation_matrix``), from
    three uniforms of ``rng`` (a numpy Generator)."""
    rng = rng or np.random.default_rng()
    theta, phi, z = rng.uniform(size=3)
    theta *= 2.0 * deflection * np.pi
    phi *= 2.0 * np.pi
    z *= 2.0 * deflection
    r = np.sqrt(z)
    V = np.array([np.sin(phi) * r, np.cos(phi) * r, np.sqrt(2.0 - z)])
    st, ct = np.sin(theta), np.cos(theta)
    Rz = np.array([[ct, st, 0.0], [-st, ct, 0.0], [0.0, 0.0, 1.0]])
    return (np.outer(V, V) - np.eye(3)) @ Rz


def flatten_to_xy(points):
    """``planificar_nuvens_em_xy``: a copy of ``points`` (..., 3) with z = 0,
    a tensor for a tensor, numpy for numpy."""
    if torch.is_tensor(points):
        return torch.cat([points[..., :2], torch.zeros_like(points[..., 2:3])], dim=-1)
    return np.concatenate([points[..., :2], np.zeros_like(points[..., 2:3])], axis=-1)
