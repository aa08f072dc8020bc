"""Batched closed-form symmetric 3x3 eigendecomposition (port of
pcr_tpu/ops/eigen3.py): trigonometric eigenvalues and cross-product
eigenvectors, no LAPACK and no data-dependent control flow."""

from __future__ import annotations

import math

import torch


def eigh3(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (ascending) and eigenvectors of symmetric (..., 3, 3).

    Returns (w, V): w (..., 3) ascending, V (..., 3, 3) whose columns
    V[..., :, i] are unit eigenvectors; degenerate inputs get a valid
    orthonormal basis.
    """
    scale = torch.clamp(A.abs().amax(dim=(-2, -1), keepdim=True), min=1e-30)
    B = A / scale
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(B.shape)

    q = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1) / 3.0
    C = B - q[..., None, None] * eye
    p2 = torch.sum(C * C, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detC = (
        C[..., 0, 0] * (C[..., 1, 1] * C[..., 2, 2] - C[..., 1, 2] * C[..., 2, 1])
        - C[..., 0, 1] * (C[..., 1, 0] * C[..., 2, 2] - C[..., 1, 2] * C[..., 2, 0])
        + C[..., 0, 2] * (C[..., 1, 0] * C[..., 2, 1] - C[..., 1, 1] * C[..., 2, 0])
    )
    # p**3 underflows f32 for near-isotropic inputs; clamp the denominator.
    r = torch.clamp(detC / torch.clamp(2.0 * p * p * p, min=1e-30), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    w2 = q + 2.0 * p * torch.cos(phi)                          # largest
    w0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)    # smallest
    w1 = 3.0 * q - w0 - w2
    w = torch.stack([w0, w1, w2], dim=-1)

    def eigvec(wa, wb):
        # columns of (B - wa I)(B - wb I) lie along the remaining eigenvector
        M = (B - wa[..., None, None] * eye) @ (B - wb[..., None, None] * eye)
        norms = torch.sum(M * M, dim=-2)
        best = torch.argmax(norms, dim=-1)
        idx = best[..., None, None].expand(best.shape + (3, 1))
        v = torch.gather(M, -1, idx)[..., 0]
        n = torch.linalg.norm(v, dim=-1, keepdim=True)
        return torch.where(n > 1e-20, v / torch.clamp(n, min=1e-30), torch.zeros_like(v))

    v0 = eigvec(w1, w2)
    v2 = eigvec(w0, w1)
    eye3 = torch.eye(3, dtype=A.dtype, device=A.device)

    def fallback(v, other):
        bad = torch.sum(v * v, dim=-1, keepdim=True) < 0.5
        cand = eye3[torch.argmin(other.abs(), dim=-1)]
        o = cand - other * torch.sum(cand * other, dim=-1, keepdim=True)
        o = o / torch.clamp(torch.linalg.norm(o, dim=-1, keepdim=True), min=1e-30)
        return torch.where(bad, o, v)

    both_bad = (torch.sum(v0 * v0, dim=-1, keepdim=True) < 0.5) & (
        torch.sum(v2 * v2, dim=-1, keepdim=True) < 0.5)
    v0 = torch.where(both_bad, eye3[0].expand(v0.shape), v0)
    v2 = torch.where(both_bad, eye3[2].expand(v2.shape), v2)
    v0 = fallback(v0, v2)
    v2 = fallback(v2, v0)
    v2 = v2 - v0 * torch.sum(v2 * v0, dim=-1, keepdim=True)
    v2 = v2 / torch.clamp(torch.linalg.norm(v2, dim=-1, keepdim=True), min=1e-30)
    v1 = torch.linalg.cross(v2, v0, dim=-1)
    V = torch.stack([v0, v1, v2], dim=-1)
    return w * scale[..., 0], V


def smallest_eigenvector(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue (the surface normal)."""
    _, V = eigh3(A)
    return V[..., :, 0]
