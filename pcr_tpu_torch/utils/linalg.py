"""Small dense solves shared by the models and the kernels' plain versions."""

from __future__ import annotations

import torch


def solve6_cholesky(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve the damped 6x6 SPD system H x = g by Cholesky (H = L L^T).

    The JAX package unrolls this factorization into scalar code because its
    looped LU costs ~1 ms on a TPU; in eager PyTorch the unrolled form is
    ~200 tiny launches, so the same factorization runs as two batched
    library calls with no host sync (``cholesky_ex`` does not check info).
    Leading batch dimensions of H (..., 6, 6) and g (..., 6) are solved
    together.
    """
    L, _ = torch.linalg.cholesky_ex(H)
    return torch.cholesky_solve(g[..., None], L)[..., 0]
