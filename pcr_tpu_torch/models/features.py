"""Eigenvalue features and the multiscale sampling experiment (port of
pcr_tpu/models/features.py).

  * ``extract_eigen_features``: centre the cloud, scale it by its larger
    bounding-box corner norm, take the whole-cloud covariance's singular
    values and form linearity, planarity, sphericity, curvature,
    anisotropy, omnivariance and the eigen-sum.  The reference's formulas
    are kept, its unparenthesised anisotropy ``s0 - s2/s0`` included.
  * ``multiscale_sampling_fractions`` (``amostragem_multiescala_otimizada``):
    per-scale sizes from the fitted model a*exp(-b*s), a=1.18397758,
    b=5.09388767.
  * ``random_downsample``: keep each valid point with probability
    ``fraction``.  Its uniforms come from a ``torch.Generator``, which
    cannot replay ``jax.random``'s stream; handed the same uniforms ``u``,
    it keeps the same points as pcr_tpu.
"""

from __future__ import annotations

import torch

from ..utils.cloud import PAD_COORD, Cloud, _placement

SAMPLING_A = 1.18397758
SAMPLING_B = 5.09388767


def extract_eigen_features(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The 7-vector [lin, pla, sph, cur, ani, omn, eig_sum] of the masked
    cloud, float32 on its device."""
    w = mask.to(torch.float32)[:, None]
    count = torch.clamp(torch.sum(w), min=1.0)
    centroid = torch.sum(points * w, dim=0) / count
    centered = (points - centroid) * w
    # normalise by the larger corner norm of the centred bounding box
    big = 3e38
    mx = torch.amax(torch.where(mask[:, None], centered, -big), dim=0)
    mn = torch.amin(torch.where(mask[:, None], centered, big), dim=0)
    scale = torch.clamp(torch.maximum(torch.linalg.norm(mx), torch.linalg.norm(mn)), min=1e-12)
    normed = centered / scale
    cov = normed.T @ (normed * w) / count
    s = torch.linalg.svdvals(cov)                            # descending
    eig_sum = s[0] + s[1] + s[2]
    s = s / torch.clamp(torch.linalg.norm(s), min=1e-30)
    lin = (s[0] - s[1]) / s[0]
    pla = (s[1] - s[2]) / s[0]
    sph = s[2] / s[0]
    cur = s[2] / (s[0] + s[1] + s[2])
    ani = s[0] - s[2] / s[0]            # the reference's exact (unparenthesised) form
    omn = (s[0] * s[1] * s[2]) ** (1.0 / 3.0)
    return torch.stack([lin, pla, sph, cur, ani, omn, eig_sum])


def multiscale_sampling_fractions(n_scales: int, voxel_inicial: float,
                                  device: torch.device | str | None = None) -> torch.Tensor:
    """Unit-norm per-scale random-sampling fractions from the exponential
    density model over linearly growing scales, float32 on ``device``
    (default: the CUDA card)."""
    scales = torch.tensor([voxel_inicial + voxel_inicial * i for i in range(n_scales)],
                          dtype=torch.float32, device=_placement(device))
    fractions = SAMPLING_A * torch.exp(-SAMPLING_B * scales)
    return fractions / torch.linalg.norm(fractions)


def random_downsample(c: Cloud, fraction, seed: int = 0,
                      generator: torch.Generator | None = None,
                      u: torch.Tensor | None = None) -> Cloud:
    """Keep each valid point with probability ``fraction`` (fixed shape;
    dropped rows parked at the sentinel).  The uniforms are ``u``
    (capacity,) when given, else drawn from ``generator``, else from a
    generator on the cloud's device seeded with ``seed``."""
    if u is None:
        if generator is None:
            generator = torch.Generator(device=c.device)
            generator.manual_seed(int(seed))
        u = torch.rand((c.capacity,), generator=generator, device=c.device)
    keep = c.mask & (u.to(c.device) < fraction)
    return c.with_(points=torch.where(keep[:, None], c.points, PAD_COORD), mask=keep)
