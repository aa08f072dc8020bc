"""Peaks of the card and the least time a kernel's work can take (a frozen
copy of ``chip_smoke.bound`` and of its K1 and K11 counts).

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
full 700 W power limit): 67 TFLOP/s in float32 outside the tensor cores and
3.35 TB/s of HBM3.  A share of a roofline is stated against them; the run's
card and power limit are printed beside it by whoever keeps the number.

Bytes count each input read once and each output written once; operations
count the float32 work the inputs need.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
K1_PAIR_OPS = 9.0            # the d2 (3 sub, 3 mul/add) and the running minimum
K11_PAIR_OPS = 2 * 33 + 5    # the 33-term dot, d2 and two compares a row pair
K11_DIM = 33


def bound_s(n_bytes: float, ops: float) -> float:
    """Least seconds: the larger of the bytes over the memory rate and the
    float32 operations over the peak."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def k1_bound_s(n_tiles: int, nq: int, nr: int, q_tile: int, band: int) -> float:
    """K1 (``nn1_band``): every query against its tile's 2*band slab; reads
    the tile starts, the queries and the sorted refs, writes d2 and a row."""
    n_bytes = 4 * n_tiles + 12 * nq + 12 * nr + 8 * nq
    return bound_s(n_bytes, K1_PAIR_OPS * n_tiles * q_tile * 2 * band)


def k11_bound_s(na: int, nb: int) -> float:
    """K11 (``nn1_mutual``): every row pair of the two feature sets; reads the
    features and masks, writes both index vectors."""
    return bound_s(4 * K11_DIM * (na + nb) + 9 * (na + nb), K11_PAIR_OPS * na * nb)
