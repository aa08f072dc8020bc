"""K11 (FGR's mutual matching): the plain version beside the kernel,
``pcr_tpu_torch/ops/kernels/nn_kernels.nn1_mutual_reference``, held against
pcr_tpu's ``ops/knn.nn1_mutual`` on the same numpy inputs, and the rule the
kernel implements (the smallest index among the minimal d2 of every row and
every column) against the tiled sweep (the kernel itself runs in
test_torch_kernels_cuda.py).

Tolerances, and why: indices are compared for equality.  The tie inputs
are integer-valued (features in {0, 1, 2}), so every product, sum and norm
of the expanded d2 is exact in float32 and both packages see the same d2
and the same ties, whatever order their matrix products sum in; the
continuous inputs have no near-ties at these sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pcr_tpu.ops import knn as j_knn
from pcr_tpu_torch.ops import knn as t_knn
from pcr_tpu_torch.ops.kernels import common, nn_kernels

torch.set_num_threads(1)


def _continuous(rng, na: int, nb: int):
    """FPFH-like rows (three 11-bin histograms of 100 each), a tenth masked."""
    def feats(n):
        return np.concatenate([rng.dirichlet(np.full(11, 0.4), size=n) * 100
                               for _ in range(3)], axis=1).astype(np.float32)

    return feats(na), rng.random(na) >= 0.1, feats(nb), rng.random(nb) >= 0.1


def _masked_blocks(na: int, nb: int):
    """Ties, with whole blocks masked: a's second q_tile and b's first 40
    rows masked, b's last rows masked so no valid a-row reaches them."""
    a, am, b, bm = chip_smoke.k11_tie_inputs(na, nb, seed=7)
    am[16:32] = False
    bm[:40] = False
    return a, am, b, bm


CASES = {   # name: (inputs, q_tile)
    "ties_across_q_tiles": (lambda rng: chip_smoke.k11_tie_inputs(300, 517, seed=1), 16),
    "ties_na_below_nb": (lambda rng: chip_smoke.k11_tie_inputs(37, 130, seed=2), 8),
    "ties_na_above_nb": (lambda rng: chip_smoke.k11_tie_inputs(2100, 5, seed=3), 2048),
    "masked_blocks": (lambda rng: _masked_blocks(70, 90), 16),
    "all_zero_rows": (lambda rng: (np.zeros((40, 33), np.float32), np.ones(40, bool),
                                   np.zeros((25, 33), np.float32), np.ones(25, bool)), 16),
    "everything_masked": (lambda rng: (np.ones((20, 33), np.float32), np.zeros(20, bool),
                                       np.ones((30, 33), np.float32), np.ones(30, bool)), 8),
    "continuous": (lambda rng: _continuous(rng, 500, 333), 128),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_mutual_nn_matches_pcr_tpu(rng, case):
    make, q_tile = CASES[case]
    a, am, b, bm = make(rng)
    ij_j, ji_j = j_knn.nn1_mutual(jnp.asarray(a), jnp.asarray(am), jnp.asarray(b),
                                  jnp.asarray(bm), q_tile=q_tile)
    ij_t, ji_t = nn_kernels.nn1_mutual_reference(
        torch.as_tensor(a), torch.as_tensor(am), torch.as_tensor(b), torch.as_tensor(bm),
        q_tile=q_tile)
    np.testing.assert_array_equal(ij_t.numpy(), np.asarray(ij_j))
    np.testing.assert_array_equal(ji_t.numpy(), np.asarray(ji_j))
    if case == "everything_masked":        # no valid partner: index 0 on both sides
        assert not ij_t.any() and not ji_t.any()


def _lexicographic(a, am, b, bm):
    """The kernel's rule in numpy: the smallest index among the minimal d2
    of each row and of each column, d2 from the plain formula."""
    d2 = common.chunk_sqdist(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    d2 = np.where(am[:, None] & bm[None, :], d2, np.float32(common.BIG))
    ij = np.array([np.flatnonzero(row == row.min())[0] for row in d2])
    ji = np.array([np.flatnonzero(col == col.min())[0] for col in d2.T])
    return ij, ji


@pytest.mark.parametrize("case", ["ties_across_q_tiles", "masked_blocks", "all_zero_rows",
                                  "everything_masked"])
def test_lexicographic_rule_is_the_tiled_sweep(rng, case):
    """What the kernel computes (the lexicographic minimum of (d2, index),
    which merges across blocks in any order) is what the plain version's
    first-index argmin in a tile and strict "<" across tiles give."""
    make, q_tile = CASES[case]
    a, am, b, bm = make(rng)
    ij_t, ji_t = nn_kernels.nn1_mutual_reference(
        torch.as_tensor(a), torch.as_tensor(am), torch.as_tensor(b), torch.as_tensor(bm),
        q_tile=q_tile)
    ij, ji = _lexicographic(a, am, b, bm)
    np.testing.assert_array_equal(ij_t.numpy(), ij)
    np.testing.assert_array_equal(ji_t.numpy(), ji)


def test_wrapper_routes_cpu_tensors_to_the_plain_version(rng):
    a, am, b, bm = (torch.as_tensor(x) for x in _continuous(rng, 300, 200))
    before = dict(nn_kernels.LAUNCHES)
    got = t_knn.nn1_mutual(a, am, b, bm, q_tile=64)
    want = nn_kernels.nn1_mutual_reference(a, am, b, bm, q_tile=64)
    assert all(torch.equal(g, w) and g.dtype == torch.int64 for g, w in zip(got, want))
    assert nn_kernels.LAUNCHES == before
    with pytest.raises(ValueError):
        nn_kernels.nn1_mutual(a[:0], am[:0], b, bm)
    with pytest.raises(ValueError):
        nn_kernels.nn1_mutual(a, am, b.to("meta"), bm)
