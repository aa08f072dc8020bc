"""Faults planted under the timed path must turn ``correct`` false.

Each case runs one cell through ``run.main`` (set-up, a one-second window,
the reference) with the program broken underneath for the whole run:

* a step that returns its state unchanged: M-GICP returns its starting
  pose; the pose-graph LM returns its starting nodes;
* an answer altered where it is produced: M-GICP's pose moved 5 cm; LUM's
  translations moved 1 um.

The cells run one card each and have no exchange between cards, and no
cell takes a mean over a batch, so those two faults have no place here.  These
tests need the card (``cuda`` marker): ``python3 -m pytest portbench -m cuda``
from the root of the checkout.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the port's kernels")


@contextlib.contextmanager
def patched(module_name: str, attr: str, make):
    import importlib

    module = importlib.import_module(module_name)
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)


def _as_pose(T, like):
    import torch

    return torch.as_tensor(T, dtype=like.dtype, device=like.device).reshape(like.shape)


def gicp_unchanged(attr):
    def make(original):
        def fault(src, tgt, T_init, *args, **kwargs):
            res = original(src, tgt, T_init, *args, **kwargs)
            return res._replace(transformation=_as_pose(T_init, res.transformation))
        return fault
    module = ("pcr_tpu_torch.parallel.pair_sharding" if attr == "batched_mgicp"
              else "pcr_tpu_torch.models.multiscale")
    return lambda: patched(module, attr, make)


def gicp_moved(attr):
    def make(original):
        def fault(*args, **kwargs):
            res = original(*args, **kwargs)
            T = res.transformation.clone()
            T[..., 0, 3] += 0.05
            return res._replace(transformation=T)
        return fault
    module = ("pcr_tpu_torch.parallel.pair_sharding" if attr == "batched_mgicp"
              else "pcr_tpu_torch.models.multiscale")
    return lambda: patched(module, attr, make)


def lm_unchanged():
    def make(original):
        def fault(graph, *args, **kwargs):
            import torch

            from pcr_tpu_torch.models.global_refine import pose_graph
            res = original(graph, *args, **kwargs)
            return pose_graph.LMResult(graph.nodes, res.final_cost, res.iterations_used,
                                       torch.ones_like(res.line_process))
        return fault
    return lambda: patched("pcr_tpu_torch.models.global_refine.pose_graph",
                           "optimize_pose_graph_once", make)


def lum_moved():
    def make(original):
        def fault(*args, **kwargs):
            out = original(*args, **kwargs)
            out = out.copy()
            out[1:, :3, 3] += 1e-6
            return out
        return fault
    return lambda: patched("pcr_tpu_torch.models.global_refine.closed_form", "refine_lum", make)


CASES = {
    "seq32-gicp-unchanged": ("nclt-seq32", gicp_unchanged("multiscale_gicp_pyramids")),
    "seq32-gicp-moved": ("nclt-seq32", gicp_moved("multiscale_gicp_pyramids")),
    "seq32-lm-unchanged": ("nclt-seq32", lm_unchanged()),
    "k2-gicp-unchanged": ("facade-k2", gicp_unchanged("batched_mgicp")),
    "k2-gicp-moved": ("facade-k2", gicp_moved("batched_mgicp")),
    "k2-lm-unchanged": ("facade-k2", lm_unchanged()),
    "online-gicp-unchanged": ("nclt-pair-online", gicp_unchanged("multiscale_gicp")),
    "online-gicp-moved": ("nclt-pair-online", gicp_moved("multiscale_gicp")),
    "refine-lm-unchanged": ("nclt-refine901", lm_unchanged()),
    "refine-lum-moved": ("nclt-refine901", lum_moved()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_fault_is_not_correct(card, case, capsys):
    workload, fault = CASES[case]
    rc = run.main(["--workload", workload, "--seed", "4100000017", "--seconds", "1",
                   "--trace", "0"], root=ROOT, fault=fault)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    line = json.loads(out[-1])
    bad = {k: c for k, c in line["checks"].items()
           if c["value"] is None or c["value"] > c["limit"]}
    print(case, json.dumps(line["checks"]))
    assert line["correct"] is False and bad
