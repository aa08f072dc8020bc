"""The collectives of the port's device meshes: sums, rank-ordered gathers,
broadcasts and the rank's block of a sharded axis over a
``torch.distributed`` process group (pcr_tpu's ``lax.psum`` and
``all_gather``).

The models take a ``group`` (pcr_tpu's ``axis_name``) and call these; only
``parallel/`` knows how the groups make a mesh.  On a ``gloo`` group a CUDA
tensor is reduced and gathered through host memory (gloo has no CUDA
all-gather), so ranks sharing one card over gloo compute on the card and
exchange through the host.

With the tracer on (``utils/trace``) every call is a span ``collective``
with attributes ``op`` and ``bytes``, and adds to the counters
``collective.calls`` and ``collective.bytes``.  ``bytes`` is the payload this
rank sends, read on the host: a tensor's bytes, an object's pickled size,
nothing for a barrier or for a broadcast's receivers.  Off, a call pays one
check of the tracer's flag.
"""

from __future__ import annotations

import contextlib
import pickle

import torch
import torch.distributed as dist

from . import trace

_OFF = contextlib.nullcontext()


def _traced(op: str, payload):
    """The span of one call; ``payload()`` gives its bytes, and is called
    only when the tracer is on."""
    if not trace.enabled():
        return _OFF
    n = int(payload())
    trace.count("collective.calls")
    trace.count("collective.bytes", n)
    return trace.span("collective", op=op, bytes=n)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _is_source(group) -> bool:
    return dist.get_rank() == dist.get_global_rank(group, 0)


def group_size(group=None) -> int:
    return dist.get_world_size(group)


def rank_block(n: int, group=None) -> slice:
    """This rank's contiguous block of ``n`` items split over the group's
    ranks in rank order, as evenly as whole items allow."""
    r, w = dist.get_rank(group), dist.get_world_size(group)
    return slice(r * n // w, (r + 1) * n // w)


def _through_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks; every rank gets the same bits."""
    with _traced("all_reduce_sum", lambda: _nbytes(x)):
        y = x.cpu() if _through_host(x, group) else x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y.to(x.device)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along dim 0 in rank order
    (every block the same shape)."""
    with _traced("all_gather_rows", lambda: _nbytes(x)):
        y = x.cpu() if _through_host(x, group) else x
        y = (y.to(torch.uint8) if y.dtype == torch.bool else y).contiguous()
        parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts).to(device=x.device, dtype=x.dtype)


def broadcast(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` as the group's first rank holds it."""
    group = group if group is not None else dist.group.WORLD
    with _traced("broadcast", lambda: _nbytes(x) if _is_source(group) else 0):
        y = x.cpu() if _through_host(x, group) else x.clone()
        dist.broadcast(y, src=dist.get_global_rank(group, 0), group=group)
        return y.to(x.device)


def broadcast_object(obj, group=None):
    """The picklable ``obj`` as the group's first rank holds it (the others
    may pass anything)."""
    group = group if group is not None else dist.group.WORLD
    with _traced("broadcast_object",
                 lambda: len(pickle.dumps(obj)) if _is_source(group) else 0):
        box = [obj]
        dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
        return box[0]


def all_gather_objects(obj, group=None) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    with _traced("all_gather_objects", lambda: len(pickle.dumps(obj))):
        out = [None] * dist.get_world_size(group)
        dist.all_gather_object(out, obj, group=group)
        return out


def barrier() -> None:
    """Wait for every rank of the world."""
    with _traced("barrier", lambda: 0):
        dist.barrier()
