"""Device meshes on ``torch.distributed`` (port of pcr_tpu/parallel/mesh.py).

The registration workload has two parallel axes:
  * ``pairs``  — scan pairs are independent; each rank registers its block
    of a circuit's pairs;
  * ``points`` — within-pair sharding of large clouds (Courtyard-scale
    pairs): the source rows of one pair are split over ranks and the
    normal equations are summed over them every iteration.

pcr_tpu runs N devices from one process (``shard_map``); the port runs one
process per device, as PyTorch does: a launcher (``torchrun --nproc-per-node
N -m pcr_tpu_torch ...``) starts the ranks, each on ``cuda:LOCAL_RANK``, and
a mesh of N devices needs a world of N ranks.  The mesh lays the world's
ranks out row-major on its axes (the device order of ``jax.make_mesh``).

Every sharded function keeps pcr_tpu's signature and replicated return:
every rank passes the same full inputs, works on its contiguous block of the
sharded axis, and the blocks are gathered so that every rank returns the
whole result.  The collectives all go through ``utils/collectives``, which
the models call with the group of an axis (pcr_tpu's ``axis_name``).
"""

from __future__ import annotations

import math
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..utils.cloud import _placement
from ..utils.collectives import rank_block

# The launcher's environment (torchrun); without it a world of one rank is
# started in this process.
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
INIT_TIMEOUT = timedelta(minutes=10)


def maybe_initialize_distributed(device=None) -> bool:
    """Start the default process group once; returns True when the world has
    more than one rank.

    An existing default group is used whatever its backend (tests and
    chip_smoke.py bring their own ``gloo`` group).  Under a launcher
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, and
    ``LOCAL_RANK``) the rank joins its world, on ``cuda:LOCAL_RANK`` over
    NCCL when ``device`` (default: the CUDA card) is a card, over gloo on the
    CPU.  Without a launcher a world of one rank starts in this process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    on_card = _placement(device).type == "cuda"
    backend = "nccl" if on_card else "gloo"
    if all(k in os.environ for k in LAUNCHER_ENV):
        if on_card:   # before NCCL starts: the rank's card
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://", timeout=INIT_TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=INIT_TIMEOUT)
    return dist.get_world_size() > 1


def world_size() -> int:
    """The world's rank count (the launcher's, or 1, before a process group
    starts)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if all(k in os.environ for k in LAUNCHER_ENV):
        return int(os.environ["WORLD_SIZE"])
    return 1


def rank() -> int:
    """This process's rank in the world (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """The world's ranks on named axes, row-major.

    ``shape`` maps each axis name to its size and ``axis_names`` lists the
    names in order, as a JAX mesh's do; ``group(axis)`` is the process group
    of the ranks that differ from this one only along ``axis`` and
    ``index(axis)`` this rank's place in it (its block of the sharded axis)."""

    def __init__(self, shape: dict[str, int]):
        names = tuple(shape)
        sizes = [int(shape[a]) for a in names]
        world, me = dist.get_world_size(), dist.get_rank()
        if math.prod(sizes) != world:
            raise ValueError(f"a {dict(shape)} mesh needs {math.prod(sizes)} ranks, the "
                             f"world has {world}")
        self.shape = {a: s for a, s in zip(names, sizes)}
        self.axis_names = names
        self._index = {a: int(c) for a, c in zip(names, np.unravel_index(me, sizes))}
        self._groups = {}
        grid = np.arange(world).reshape(sizes)
        for k, axis in enumerate(names):
            if len(names) == 1:
                self._groups[axis] = dist.group.WORLD
                continue
            # every rank creates every group, in the same order
            for line in np.moveaxis(grid, k, -1).reshape(-1, sizes[k]).tolist():
                group = dist.new_group(line)
                if me in line:
                    self._groups[axis] = group

    def group(self, axis: str):
        return self._groups[axis]

    def index(self, axis: str) -> int:
        return self._index[axis]

    def block(self, axis: str, n: int) -> slice:
        """This rank's contiguous block of ``n`` rows sharded over ``axis``
        (``n`` must divide by the axis size; callers raise pcr_tpu's errors)."""
        return rank_block(n, self.group(axis))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _make(shape: dict[str, int], device) -> Mesh:
    n = math.prod(shape.values())
    world = world_size()
    if n != world:
        if world == 1:
            raise ValueError(
                f"a mesh of {n} devices needs {n} processes, one a device: run "
                f"'torchrun --nproc-per-node {n} -m pcr_tpu_torch ...'")
        raise ValueError(f"a mesh of {n} devices in a world of {world} ranks: the mesh "
                         f"takes every rank")
    maybe_initialize_distributed(device)
    return Mesh(shape)


def make_pair_mesh(n_devices: int | None = None, axis: str = "pairs", device=None) -> Mesh:
    """1-D mesh over the whole world (``n_devices`` must equal the world
    size; default: the world).  ``device`` picks the backend of a world this
    call starts (default: the card, NCCL)."""
    return _make({axis: n_devices or world_size()}, device)


def make_2d_mesh(n_pairs: int, n_points: int, device=None) -> Mesh:
    """(pairs, points) mesh: pair-parallel and within-pair point sharding
    (the ``points`` axis is consumed by parallel.point_sharding)."""
    return _make({"pairs": n_pairs, "points": n_points}, device)


def make_point_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """1-D 'points' mesh: all ranks cooperate on ONE large cloud pair."""
    return make_pair_mesh(n_devices, axis="points", device=device)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
