"""The ranks of a ``circuit_mesh`` cell (``kinds/circuit_mesh.py``): one
process a card of one host, as ``torchrun --nproc-per-node N`` starts them.

The harness's own process is rank 0 on ``cuda:0``.  ``start`` spawns ranks
1..N-1, rank r on ``cuda:r`` (the CPU with gloo in the tests), each with
torchrun's environment (``launcher_env``) and one pipe to rank 0.  A rank
answers every message of rank 0 with ``("ok", value)`` or ``("error",
traceback)``:

* ``("scans", scans)``: it puts rank 0's scans on its card, as
  ``kinds/circuit.py``'s set-up puts its own; the value is their digest;
* ``("join",)``: it joins the process group with the configuration's
  timeout and makes the pair mesh;
* ``("unit", k)``: ``run_unit``, the program's ``run_full(mesh=)`` over the
  circuit; the value is the digest of what it returned;
* ``("stop",)``: it leaves the group and ends.

``Ranks.run`` runs rank 0's part of a step while it waits for the others'
answers: a rank that fails, dies or does not answer within the timeout ends
every rank and makes it raise.  A rank ends when rank 0's pipe closes, and
when rank 0's process dies.
"""

from __future__ import annotations

import ctypes
import multiprocessing as mp
import multiprocessing.connection
import os
import signal
import socket
import sys
import threading
import time
import traceback
from datetime import timedelta

import numpy as np

from portbench.work import digest, sync

# seconds rank 0 is given to leave a collective once the other ranks are gone
GRACE_S = 30.0


def free_port() -> int:
    """A free TCP port on this host's loopback, for the group's store."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launcher_env(rank: int, world: int, port: int) -> dict:
    """What torchrun sets for one rank of a single-host world."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def join_group(device, backend: str, world: int, timeout_s: float):
    """Start the default process group from the launcher's environment (the
    rank's card made current first), then the program's pair mesh over it."""
    import torch
    import torch.distributed as dist
    from pcr_tpu_torch.parallel import mesh as mesh_mod

    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", timeout=timedelta(seconds=timeout_s))
    return mesh_mod.make_pair_mesh(world, device=device)


def place(runner, scans) -> None:
    """Rank 0's scans on this rank's card, as ``circuit.Runner.setup`` puts
    its own."""
    from pcr_tpu_torch.utils import cloud

    cap = runner.cfg["scans"]["capacity"]
    runner.scans, runner.n = scans, len(scans)
    runner.clouds = [cloud.from_numpy(s, cap, device=runner.device) for s in scans]


def run_unit(runner, k: int, mesh) -> dict:
    """One circuit through ``run_full(mesh=)`` on this rank, as
    ``kinds/circuit.py``'s unit runs it without a mesh.  ``run_full`` is
    looked up at the call, so that a traced run's wrapper sees it."""
    from pcr_tpu_torch import pipeline

    metrics = pipeline.PairMetrics()
    out = pipeline.run_full(runner.pipeline_config(f"u{k % 2}"), clouds=runner.clouds,
                            n=runner.n, metrics=metrics,
                            methods=tuple(runner.traffic["methods"]), mesh=mesh)
    sync()
    gate = np.array([r["gate_fitness"] for r in metrics.rows if r["stage"] == "mgicp"])
    return {"stage1": out["stage1"], "stage2": out["stage2"], "gate": gate,
            "stage3": {m: np.asarray(p) for m, p in out["stage3"].items()}}


def unit_digest(out: dict) -> str:
    return digest(out["stage1"], out["stage2"], out["gate"],
                  *[out["stage3"][m] for m in sorted(out["stage3"])])


class Ranks:
    """Ranks 1..N-1, spawned; the caller is rank 0."""

    def __init__(self, procs, conns):
        self.procs, self.conns = procs, conns

    def send(self, msg) -> None:
        for c in self.conns:
            c.send(msg)

    def run(self, fn, timeout_s: float):
        """(``fn()``, the other ranks' answers): rank 0's part of a step, run
        here while a thread waits for the others.  A rank that answers with an
        error, dies or is silent for ``timeout_s`` ends every rank and makes
        this raise, with that rank's error; the group is aborted, so that rank
        0 leaves a collective that waits on a rank that is gone, and if it has
        not left it within ``GRACE_S`` this process exits with status 1.  When
        ``fn`` raises, every rank is ended."""
        state: dict = {}
        done = threading.Event()
        watcher = threading.Thread(target=self._watch, args=(timeout_s, state, done),
                                   daemon=True)
        watcher.start()
        try:
            value = fn()
        except BaseException as e:
            done.set()
            self.kill()
            watcher.join()
            if "failure" in state and isinstance(e, Exception):
                raise RuntimeError(state["failure"]) from e
            raise
        done.set()
        watcher.join()
        if "failure" in state:
            raise RuntimeError(state["failure"])
        return value, state["answers"]

    def _watch(self, timeout_s: float, state: dict, done: threading.Event) -> None:
        deadline = time.monotonic() + timeout_s
        answers: dict = {}
        failure = None
        while len(answers) < len(self.conns) and failure is None:
            waiting = [c for c in self.conns if c not in answers]
            for c in mp.connection.wait(waiting, timeout=1.0):
                r = self.conns.index(c) + 1
                try:
                    status, value = c.recv()
                except (EOFError, OSError):
                    failure = f"rank {r} died (exit code {self.procs[r - 1].exitcode})"
                    break
                if status != "ok":
                    failure = f"rank {r} failed:\n{value}"
                    break
                answers[c] = value
            if failure is None and time.monotonic() > deadline:
                failure = f"no answer from every rank within {timeout_s:g} s"
        if failure is None:
            state["answers"] = [answers[c] for c in self.conns]
            return
        state["failure"] = failure
        self.kill()
        _abort_group()
        if not done.wait(GRACE_S):
            print(f"portbench: rank 0 still inside a collective {GRACE_S:g} s after the "
                  f"other ranks were ended: {failure}", file=sys.stderr, flush=True)
            os._exit(1)

    def stop(self, timeout_s: float = 30.0) -> None:
        """Tell every rank to leave the group and end; end what is still
        running after ``timeout_s``."""
        for c in self.conns:
            try:
                c.send(("stop",))
            except OSError:
                pass
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        self.kill()
        for c in self.conns:
            c.close()

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(10)


def _abort_group() -> None:
    """Abort the default process group, so that a collective waiting on a
    rank that is gone returns."""
    import torch.distributed as dist

    abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
    if dist.is_initialized() and abort is not None:
        try:
            abort()
        except Exception as e:                    # the group may be torn down already
            print(f"portbench: aborting the group: {e}", file=sys.stderr)


def start(world: int, port: int, spec: dict, target=None) -> Ranks:
    """Spawn ranks 1..world-1, each running ``target`` (``rank_main``;
    ``spec``: the runner's configuration, traffic, seed, workdir, device
    type, backend and timeout)."""
    ctx = mp.get_context("spawn")
    procs, conns = [], []
    for r in range(1, world):
        ours, theirs = ctx.Pipe()
        p = ctx.Process(target=target or rank_main, args=(r, world, port, theirs, spec),
                        daemon=True)
        p.start()
        theirs.close()
        procs.append(p)
        conns.append(ours)
    return Ranks(procs, conns)


def _die_with_parent() -> None:
    """Linux: this process is killed when the process that spawned it ends."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def rank_main(rank: int, world: int, port: int, conn, spec: dict) -> None:
    _die_with_parent()
    os.dup2(2, 1)                # the harness's standard output carries its result alone
    os.environ.update(launcher_env(rank, world, port))
    import torch

    from portbench.kinds.circuit import Runner

    torch.set_num_threads(1)     # torchrun's OMP_NUM_THREADS for a world of several ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cpu")
    if spec["device_type"] == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)      # the kernels launch on the current card's stream
    mesh = None
    try:
        runner = Runner(spec["cfg"], spec["traffic"], spec["seed"], device, spec["workdir"])
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                return
            if msg[0] == "stop":
                break
            if msg[0] == "scans":
                place(runner, msg[1])
                conn.send(("ok", digest(*runner.scans)))
            elif msg[0] == "join":
                mesh = join_group(device, spec["backend"], world, spec["timeout_s"])
                conn.send(("ok", None))
            elif msg[0] == "unit":
                conn.send(("ok", unit_digest(run_unit(runner, msg[1], mesh))))
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
        raise SystemExit(1)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
