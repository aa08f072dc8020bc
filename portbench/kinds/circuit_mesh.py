"""``pipeline.run_full(mesh=make_pair_mesh(ranks))`` over a closed circuit
of ``scans`` scans on ``ranks`` cards of one host, one process a card as
``torchrun --nproc-per-node <ranks> -m pcr_tpu_torch full --devices <ranks>``
runs it: each rank registers a contiguous block of the circuit's pairs, the
blocks are gathered, rank 0 runs stage 3 and writes the files.  One circuit
a unit (stages 1 -> 3, the traffic's methods).

The harness's process is rank 0 on ``cuda:0``; ``setup`` spawns the others
on ``cuda:1``.. (``mesh_worker.py``), makes the scans from the seed once and
sends them to every rank (checked by digest), and starts the process group
(the configuration's ``mesh.backend`` on the cards, gloo on the CPU) with
its ``mesh.timeout_s`` before the program sees it.  ``unit`` sends k to the ranks and runs rank 0's
part; every rank returns the same result (checked by digest).  A rank that
fails, dies or does not answer within the timeout ends the others and makes
``setup`` or ``unit`` raise; so does a program whose ``run_full`` takes no
mesh, before any rank starts.  ``judge`` and ``control`` are
``circuit.py``'s: a mesh changes where pairs run, not what they compute.
The profiler and the harness see this process alone, so a traced run's
per-layer metrics and the peak memory are rank 0's.
"""

from __future__ import annotations

import inspect
import os

from portbench import mesh_worker
from portbench.kinds import circuit
from portbench.work import digest


class Runner(circuit.Runner):
    # what each spawned rank runs
    rank_main = staticmethod(mesh_worker.rank_main)
    ranks = None

    def setup(self):
        import torch

        from pcr_tpu_torch import pipeline

        if "mesh" not in inspect.signature(pipeline.run_full).parameters:
            raise RuntimeError("the program's run_full takes no mesh=: it cannot run a "
                               "circuit over a pair mesh")
        m = self.cfg["mesh"]
        self.world, self.timeout_s = int(self.traffic["ranks"]), float(m["timeout_s"])
        on_card = self.device.type == "cuda"
        backend = m["backend"] if on_card else "gloo"
        port = mesh_worker.free_port()
        os.environ.update(mesh_worker.launcher_env(0, self.world, port))
        self.ranks = mesh_worker.start(self.world, port, dict(
            cfg=self.cfg, traffic=self.traffic, seed=self.seed, workdir=self.workdir,
            device_type=self.device.type, backend=backend, timeout_s=self.timeout_s),
            self.rank_main)
        try:
            if on_card:   # built once here, before the other ranks load it
                from pcr_tpu_torch.ops.kernels import build

                torch.cuda.set_device(self.device)
                build.build()
            super().setup()

            def send_scans():
                self.ranks.send(("scans", self.scans))
                return digest(*self.scans)

            mine, theirs = self.ranks.run(send_scans, self.timeout_s)
            if any(d != mine for d in theirs):
                raise RuntimeError("the ranks hold other scans than rank 0")
            self.ranks.send(("join",))
            self.mesh, _ = self.ranks.run(lambda: mesh_worker.join_group(
                self.device, backend, self.world, self.timeout_s), self.timeout_s)
        except BaseException:
            self.release()
            raise

    def unit(self, k: int):
        self.ranks.send(("unit", k))
        out, theirs = self.ranks.run(
            lambda: mesh_worker.run_unit(self, k, self.mesh), self.timeout_s)
        if any(d != mesh_worker.unit_digest(out) for d in theirs):
            raise RuntimeError("the ranks returned different results")
        return out

    def release(self):
        import torch.distributed as dist

        if self.ranks is not None:
            self.ranks.stop()
            self.ranks = None
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in mesh_worker.launcher_env(0, 1, 0):
            os.environ.pop(k, None)
        super().release()
