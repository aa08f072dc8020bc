"""``pipeline.run_full`` over a closed circuit of ``scans`` scans (stages
1 -> 3, the methods of the traffic), one circuit a unit."""

from __future__ import annotations

import numpy as np

from portbench import reference as ref
from portbench import scene
from portbench.work import Kind, digest, entry_gap, pose_gap, scene_args, sync

CLOSED = {"LUM": ref.lum, "SLERP": ref.slerp, "SLERP_LUM": ref.slerp_lum}


class Runner(Kind):
    def setup(self):
        from pcr_tpu_torch.utils import cloud

        n = self.traffic["scans"]
        self.scans, self.gt, _ = scene.make_circuit(n, self.seed, self.cfg["scene_seed"],
                                                    **scene_args(self.cfg))
        cap = self.cfg["scans"]["capacity"]
        self.clouds = [cloud.from_numpy(s, cap, device=self.device) for s in self.scans]
        self.n = n

    def unit(self, k: int):
        from pcr_tpu_torch import pipeline

        metrics = pipeline.PairMetrics()
        out = pipeline.run_full(self.pipeline_config(f"u{k % 2}"), clouds=self.clouds, n=self.n,
                                metrics=metrics, methods=tuple(self.traffic["methods"]))
        sync()
        gate = np.array([r["gate_fitness"] for r in metrics.rows if r["stage"] == "mgicp"])
        return {"stage1": out["stage1"], "stage2": out["stage2"], "gate": gate,
                "stage3": {m: np.asarray(p) for m, p in out["stage3"].items()}}

    def work(self, out) -> int:
        return self.n

    def pairs(self):
        return [((k + 1) % self.n, k) for k in range(self.n)]

    def _icp(self, dtype=ref.F64):
        """The reference's pose of every pair, from the truth."""
        c = self.cfg["check"]
        return np.stack([ref.icp(self.scans[s], self.scans[t], self.gt[k], voxel=c["voxel"],
                                 max_dist=c["icp_max_dist"], dtype=dtype)
                         for k, (s, t) in enumerate(self.pairs())])

    def _stage3(self, rel, dtype):
        """The reference's four stage-3 trajectories on relative poses ``rel``."""
        import torch

        np_dt = np.float32 if dtype != torch.float64 else np.float64
        st3 = {m: f(rel, np_dt) for m, f in CLOSED.items()}
        st3["pose_graph"] = self._pose_graph(rel, dtype)
        return st3

    def control(self, dtype):
        """The reference in the program's place, ``dtype`` below the
        program's precision: its own poses from the truth, fitness, closed
        forms (float32) and pose graph."""
        c = self.cfg["check"]
        T = self._icp(dtype)
        gate = np.array([ref.fitness(self.scans[s], self.scans[t], T[k], c["gate_dist"], dtype)
                         for k, (s, t) in enumerate(self.pairs())])
        return {"stage1": T, "stage2": T, "gate": gate, "stage3": self._stage3(T, dtype)}

    def _pose_graph(self, rel, dtype):
        c = self.cfg["check"]
        infos = np.stack([ref.information(self.scans[t], self.scans[s], np.linalg.inv(rel[k]),
                                          c["info_dist"], dtype)
                          for k, (s, t) in enumerate(self.pairs())])
        n = self.n
        nodes, _ = ref.pose_graph(ref.chain_standard(rel), np.arange(n),
                                  np.r_[np.arange(1, n), 0], np.linalg.inv(rel), infos,
                                  np.arange(n) == n - 1, max_corr=c["pg_max_corr"],
                                  prune=c["pg_prune"], dtype=dtype)
        return nodes

    def judge(self, outputs):
        c = self.cfg["check"]
        pairs = self.pairs()
        T_ref = self._icp()
        # stage 3 as the reference derives it from its own chain, from the truth
        chain = self._stage3(T_ref, ref.F64)
        seen, nums = {}, {}
        for out in outputs:
            key = digest(out["stage1"], out["stage2"], out["gate"],
                         *[out["stage3"][m] for m in sorted(out["stage3"])])
            if key in seen:
                continue
            seen[key] = True
            g1 = [pose_gap(out["stage1"][k], T_ref[k]) for k in range(self.n)]
            g2 = [pose_gap(out["stage2"][k], T_ref[k]) for k in range(self.n)]
            gate = [abs(out["gate"][k] - ref.fitness(self.scans[s], self.scans[t],
                                                     out["stage2"][k], c["gate_dist"]))
                    for k, (s, t) in enumerate(pairs)]
            rel = out["stage2"]
            st3 = out["stage3"]
            row = {
                "fgr_mm": max(a for a, _ in g1), "fgr_mdeg": max(b for _, b in g1),
                "gicp_mm": max(a for a, _ in g2), "gicp_mdeg": max(b for _, b in g2),
                "gate": max(gate),
                "closed_forms": max(entry_gap(st3[m], f(rel))
                                    for m, f in CLOSED.items() if m in st3),
                "stage3_chain": max(entry_gap(st3[m], chain[m]) for m in chain if m in st3),
            }
            if "pose_graph" in st3:
                row["pose_graph"] = entry_gap(st3["pose_graph"], self._pose_graph(rel, ref.F64))
            for k, v in row.items():
                nums[k] = max(nums.get(k, 0.0), v)
        return nums
