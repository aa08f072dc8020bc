"""One closed-loop client: request k is ``pipeline.run_pair(cfg, s, t,
init=<the mix's init>)`` for the circuit's pair k (mod n) in turn, the scans
read from binary PCD files under the run's temporary directory."""

from __future__ import annotations

import os

import numpy as np

from portbench import reference as ref
from portbench import scene
from portbench.work import Kind, pose_gap, scene_args, sync


class Runner(Kind):
    def setup(self):
        n = self.traffic["scans"]
        self.scans, self.gt, _ = scene.make_circuit(n, self.seed, self.cfg["scene_seed"],
                                                    **scene_args(self.cfg))
        self.n = n
        d = os.path.join(self.workdir, "reference", "nuvens", "nuvens_pre_processadas",
                         self.cfg["dataset"])
        os.makedirs(d, exist_ok=True)
        for i, s in enumerate(self.scans):
            scene.write_pcd(os.path.join(d, f"s{i}.pcd"), s)
        from pcr_tpu_torch.utils import poses_io

        # the program reads PCR_REFERENCE_ROOT once, when it is imported; the
        # harness sets it before that, and this states it for the record
        poses_io.REFERENCE_ROOT = os.environ["PCR_REFERENCE_ROOT"]
        self.pcfg = self.pipeline_config("pair")

    def unit(self, k: int):
        from pcr_tpu_torch import pipeline

        s, t = (k + 1) % self.n, k % self.n
        out = pipeline.run_pair(self.pcfg, s, t, init=self.traffic["init"], device=self.device)
        sync()
        return {"src": s, "tgt": t, "T": np.asarray(out["T"]), "fitness": out["fitness"],
                "rmse": out["rmse"], "info_trace": out["info_trace"]}

    def work(self, out) -> int:
        return 1

    def control_units(self) -> int:
        return self.n

    def control(self, dtype):
        c = self.cfg["check"]
        outs = []
        for k in range(self.n):
            s, t = (k + 1) % self.n, k
            T = ref.icp(self.scans[s], self.scans[t], self.gt[t], voxel=c["voxel"],
                        max_dist=c["icp_max_dist"], dtype=dtype)
            info = ref.information(self.scans[t], self.scans[s], np.linalg.inv(T),
                                   c["info_dist"], dtype)
            outs.append({"src": s, "tgt": t, "T": T, "info_trace": float(np.trace(info))})
        return outs

    def judge(self, outputs):
        c = self.cfg["check"]
        by_pair = {}
        for out in outputs:
            by_pair.setdefault((out["src"], out["tgt"]), []).append(out)
        keys = sorted(by_pair)
        m = min(len(keys), self.traffic["check_pairs"])
        pick = [keys[i] for i in sorted(self.rng.choice(len(keys), m, replace=False))]
        nums = {}
        for s, t in pick:
            T_ref = ref.icp(self.scans[s], self.scans[t], self.gt[t], voxel=c["voxel"],
                            max_dist=c["icp_max_dist"])
            for out in by_pair[(s, t)]:
                a, b = pose_gap(out["T"], T_ref)
                tr = float(np.trace(ref.information(self.scans[t], self.scans[s],
                                                    np.linalg.inv(out["T"]), c["info_dist"])))
                row = {"gicp_mm": a, "gicp_mdeg": b,
                       "info_trace": abs(out["info_trace"] - tr) / tr}
                for k, v in row.items():
                    nums[k] = max(nums.get(k, 0.0), v)
        return nums
