"""Stage 3 on NCLT's relative poses as ``run_stage3_global`` runs it: the
three closed forms, then the pose graph (standard chain start, constant
information matrices) with ``global_optimization``; one refinement a unit."""

from __future__ import annotations

import numpy as np

from portbench import reference as ref
from portbench import scene
from portbench.work import Kind, digest, entry_gap, sync


class Runner(Kind):
    def setup(self):
        import torch

        n = self.traffic["nodes"]
        rel = scene.nclt_relative()[:n].copy()
        # the seed moves each relative pose by a small twist, so every seed
        # is a fresh input of the same size
        p = self.traffic["perturb"]
        rng = np.random.default_rng(self.seed)
        xi = np.concatenate([rng.normal(0, p["rad"], (n, 3)), rng.normal(0, p["m"], (n, 3))], 1)
        rel = np.einsum("nij,njk->nik", ref.exp_se3(torch.as_tensor(xi)).numpy(), rel)
        self.rel = rel
        self.info = np.repeat(np.diag(self.cfg["refine"]["information_diag"])[None], n, 0)
        self.n = n

    def unit(self, k: int):
        import torch

        from pcr_tpu_torch.models.global_refine import closed_form
        from pcr_tpu_torch.models.global_refine import pose_graph
        from pcr_tpu_torch.utils import se3

        out = {"LUM": closed_form.refine_lum(self.rel),
               "SLERP": closed_form.refine_slerp(self.rel),
               "SLERP_LUM": closed_form.refine_slerp_lum(self.rel)}
        infos = torch.as_tensor(self.info, dtype=torch.float32, device=self.device)
        graph = pose_graph.build_circuit_graph(se3.relative_to_absolute_standard(self.rel),
                                               self.rel, infos, device=self.device)
        r = self.cfg["refine"]
        res, info = pose_graph.global_optimization(
            graph, max_correspondence_distance=r["pg_max_corr"],
            edge_prune_threshold=r["pg_prune"], return_info=True)
        out["pose_graph"] = res.nodes.double().cpu().numpy()
        sync()
        return {"stage3": {m: np.asarray(v) for m, v in out.items()}, "info": info}

    def work(self, out) -> int:
        return 1

    def _graph(self):
        n = self.n
        return (np.arange(n), np.r_[np.arange(1, n), 0], np.linalg.inv(self.rel), self.info,
                np.arange(n) == n - 1)

    def _pose_graph(self, dtype):
        r = self.cfg["refine"]
        return ref.pose_graph(ref.chain_standard(self.rel), *self._graph(),
                              max_corr=r["pg_max_corr"], prune=r["pg_prune"], dtype=dtype)

    def control(self, dtype):
        import torch

        np_dt = np.float32 if dtype != torch.float64 else np.float64
        return {"stage3": {"LUM": ref.lum(self.rel, np_dt), "SLERP": ref.slerp(self.rel, np_dt),
                           "SLERP_LUM": ref.slerp_lum(self.rel, np_dt),
                           "pose_graph": self._pose_graph(dtype)[0]}, "info": {}}

    def judge(self, outputs):
        closed = {"LUM": ref.lum(self.rel), "SLERP": ref.slerp(self.rel),
                  "SLERP_LUM": ref.slerp_lum(self.rel)}
        pg, it = self._pose_graph(ref.F64)
        best = ref.objective(pg, *self._graph(), it["mask"], it["mu"])
        seen, nums = {}, {}
        for out in outputs:
            st3 = out["stage3"]
            key = digest(*[st3[m] for m in sorted(st3)])
            if key in seen:
                continue
            seen[key] = True
            cost = ref.objective(st3["pose_graph"], *self._graph(), it["mask"], it["mu"])
            row = {"closed_forms": max(entry_gap(st3[m], closed[m]) for m in closed),
                   "pose_graph": entry_gap(st3["pose_graph"], pg),
                   # the objective's excess over the reference's optimum, per
                   # unit of that optimum (at least 1: a pruned loop leaves ~0)
                   "pose_graph_cost": (cost - best) / max(best, 1.0)}
            for k, v in row.items():
                nums[k] = max(nums.get(k, 0.0), v)
        return nums
