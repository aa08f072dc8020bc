"""SLAM mode: ``graph_builder.full_registration_batched`` over a path of
``scans`` scans at k-connectivity ``k``, then
``pose_graph.global_optimization`` of the graph; one graph a unit."""

from __future__ import annotations

import numpy as np

from portbench import reference as ref
from portbench import scene
from portbench.work import Kind, digest, entry_gap, pose_gap, sync


class Runner(Kind):
    def setup(self):
        from pcr_tpu_torch.utils import cloud

        s = self.cfg["scans"]
        self.scans, self.absolute = scene.make_kgraph_path(
            self.traffic["scans"], self.seed, self.cfg["scene_seed"],
            points=tuple(s["points"]), steps_m=tuple(s["steps_m"]), noise_m=s["noise_m"])
        self.clouds = [cloud.from_numpy(sc, s["capacity"], device=self.device)
                       for sc in self.scans]

    def unit(self, k: int):
        from pcr_tpu_torch.models import graph_builder
        from pcr_tpu_torch.models.global_refine import pose_graph

        b = self.cfg["k_graph"]
        graph = graph_builder.full_registration_batched(
            self.clouds, voxel_size=b["voxel_size"], k=self.traffic["k"], log=None,
            n_scales=b["n_scales"], iterations=b["iterations"],
            batch_size=self.traffic["batch_size"])
        out, info = pose_graph.global_optimization(
            graph, max_correspondence_distance=b["pg_max_corr"],
            edge_prune_threshold=b["pg_prune"], return_info=True)
        sync()
        f = lambda x: x.detach().double().cpu().numpy()        # noqa: E731
        return {"src": graph.edge_src.cpu().numpy(), "dst": graph.edge_dst.cpu().numpy(),
                "edge_T": f(graph.edge_T), "edge_info": f(graph.edge_info),
                "nodes": f(out.nodes), "info": info}

    def work(self, out) -> int:
        return len(out["src"])

    def _truth(self, s, t):
        return np.linalg.inv(self.absolute[t]) @ self.absolute[s]

    def _icp(self, s, t, dtype=ref.F64):
        c = self.cfg["check"]
        return ref.icp(self.scans[s], self.scans[t], self._truth(s, t), voxel=c["voxel"],
                       max_dist=c["icp_max_dist"], dtype=dtype)

    def _infos(self, src, dst, edge_T, dtype):
        c = self.cfg["check"]
        return np.stack([ref.information(self.scans[s], self.scans[t], edge_T[e],
                                         c["info_dist"], dtype)
                         for e, (s, t) in enumerate(zip(src, dst))])

    def _nodes(self, src, dst, edge_T, infos, dtype):
        """The reference's optimised nodes of the graph whose edges are given:
        start from the odometry chain (node i+1 = node i edge^-1), as
        ``full_registration_batched`` does."""
        nodes0 = [np.eye(4)]
        odo = np.eye(4)
        for e, (s, t) in enumerate(zip(src, dst)):
            if t == s + 1:
                odo = edge_T[e] @ odo
                nodes0.append(np.linalg.inv(odo))
        b = self.cfg["k_graph"]
        nodes, _ = ref.pose_graph(np.stack(nodes0), src, dst, edge_T, infos,
                                  np.asarray(dst) != np.asarray(src) + 1,
                                  max_corr=b["pg_max_corr"], prune=b["pg_prune"], dtype=dtype)
        return nodes

    def control(self, dtype):
        n, k = len(self.scans), self.traffic["k"]
        pairs = [(s, t) for s in range(n) for t in range(s + 1, min(s + k + 1, n))]
        src, dst = np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs])
        T = np.stack([self._icp(s, t, dtype) for s, t in pairs])
        infos = self._infos(src, dst, T, dtype)
        return {"src": src, "dst": dst, "edge_T": T, "edge_info": infos,
                "nodes": self._nodes(src, dst, T, infos, dtype), "info": {}}

    def judge(self, outputs):
        T_ref, chain, seen, nums = {}, {}, {}, {}
        for out in outputs:
            key = digest(out["edge_T"], out["edge_info"], out["nodes"])
            if key in seen:
                continue
            seen[key] = True
            src, dst = out["src"], out["dst"]
            for s, t in zip(src, dst):
                if (s, t) not in T_ref:
                    T_ref[(s, t)] = self._icp(s, t)
            edges = tuple(zip(src.tolist(), dst.tolist()))
            if edges not in chain:
                # the nodes as the reference derives them from its own edges,
                # from the truth
                T = np.stack([T_ref[e] for e in edges])
                chain[edges] = self._nodes(src, dst, T, self._infos(src, dst, T, ref.F64),
                                           ref.F64)
            gaps = [pose_gap(out["edge_T"][e], T_ref[st]) for e, st in enumerate(edges)]
            infos = self._infos(src, dst, out["edge_T"], ref.F64)
            info_rel = [np.abs(out["edge_info"][e] - I).max() / np.abs(I).max()
                        for e, I in enumerate(infos)]
            nodes = self._nodes(src, dst, out["edge_T"], infos, ref.F64)
            row = {"edge_mm": max(a for a, _ in gaps), "edge_mdeg": max(b for _, b in gaps),
                   "info_rel": float(max(info_rel)), "nodes": entry_gap(out["nodes"], nodes),
                   "nodes_chain": entry_gap(out["nodes"], chain[edges])}
            for k, v in row.items():
                nums[k] = max(nums.get(k, 0.0), v)
        return nums
