"""A boosted tree regressor explained by exact interventional TreeSHAP.

The configuration gives the data set's column groups, the explained and
background row counts, the ensemble's tree count, leaf cap and leaf value
scale, its offset, the rows the trees are grown on, and how the results are
judged.  The trees are grown from the seed: each best-first (split the leaf
holding the most growing rows) to at most the leaf cap, on a random column
that varies at the leaf and a threshold drawn from that column's values
there (``x <= t`` goes left), leaf values normal.  The port gets the node
tables as its ``TreeEnsemblePredictor`` and runs its kernels (on the CPU,
as in the tests, their wrappers' plain versions); the reference reads the
same tables.

Judging: phi, the interaction matrices, f(x) and E of every row of the
first two calls and a seeded share of the others (``judge.call_share``)
against ``reference/treeshap.py`` in float64, as one number: the
largest gap of any of them over ``max(1, max |reference|)`` of its kind.
"""

from typing import Dict, List

import numpy as np
import torch

from portbench import data, precision
from portbench.counts import trees as counts
from portbench.reference import treeshap as ref


def grow(rng, sample, n_trees, max_leaves, leaf_scale):
    """Node tables of ``n_trees`` trees grown over ``sample``'s columns."""

    n_nodes = 2 * max_leaves - 1
    feature = np.zeros((n_trees, n_nodes), np.int64)
    threshold = np.full((n_trees, n_nodes), np.inf, np.float32)
    left = np.tile(np.arange(n_nodes), (n_trees, 1))
    right = left.copy()
    value = np.zeros((n_trees, n_nodes, 1), np.float32)
    depth = 0
    for t in range(n_trees):
        leaves = {0: np.arange(sample.shape[0])}
        node_depth = {0: 0}
        used = 1
        while len(leaves) < max_leaves:
            j = max(leaves, key=lambda leaf: leaves[leaf].shape[0])
            sub = sample[leaves[j]]
            cols = np.flatnonzero(np.ptp(sub, axis=0) > 0)
            if not cols.size:
                break
            c = int(rng.choice(cols))
            thr = np.float32(rng.choice(np.unique(sub[:, c])[:-1]))
            go_left = sub[:, c] <= thr
            lc, rc = used, used + 1
            used += 2
            feature[t, j], threshold[t, j], left[t, j], right[t, j] = c, thr, lc, rc
            leaves[lc], leaves[rc] = leaves[j][go_left], leaves[j][~go_left]
            del leaves[j]
            node_depth[lc] = node_depth[rc] = node_depth[j] + 1
        for leaf in leaves:
            value[t, leaf, 0] = rng.normal(scale=leaf_scale)
        depth = max(depth, max(node_depth.values()))
    return {"feature": feature, "threshold": threshold, "left": left, "right": right,
            "value": value, "depth": depth}


class System:
    def __init__(self, cfg, seed, device):
        from distributedkernelshap_tpu_torch import EngineConfig, KernelShap, TreeEnsemblePredictor
        from distributedkernelshap_tpu_torch.ops.explain import ShapConfig

        self.cfg, self.device = cfg, torch.device(device)
        ex, model = cfg["explainer"], cfg["model"]
        groups = cfg["groups"]
        self.names = [g["name"] for g in groups]
        self.columns = data.group_columns(groups)
        sample = data.make_rows(groups, int(model["grow_rows"]), seed, "grow", device)
        self.tables = grow(data.host_rng(seed, "trees"), sample, int(model["trees"]),
                           int(model["max_leaves"]), float(model["leaf_scale"]))
        self.base = float(np.float32(model["base"]))
        self.X = data.make_rows(groups, int(cfg["rows"]), seed, "rows", device)
        self.bg = data.make_rows(groups, int(ex["background_rows"]), seed, "background",
                                 device)
        tb = self.tables
        predictor = TreeEnsemblePredictor(
            tb["feature"], tb["threshold"], tb["left"], tb["right"], tb["value"],
            depth=tb["depth"], aggregation="sum", base=[self.base],
            out_transform="identity", vector_out=False, device=self.device)
        self.explainer = KernelShap(
            predictor, task="regression", seed=int(seed) % (2 ** 31), device=self.device,
            engine_config=EngineConfig(shap=ShapConfig(use_kernel=True)))
        self.explainer.fit(self.bg, group_names=self.names, groups=self.columns)
        self._judged_calls = data.host_rng(seed, "judged calls")

    def rows(self, traffic):
        return self.X if traffic["rows"] == "all" else self.X[:int(traffic["rows"])]

    def call(self, traffic):
        return self.explainer.explain(self.rows(traffic), **traffic.get("kwargs", {}))

    def keep(self, result, traffic, index=0):
        """The results of the first two calls and of a seeded share of the
        rest, whole; the others are let go as a caller would."""

        if index >= 2 and self._judged_calls.random() >= self.cfg["judge"]["call_share"]:
            return None
        raw = result.data["raw"]
        inter = raw.get("interaction_values")
        return {"phi": np.asarray(result.shap_values[0]),
                "inter": None if inter is None else np.asarray(inter[0]),
                "raw": np.asarray(raw["raw_prediction"]).reshape(-1),
                "ev": float(np.ravel(result.expected_value)[0])}

    def launches(self) -> Dict[str, int]:
        from distributedkernelshap_tpu_torch.ops import cuda_kernels

        return {"exact_tree_phi": int(cuda_kernels.exact_tree_phi.launches),
                "exact_tree_inter": int(cuda_kernels.exact_tree_inter.launches)}

    def free_program(self):
        self.explainer = None

    def reference(self, traffic, device, dtype=torch.float64, tf32=False):
        inter = bool(traffic.get("kwargs", {}).get("interactions"))
        with precision.tf32(tf32):
            phi, ev, fx, im = ref.explain(self.rows(traffic), self.bg,
                                          np.ones(self.bg.shape[0]), self.tables,
                                          self.columns, base=self.base, interactions=inter,
                                          dtype=dtype, device=device)
        return {"phi": phi, "inter": im, "raw": fx, "ev": ev}

    def control(self, traffic, device):
        return self.reference(traffic, device, dtype=torch.float32, tf32=True)

    def judge(self, kept: List[dict], traffic, device):
        """One number: the largest gap, over every call, of phi, the
        interaction matrices, f(x) and E, each over ``max(1, max |ref|)``.
        The control's TF32 products reach only the interaction sums (phi,
        f(x) and E are sums the reference forms without a matrix product
        on the tensor cores), so one number carries all four."""

        r = self.reference(traffic, device)
        gap = 0.0
        for name in ("phi", "inter", "raw", "ev"):
            if r[name] is None:
                continue
            scale = max(1.0, float(np.abs(r[name]).max()))
            for k in kept:
                gap = max(gap, float(np.abs(np.asarray(k[name], np.float64) - r[name]).max())
                          / scale)
        return [("exact_gap", gap, self.cfg["limits"]["exact_gap"])]

    def work(self, traffic, device):
        """``{"exact_tree_inter": ..., "call": ...}``: one call's work,
        counted from the reach tests of these rows and this background."""

        X = self.rows(traffic)
        M, D = len(self.columns), X.shape[1]
        col_group = np.zeros(D, np.int64)
        for g, cols in enumerate(self.columns):
            col_group[cols] = g
        paths = ref.leaf_paths(self.tables)
        dev = torch.device(device)
        pt = tuple(torch.as_tensor(a, device=dev) for a in paths[:4])
        cg = torch.as_tensor(col_group, device=dev)
        with torch.no_grad():
            x_fail, on_path = ref.group_failures(torch.as_tensor(X, device=dev), pt, cg, M)
            z_fail, _ = ref.group_failures(torch.as_tensor(self.bg, device=dev), pt, cg, M)
            stats = counts.triple_stats(x_fail, z_fail, on_path)
        n_internal = int(paths[3].shape[0]) - int(self.tables["feature"].shape[0])
        tables_b = counts.table_bytes(n_internal, int(paths[3].shape[0]))
        B, N = X.shape[0], self.bg.shape[0]
        out = {"call": counts.explain_interactions(stats, B, N, D, M, n_internal, tables_b)}
        if traffic.get("kwargs", {}).get("interactions"):
            out["exact_tree_inter"] = counts.interactions(stats, B, N, D, M, tables_b)
        return out


def build(cfg, seed, device):
    return System(cfg, seed, device)
