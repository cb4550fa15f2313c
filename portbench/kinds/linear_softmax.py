"""A multinomial logistic regression explained by sampled KernelSHAP.

The configuration gives the data set's column groups and row count, the
model's class count and the scales its seeded weights are drawn at, the
explainer's link, background row count (the first rows, as the task takes
them), coalition budget, instance chunk and result dtype (float16), and how
the results are judged.  The port runs its kernels (on the CPU, as in the
tests, their wrappers' plain versions).  The port sees the model as a
scikit-learn-shaped estimator (``coef_``, ``intercept_``, a numpy
``predict_proba``), which it lifts to one softmax linear predictor.

Judging an explain: phi, f(x) and E of a fixed seeded sample of rows,
every call, against ``reference/linear_softmax.py`` in float64.  Each gap
is taken in units of what float32 and the result's dtype allow an element:
``rel·|ref| + abs + p_ulps · ulp(p) / (p (1 - p))`` with ``p`` the model's
probability behind the element's class (the logit link stretches a float32
rounding of ``p`` by ``1 / (p (1 - p))``) and ``rel`` half an ulp of the
result dtype.  Judging ``rank_features``: each ranked mean |phi| against the
reference's over every row (float32 products, TF32 off, float64 sums) of
the feature named beside it and of the same rank, over the largest.
"""

from typing import Dict, List

import numpy as np
import torch

from portbench import data, precision
from portbench.counts import linear as counts
from portbench.counts.roofline import add
from portbench.reference import coalitions
from portbench.reference import linear_softmax as ref

#: half an ulp of each result dtype the configurations copy phi in
HALF_ULP = {"float16": 2.0 ** -11}


class SoftmaxRegression:
    """``predict_proba`` of a multinomial logistic regression, with
    scikit-learn's fitted attributes ``coef_ (K, D)`` and ``intercept_ (K,)``."""

    def __init__(self, coef, intercept):
        self.coef_ = coef
        self.intercept_ = intercept

    def predict_proba(self, X):
        z = np.asarray(X, np.float64) @ self.coef_.T + self.intercept_
        e = np.exp(z - z.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)


def _f32(a):
    """``a`` rounded to float32 and held as float64: both sides get the
    same numbers."""

    return np.asarray(a, np.float32).astype(np.float64)


def link_tol(fx, abs_floor, p_ulps):
    """What float32 allows a link-space value whose logit is ``fx``."""

    p = 1.0 / (1.0 + np.exp(-np.asarray(fx, np.float64)))
    p = np.clip(p, ref.LOGIT_EPS, 1.0 - ref.LOGIT_EPS)
    ulp = np.spacing(p.astype(np.float32)).astype(np.float64)
    return abs_floor + p_ulps * ulp / (p * (1.0 - p))


class System:
    def __init__(self, cfg, seed, device):
        from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
        from distributedkernelshap_tpu_torch.ops.explain import ShapConfig

        self.cfg, self.device = cfg, torch.device(device)
        ex, model = cfg["explainer"], cfg["model"]
        groups = cfg["groups"]
        self.names = [g["name"] for g in groups]
        self.columns = data.group_columns(groups)
        self.X = data.make_rows(groups, int(cfg["rows"]), seed, "rows", device)
        n_bg = int(ex["background_rows"])
        self.bg = self.X[:n_bg]
        rng = data.host_rng(seed, "model")
        K, D = int(model["classes"]), self.X.shape[1]
        self.coef = _f32(rng.normal(scale=model["coef_scale"], size=(K, D)))
        self.intercept = _f32(rng.normal(scale=model["intercept_scale"], size=K))
        self.est = SoftmaxRegression(self.coef, self.intercept)
        self.plan_seed = int(seed) % (2 ** 31)
        self.mask, self.weights = coalitions.plan(len(groups), ex.get("nsamples"),
                                                  self.plan_seed)
        self.G = np.zeros((len(groups), D), np.float32)
        for g, cols in enumerate(self.columns):
            self.G[g, cols] = 1.0
        self.explainer = KernelShap(
            self.est.predict_proba, link=ex["link"], feature_names=self.names,
            seed=self.plan_seed, device=self.device,
            engine_config=EngineConfig(
                shap=ShapConfig(transfer_dtype=ex["transfer_dtype"], use_kernel=True),
                instance_chunk=int(ex["instance_chunk"])))
        self.explainer.fit(self.bg, group_names=self.names, groups=self.columns)
        judge = cfg["judge"]
        rng = data.host_rng(seed, "judged rows")
        n, R = self.X.shape[0], min(int(judge["rows"]), self.X.shape[0])
        self.judged = np.unique(np.concatenate(
            [[0, n - 1], rng.choice(n, size=max(R - 2, 0), replace=False)]))
        self._references = {}

    # ---------------------------------------------------------------- calls

    def rows(self, traffic):
        return self.X if traffic["rows"] == "all" else self.X[:int(traffic["rows"])]

    def call(self, traffic):
        rows = self.rows(traffic)
        nsamples = self.cfg["explainer"].get("nsamples")
        if traffic["call"] == "rank_features":
            return self.explainer.rank_features(rows, nsamples=nsamples)
        return self.explainer.explain(rows, nsamples=nsamples, **traffic.get("kwargs", {}))

    def keep(self, result, traffic, index=0):
        if traffic["call"] == "rank_features":
            return {"ranking": result}
        idx = self.judged
        return {"phi": np.stack([np.asarray(v)[idx] for v in result.shap_values], 1),
                "raw": np.asarray(result.data["raw"]["raw_prediction"])[idx],
                "ev": np.asarray(result.expected_value, np.float64)}

    def launches(self) -> Dict[str, int]:
        from distributedkernelshap_tpu_torch.ops import cuda_kernels

        return {"fused_linear_ey": int(cuda_kernels.fused_linear_ey.launches)}

    def free_program(self):
        self.explainer = None

    # ----------------------------------------------------------- the judge

    def _ref_args(self):
        ex = self.cfg["explainer"]
        return (self.bg, np.ones(self.bg.shape[0]), self.coef.T, self.intercept, self.G,
                self.mask, self.weights), dict(link_name=ex["link"], ridge=ex["ridge"])

    def reference(self, traffic, device, dtype=torch.float64, tf32=False, rounded=False):
        """The reference's answer to the traffic's call, in ``dtype`` (with
        ``tf32``: float32 products on TF32), in the form ``keep`` gives the
        port's: the control passes ``rounded`` to round phi to the result
        dtype, as the port's copy does."""

        key = (traffic["call"], dtype, tf32, rounded)
        if key in self._references:
            return self._references[key]
        args, kw = self._ref_args()
        with precision.tf32(tf32):
            if traffic["call"] == "rank_features":
                out = {"importance": ref.mean_abs_phi(self.rows(traffic), *args, **kw,
                                                      dtype=dtype, device=device)}
            else:
                td = self.cfg["explainer"]["transfer_dtype"] if rounded else None
                phi, ev, fx = ref.explain(self.rows(traffic)[self.judged], *args, **kw,
                                          dtype=dtype, device=device, transfer_dtype=td)
                out = {"phi": phi, "raw": fx, "ev": ev}
        self._references[key] = out
        return out

    def control(self, traffic, device):
        """What the reference in the next precision below float32 (TF32
        products) gives in the port's place."""

        out = self.reference(traffic, device, dtype=torch.float32, tf32=True, rounded=True)
        if traffic["call"] == "rank_features":
            return {"ranking": _ranking(out["importance"], self.names)}
        return out

    def judge(self, kept: List[dict], traffic, device):
        limits = self.cfg["limits"]
        if traffic["call"] == "rank_features":
            imp_r = self.reference(traffic, device, dtype=torch.float32)["importance"]
            gap = max(_ranking_gap(k["ranking"], imp_r, self.names) for k in kept)
            return [("importance_gap", gap, limits["importance_gap"])]
        r = self.reference(traffic, device)
        j = self.cfg["judge"]
        tol_fx = link_tol(r["raw"], j["abs_floor"], j["p_ulps"])
        rel = HALF_ULP[self.cfg["explainer"]["transfer_dtype"]]
        tol_phi = rel * np.abs(r["phi"]) + tol_fx[:, :, None]
        tol_ev = link_tol(r["ev"], j["abs_floor"], j["p_ulps"])
        phi_gap = max(float((np.abs(k["phi"] - r["phi"]) / tol_phi).max()) for k in kept)
        raw_gap = max(float((np.abs(k["raw"] - r["raw"]) / tol_fx).max()) for k in kept)
        ev_gap = max(float((np.abs(k["ev"] - r["ev"]) / tol_ev).max()) for k in kept)
        return [("phi_gap", phi_gap, limits["phi_gap"]),
                ("raw_gap", raw_gap, limits["raw_gap"]),
                ("ev_gap", ev_gap, limits["ev_gap"])]

    # ------------------------------------------------------------- counts

    def work(self, traffic, device):
        """``{"fused_linear_ey": ..., "call": ...}``: one call's work."""

        ex = self.cfg["explainer"]
        B = self.rows(traffic).shape[0]
        S = int((self.weights > 0).sum())
        N, D = self.bg.shape
        M, K = self.G.shape[0], self.coef.shape[0]
        chunk = int(ex["instance_chunk"])
        sizes = [min(chunk, B - b0) for b0 in range(0, B, chunk)]
        ey = add(*[counts.masked_eval(b, S, N, M, K, D) for b in sizes])
        call = counts.explain(B, S, N, M, K, D, phi_bytes=2.0,
                              return_phi=traffic["call"] != "rank_features")
        return {"fused_linear_ey": ey, "call": call}


def _ranking(imp, names):
    """``rank_features``' structure for a ``(K, M)`` importance."""

    out = {}
    for k, row in enumerate(imp):
        order = np.argsort(row)[::-1]
        out[str(k)] = {"ranked_effect": row[order], "names": [names[i] for i in order]}
    total = imp.sum(0)
    order = np.argsort(total)[::-1]
    out["aggregated"] = {"ranked_effect": total[order], "names": [names[i] for i in order]}
    return out


def _ranking_gap(ranking, imp_r, names):
    """Largest gap, over every class's entry and the aggregate, of each
    ranked value from the reference importance of the feature named beside
    it and from the reference's value at the same rank, over the entry's
    largest reference importance: a wrong value, a name attached to another
    feature's value and an order that is not the reference's all show."""

    pos = {n: i for i, n in enumerate(names)}
    gap = 0.0
    for key, entry in ranking.items():
        ref_k = imp_r.sum(0) if key == "aggregated" else imp_r[int(key)]
        got = np.asarray(entry["ranked_effect"], np.float64)
        by_rank = np.sort(ref_k)[::-1]
        if got.shape != by_rank.shape:
            return float("inf")
        by_name = ref_k[[pos[n] for n in entry["names"]]]
        gap = max(gap, float(np.abs(got - by_name).max() / by_rank[0]),
                  float(np.abs(got - by_rank).max() / by_rank[0]))
    return gap


def build(cfg, seed, device):
    return System(cfg, seed, device)
