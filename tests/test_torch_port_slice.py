"""The PyTorch port's first slice end to end against the JAX package, on the
CPU: ``KernelShap(...).fit(background, groups=...).explain(X)``.

Both explainers get the same data, weights, link and seed (so the same
coalition plan).  Tolerances: the two frameworks reduce f32 sums in other
orders, and the logit link amplifies a probability difference δ into
δ/(p(1-p)) near saturation, which the WLS solve then spreads over the
groups.  Measured on these problems the port sits ~1e-5 from the
reference in phi; the bounds below leave a decade of room and stay far
below the scale of the values (phi of O(1)).
"""

import sys

import numpy as np
import pytest

from distributedkernelshap_tpu import KernelShap as JaxKernelShap
from distributedkernelshap_tpu.models.predictors import LinearPredictor as JaxLinear
from distributedkernelshap_tpu.utils import load_data, load_model
from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
from distributedkernelshap_tpu_torch.convert import kernel_shap_from_numpy
from distributedkernelshap_tpu_torch.ops.explain import ShapConfig

PHI_ATOL = 1e-4       # link-space phi, values of O(1)
RAW_ATOL = 2e-5       # link-space f(x) and E[f(x)]
ADDITIVITY = 1e-3     # the gate of bench.py


def _compare(ref, got, phi_atol=PHI_ATOL):
    assert len(ref.shap_values) == len(got.shap_values)
    for r, g in zip(ref.shap_values, got.shap_values):
        assert g.shape == np.asarray(r).shape
        np.testing.assert_allclose(g, np.asarray(r), atol=phi_atol)
    np.testing.assert_allclose(got.expected_value, np.asarray(ref.expected_value),
                               atol=RAW_ATOL)
    np.testing.assert_allclose(got.data["raw"]["raw_prediction"],
                               np.asarray(ref.data["raw"]["raw_prediction"]),
                               atol=RAW_ATOL)


def _additivity(expl) -> float:
    total = np.stack(expl.shap_values, 1).sum(-1) + np.asarray(expl.expected_value)[None]
    return float(np.abs(total - expl.data["raw"]["raw_prediction"]).max())


@pytest.fixture(scope="module")
def adult():
    data = load_data()
    return {
        "clf": load_model(),
        "group_names": data["all"]["group_names"],
        "groups": data["all"]["groups"],
        "X": data["all"]["X"]["processed"]["test"][:64].toarray().astype(np.float32),
        "background": data["background"]["X"]["preprocessed"],
    }


@pytest.mark.parametrize("use_kernel,path", [(None, "einsum_cached"), (True, "plain")])
def test_adult_headline_matches_jax(adult, use_kernel, path):
    """The paper's task (bench.py:141-169) on 64 Adult test rows: by
    default on the CPU through the plan-constant path, with the kernel
    asked for through the kernel's plain version."""

    gn, groups = adult["group_names"], adult["groups"]
    ref = JaxKernelShap(adult["clf"].predict_proba, link="logit",
                        feature_names=gn, seed=0).fit(
        adult["background"], group_names=gn, groups=groups).explain(adult["X"])
    ks = KernelShap(adult["clf"].predict_proba, link="logit", feature_names=gn,
                    seed=0, device="cpu",
                    engine_config=EngineConfig(shap=ShapConfig(use_kernel=use_kernel)))
    got = ks.fit(adult["background"], group_names=gn, groups=groups).explain(adult["X"])
    assert ks.kernel_path == {"ey": path}
    assert got.shap_values[0].shape == (64, 12)
    _compare(ref, got)
    assert _additivity(got) < ADDITIVITY
    assert got.data["raw"]["importances"]["aggregated"]["names"][0] in gn


def _synthetic(K, activation, seed, n_bg=30, B=24, D=10):
    rng = np.random.default_rng(seed)
    # logits of O(1): far from the f32 saturation the logit link amplifies
    W = rng.normal(scale=0.5, size=(D, K)).astype(np.float32)
    b = rng.normal(size=K).astype(np.float32)
    bg = rng.normal(size=(n_bg, D)).astype(np.float32)
    X = rng.normal(size=(B, D)).astype(np.float32)
    weights = rng.random(n_bg) + 0.5
    return W, b, bg, X, weights


@pytest.mark.parametrize("K,activation,grouped,use_kernel", [
    (7, "softmax", False, None), (7, "softmax", True, None),
    (7, "softmax", False, True), (7, "softmax", True, True),
    (3, "sigmoid", False, True), (3, "sigmoid", True, None),
    (3, "sigmoid", True, True), (2, "identity", True, None),
])
def test_synthetic_linear_matches_jax(K, activation, grouped, use_kernel):
    W, b, bg, X, weights = _synthetic(K, activation, seed=K)
    groups = [[0, 1], [2], [3, 4, 5], [6], [7, 8, 9]] if grouped else None
    names = [f"g{i}" for i in range(len(groups))] if grouped else None
    # ungrouped D=10 enumerates all 1022 coalitions; grouped M=5 all 30
    link = "identity" if activation == "identity" else "logit"
    ref = JaxKernelShap(JaxLinear(W, b, activation), link=link, seed=3).fit(
        bg, group_names=names, groups=groups, weights=weights).explain(X, l1_reg=False)
    ks = kernel_shap_from_numpy(W, b, activation, bg, group_names=names,
                                groups=groups, weights=weights, link=link, seed=3,
                                engine_config=EngineConfig(
                                    shap=ShapConfig(use_kernel=use_kernel)),
                                device="cpu")
    got = ks.explain(X, l1_reg=False)
    # the plan-constant path takes every activation unless the kernel is
    # asked for, and the identity even then
    expect = "einsum_cached" if use_kernel is None or activation == "identity" else "plain"
    assert ks.kernel_path == {"ey": expect}
    _compare(ref, got)
    assert _additivity(got) < ADDITIVITY


def test_sampled_plan_matches_jax():
    """M=14 groups samples the plan (default budget 2076 < 2^14-2)."""

    W, b, bg, X, _ = _synthetic(2, "softmax", seed=11, D=14, B=16)
    ref = JaxKernelShap(JaxLinear(W, b, "softmax"), link="logit", seed=5).fit(bg).explain(
        X, l1_reg=False)
    ks = kernel_shap_from_numpy(W, b, "softmax", bg, link="logit", seed=5, device="cpu")
    got = ks.explain(X, l1_reg=False)
    _compare(ref, got)


def test_l1_and_exact_paths_raise(monkeypatch):
    """l1 selection runs where the reference runs it; only its
    scikit-learn route raises where scikit-learn is missing, naming the
    route.  The exact path refuses a linear model as the JAX package does."""

    W, b, bg, X, _ = _synthetic(2, "softmax", seed=2, D=14, B=4)
    ks = kernel_shap_from_numpy(W, b, "softmax", bg, link="logit", seed=0, device="cpu")
    assert ks.explain(X, nsamples=100).shap_values[0].shape == (4, 14)  # 'auto': AIC
    monkeypatch.setitem(sys.modules, "sklearn", None)     # import sklearn fails
    with pytest.raises(ImportError, match=r"l1_reg=0\.01 \(Lasso\) needs scikit-learn"):
        ks.explain(X, nsamples=100, l1_reg=0.01)
    assert ks.explain(X, nsamples=100, l1_reg="bic").shap_values[0].shape == (4, 14)
    # the exact path takes lifted tree ensembles; a linear model is refused
    # as the JAX package refuses it
    with pytest.raises(ValueError, match="exact"):
        ks.explain(X, nsamples="exact")
    assert ks.explain(X, nsamples=100, l1_reg=False).shap_values[0].shape == (4, 14)


def test_engine_pads_batches_and_takes_tuples():
    W, b, bg, X, _ = _synthetic(2, "softmax", seed=4, B=5)
    ks = kernel_shap_from_numpy(W, b, "softmax", bg, link="logit", seed=0, device="cpu")
    idx, values = ks._explainer.get_explanation((7, X), l1_reg=False)
    assert idx == 7 and values[0].shape == (5, 10)
    single = ks.explain(X[0], l1_reg=False)
    np.testing.assert_allclose(single.shap_values[1][0], values[1][0], atol=1e-5)
