"""Host-side l1 feature selection of the PyTorch port against the JAX
package, on the CPU.

``_lars_knots_batched`` and ``_l1_select_batch`` are the same float64 numpy
in both packages, so on the same designs (random, correlated, collinear:
the cases of ``tests/test_kernel_shap.py``) the selected sets are equal and
the knots agree within 1e-12.  The explains differ only by the f32 sums of
the device pass that feeds the selection, so on the Adult rows (48
ungrouped one-hot columns, 64 rows) a target near an AIC/BIC tie may pick
another set: at least 99% of the B·K targets must select the same set
(measured: all 128 for each mode), and on those phi agrees within
``PHI_ATOL``.
"""

import logging
import sys

import numpy as np
import pytest

from distributedkernelshap_tpu import KernelShap as JaxKernelShap
from distributedkernelshap_tpu.kernel_shap import KernelExplainerEngine as JaxEngine
from distributedkernelshap_tpu.kernel_shap import _l1_select_batch as jax_select
from distributedkernelshap_tpu.kernel_shap import _lars_knots_batched as jax_knots
from distributedkernelshap_tpu.models.predictors import LinearPredictor as JaxLinear
from distributedkernelshap_tpu.utils import load_data, load_model
from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
from distributedkernelshap_tpu_torch import kernel_shap as tks
from distributedkernelshap_tpu_torch.convert import linear_predictor_from_numpy
from distributedkernelshap_tpu_torch.ops import explain as texp
from distributedkernelshap_tpu_torch.ops.explain import ShapConfig

PHI_ATOL = 1e-4       # link-space phi, values of O(1) (tests/test_torch_port_slice.py)
KNOT_ATOL = 1e-12     # the same float64 numpy in both packages
SHARE = 0.99          # targets that must select the same set on the Adult rows


def _design(kind, seed=3):
    """``(Xw, Yw)`` of the reference's l1 tests: a random design with a
    sparse truth, a correlated one (lasso drops, LARS sign flips) and one
    with an exactly duplicated column (degenerate targets)."""

    rng = np.random.default_rng(seed)
    if kind == "correlated":
        S, p, T = int(rng.integers(60, 300)), int(rng.integers(4, 14)), 6
        mix = np.eye(p) + 0.6 * rng.normal(size=(p, p)) / np.sqrt(p)
        Xw = rng.normal(size=(S, p)) @ mix
        C = rng.normal(size=(p, T)) * (rng.random(size=(p, T)) < 0.5)
        return Xw, Xw @ C + 0.1 * rng.normal(size=(S, T))
    S, p, T = (120, 9, 12) if kind == "random" else (120, 6, 8)
    Xw = rng.normal(size=(S, p))
    if kind == "collinear":
        Xw[:, 3] = Xw[:, 2]
    C = rng.normal(size=(p, T)) * (rng.random(size=(p, T)) < (0.4 if kind == "random" else 0.6))
    return Xw, Xw @ C + 0.05 * rng.normal(size=(S, T))


DESIGNS = ["random", "collinear"] + [("correlated", s) for s in (3, 7, 11)]


def _xy(design):
    return _design(*design) if isinstance(design, tuple) else _design(design)


@pytest.mark.parametrize("design", DESIGNS, ids=str)
@pytest.mark.parametrize("lasso", [True, False])
def test_lars_knots_batched_matches_jax(design, lasso):
    Xw, Yw = _xy(design)
    G, XtY = Xw.T @ Xw, Xw.T @ Yw
    steps = 8 * G.shape[0] + 16 if lasso else 3
    ref, ref_ok = jax_knots(G, XtY, max_steps=steps, lasso=lasso)
    got, got_ok = tks._lars_knots_batched(G, XtY, max_steps=steps, lasso=lasso)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=KNOT_ATOL)
    np.testing.assert_array_equal(got_ok, ref_ok)


@pytest.mark.parametrize("design", DESIGNS, ids=str)
@pytest.mark.parametrize("mode", ["aic", "bic", "num_features(3)", 0.01, True])
def test_l1_select_batch_matches_jax(design, mode, caplog):
    """The same selected sets, degenerate targets (the collinear design)
    included: both packages send them to scikit-learn's per-target path
    and log it."""

    Xw, Yw = _xy(design)
    with caplog.at_level(logging.WARNING):
        got = tks._l1_select_batch(Xw, Yw, mode)
    ref = jax_select(Xw, Yw, mode)
    assert len(got) == len(ref) == Yw.shape[1]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    if design == "collinear" and mode == "aic":
        # the port logs a degenerate target's fallback as the reference does
        assert any("degenerate" in r.message for r in caplog.records)
    with pytest.raises(ValueError):
        tks._l1_select_batch(Xw, Yw, "bogus")


def test_l1_sklearn_routes_raise_without_sklearn(monkeypatch):
    """Without scikit-learn the LARS routes run on numpy; the float route
    and a degenerate target's fallback raise an ImportError naming their
    route."""

    Xw, Yw = _design("random")
    ref = jax_select(Xw, Yw, "aic")
    monkeypatch.setitem(sys.modules, "sklearn", None)      # import sklearn fails
    for g, r in zip(tks._l1_select_batch(Xw, Yw, "aic"), ref):
        np.testing.assert_array_equal(g, r)
    with pytest.raises(ImportError, match=r"Lasso\) needs scikit-learn.*'num_features"):
        tks._l1_select_batch(Xw, Yw, 0.01)
    Xc, Yc = _design("collinear")
    with pytest.raises(ImportError, match="degenerate-target fallback"):
        tks._l1_select_batch(Xc, Yc, "aic")


@pytest.fixture(scope="module")
def adult_ungrouped():
    data = load_data()
    return {
        "clf": load_model(),
        "X": data["all"]["X"]["processed"]["test"][:64].toarray().astype(np.float32),
        "background": data["background"]["X"]["preprocessed"],
    }


def _selected(phi):
    """Each target's selected set: the nonzero groups before the last,
    which takes the additivity remainder."""

    return [tuple(np.flatnonzero(row[:-1])) for row in phi.reshape(-1, phi.shape[-1])]


@pytest.mark.parametrize("l1_reg", ["auto", "num_features(5)", "bic"])
def test_adult_ungrouped_l1_matches_jax(adult_ungrouped, l1_reg, caplog):
    """The default explain of the 48 one-hot Adult columns runs AIC
    selection (2144 of 2^48 coalitions) in both packages."""

    a = adult_ungrouped
    ref = JaxKernelShap(a["clf"].predict_proba, link="logit", seed=0).fit(
        a["background"]).explain(a["X"], l1_reg=l1_reg)
    with caplog.at_level(logging.WARNING):
        got = KernelShap(a["clf"].predict_proba, link="logit", seed=0, device="cpu").fit(
            a["background"]).explain(a["X"], l1_reg=l1_reg)
    assert any("l1_reg='auto'" in r.message for r in caplog.records) == (l1_reg == "auto")
    phi_ref = np.stack([np.asarray(v) for v in ref.shap_values], 1)
    phi = np.stack(got.shap_values, 1)
    assert phi.shape == phi_ref.shape == (64, 2, 48)
    same = np.array([s == r for s, r in zip(_selected(phi), _selected(phi_ref))])
    assert same.mean() >= SHARE, same.mean()
    np.testing.assert_allclose(phi.reshape(-1, 48)[same], phi_ref.reshape(-1, 48)[same],
                               atol=PHI_ATOL)
    total = phi.sum(-1) + np.asarray(got.expected_value)[None]
    np.testing.assert_allclose(total, got.data["raw"]["raw_prediction"], atol=1e-4)


def test_l1_device_pass_takes_the_kernel_route(monkeypatch):
    """With the kernel asked for, the l1 device pass goes through the
    ``fused_linear_ey`` wrapper (here on CPU tensors: its plain version),
    and the restricted solve keeps additivity; the auto rule's warning fires
    and phi matches the JAX engine."""

    rng = np.random.default_rng(1)
    D, N, B = 20, 10, 3
    W = rng.normal(scale=0.5, size=(D, 2)).astype(np.float32)
    b = rng.normal(size=2).astype(np.float32)
    bg = rng.normal(size=(N, D)).astype(np.float32)
    X = rng.normal(size=(B, D)).astype(np.float32)
    calls = []
    wrapper = texp.fused_linear_ey
    monkeypatch.setattr(texp, "fused_linear_ey",
                        lambda *a: calls.append(a[0].shape) or wrapper(*a))
    engine = tks.KernelExplainerEngine(
        linear_predictor_from_numpy(W, b, "softmax", device="cpu"), bg, link="logit",
        seed=0, config=EngineConfig(device="cpu", shap=ShapConfig(use_kernel=True)))
    sv = engine.get_explanation(X, nsamples=300, l1_reg="auto")
    # the explain's pass (bucket-padded to 4 rows), then the l1 pass on X
    assert calls == [(4, D, 2), (B, D, 2)]
    assert engine.kernel_path == {"ey": "plain"}
    fx = engine.predict(X, link=True)
    total = np.stack(sv, 1).sum(-1) + np.atleast_1d(engine.expected_value)[None]
    np.testing.assert_allclose(total, fx, atol=1e-4)
    ref = JaxEngine(JaxLinear(W, b, "softmax"), bg, link="logit", seed=0).get_explanation(
        X, nsamples=300, l1_reg="auto")
    same = np.array([s == r for s, r in zip(_selected(np.stack(sv, 1)),
                                            _selected(np.stack(ref, 1)))])
    assert same.all()
    np.testing.assert_allclose(np.stack(sv, 1), np.stack(ref, 1), atol=PHI_ATOL)
