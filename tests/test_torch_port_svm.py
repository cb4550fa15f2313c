"""The PyTorch port's SVM and Gaussian quadratic lifts against the JAX
package, on the CPU: ``models/svm.py`` (``SVMPredictor``, its forward and
its ``masked_ey`` in all four kernels, ``lift_svm`` and its declines) and
``models/quadratic.py`` (``QuadraticDiscriminantPredictor``,
``lift_gaussian_quadratic``), with ``convert.svm_from_numpy`` /
``quadratic_from_numpy`` and the end-to-end ``KernelShap`` explain.

Real scikit-learn estimators are fitted on small seeded data (the cases of
``tests/test_svm_lift.py`` and ``tests/test_quadratic_lift.py``) and lifted
by both packages.  Tolerances: lifted buffers equal the JAX lift's arrays
(``array_equal``); predictions port vs JAX within ``PRED_REL · max(1,
|f|)``, and port vs scikit-learn within the JAX package's own bars (2e-5
and 5e-5 scaled, the reference tests'); ``masked_ey`` port vs JAX and vs
the port's row evaluation within ``EY_REL · max(1, max|ey|)``; phi port vs
JAX within 1e-4 (identity link) and 1e-3 (logit link).
"""

import warnings

import numpy as np
import pytest
import torch

from distributedkernelshap_tpu import KernelShap as JaxKernelShap
from distributedkernelshap_tpu.models import as_predictor as jax_as_predictor
from distributedkernelshap_tpu.models.quadratic import (
    lift_gaussian_quadratic as jax_lift_quadratic,
)
from distributedkernelshap_tpu.models.svm import lift_svm as jax_lift_svm
from distributedkernelshap_tpu.ops.coalitions import coalition_plan
from distributedkernelshap_tpu.ops.explain import groups_to_matrix
from distributedkernelshap_tpu_torch import KernelShap
from distributedkernelshap_tpu_torch.convert import quadratic_from_numpy, svm_from_numpy
from distributedkernelshap_tpu_torch.models import (
    CallbackPredictor,
    LinearPredictor,
    QuadraticDiscriminantPredictor,
    SVMPredictor,
    as_predictor,
)
from distributedkernelshap_tpu_torch.models.quadratic import lift_gaussian_quadratic
from distributedkernelshap_tpu_torch.models import svm as svm_mod
from distributedkernelshap_tpu_torch.models.svm import lift_svm
from distributedkernelshap_tpu_torch.ops.explain import _ey_generic

PRED_REL = 1e-5
EY_REL = 1e-5
PHI_IDENTITY, PHI_LOGIT = 1e-4, 1e-3
CPU = "cpu"


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if want.ndim == 1 and got.ndim == 2:
        want = want[:, None]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _port_out(pred, X):
    with torch.no_grad():
        return pred(_t(X)).numpy()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(250, 5))
    y = (X[:, 0] + 0.4 * X[:, 1] ** 2 > 0.2).astype(int)
    yr = np.sin(X[:, 0]) + 0.1 * X[:, 1]
    return X, y, yr


def _svm_estimator(data, family, kernel):
    from sklearn.svm import SVC, SVR, NuSVR

    X, y, yr = data
    if family == "svc":
        return SVC(kernel=kernel, random_state=0).fit(X, y).decision_function
    if family == "svr":
        return SVR(kernel=kernel).fit(X, yr).predict
    return NuSVR(kernel=kernel).fit(X, yr).predict


# ---------------------------------------------------------------------------
# the SVM lift


@pytest.mark.parametrize("family,kernel", [("svc", "rbf"), ("svc", "poly"),
                                           ("svc", "sigmoid"), ("svr", "rbf"),
                                           ("svr", "poly"), ("svr", "sigmoid"),
                                           ("nusvr", "rbf")])
def test_svm_lift_matches_jax(data, family, kernel):
    method = _svm_estimator(data, family, kernel)
    ref = jax_lift_svm(method)
    pred = lift_svm(method, device=CPU)
    assert isinstance(pred, SVMPredictor) and ref is not None
    for name in ("sv", "dual_coef"):
        np.testing.assert_array_equal(_np(getattr(pred, name)), _np(getattr(ref, name)))
    assert (pred.kernel, pred.gamma, pred.coef0, pred.degree, pred.intercept,
            pred.vector_out, pred.n_outputs) == (ref.kernel, ref.gamma, ref.coef0,
                                                 ref.degree, ref.intercept,
                                                 ref.vector_out, ref.n_outputs)
    X = data[0][:64]
    got = _port_out(pred, X)
    _close(got, np.asarray(ref(X.astype(np.float32))), PRED_REL)
    _close(got, method(X), 2e-5)                 # tests/test_svm_lift.py's bar


def test_linear_kernel_svc_takes_the_linear_lift(data):
    from sklearn.svm import SVC

    X, y, _ = data
    clf = SVC(kernel="linear", random_state=0).fit(X, y)
    pred = as_predictor(clf.decision_function, example_dim=X.shape[1], device=CPU)
    ref = jax_as_predictor(clf.decision_function, example_dim=X.shape[1])
    assert isinstance(pred, LinearPredictor) and type(ref).__name__ == "LinearPredictor"
    np.testing.assert_array_equal(_np(pred.W), _np(ref.W))


@pytest.mark.parametrize("case", ["multiclass", "label_predict", "platt_proba",
                                  "unfitted", "callable_kernel"])
def test_svm_declines_like_the_reference(data, case):
    from sklearn.svm import SVC

    X, y, _ = data
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if case == "multiclass":
            method = SVC(kernel="rbf", random_state=0).fit(
                X, y + (X[:, 2] > 1).astype(int)).decision_function
        elif case == "label_predict":
            method = SVC(kernel="rbf", random_state=0).fit(X, y).predict
        elif case == "platt_proba":
            method = SVC(kernel="rbf", probability=True, random_state=0).fit(
                X, y).predict_proba
        elif case == "unfitted":
            method = SVC(kernel="rbf").decision_function
        else:
            method = SVC(kernel=lambda A, B: A @ B.T).fit(X, y).decision_function
        assert lift_svm(method, device=CPU) is None
        assert jax_lift_svm(method) is None
        if case == "platt_proba":
            pred = as_predictor(method, example_dim=X.shape[1], device=CPU)
            ref = jax_as_predictor(method, example_dim=X.shape[1])
            assert isinstance(pred, CallbackPredictor)
            assert type(ref).__name__ == "CallbackPredictor"


def test_sparse_fitted_svm_lifts_like_the_reference(data):
    import scipy.sparse as sp
    from sklearn.svm import SVC

    X, y, _ = data
    clf = SVC(kernel="rbf", random_state=0).fit(sp.csr_matrix(X), y)
    pred = as_predictor(clf.decision_function, example_dim=X.shape[1], device=CPU)
    ref = jax_as_predictor(clf.decision_function, example_dim=X.shape[1])
    assert type(pred).__name__ == type(ref).__name__ == "SVMPredictor"
    _close(_port_out(pred, X[:16]), clf.decision_function(X[:16]), 1e-4)


def test_as_predictor_routes_svm_and_to_moves_its_buffers(data):
    from sklearn.svm import SVC

    X, y, _ = data
    clf = SVC(kernel="rbf", random_state=0).fit(X, y)
    pred = as_predictor(clf.decision_function, example_dim=X.shape[1], device=CPU)
    assert isinstance(pred, SVMPredictor)
    assert {n for n, _ in pred.named_buffers()} == {"sv", "dual_coef", "sv_sq"}
    moved = pred.to("meta")
    assert all(b.device.type == "meta" for b in moved.buffers())


def _masked_inputs(X, groups, nsamples=30):
    G = groups_to_matrix(groups, X.shape[1])
    plan = coalition_plan(G.shape[0], nsamples=nsamples, seed=0)
    Xe = X[:9].astype(np.float32)
    bg = X[100:117].astype(np.float32)
    bgw = np.full(bg.shape[0], 1.0 / bg.shape[0], np.float32)
    return Xe, bg, bgw, np.asarray(plan.mask, np.float32), G


@pytest.mark.parametrize("groups", [None, [[0, 1], [2], [3, 4]]], ids=["ungrouped", "grouped"])
@pytest.mark.parametrize("kernel", ["rbf", "linear", "poly", "sigmoid"])
def test_svm_masked_ey_matches_jax_and_rows(data, kernel, groups):
    from sklearn.svm import SVC

    X, y, _ = data
    clf = SVC(kernel=kernel, random_state=0).fit(X, y)
    ref = jax_lift_svm(clf.decision_function)
    pred = lift_svm(clf.decision_function, device=CPU)
    assert pred.supports_masked_ey
    Xe, bg, bgw, mask, G = _masked_inputs(X, groups)
    want = np.asarray(ref.masked_ey(Xe, bg, bgw, mask, G))
    with torch.no_grad():
        got = pred.masked_ey(_t(Xe), _t(bg), _t(bgw), _t(mask), _t(G)).numpy()
        rows = _ey_generic(pred, _t(Xe), _t(bg), _t(bgw), _t(mask @ G), 8).numpy()
    assert got.shape == want.shape == (Xe.shape[0], mask.shape[0], 1)
    _close(got.reshape(-1), want.reshape(-1), EY_REL)
    _close(got.reshape(-1), rows.reshape(-1), EY_REL)


def test_svm_masked_ey_tiny_chunks(data):
    from sklearn.svm import SVC

    X, y, _ = data
    pred = lift_svm(SVC(kernel="rbf", random_state=0).fit(X, y).decision_function,
                    device=CPU)
    Xe, bg, bgw, mask, G = _masked_inputs(X[:, :5], None, nsamples=22)
    args = (_t(Xe[:7]), _t(bg[:13]), _t(np.full(13, 1 / 13)), _t(mask), _t(G))
    with torch.no_grad():
        big = pred.masked_ey(*args).numpy()
        tiny = pred.masked_ey(*args, target_chunk_elems=1 << 9).numpy()
    np.testing.assert_allclose(tiny, big, atol=1e-5)


def test_svm_gram_products_turn_tf32_off(data, monkeypatch):
    """The SVM forward and ``masked_ey`` run with TF32 off even when the
    caller turned it on (rbf's ``exp`` amplifies TF32's error), and give
    the caller's setting back."""

    from sklearn.svm import SVC

    X, y, _ = data
    pred = lift_svm(SVC(kernel="rbf", random_state=0).fit(X, y).decision_function,
                    device=CPU)
    seen = []
    chunk_map, kernel_map = svm_mod.padded_chunk_map, SVMPredictor._kernel_map

    def spy_chunks(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return chunk_map(*args)

    def spy_map(self, g):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return kernel_map(self, g)

    monkeypatch.setattr(svm_mod, "padded_chunk_map", spy_chunks)
    monkeypatch.setattr(SVMPredictor, "_kernel_map", spy_map)
    Xe, bg, bgw, mask, G = _masked_inputs(X, None)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            pred.masked_ey(_t(Xe), _t(bg), _t(bgw), _t(mask), _t(G))
            pred(_t(Xe))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert len(seen) >= 2 and not any(seen)


def test_svm_kernel_shap_matches_jax(data):
    from sklearn.svm import SVC

    X, y, _ = data
    clf = SVC(kernel="rbf", random_state=0).fit(X, y)
    Xe = X[40:56]
    ref = JaxKernelShap(clf.decision_function, seed=0).fit(X[:40]).explain(Xe, silent=True)
    ks = KernelShap(clf.decision_function, seed=0, device=CPU).fit(X[:40])
    assert isinstance(ks._explainer.predictor, SVMPredictor)
    res = ks.explain(Xe, silent=True)
    assert ks.kernel_path == {"ey": "masked_ey"}
    np.testing.assert_allclose(np.asarray(res.shap_values), np.asarray(ref.shap_values),
                               atol=PHI_IDENTITY)
    phi = np.asarray(res.shap_values[0] if isinstance(res.shap_values, list)
                     else res.shap_values)
    lhs = phi.sum(axis=1) + np.ravel(res.expected_value)[0]
    np.testing.assert_allclose(lhs, clf.decision_function(Xe), atol=5e-3)


def test_svm_from_numpy_reproduces_the_jax_predictor(data):
    from sklearn.svm import SVC

    X, y, _ = data
    ref = jax_lift_svm(SVC(kernel="poly", degree=2, random_state=0).fit(
        X, y).decision_function)
    pred = svm_from_numpy(np.asarray(ref.sv), np.asarray(ref.dual_coef), ref.intercept,
                          kernel=ref.kernel, gamma=ref.gamma, coef0=ref.coef0,
                          degree=ref.degree, vector_out=ref.vector_out, device=CPU)
    _close(_port_out(pred, X[:32]), np.asarray(ref(X[:32].astype(np.float32))), PRED_REL)


# ---------------------------------------------------------------------------
# Gaussian quadratic classifiers


@pytest.fixture(scope="module")
def qdata():
    rng = np.random.default_rng(51)
    X = rng.normal(size=(400, 5)) * np.array([1, 2, 0.5, 1, 3])
    y = (X[:, 0] + 0.4 * X[:, 1] > 0).astype(int) + (X[:, 4] > 3).astype(int)
    return X, y


def _quadratic_estimator(qdata, case):
    from sklearn.discriminant_analysis import QuadraticDiscriminantAnalysis
    from sklearn.naive_bayes import GaussianNB

    X, y = qdata
    if case == "nb2":
        return GaussianNB().fit(X, (y > 0).astype(int))
    if case == "nb3":
        return GaussianNB().fit(X, y)
    if case == "nb_priors":
        return GaussianNB(priors=[0.7, 0.2, 0.1]).fit(X, y)
    return QuadraticDiscriminantAnalysis(reg_param=float(case[3:])).fit(X, y)


@pytest.mark.parametrize("case", ["nb2", "nb3", "nb_priors", "qda0.0", "qda0.1"])
def test_quadratic_lift_matches_jax(qdata, case):
    clf = _quadratic_estimator(qdata, case)
    ref = jax_lift_quadratic(clf.predict_proba)
    pred = lift_gaussian_quadratic(clf.predict_proba, device=CPU)
    assert isinstance(pred, QuadraticDiscriminantPredictor) and ref is not None
    for name in ("W", "mu", "u"):
        np.testing.assert_array_equal(_np(getattr(pred, name)), _np(getattr(ref, name)))
    assert pred.n_outputs == ref.n_outputs == len(clf.classes_)
    Xq = qdata[0][:64].astype(np.float32)
    got = _port_out(pred, Xq)
    _close(got, np.asarray(ref(Xq)), PRED_REL)
    np.testing.assert_allclose(got, clf.predict_proba(Xq.astype(np.float64)),
                               atol=5e-5)       # tests/test_quadratic_lift.py's bar
    routed = as_predictor(clf.predict_proba, example_dim=5, device=CPU)
    assert isinstance(routed, QuadraticDiscriminantPredictor)


def test_quadratic_declines_like_the_reference(qdata):
    clf = _quadratic_estimator(qdata, "nb2")
    assert lift_gaussian_quadratic(clf.predict, device=CPU) is None
    assert jax_lift_quadratic(clf.predict) is None
    assert lift_gaussian_quadratic(lambda X: X, device=CPU) is None


def test_quadratic_kernel_shap_matches_jax(qdata):
    X, _ = qdata
    clf = _quadratic_estimator(qdata, "nb2")
    Xe = X[40:56].astype(np.float32).astype(np.float64)
    ref = JaxKernelShap(clf.predict_proba, link="logit", seed=0).fit(X[:40]).explain(
        Xe, silent=True)
    ks = KernelShap(clf.predict_proba, link="logit", seed=0, device=CPU).fit(X[:40])
    assert isinstance(ks._explainer.predictor, QuadraticDiscriminantPredictor)
    res = ks.explain(Xe, silent=True)
    assert ks.kernel_path == {"ey": "generic"}
    for got, want in zip(res.shap_values, ref.shap_values):
        np.testing.assert_allclose(got, want, atol=PHI_LOGIT)
    proba = np.clip(clf.predict_proba(Xe), 1e-7, 1 - 1e-7)
    for k, phi in enumerate(res.shap_values):
        lhs = phi.sum(axis=1) + res.expected_value[k]
        np.testing.assert_allclose(lhs, np.log(proba[:, k] / (1 - proba[:, k])),
                                   rtol=1e-3, atol=5e-3)


@pytest.mark.parametrize("case", ["nb3", "qda0.1"])
def test_quadratic_from_numpy_reproduces_the_jax_predictor(qdata, case):
    ref = jax_lift_quadratic(_quadratic_estimator(qdata, case).predict_proba)
    pred = quadratic_from_numpy(np.asarray(ref.W), np.asarray(ref.mu), np.asarray(ref.u),
                                device=CPU)
    Xq = qdata[0][:32].astype(np.float32)
    _close(_port_out(pred, Xq), np.asarray(ref(Xq)), PRED_REL)
