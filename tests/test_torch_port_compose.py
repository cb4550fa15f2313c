"""The PyTorch port's composite scikit-learn lifts against the JAX package,
on the CPU: ``models/compose.py`` (pipelines with their folding, voting,
bagging, stacking, one-vs-rest, calibrated, search-CV, AdaBoost and
transformed-target lifts, the forwarding ``masked_ey``), the linear
``masked_ey`` they forward to, ``structural_lift`` and the sixteen lifter
families of ``_nonlinear_lifters``, the torch ``interp``, ``.to()`` and the
``save`` / ``load`` round trip of a composite, and the committed fixture
``tests/fixtures/compose_parity.npz`` (``scripts/make_compose_parity_fixture.py``)
through ``chip_smoke.py``'s stand-in estimators.

Real scikit-learn estimators are fitted on small seeded data (the cases of
``tests/test_compose_lift.py``) and lifted by both packages.  Tolerances:
folded ``W`` / ``b`` equal the JAX fold (``array_equal``); predictions port
vs JAX within ``PRED_REL · max(1, |f|)``, and port vs scikit-learn within
the reference test's own bar for the case; ``masked_ey`` port vs JAX within
``EY_REL · max(1, max|ey|)``; ``interp`` port vs JAX within one float32
ulp (``ULP``: XLA may fuse a multiply-add) and vs ``np.interp`` within
1e-6; phi port vs JAX within 1e-4 (identity link) and 1e-3 (logit link,
plus 16 float32 ulps of p at the row's f(x)); the fixture's phi within 1e-3 plus 16 float32 ulps
of p through the logit link (ROADMAP C.9), as ``chip_smoke.py`` phase 28.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
import distributedkernelshap_tpu.models as jax_models
import distributedkernelshap_tpu_torch as port_package
from distributedkernelshap_tpu import KernelShap as JaxKernelShap
from distributedkernelshap_tpu.models import as_predictor as jax_as_predictor
from distributedkernelshap_tpu.models import compose as jcompose
from distributedkernelshap_tpu.models import predictors as jpred
from distributedkernelshap_tpu.ops.coalitions import coalition_plan
from distributedkernelshap_tpu.ops.explain import groups_to_matrix
from distributedkernelshap_tpu_torch import KernelShap
from distributedkernelshap_tpu_torch import models as port_models
from distributedkernelshap_tpu_torch.models import compose as tcompose
from distributedkernelshap_tpu_torch.models import predictors as tpred
from distributedkernelshap_tpu_torch.models.compose import (
    MeanEnsemblePredictor,
    PipelinePredictor,
    interp,
)
from distributedkernelshap_tpu_torch.ops import explain as texp

PRED_REL = 1e-5
EY_REL = 1e-5
PHI_IDENTITY, PHI_LOGIT = 1e-4, 1e-3
ULP = 2.0 ** -24      # one float32 ulp of a probability in [0.5, 1)
CPU = "cpu"


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _quant(X):
    return X.astype(np.float32).astype(np.float64)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if want.ndim == 1 and got.ndim == 2:
        want = want[:, None]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.nanmax(np.abs(want)))))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    X = (rng.normal(size=(300, 6)) * np.array([1, 5, 0.2, 3, 1, 10])
         + np.array([0, 2, -1, 0, 4, -3]))
    y = (X[:, 0] + 0.3 * X[:, 1] - 0.05 * X[:, 5] > 1).astype(int)
    yr = X[:, 0] * 2.0 - X[:, 3] + rng.normal(size=300)
    return X, y, yr


# ---------------------------------------------------------------------------
# the case table: (estimator builder, method, lifted class, scikit-learn bar)


def _build(case, data):
    """``(bound method, rows to compare on, the reference test's bar)``."""

    from sklearn.calibration import CalibratedClassifierCV
    from sklearn.compose import TransformedTargetRegressor
    from sklearn.decomposition import PCA
    from sklearn.ensemble import (
        AdaBoostClassifier,
        BaggingClassifier,
        BaggingRegressor,
        GradientBoostingClassifier,
        HistGradientBoostingRegressor,
        StackingClassifier,
        StackingRegressor,
        VotingClassifier,
        VotingRegressor,
    )
    from sklearn.impute import SimpleImputer
    from sklearn.linear_model import LinearRegression, LogisticRegression
    from sklearn.model_selection import GridSearchCV, RandomizedSearchCV
    from sklearn.multiclass import OneVsRestClassifier
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import (
        MaxAbsScaler,
        MinMaxScaler,
        RobustScaler,
        StandardScaler,
    )
    from sklearn.svm import SVC
    from sklearn.tree import DecisionTreeClassifier, DecisionTreeRegressor

    X, y, yr = data
    y3 = y + (X[:, 3] > 2).astype(int)
    rows = X[:64]
    scalers = {"standard": StandardScaler, "minmax": MinMaxScaler,
               "maxabs": MaxAbsScaler, "robust": RobustScaler}
    if case.startswith("pipe_") and case[5:] in scalers:
        est = Pipeline([("sc", scalers[case[5:]]()), ("lr", LogisticRegression())]).fit(X, y)
        return est.predict_proba, rows, 5e-5
    if case == "pipe_pca_svc":
        est = Pipeline([("sc", StandardScaler()), ("pca", PCA(n_components=4)),
                        ("svc", SVC(kernel="rbf"))]).fit(X, y)
        return est.decision_function, rows, 5e-5
    if case == "pipe_imputer":
        Xm = X.copy()
        Xm[::5, 1] = np.nan
        est = Pipeline([("imp", SimpleImputer(strategy="median")),
                        ("lr", LogisticRegression())]).fit(Xm, y)
        return est.predict_proba, Xm[:64], 5e-5
    if case == "pipe_whitened_pca":
        est = Pipeline([("pca", PCA(n_components=5, whiten=True)),
                        ("lin", LinearRegression())]).fit(X, yr)
        return est.predict, rows, 5e-5
    if case == "pipe_minmax_clip":
        est = Pipeline([("sc", MinMaxScaler(clip=True)),
                        ("lr", LogisticRegression())]).fit(X, y)
        return est.predict_proba, X[:16] * 25.0 + 40.0, 5e-5
    if case == "voting_dropped":
        est = VotingClassifier(
            [("lr", LogisticRegression()), ("drop_me", "drop"),
             ("dt", DecisionTreeClassifier(max_depth=3, random_state=0))],
            voting="soft", weights=[2.0, 5.0, 1.0]).fit(X, y)
        return est.predict_proba, rows, 5e-5
    if case == "voting_soft":
        est = VotingClassifier(
            [("lr", LogisticRegression()),
             ("gb", GradientBoostingClassifier(n_estimators=10, random_state=0))],
            voting="soft", weights=[2.0, 1.0]).fit(X, y)
        return est.predict_proba, rows, 5e-5
    if case == "voting_regressor":
        est = VotingRegressor([("lin", LinearRegression()),
                               ("dt", DecisionTreeRegressor(max_depth=4))]).fit(X, yr)
        return est.predict, rows, 5e-5
    if case == "bagging_classifier":
        est = BaggingClassifier(n_estimators=7, max_features=0.5, bootstrap_features=True,
                                random_state=0).fit(X, y)
        return est.predict_proba, rows, 5e-5
    if case == "bagging_regressor":
        est = BaggingRegressor(n_estimators=5, max_features=4, random_state=0).fit(X, yr)
        return est.predict, rows, 5e-5
    if case == "ovr_multiclass":
        est = OneVsRestClassifier(LogisticRegression()).fit(X, y3)
        return est.predict_proba, rows, 1e-4
    if case == "ovr_multilabel":
        Y = np.stack([(y > 0).astype(int), (X[:, 3] > 2).astype(int)], axis=1)
        est = OneVsRestClassifier(GradientBoostingClassifier(
            n_estimators=5, random_state=0)).fit(X, Y)
        return est.predict_proba, rows, 1e-4
    if case.startswith("stacking_pass"):
        est = StackingClassifier(
            [("lr", LogisticRegression()),
             ("gb", GradientBoostingClassifier(n_estimators=8, random_state=0))],
            final_estimator=LogisticRegression(), cv=3,
            passthrough=case.endswith("true")).fit(X, y)
        return est.predict_proba, rows, 1e-4
    if case == "stacking_multiclass":
        est = StackingClassifier(
            [("lr", LogisticRegression()),
             ("dt", DecisionTreeClassifier(max_depth=4, random_state=0))],
            final_estimator=LogisticRegression(), cv=3).fit(X, y3)
        return est.predict_proba, rows, 1e-4
    if case == "stacking_regressor":
        est = StackingRegressor(
            [("lin", LinearRegression()),
             ("dt", DecisionTreeRegressor(max_depth=4, random_state=0))],
            final_estimator=LinearRegression(), cv=3).fit(X, yr)
        return est.predict, rows, 1e-4
    if case.startswith("calibrated_"):
        method = case.split("_")[1]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            est = CalibratedClassifierCV(SVC(kernel="rbf"), method=method, cv=3,
                                         ensemble=not case.endswith("single")).fit(X, y)
        return est.predict_proba, rows, 1e-4
    if case.startswith("adaboost"):
        if case.startswith("adaboost3"):
            rng = np.random.default_rng(9)
            Xa = rng.normal(size=(300, 6))
            ya = (Xa[:, 0] > 0.5).astype(int) + (Xa[:, 1] > 0).astype(int)
            est = AdaBoostClassifier(n_estimators=10, random_state=0).fit(Xa, ya)
            rows = Xa[:64]
        else:
            est = AdaBoostClassifier(n_estimators=12, random_state=0).fit(X, y)
        name = "decision_function" if case.endswith("decision") else "predict_proba"
        return getattr(est, name), rows, 5e-5
    if case == "ttr_linear":
        est = TransformedTargetRegressor(regressor=LinearRegression(),
                                         transformer=StandardScaler()).fit(X, yr)
        return est.predict, rows, 5e-5
    if case == "ttr_hgb":
        est = TransformedTargetRegressor(
            regressor=HistGradientBoostingRegressor(max_iter=8, random_state=0),
            transformer=MinMaxScaler()).fit(X, yr)
        return est.predict, rows, 5e-5
    if case == "search_grid":
        pipe = Pipeline([("sc", StandardScaler()), ("lr", LogisticRegression())])
        est = GridSearchCV(pipe, {"lr__C": [0.1, 1.0]}, cv=3).fit(X, y)
        return est.predict_proba, rows, 5e-5
    if case == "search_randomized":
        est = RandomizedSearchCV(LogisticRegression(), {"C": [0.5, 2.0]}, n_iter=2, cv=3,
                                 random_state=0).fit(X, y)
        return est.predict_proba, rows, 5e-5
    raise ValueError(case)


LIFT_CASES = {
    "pipe_standard": "LinearPredictor", "pipe_minmax": "LinearPredictor",
    "pipe_maxabs": "LinearPredictor", "pipe_robust": "LinearPredictor",
    "pipe_pca_svc": "PipelinePredictor", "pipe_imputer": "PipelinePredictor",
    "pipe_whitened_pca": "LinearPredictor", "pipe_minmax_clip": "PipelinePredictor",
    "voting_dropped": "MeanEnsemblePredictor", "voting_soft": "MeanEnsemblePredictor",
    "voting_regressor": "MeanEnsemblePredictor",
    "bagging_classifier": "MeanEnsemblePredictor",
    "bagging_regressor": "MeanEnsemblePredictor",
    "ovr_multiclass": "OneVsRestPredictor", "ovr_multilabel": "OneVsRestPredictor",
    "stacking_passfalse": "StackingPredictor", "stacking_passtrue": "StackingPredictor",
    "stacking_multiclass": "StackingPredictor", "stacking_regressor": "StackingPredictor",
    "calibrated_sigmoid": "MeanEnsemblePredictor",
    "calibrated_isotonic": "MeanEnsemblePredictor",
    "calibrated_sigmoid_single": "CalibratedBinaryPredictor",
    "adaboost2_proba": "AdaBoostPredictor", "adaboost2_decision": "AdaBoostPredictor",
    "adaboost3_proba": "AdaBoostPredictor", "adaboost3_decision": "AdaBoostPredictor",
    "ttr_linear": "LinearPredictor", "ttr_hgb": "AffineOutputPredictor",
    "search_grid": "LinearPredictor", "search_randomized": "LinearPredictor",
}


#: isotonic calibration maps the inner margin through slopes of up to ~1e2
#: here, so the margin's f32 rounding (port vs JAX ~2e-6 on an rbf SVC)
#: reaches the output at ~1e-5: these cases are held to the reference
#: test's own bar, and their calibration map to the JAX map
#: within one f32 ulp (test_isotonic_map_is_the_references)
AMPLIFIED = {"calibrated_isotonic": 1e-4}


@pytest.mark.parametrize("case", sorted(LIFT_CASES))
def test_composite_lift_matches_jax(data, case):
    method, rows, sk_bar = _build(case, data)
    D = rows.shape[1]
    probe = data[0][:32] if D == data[0].shape[1] else rows[:32]
    # the port through its public entry point (the probe included); the
    # reference's structural lift (its probe is its own tests' business)
    pred = tpred.as_predictor(method, example_dim=D, probe_data=probe, device=CPU)
    ref = jpred.structural_lift(method)
    assert type(pred).__name__ == type(ref).__name__ == LIFT_CASES[case]
    assert (pred.n_outputs, pred.vector_out) == (ref.n_outputs, ref.vector_out)
    if LIFT_CASES[case] == "LinearPredictor":
        # the fold runs in float64 numpy and casts once, as the reference's
        np.testing.assert_array_equal(_np(pred.W), _np(ref.W))
        np.testing.assert_array_equal(_np(pred.b), _np(ref.b))
        assert pred.activation == ref.activation
    Xq = _quant(rows).astype(np.float32)
    with torch.no_grad():
        got = pred(_t(Xq)).numpy()
    # jitted, as the JAX package runs its predictors (and one compile, not
    # one per eager op)
    _close(got, np.asarray(jax.jit(ref.__call__)(Xq)), AMPLIFIED.get(case, PRED_REL))
    _close(got, method(Xq.astype(np.float64)), sk_bar)


def test_isotonic_map_is_the_references(data):
    method, rows, _ = _build("calibrated_isotonic", data)
    pred = tpred.structural_lift(method, device=CPU)
    ref = jpred.structural_lift(method)
    Xq = _quant(rows).astype(np.float32)
    for fold, ref_fold in zip(pred.members, ref.members):
        margin = np.asarray(ref_fold.inner(Xq))[:, 0]
        _close(fold.inner(_t(Xq)).detach().numpy()[:, 0], margin, PRED_REL)
        np.testing.assert_array_equal(_np(fold.xs), _np(ref_fold.xs))
        # the same margins through both calibration maps: the same formula
        # (XLA may fuse its multiply-add, so within one f32 ulp)
        got = interp(_t(margin), fold.xs, fold.ys).numpy()
        import jax.numpy as jnp

        np.testing.assert_allclose(got, np.asarray(jnp.interp(margin, ref_fold.xs,
                                                              ref_fold.ys)),
                                   rtol=0, atol=ULP)


@pytest.mark.parametrize("case", ["voting_hard", "pipe_normalizer", "adaboost_regressor",
                                  "ttr_nonaffine", "search_no_refit", "ovr_platt_svc"])
def test_composites_decline_like_the_reference(data, case):
    from sklearn.compose import TransformedTargetRegressor
    from sklearn.ensemble import AdaBoostRegressor, VotingClassifier
    from sklearn.linear_model import LinearRegression, LogisticRegression
    from sklearn.model_selection import GridSearchCV
    from sklearn.multiclass import OneVsRestClassifier
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import Normalizer
    from sklearn.svm import SVC
    from sklearn.tree import DecisionTreeClassifier

    X, y, yr = data
    lifter = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if case == "voting_hard":
            method = VotingClassifier([("lr", LogisticRegression()),
                                       ("dt", DecisionTreeClassifier(max_depth=3))],
                                      voting="hard").fit(X, y).predict
        elif case == "pipe_normalizer":
            method = Pipeline([("norm", Normalizer()),
                               ("lr", LogisticRegression())]).fit(X, y).predict_proba
            lifter = "lift_pipeline"
        elif case == "adaboost_regressor":
            method = AdaBoostRegressor(n_estimators=5, random_state=0).fit(X, yr).predict
            lifter = "lift_adaboost"
        elif case == "ttr_nonaffine":
            method = TransformedTargetRegressor(
                regressor=LinearRegression(), func=np.log,
                inverse_func=np.exp).fit(X, np.abs(yr) + 1.0).predict
            lifter = "lift_transformed_target"
        elif case == "search_no_refit":
            gs = GridSearchCV(LogisticRegression(), {"C": [0.1, 1.0]}, cv=3,
                              refit=False).fit(X, y)
            method = getattr(gs, "predict_proba", None) or gs.score
            lifter = "lift_search_cv"
        else:
            method = OneVsRestClassifier(SVC(kernel="rbf", probability=True,
                                             random_state=0)).fit(
                X, y + (X[:, 3] > 2).astype(int)).predict_proba
        if lifter is not None:
            assert getattr(tcompose, lifter)(method, device=CPU) is None
            assert getattr(jcompose, lifter)(method) is None
        if case in ("voting_hard", "pipe_normalizer", "ovr_platt_svc", "ttr_nonaffine"):
            pred = tpred.as_predictor(method, example_dim=X.shape[1], device=CPU)
            ref = jax_as_predictor(method, example_dim=X.shape[1])
            assert type(pred).__name__ == type(ref).__name__ == "CallbackPredictor"


# ---------------------------------------------------------------------------
# masked_ey: the linear route and the forwarding composites


def _masked_inputs(X, nsamples=24, B=6, N=12):
    G = groups_to_matrix([[0, 1], [2], [3, 4], [5]], X.shape[1])
    plan = coalition_plan(G.shape[0], nsamples=nsamples, seed=0)
    Xe = _quant(X[:B]).astype(np.float32)
    bg = _quant(X[100:100 + N]).astype(np.float32)
    bgw = np.full(N, 1.0 / N, np.float32)
    return Xe, bg, bgw, np.asarray(plan.mask, np.float32), G


def _masked_case(case, data):
    from sklearn.ensemble import BaggingClassifier, GradientBoostingClassifier
    from sklearn.linear_model import LinearRegression, LogisticRegression
    from sklearn.multiclass import OneVsRestClassifier
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler
    from sklearn.ensemble import VotingClassifier

    X, y, yr = data
    if case == "linear_binary":
        return LogisticRegression().fit(X, y).predict_proba
    if case == "linear_multiclass":
        return LogisticRegression().fit(X, y + (X[:, 3] > 2).astype(int)).predict_proba
    if case == "linear_identity":
        return LinearRegression().fit(X, yr).predict
    if case == "pipeline":
        return Pipeline([("sc", StandardScaler()),
                         ("gb", GradientBoostingClassifier(n_estimators=8, max_depth=3,
                                                           random_state=0))]).fit(
            X, y).predict_proba
    if case == "mean_ensemble":
        return VotingClassifier(
            [("lr", LogisticRegression()),
             ("gb", GradientBoostingClassifier(n_estimators=8, max_depth=3,
                                               random_state=0))],
            voting="soft", weights=[2.0, 1.0]).fit(X, y).predict_proba
    if case == "bagging_select":
        return BaggingClassifier(LogisticRegression(), n_estimators=4, max_features=0.7,
                                 bootstrap_features=True, random_state=0).fit(
            X, y).predict_proba
    Y = np.stack([(y > 0).astype(int), (X[:, 3] > 2).astype(int),
                  (X[:, 1] > 2).astype(int)], axis=1)
    return OneVsRestClassifier(LogisticRegression()).fit(X, Y).predict_proba


@pytest.mark.parametrize("case", ["linear_binary", "linear_multiclass", "linear_identity",
                                  "pipeline", "mean_ensemble", "bagging_select",
                                  "ovr_multilabel"])
def test_masked_ey_matches_jax(data, case):
    method = _masked_case(case, data)
    pred = tpred.structural_lift(method, device=CPU)
    ref = jpred.structural_lift(method)
    assert type(pred).__name__ == type(ref).__name__
    assert pred.supports_masked_ey and ref.supports_masked_ey
    Xe, bg, bgw, mask, G = _masked_inputs(data[0])
    want = np.asarray(ref.masked_ey(Xe, bg, bgw, mask, G))
    with texp.capture_kernel_paths() as paths, torch.no_grad():
        got = pred.masked_ey(_t(Xe), _t(bg), _t(bgw), _t(mask), _t(G)).numpy()
        rows = texp._ey_generic(pred, _t(Xe), _t(bg), _t(bgw), _t(mask @ G), 8).numpy()
    assert got.shape == want.shape == (Xe.shape[0], mask.shape[0], pred.n_outputs)
    _close(got.reshape(-1), want.reshape(-1), EY_REL)
    _close(got.reshape(-1), rows.reshape(-1), EY_REL)
    linear = case.startswith("linear") or case in ("bagging_select", "ovr_multilabel")
    if linear:
        # CPU tensors run fused_linear_ey's plain version (identity: einsums)
        assert paths == {"ey": "einsum" if case == "linear_identity" else "plain"}


def test_linear_masked_ey_launches_the_kernel_or_raises_on_cuda(data, monkeypatch):
    """On a CUDA tensor the linear ``masked_ey`` calls ``fused_linear_ey``
    (never its plain version): here the kernel wrapper is replaced by a
    recorder, because this machine has no card."""

    calls = []
    monkeypatch.setattr(texp, "fused_linear_ey", lambda *a: calls.append(a) or "kernel")
    monkeypatch.setattr(texp, "fused_linear_ey_plain",
                        lambda *a, **k: pytest.fail("the plain version ran"))
    monkeypatch.setattr(texp, "resolve_use_kernel", lambda use, dev: True)
    pred = tpred.structural_lift(_masked_case("linear_binary", data), device=CPU)
    Xe, bg, bgw, mask, G = _masked_inputs(data[0])
    with torch.no_grad():
        assert pred.masked_ey(_t(Xe), _t(bg), _t(bgw), _t(mask), _t(G)) == "kernel"
    assert len(calls) == 1 and calls[0][-1] == "softmax"


def test_pca_pipeline_does_not_forward_masked_ey(data):
    from sklearn.decomposition import PCA
    from sklearn.ensemble import GradientBoostingClassifier
    from sklearn.pipeline import Pipeline

    X, y, _ = data
    pipe = Pipeline([("pca", PCA(n_components=4)),
                     ("gb", GradientBoostingClassifier(n_estimators=5,
                                                       random_state=0))]).fit(X, y)
    pred = tpred.as_predictor(pipe.predict_proba, example_dim=X.shape[1], device=CPU)
    assert isinstance(pred, PipelinePredictor) and not pred.supports_masked_ey


# ---------------------------------------------------------------------------
# end to end: KernelShap in both packages


@pytest.mark.parametrize("case,link", [("pipe_standard", "logit"), ("voting_soft", "logit"),
                                       ("ovr_multilabel", "logit"), ("ttr_hgb", "identity")])
def test_kernel_shap_matches_jax(data, case, link):
    method, _, _ = _build(case, data)
    X = data[0]
    Xe = _quant(X[200:208])
    task = "regression" if case.startswith("ttr") else "classification"
    ks = KernelShap(method, link=link, task=task, seed=0, device=CPU).fit(X[:30])
    res = ks.explain(Xe, silent=True)
    ref = JaxKernelShap(method, link=link, task=task, seed=0).fit(X[:30]).explain(
        Xe, silent=True)
    assert type(ks._explainer.predictor).__name__ == LIFT_CASES[case]
    got, want = res.shap_values, ref.shap_values
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    fx = np.asarray(ref.data["raw"]["raw_prediction"]).reshape(len(Xe), -1)
    for k, (g, w) in enumerate(zip(got, want)):
        tol = np.full(len(Xe), PHI_IDENTITY)
        if link == "logit":
            # near saturation one f32 ulp of p is 2^-24 / (p (1-p)) of logit
            # (ROADMAP C.9): phase 28's tolerance
            tol = PHI_LOGIT + cs.LOGIT_ULPS * 2.0 ** -24 * (2.0 + 2.0 * np.cosh(fx[:, k]))
        assert (np.abs(np.asarray(g) - np.asarray(w)).max(1) <= tol).all(), (k, g, w)
    np.testing.assert_allclose(np.asarray(res.expected_value), np.asarray(ref.expected_value),
                               atol=PHI_LOGIT if link == "logit" else PHI_IDENTITY)


# ---------------------------------------------------------------------------
# the pieces: interp, structural_lift, the lifter table, devices, checkpoints


@pytest.mark.parametrize("x,xp,fp", [
    ([0.0, 1.0, 2.5, 3.0], [0.0, 1.0, 3.0], [0.1, 0.4, 0.9]),          # on thresholds
    ([0.25, 1.7, 2.99], [0.0, 1.0, 3.0], [0.0, 0.5, 1.0]),             # between
    ([-5.0, -1e-3, 3.001, 40.0], [0.0, 1.0, 3.0], [0.2, 0.5, 0.7]),    # outside both ends
    ([0.5, 1.0, 1.5, 2.0], [0.0, 1.0, 1.0, 2.0], [0.0, 0.3, 0.6, 1.0]),  # repeated
], ids=["on", "between", "outside", "repeated"])
def test_interp_matches_numpy_and_jax(x, xp, fp):
    import jax.numpy as jnp

    x, xp, fp = (np.asarray(a, np.float32) for a in (x, xp, fp))
    got = interp(_t(x), _t(xp), _t(fp)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp.interp(x, xp, fp)), rtol=0, atol=ULP)
    np.testing.assert_allclose(got, np.interp(x.astype(np.float64), xp, fp), atol=1e-6)


def test_structural_lift_matches_the_reference(data):
    from sklearn.linear_model import LogisticRegression
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import Normalizer
    from sklearn.svm import SVC

    X, y, _ = data
    for method in (LogisticRegression().fit(X, y).predict_proba,
                   SVC(kernel="rbf").fit(X, y).decision_function,
                   _build("voting_soft", data)[0]):
        pred, ref = tpred.structural_lift(method, device=CPU), jpred.structural_lift(method)
        assert type(pred).__name__ == type(ref).__name__
    bad = Pipeline([("norm", Normalizer()), ("lr", LogisticRegression())]).fit(X, y)
    assert tpred.structural_lift(bad.predict_proba, device=CPU) is None
    assert jpred.structural_lift(bad.predict_proba) is None


def test_nonlinear_lifters_are_the_references_sixteen_in_order():
    port = [name for name, _ in tpred._nonlinear_lifters()]
    assert port == [name for name, _ in jpred._nonlinear_lifters()]
    assert len(port) == 16


def test_models_export_the_references_names_of_these_modules():
    mods = ("svm", "quadratic", "compose")
    ref = {n for n, v in vars(jax_models).items()
           if getattr(v, "__module__", "").rsplit(".", 1)[-1] in mods}
    port = {n for n, v in vars(port_models).items()
            if getattr(v, "__module__", "").rsplit(".", 1)[-1] in mods}
    assert ref <= port and port - ref == {"AffineOutputPredictor"}
    assert ref <= set(vars(port_package))


def _composite_with_every_buffer(data):
    """A voting ensemble of a select-stage bagging member, a clip pipeline
    and an isotonic calibrated LR, built from numpy by the constructors."""

    X, y, _ = data
    from sklearn.linear_model import LogisticRegression

    lr = LogisticRegression().fit(X, y)
    lr_sub = LogisticRegression().fit(X[:, [0, 1, 4]], y)
    base = tpred.structural_lift(lr.predict_proba, device=CPU)
    sub = PipelinePredictor([("select", np.array([0, 1, 4]))],
                            tpred.structural_lift(lr_sub.predict_proba, device=CPU))
    clipped = PipelinePredictor([("affine", np.full(6, 0.5), np.zeros(6)),
                                 ("clip", -3.0, 3.0)], base)
    margin = tpred.LinearPredictor(lr.coef_.T, lr.intercept_, "identity", device=CPU)
    calibrated = tcompose.CalibratedBinaryPredictor(
        margin, "isotonic", (np.array([-3.0, 0.0, 2.0]), np.array([0.05, 0.4, 0.95])))
    return MeanEnsemblePredictor([sub, clipped, calibrated], weights=[1.0, 2.0, 1.0])


def test_to_moves_every_buffer_of_a_composite(data):
    pred = _composite_with_every_buffer(data)
    names = {n for n, _ in pred.named_buffers()}
    assert {"weights", "members.0.stage0_1", "members.1.stage0_1", "members.1.stage0_2",
            "members.2.xs", "members.2.ys"} <= names
    assert pred.members[0].stage0_1.dtype == torch.int64
    moved = pred.to("meta")
    assert all(b.device.type == "meta" for b in moved.buffers())
    assert moved.members[1].stages[1] == ("clip", -3.0, 3.0)


def test_save_load_round_trip_of_a_composite(data, tmp_path):
    X = data[0]
    ks = KernelShap(_composite_with_every_buffer(data), link="logit", seed=0,
                    device=CPU).fit(X[:20])
    Xe = _quant(X[200:204])
    before = ks.explain(Xe, silent=True)
    path = str(tmp_path / "composite.pkl")
    ks.save(path)
    loaded = KernelShap.load(path, device=CPU)
    assert isinstance(loaded._explainer.predictor, MeanEnsemblePredictor)
    after = loaded.explain(Xe, silent=True)
    for a, b in zip(before.shap_values, after.shap_values):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the committed fixture through chip_smoke.py's stand-in estimators


def test_port_reproduces_the_compose_fixture():
    """The fixture's four models rebuilt from their fitted attributes by
    ``chip_smoke.py``'s stand-ins (phase 33's code), on the CPU: the
    stand-ins reproduce scikit-learn's outputs, the port's lifts match them
    within 1e-5 · max(1, |f|), and the port's phi on the first rows matches
    the JAX package's (each row's explanation is independent of the batch:
    the plan depends only on M and the seed)."""

    fx = cs.load_compose_fixture()
    reports = cs.compose_fixture_checks(fx, CPU, n_rows=8)
    assert set(reports) == {"pipe", "svc", "cal", "nb"}
    for name, report in reports.items():
        assert report["lifted"] == report["want_class"], name
        assert report["numpy_err"] <= 1e-9 * max(1.0, np.abs(fx[f"{name}_out"]).max()), name
        assert report["pred_ok"], (name, report["pred_err"])
        assert report["phi_ok"], (name, report["phi_err"])
