"""The PyTorch port's remaining tree lifts against the JAX package, on the
CPU: XGBoost ``save_model`` JSON (``models/xgb.py``), LightGBM
``dump_model()`` dicts (``models/lgbm.py``), IsolationForest
(``models/trees.py``), the affine output head (``models/compose.py``) and
its exact TreeSHAP (``ops/treeshap._unwrap``).

Neither xgboost nor lightgbm is installed, so the dumps are written by hand
(the cases of ``tests/test_xgb_lift.py`` and ``tests/test_lgbm_lift.py``)
or from ``chip_smoke.py``'s seeded Adult-shaped GBT, and the bound-method
entry points are driven through stand-in estimators.  Inputs are made from
a seed with numpy.  Tolerances: the lifted node tables equal the JAX
lift's (``array_equal``); predictions agree within 1e-6 · max(1, |y|);
exact phi and interaction matrices within 2e-5 · max(1, max|·|), the JAX
package's own bar (``tests/test_treeshap.py:780``); IsolationForest scores
within 1e-3 of scikit-learn (``tests/test_trees.py:744``).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from distributedkernelshap_tpu import KernelShap as JaxKernelShap
from distributedkernelshap_tpu.models import TreeEnsemblePredictor as JaxTree
from distributedkernelshap_tpu.models import lgbm as jlgbm
from distributedkernelshap_tpu.models import trees as jtrees
from distributedkernelshap_tpu.models import xgb as jxgb
from distributedkernelshap_tpu.models.compose import AffineOutputPredictor as JaxAffine
from distributedkernelshap_tpu_torch import (
    AffineOutputPredictor,
    EngineConfig,
    KernelShap,
    TreeEnsemblePredictor,
)
from distributedkernelshap_tpu_torch.models import lgbm, trees, xgb
from distributedkernelshap_tpu_torch.models.predictors import as_predictor
from distributedkernelshap_tpu_torch.ops.treeshap import supports_exact

PRED_REL = 1e-6
PHI_REL = 2e-5
IFOREST_ATOL = 1e-3

TABLES = ("feature", "threshold", "left", "right", "value", "base", "path_sign",
          "path_offset", "path_len", "leaf_value")
SCALARS = ("depth", "aggregation", "scale", "out_transform", "n_outputs", "vector_out",
           "n_leaves")


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same_tables(port, ref):
    """The port's lifted ensemble holds the JAX lift's node and path tables."""

    assert isinstance(port, TreeEnsemblePredictor) and isinstance(ref, JaxTree)
    for name in TABLES:
        np.testing.assert_array_equal(_np(getattr(port, name)), _np(getattr(ref, name)),
                                      err_msg=name)
    assert (port.missing_left is None) == (ref.missing_left is None)
    if ref.missing_left is not None:
        np.testing.assert_array_equal(_np(port.missing_left), _np(ref.missing_left))
    for name in SCALARS:
        assert getattr(port, name) == getattr(ref, name), name


def _same_predictions(port, ref, X):
    got = port(torch.as_tensor(X)).numpy()
    want = np.asarray(ref(X))
    assert got.shape == want.shape
    tol = PRED_REL * max(1.0, float(np.nanmax(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# XGBoost JSON dumps (the cases of tests/test_xgb_lift.py)


def _xtree(split_indices, split_conditions, left, right, default_left):
    return {"split_indices": split_indices, "split_conditions": split_conditions,
            "left_children": left, "right_children": right,
            "default_left": default_left, "split_type": [0] * len(split_indices),
            "categories": []}


def _xmodel(trees_, objective, base_score, num_class=0, tree_info=None):
    return {"learner": {
        "objective": {"name": objective},
        "learner_model_param": {"base_score": str(base_score),
                                "num_class": str(num_class)},
        "gradient_booster": {"model": {"trees": trees_,
                                       "tree_info": tree_info or [0] * len(trees_)}}}}


def _xbinary_trees():
    t0 = _xtree([0, 1, 2, 0, 0, 0, 0], [0.5, -1.0, 2.0, 0.3, -0.7, 1.1, -0.2],
                [1, 3, 5, -1, -1, -1, -1], [2, 4, 6, -1, -1, -1, -1], [1, 0, 1, 0, 0, 0, 0])
    t1 = _xtree([2, 0, 0], [1.5, 0.25, -0.4], [1, -1, -1], [2, -1, -1], [0, 0, 0])
    return [t0, t1]


def _xgb_case(name):
    rng = np.random.default_rng(0)
    X3 = rng.normal(size=(64, 3)).astype(np.float32)
    edge = np.array([[0.5, 0.0, 0.0], [np.nan, 2.0, 0.0], [0.1, np.nan, 5.0],
                     [np.nan, np.nan, np.nan], [0.5, -1.0, 1.5]], np.float32)
    X3 = np.concatenate([X3, edge])
    if name == "binary_logistic":
        return _xmodel(_xbinary_trees(), "binary:logistic", 0.5), X3
    if name == "base_score_bias":
        return _xmodel([_xtree([0], [0.0], [-1], [-1], [0])], "binary:logistic", 0.8), \
            np.zeros((2, 1), np.float32)
    if name == "logitraw":
        return _xmodel([_xtree([0], [0.0], [-1], [-1], [0])], "binary:logitraw", 0.8), \
            np.zeros((2, 1), np.float32)
    if name == "multiclass_softprob":
        trees_ = [_xtree([0, 0, 0], [0.5, 0.3 * (k + 1), -0.1 * (k + 1)], [1, -1, -1],
                         [2, -1, -1], [0, 0, 0]) for k in range(3)]
        return _xmodel(trees_, "multi:softprob", 0.5, num_class=3, tree_info=[0, 1, 2]), \
            rng.normal(size=(32, 1)).astype(np.float32)
    if name == "regression_identity":
        t = _xtree([0, 0, 0], [1.0, 2.5, -3.5], [1, -1, -1], [2, -1, -1], [0, 0, 0])
        return _xmodel([t], "reg:squarederror", 0.7), \
            np.array([[0.0], [1.0], [2.0]], np.float32)
    if name == "strict_threshold_casts":
        trees_ = [_xtree([0, 0, 0], [t, 10.0, -10.0], [1, -1, -1], [2, -1, -1], [0, 0, 0])
                  for t in (1.0 - 1e-12, 1.0 + 1e-12, 1.0)]
        X = np.array([[1.0], [np.nextafter(np.float32(1.0), np.float32(-np.inf))],
                      [0.999999]], np.float32)
        return _xmodel(trees_, "reg:squarederror", 0.0), X
    model = _xmodel(_xbinary_trees(), "binary:logistic", 0.5)
    model["learner"]["attributes"] = {"best_iteration": "0"}
    bm = model["learner"]["gradient_booster"]["model"]
    if name == "early_stopping_indptr":
        bm["iteration_indptr"] = [0, 1, 2]
    else:                                   # early_stopping_no_indptr
        bm["gbtree_model_param"] = {"num_parallel_tree": "1"}
    return model, X3


@pytest.mark.parametrize("case", [
    "binary_logistic", "base_score_bias", "logitraw", "multiclass_softprob",
    "regression_identity", "strict_threshold_casts", "early_stopping_indptr",
    "early_stopping_no_indptr"])
def test_xgboost_lift_matches_jax(case):
    model, X = _xgb_case(case)
    port = xgb.predictor_from_xgboost_json(model, device="cpu")
    ref = jxgb.predictor_from_xgboost_json(model)
    _same_tables(port, ref)
    _same_predictions(port, ref, X)


def _xgb_decline(name):
    t = _xtree([0, 0, 0], [0.5, 1.0, -1.0], [1, -1, -1], [2, -1, -1], [0, 0, 0])
    if name == "categorical":
        t["split_type"] = [1, 0, 0]
        return _xmodel([t], "binary:logistic", 0.5)
    if name == "empty_learner":
        return {"learner": {}}
    if name == "empty":
        return {}
    if name == "malformed_tree":
        model = _xmodel(_xbinary_trees(), "binary:logistic", 0.5)
        del model["learner"]["gradient_booster"]["model"]["trees"][0]["default_left"]
        return model
    if name == "short_tree_info":
        return _xmodel([t, t, t], "multi:softprob", 0.5, num_class=3, tree_info=[0])
    return _xmodel([_xtree([0], [1.5], [-1], [-1], [0])], name, 0.5)   # objective


@pytest.mark.parametrize("case", [
    "categorical", "empty_learner", "empty", "malformed_tree", "short_tree_info",
    "reg:logistic", "count:poisson", "reg:gamma", "reg:tweedie"])
def test_xgboost_lift_declines_like_jax(case):
    model = _xgb_decline(case)
    assert jxgb.predictor_from_xgboost_json(model) is None
    assert xgb.predictor_from_xgboost_json(model, device="cpu") is None


# ---------------------------------------------------------------------------
# LightGBM dumps (the cases of tests/test_lgbm_lift.py)


def _leaf(v):
    return {"leaf_value": v}


def _split(feat, thr, left, right, default_left=True, decision_type="<="):
    return {"split_feature": feat, "threshold": thr, "decision_type": decision_type,
            "default_left": default_left, "left_child": left, "right_child": right}


def _dump(roots, objective, num_class=1, average_output=False):
    return {"objective": objective, "num_class": num_class,
            "average_output": average_output,
            "tree_info": [{"tree_structure": r} for r in roots]}


def _lbinary_roots():
    r0 = _split(0, 0.5, _split(1, -1.0, _leaf(0.3), _leaf(-0.7), default_left=False),
                _split(2, 2.0, _leaf(1.1), _leaf(-0.2)))
    return [r0, _split(2, 1.5, _leaf(0.25), _leaf(-0.4))]


def _lgbm_case(name):
    rng = np.random.default_rng(1)
    X3 = np.concatenate([rng.normal(size=(64, 3)).astype(np.float32),
                         np.array([[0.5, -1.0, 1.5], [np.nan, 0.0, 0.0],
                                   [1.0, np.nan, np.nan]], np.float32)])
    if name in ("binary", "binary_bare", "binary_scalar"):
        obj = "binary" if name == "binary_bare" else "binary sigmoid:1"
        return _dump(_lbinary_roots(), obj), X3, name == "binary_scalar"
    if name == "multiclass":
        roots = [_split(0, 0.0, _leaf(0.1 * (i + 1)), _leaf(-0.2 * (i + 1))) for i in range(6)]
        return _dump(roots, "multiclass num_class:3", num_class=3), \
            rng.normal(size=(32, 1)).astype(np.float32), False
    X1 = np.array([[0.5], [1.0], [0.999999], [-3.0]], np.float32)
    if name in ("regression", "rf_average"):
        roots = [_split(0, 0.0, _leaf(2.0), _leaf(4.0)), _split(0, 1.0, _leaf(-1.0), _leaf(3.0))]
        return _dump(roots, "regression", average_output=name == "rf_average"), X1, False
    if name == "threshold_rounds_down":
        return _dump([_split(0, 1.0 - 1e-12, _leaf(10.0), _leaf(-10.0))], "regression"), \
            X1, False
    return _dump([_leaf(1.25)], "regression"), X1, False        # single leaf


@pytest.mark.parametrize("case", [
    "binary", "binary_bare", "binary_scalar", "multiclass", "regression", "rf_average",
    "threshold_rounds_down", "single_leaf"])
def test_lightgbm_lift_matches_jax(case):
    dump, X, scalar = _lgbm_case(case)
    port = lgbm.predictor_from_lightgbm_dump(dump, binary_as_scalar=scalar, device="cpu")
    ref = jlgbm.predictor_from_lightgbm_dump(dump, binary_as_scalar=scalar)
    _same_tables(port, ref)
    _same_predictions(port, ref, X)


def _lgbm_decline(name):
    roots = _lbinary_roots()
    if name.startswith("binary sigmoid:"):
        return _dump(roots, name)
    if name == "linear_tree":
        leaf = {"leaf_value": 0.5, "leaf_coeff": [0.1], "leaf_const": 0.2,
                "leaf_features": [0]}
        return _dump([_split(0, 0.0, leaf, _leaf(-0.5))], "regression")
    if name == "multiclass_rf":
        return _dump([_split(0, 0.0, _leaf(0.1), _leaf(-0.1)) for _ in range(6)],
                     "multiclass", num_class=3, average_output=True)
    if name == "categorical":
        return _dump([_split(0, 0.5, _leaf(1.0), _leaf(-1.0), decision_type="==")],
                     "binary")
    if name == "empty":
        return {}
    if name == "no_trees":
        return {"objective": "binary"}
    if name == "bogus_tree":
        return {"objective": "binary", "tree_info": [{"tree_structure": {"bogus": 1}}]}
    return _dump([_leaf(0.5)], name)                            # link objectives


@pytest.mark.parametrize("case", [
    "binary sigmoid:2", "binary sigmoid:0.5", "binary sigmoid:bogus", "linear_tree",
    "multiclass_rf", "categorical", "empty", "no_trees", "bogus_tree", "poisson", "gamma",
    "tweedie", "cross_entropy", "multiclassova"])
def test_lightgbm_lift_declines_like_jax(case):
    dump = _lgbm_decline(case)
    assert jlgbm.predictor_from_lightgbm_dump(dump) is None
    assert lgbm.predictor_from_lightgbm_dump(dump, device="cpu") is None


# ---------------------------------------------------------------------------
# the bound-method entry points, through stand-in estimators


@pytest.mark.parametrize("cls,method,lifts", [
    ("XGBRegressor", "predict", True), ("XGBClassifier", "predict_proba", True),
    ("XGBClassifier", "predict", False), ("LGBMRegressor", "predict", True),
    ("LGBMClassifier", "predict_proba", True), ("LGBMClassifier", "predict", False),
    ("Booster", "predict", True), ("RandomThing", "predict", False)])
def test_bound_method_lifts_follow_the_reference(cls, method, lifts):
    if cls.startswith("XGB"):
        obj = "binary:logistic" if "Classifier" in cls else "reg:squarederror"
        dump = _xmodel(_xbinary_trees(), obj, 0.5)
        port_lift, ref_lift = xgb.lift_xgboost, jxgb.lift_xgboost
    else:
        obj = "binary" if cls != "LGBMRegressor" else "regression"
        dump = _dump(_lbinary_roots(), obj)
        port_lift, ref_lift = lgbm.lift_lightgbm, jlgbm.lift_lightgbm
    owner = cs.booster_owner(cls, dump, lambda X: np.zeros(len(X)))
    if cls == "Booster":
        type(owner).dump_model = lambda self: dump
    ref = ref_lift(getattr(owner, method))
    port = port_lift(getattr(owner, method), device="cpu")
    assert (port is not None) == (ref is not None) == lifts
    if lifts:
        _same_tables(port, ref)


def test_as_predictor_lifts_a_booster_through_its_probe():
    """``KernelShap(estimator.predict)`` on an xgboost-shaped estimator: the
    lift passes the probe against the estimator's own outputs and serves
    the exact path; a dump that disagrees with the estimator is refused."""

    model, X = _xgb_case("binary_logistic")
    ref = jxgb.predictor_from_xgboost_json(model)
    owner = cs.booster_owner("XGBClassifier", model, lambda Z: np.asarray(ref(Z)))
    pred = as_predictor(owner.predict_proba, example_dim=3, device="cpu")
    assert isinstance(pred, TreeEnsemblePredictor)
    wrong = cs.booster_owner("XGBClassifier", model, lambda Z: 1.0 - np.asarray(ref(Z)))
    assert not isinstance(as_predictor(wrong.predict_proba, example_dim=3, device="cpu"),
                          TreeEnsemblePredictor)


# ---------------------------------------------------------------------------
# the seeded Adult-shaped GBT's dumps (chip_smoke.py's phase 22) and their
# exact explains against the JAX package


@pytest.fixture(scope="module")
def seeded(monkeypatch_module):
    monkeypatch_module.setattr(cs, "N_TREES", 6)
    tables = cs.adult_shaped_gbt(0)
    X, bg, _ = cs.adult_task(0)
    return tables, X[:8], bg[:20]


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _jax_tree(tables, base):
    return JaxTree(tables["feature"], tables["threshold"], tables["left"], tables["right"],
                   tables["value"], depth=tables["depth"], aggregation="sum", base=[base],
                   vector_out=False)


@pytest.mark.parametrize("kind", ["xgboost", "lightgbm"])
def test_seeded_dump_lifts_bit_identically_and_explains_like_jax(seeded, kind):
    tables, X, bg = seeded
    if kind == "xgboost":
        dump, base = cs.xgboost_json(tables), cs.GBT_BASE
        port = xgb.predictor_from_xgboost_json(dump, device="cpu")
        ref = jxgb.predictor_from_xgboost_json(dump)
    else:
        dump, base = cs.lightgbm_dump(tables), 0.0
        port = lgbm.predictor_from_lightgbm_dump(dump, device="cpu")
        ref = jlgbm.predictor_from_lightgbm_dump(dump)
    _same_tables(port, ref)
    seeded_pred = cs.tree_predictor(tables, "cpu", base=base)
    Xt = torch.as_tensor(X)
    assert torch.equal(port(Xt), seeded_pred(Xt))
    # the exact path against the JAX package's, through the public API
    got = KernelShap(port, seed=0, device="cpu").fit(
        bg, group_names=cs.ADULT_GROUP_NAMES, groups=cs.adult_groups()).explain(
            X, nsamples="exact", interactions=kind == "xgboost", silent=True)
    want = JaxKernelShap(_jax_tree(tables, base), seed=0).fit(
        bg, group_names=cs.ADULT_GROUP_NAMES, groups=cs.adult_groups()).explain(
            X, nsamples="exact", interactions=kind == "xgboost", silent=True)
    phi, phi_ref = np.asarray(got.shap_values[0]), np.asarray(want.shap_values[0])
    assert np.abs(phi - phi_ref).max() <= PHI_REL * max(1.0, np.abs(phi_ref).max())
    if kind == "xgboost":
        inter = got.data["raw"]["interaction_values"][0]
        inter_ref = np.asarray(want.data["raw"]["interaction_values"][0])
        assert np.abs(inter - inter_ref).max() <= PHI_REL * max(1.0, np.abs(inter_ref).max())


# ---------------------------------------------------------------------------
# IsolationForest


@pytest.fixture(scope="module")
def iforest():
    from sklearn.ensemble import IsolationForest

    rng = np.random.default_rng(9)
    Xtr = rng.normal(size=(300, 5))
    Xtr[:10] += 4.0
    iso = IsolationForest(n_estimators=25, max_samples=64, max_features=0.8,
                          random_state=0).fit(Xtr)
    return iso, rng.normal(size=(40, 5)).astype(np.float32) * 1.5, Xtr[:20].astype(np.float32)


@pytest.mark.parametrize("method", ["score_samples", "decision_function"])
def test_isolation_forest_lift_matches_sklearn_and_jax(iforest, method):
    iso, X, _ = iforest
    port = trees.lift_tree_ensemble(getattr(iso, method), device="cpu")
    ref = jtrees.lift_tree_ensemble(getattr(iso, method))
    if method == "decision_function":
        assert isinstance(port, AffineOutputPredictor) and isinstance(ref, JaxAffine)
        assert (port.a, port.b) == (float(ref.a), float(ref.b)) == (1.0, -iso.offset_)
        port_tree, ref_tree = port.inner, ref.inner
    else:
        port_tree, ref_tree = port, ref
    _same_tables(port_tree, ref_tree)
    assert port_tree.out_transform == "neg_exp2" and not supports_exact(port)
    got = port(torch.as_tensor(X)).numpy()[:, 0]
    np.testing.assert_allclose(got, getattr(iso, method)(X), atol=IFOREST_ATOL)
    np.testing.assert_allclose(got, np.asarray(ref(X))[:, 0], atol=1e-6)


def test_isolation_forest_explains_like_jax(iforest):
    """``KernelShap(iso.decision_function)`` lifts through ``as_predictor``
    (probe included) and its sampled explain (the tree ``masked_ey`` under
    the affine head) matches the JAX package's."""

    iso, X, bg = iforest
    ks = KernelShap(iso.decision_function, seed=0, device="cpu").fit(bg)
    assert isinstance(ks._explainer.predictor, AffineOutputPredictor)
    got = ks.explain(X[:4], silent=True)
    assert ks.kernel_path == {"ey": "masked_ey"}
    want = JaxKernelShap(iso.decision_function, seed=0).fit(bg).explain(X[:4], silent=True)
    np.testing.assert_allclose(np.asarray(got.shap_values[0]),
                               np.asarray(want.shap_values[0]), atol=1e-5)
    np.testing.assert_allclose(np.ravel(got.expected_value), np.ravel(want.expected_value),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the affine head on the exact path


def test_affine_head_exact_path_matches_jax(seeded):
    tables, X, bg = seeded
    a, b = cs.AFFINE_A, cs.AFFINE_B
    port = AffineOutputPredictor(cs.tree_predictor(tables, "cpu"), a, b)
    ref = JaxAffine(_jax_tree(tables, cs.GBT_BASE), a, b)
    assert supports_exact(port)
    fit = dict(group_names=cs.ADULT_GROUP_NAMES, groups=cs.adult_groups())
    ks = KernelShap(port, seed=0, device="cpu", engine_config=EngineConfig()).fit(bg, **fit)
    got = ks.explain(X, nsamples="exact", silent=True)
    assert ks.kernel_path == {"exact_phi": "plain"}
    want = JaxKernelShap(ref, seed=0).fit(bg, **fit).explain(X, nsamples="exact", silent=True)
    bare = KernelShap(cs.tree_predictor(tables, "cpu"), seed=0, device="cpu").fit(
        bg, **fit).explain(X, nsamples="exact", silent=True)
    phi, phi_ref = np.asarray(got.shap_values[0]), np.asarray(want.shap_values[0])
    tol = PHI_REL * max(1.0, np.abs(phi_ref).max())
    assert np.abs(phi - phi_ref).max() <= tol
    assert np.abs(phi - a * np.asarray(bare.shap_values[0])).max() <= tol
    np.testing.assert_allclose(np.ravel(got.expected_value), np.ravel(want.expected_value),
                               atol=1e-5)
    np.testing.assert_allclose(np.ravel(got.expected_value),
                               a * np.ravel(bare.expected_value) + b, atol=1e-5)
    np.testing.assert_allclose(got.data["raw"]["raw_prediction"],
                               a * bare.data["raw"]["raw_prediction"] + b, atol=1e-5)


def test_affine_head_moves_with_its_inner_predictor():
    tables = {"feature": np.array([[0, 0, 0]]),
              "threshold": np.array([[0.0, np.inf, np.inf]], np.float32),
              "left": np.array([[1, 1, 2]]), "right": np.array([[2, 1, 2]]),
              "value": np.array([[[0.0], [1.0], [-1.0]]], np.float32), "depth": 1}
    tree = cs.tree_predictor(tables, "cpu")
    head = AffineOutputPredictor(tree, 2.0, 1.0).to("cpu")
    assert head._device().type == "cpu" and head.inner is tree
    assert head.linear_decomposition is None
    assert head.supports_masked_ey == tree.supports_masked_ey
    X = torch.tensor([[-1.0], [1.0]])
    np.testing.assert_array_equal(head(X).numpy(), 2.0 * tree(X).numpy() + 1.0)
