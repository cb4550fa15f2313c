"""XGBoost ensembles lifted onto a torch device.

Port of ``distributedkernelshap_tpu/models/xgb.py``: a fitted booster's
documented ``save_model`` JSON schema (xgboost "Introduction to Model IO")
is parsed into the same padded node tables as the scikit-learn lifts, so
prediction runs as
:class:`~distributedkernelshap_tpu_torch.models.trees.TreeEnsemblePredictor`
path contractions; xgboost is needed only to serialise the model.

Schema facts used (stable since xgboost 1.x):

* ``learner.gradient_booster.model.trees[i]`` holds parallel arrays
  ``split_indices`` (feature ids), ``split_conditions`` (thresholds for
  internal nodes, **leaf values for leaves**), ``left_children`` /
  ``right_children`` (-1 at leaves), ``default_left`` (missing-value
  routing);
* split comparison is ``x < threshold`` (strict; the node tables compare
  ``x <= t``), so thresholds become the largest float32 strictly below
  ``t`` (``f32_lt_threshold``);
* ``tree_info[i]`` is the output-class slot of tree ``i`` (multiclass);
* ``learner.learner_model_param.base_score`` is the global bias, stored in
  *transformed* (probability) space for logistic-family objectives
  (including ``binary:logitraw``, whose outputs are raw margins but whose
  bias still goes through logit);
* ``learner.attributes.best_iteration`` + ``iteration_indptr`` bound the
  trees actually used by ``predict`` after early stopping;
* objectives: ``binary:logistic`` -> sigmoid pair, ``multi:soft*`` ->
  softmax, squared/absolute/huber/quantile regression and ``rank:*`` /
  ``binary:logitraw`` -> identity margins.  Objectives with prediction
  transforms this lift does not reproduce (``reg:logistic``, poisson /
  gamma / tweedie exp links, survival) are declined outright.

Categorical splits (``split_type`` != 0 / non-empty ``categories``) are not
lifted.  Every lift is still numerically probe-gated in ``as_predictor``
against the original callable before being trusted.
"""

import json
import logging
from typing import Optional

import numpy as np

from distributedkernelshap_tpu_torch.models.trees import (
    TreeEnsemblePredictor,
    _finalise,
    f32_lt_threshold,
)

logger = logging.getLogger(__name__)


#: objectives whose prediction transform the lift reproduces exactly.
#: Anything else (reg:logistic's sigmoid, poisson/gamma/tweedie's exp link,
#: survival objectives, ...) is declined outright so neither the probe-gated
#: path nor the direct predictor_from_xgboost_json API can return silently
#: wrong outputs.
_IDENTITY_OBJECTIVES = (
    "reg:squarederror", "reg:absoluteerror", "reg:pseudohubererror",
    "reg:quantileerror", "rank:pairwise", "rank:ndcg", "rank:map",
    "binary:logitraw",
)


def _objective_transform(objective: str, n_class: int):
    """(out_transform, vector_out) for a booster objective name, or None when
    the objective's prediction transform is not reproduced."""

    if objective == "binary:logistic":
        return "binary_sigmoid", True
    if objective in ("multi:softprob", "multi:softmax"):
        # softmax margins; multi:softmax argmax is applied by predict(), which
        # is not lifted — predict_proba goes through softprob either way
        return "softmax", True
    if objective in _IDENTITY_OBJECTIVES:
        return "identity", n_class > 1
    return None


def _xgb_tree_table(tree: dict, k_slot: int, k_total: int) -> Optional[dict]:
    """Node table from one tree of the xgboost JSON model.

    xgboost routes left when ``x < t`` (strict) while the shared traversal /
    path-matmul compares ``x <= t``; thresholds are therefore converted to
    the largest float32 strictly below ``t`` (``f32_lt_threshold``) instead
    of changing the comparator.
    """

    if tree.get("categories") or any(int(s) != 0 for s in tree.get("split_type", [])):
        return None  # categorical splits are not lifted
    feat = np.asarray(tree["split_indices"], dtype=np.int64)
    cond = np.asarray(tree["split_conditions"], dtype=np.float64)
    left = np.asarray(tree["left_children"], dtype=np.int64)
    right = np.asarray(tree["right_children"], dtype=np.int64)
    default_left = np.asarray(tree["default_left"], dtype=np.int64).astype(bool)
    n = feat.shape[0]
    idx = np.arange(n, dtype=np.int32)
    is_leaf = left < 0

    threshold = f32_lt_threshold(np.where(is_leaf, np.inf, cond))
    threshold = np.where(is_leaf, np.float32(np.inf), threshold)
    value = np.zeros((n, k_total), np.float32)
    value[is_leaf, k_slot] = cond[is_leaf]   # leaf payout lives in split_conditions
    return {
        "feature": np.where(is_leaf, 0, np.maximum(feat, 0)).astype(np.int32),
        "threshold": threshold,
        "left": np.where(is_leaf, idx, left).astype(np.int32),
        "right": np.where(is_leaf, idx, right).astype(np.int32),
        "value": value,
        "missing_left": np.where(is_leaf, True, default_left),
    }


def predictor_from_xgboost_json(model: dict, device=None) -> Optional[TreeEnsemblePredictor]:
    """Build a :class:`TreeEnsemblePredictor` on ``device`` from a parsed
    ``save_model`` JSON dict (the object with the top-level ``learner``
    key), or None where the lift declines."""

    try:
        learner = model["learner"]
        objective = learner["objective"]["name"]
        mparam = learner["learner_model_param"]
        base_score = float(mparam["base_score"])
        n_class = max(1, int(mparam.get("num_class", "0") or 0))
        booster_model = learner["gradient_booster"]["model"]
        trees = booster_model["trees"]
        tree_info = booster_model.get("tree_info") or [0] * len(trees)

        transform = _objective_transform(objective, n_class)
        if transform is None:
            logger.info("objective %r has a prediction transform this lift "
                        "does not reproduce; not lifted", objective)
            return None
        out_transform, vector_out = transform

        # early stopping: predict() uses only the first best_iteration+1
        # rounds; iteration_indptr (xgboost >= 1.7 JSON) maps rounds -> trees
        best_iter = (learner.get("attributes") or {}).get("best_iteration")
        if best_iter is not None:
            indptr = booster_model.get("iteration_indptr")
            if indptr is not None:
                n_keep = int(indptr[int(best_iter) + 1])
            else:
                gparam = booster_model.get("gbtree_model_param", {})
                per_iter = max(1, n_class) * max(
                    1, int(gparam.get("num_parallel_tree", "1") or 1))
                n_keep = (int(best_iter) + 1) * per_iter
            trees, tree_info = trees[:n_keep], tree_info[:n_keep]

        k_total = n_class if n_class > 1 else 1
        # base_score is stored in transformed (probability) space for
        # logistic-family objectives: margin bias = logit(base_score).
        # binary:logitraw outputs raw margins but still stores base_score as
        # a probability (ProbToMargin in xgboost's objective registry)
        if objective in ("binary:logistic", "binary:logitraw",
                         "multi:softprob", "multi:softmax") \
                and 0.0 < base_score < 1.0:
            base_margin = float(np.log(base_score / (1.0 - base_score)))
        else:
            base_margin = base_score
        base = np.full((k_total,), base_margin, np.float32)

        tables = [_xgb_tree_table(t, k_slot=int(tree_info[i]) if k_total > 1 else 0,
                                  k_total=k_total)
                  for i, t in enumerate(trees)]
        return _finalise(tables, device=device, aggregation="sum", base=base,
                         out_transform=out_transform, vector_out=vector_out)
    except Exception as exc:  # schema drift / malformed trees: never crash
        logger.info("unrecognised xgboost JSON layout (%s); not lifted", exc)
        return None


def lift_xgboost(method, device=None) -> Optional[TreeEnsemblePredictor]:
    """Lift a bound ``XGBClassifier.predict_proba`` / ``XGBRegressor.predict``
    into a tree predictor on ``device``.

    Requires the xgboost package only to serialise the booster; the caller
    (``as_predictor``) numerically verifies the lift before trusting it.
    """

    owner = getattr(method, "__self__", None)
    name = getattr(method, "__name__", "")
    if owner is None:
        return None
    cls = type(owner).__name__
    if not (cls.startswith("XGB") and name in ("predict", "predict_proba")):
        return None
    if cls.endswith("Classifier") and name == "predict":
        return None  # class-label argmax: not lifted
    try:
        booster = owner.get_booster()
        raw = bytes(booster.save_raw("json"))
        model = json.loads(raw)
    except Exception as exc:
        logger.info("could not serialise xgboost booster (%s); not lifted", exc)
        return None
    return predictor_from_xgboost_json(model, device=device)
