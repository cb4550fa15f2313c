"""LightGBM ensembles lifted onto a torch device.

Port of ``distributedkernelshap_tpu/models/lgbm.py``, the counterpart of
``models/xgb.py`` for the other mainstream boosting library: a fitted
booster's ``dump_model()`` JSON (documented structure, stable across
LightGBM 2.x-4.x) parses into the shared
:class:`~distributedkernelshap_tpu_torch.models.trees.TreeEnsemblePredictor`
node tables, with lightgbm needed only to serialise the model.

Dump facts used:

* ``tree_info[i].tree_structure`` is a nested node dict: internal nodes have
  ``split_feature``, ``threshold``, ``decision_type``, ``default_left``,
  ``left_child``/``right_child``; leaves have ``leaf_value``;
* numerical splits are ``x <= threshold`` -> left (same comparator as the
  shared traversal, no ulp shift needed); ``default_left`` routes NaN.
  (LightGBM's per-node ``missing_type`` refinement — None/Zero/NaN — is not
  replicated; with ``missing_type='Zero'`` models, rows containing NaN or
  zeros-as-missing may route differently than lightgbm itself.  The probe
  uses dense Gaussian data and will not catch that; explain-time data with
  NaNs under such models should explain the unlifted callable.);
* only ``decision_type == '<='`` is lifted — categorical ``'=='`` splits
  decline;
* ``num_class > 1``: tree ``i`` contributes to class ``i % num_class``
  (iteration-major order); ``objective`` names the head: ``binary`` ->
  sigmoid pair (LightGBM stores no separate bias; the prior is trained into
  the leaves), ``multiclass`` -> softmax, ``regression``/``regression_l1``/
  ``huber``/``quantile``/``lambdarank`` etc. -> identity.  Link objectives
  (``poisson``, ``gamma``, ``tweedie``, ``cross_entropy`` variants) and
  ``multiclassova`` (per-class sigmoids over OvA margins) are declined.
* ``average_output`` (rf boosting) averages instead of summing (declined for
  multiclass, where each class averages over its own trees);
* ``linear_tree`` leaves (``leaf_coeff``/``leaf_const``) are declined — their
  prediction is feature-dependent, not a constant payout.

Every lift is still numerically probe-gated in ``as_predictor`` against the
original callable before being trusted.
"""

import logging
from typing import List, Optional

import numpy as np

from distributedkernelshap_tpu_torch.models.trees import (
    TreeEnsemblePredictor,
    _finalise,
    f32_le_threshold,
)

logger = logging.getLogger(__name__)


def _flatten_tree(root: dict) -> Optional[dict]:
    """Flatten a nested LightGBM tree dict into parallel node arrays
    (children self-loop at leaves, the shared table convention)."""

    feature: List[int] = []
    threshold: List[float] = []
    left: List[int] = []
    right: List[int] = []
    missing_left: List[bool] = []
    value: List[float] = []

    def add(node: dict) -> Optional[int]:
        i = len(feature)
        if "leaf_value" in node:
            if "leaf_coeff" in node or "leaf_const" in node:
                return None  # linear_tree leaves: prediction is x-dependent
            feature.append(0)
            threshold.append(np.inf)
            left.append(i)
            right.append(i)
            missing_left.append(True)
            value.append(float(node["leaf_value"]))
            return i
        if node.get("decision_type", "<=") != "<=":
            return None  # categorical split
        feature.append(int(node["split_feature"]))
        threshold.append(float(node["threshold"]))
        left.append(-1)
        right.append(-1)
        missing_left.append(bool(node.get("default_left", True)))
        value.append(0.0)
        l = add(node["left_child"])
        r = add(node["right_child"])
        if l is None or r is None:
            return None
        left[i], right[i] = l, r
        return i

    if add(root) is None:
        return None
    n = len(feature)
    v = np.zeros((n, 1), np.float32)
    v[:, 0] = value
    # thresholds are doubles; cast rounded DOWN so the inclusive x <= t
    # routing cannot flip at f32-representable data values
    thr = f32_le_threshold(np.asarray(threshold, np.float64))
    return {"feature": np.asarray(feature, np.int32),
            "threshold": thr,
            "left": np.asarray(left, np.int32),
            "right": np.asarray(right, np.int32),
            "missing_left": np.asarray(missing_left, bool),
            "value": v}


def _objective_transform(objective: str, num_class: int):
    parts = objective.split(" ")                     # e.g. "binary sigmoid:2"
    obj = parts[0]
    if obj == "binary":
        # the binary objective carries a sigmoid scale (p = 1/(1+e^{-s*f}));
        # only s == 1 is reproduced by the lifted sigmoid head — decline the
        # rest on BOTH paths (xgb.py policy), not just via the as_predictor
        # probe, so predictor_from_lightgbm_dump never returns a wrong model
        for tok in parts[1:]:
            if tok.startswith("sigmoid:"):
                try:
                    scale = float(tok.split(":", 1)[1])
                except ValueError:
                    return None
                if scale != 1.0:
                    return None
        return "binary_sigmoid", True
    if obj == "multiclass":
        return "softmax", True
    if obj in ("regression", "regression_l1", "regression_l2", "huber",
               "fair", "quantile", "mape", "lambdarank", "rank_xendcg",
               "l2", "l1", "mean_squared_error", "mean_absolute_error"):
        return "identity", num_class > 1
    return None  # poisson/gamma/tweedie/cross_entropy/multiclassova etc.


def predictor_from_lightgbm_dump(dump: dict, binary_as_scalar: bool = False,
                                 device=None) -> Optional[TreeEnsemblePredictor]:
    """Build a :class:`TreeEnsemblePredictor` on ``device`` from
    ``Booster.dump_model()``, or None where the lift declines.

    ``binary_as_scalar``: emit the raw ``Booster.predict`` layout for binary
    objectives — one sigmoid probability column — instead of the sklearn-API
    ``[1-p, p]`` pair.
    """

    try:
        objective = dump.get("objective", "") or ""
        num_class = max(1, int(dump.get("num_class", 1) or 1))
        transform = _objective_transform(objective, num_class)
        if transform is None:
            logger.info("LightGBM objective %r is not reproduced; not lifted",
                        objective)
            return None
        out_transform, vector_out = transform
        if binary_as_scalar and out_transform == "binary_sigmoid":
            out_transform, vector_out = "sigmoid", False

        aggregation = "mean" if dump.get("average_output") else "sum"
        if aggregation == "mean" and num_class > 1:
            # rf-boosting multiclass averages each class over its OWN trees;
            # the shared mean-over-all-trees would understate by num_class
            logger.info("LightGBM multiclass rf averaging is not reproduced; "
                        "not lifted")
            return None

        trees = dump["tree_info"]
        k_total = num_class
        tables = []
        for i, t in enumerate(trees):
            tbl = _flatten_tree(t["tree_structure"])
            if tbl is None:
                logger.info("LightGBM tree %d has categorical splits or "
                            "linear leaves; not lifted", i)
                return None
            if k_total > 1:
                wide = np.zeros((tbl["value"].shape[0], k_total), np.float32)
                wide[:, i % k_total] = tbl["value"][:, 0]
                tbl["value"] = wide
            tables.append(tbl)

        return _finalise(tables, device=device, aggregation=aggregation,
                         out_transform=out_transform, vector_out=vector_out)
    except Exception as exc:  # schema drift: never crash the caller
        logger.info("unrecognised LightGBM dump layout (%s); not lifted", exc)
        return None


def lift_lightgbm(method, device=None) -> Optional[TreeEnsemblePredictor]:
    """Lift a bound ``LGBMClassifier.predict_proba`` /
    ``LGBMRegressor.predict`` (or a ``Booster.predict``) into a tree
    predictor on ``device``; probe-verified by the caller
    (``as_predictor``)."""

    owner = getattr(method, "__self__", None)
    name = getattr(method, "__name__", "")
    if owner is None:
        return None
    cls = type(owner).__name__
    if cls.startswith("LGBM") and name in ("predict", "predict_proba"):
        if cls.endswith("Classifier") and name == "predict":
            return None  # class-label argmax: not lifted
        booster = getattr(owner, "booster_", None)
    elif cls == "Booster" and name == "predict" and hasattr(owner, "dump_model"):
        booster = owner
    else:
        return None
    try:
        # dump_model() defaults to num_iteration=None, which itself honours
        # best_iteration after early stopping — no slicing needed here
        # (booster.best_iteration is -1, not 0, when unset)
        dump = booster.dump_model()
    except Exception as exc:
        logger.info("could not dump LightGBM booster (%s); not lifted", exc)
        return None
    # raw Booster.predict returns one probability column for binary
    # objectives, not the sklearn [1-p, p] pair
    return predictor_from_lightgbm_dump(dump, binary_as_scalar=(cls == "Booster"),
                                        device=device)
