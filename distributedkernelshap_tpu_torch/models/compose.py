"""Composite scikit-learn estimators lifted onto a torch device.

Port of ``distributedkernelshap_tpu/models/compose.py``.  The family lifts
(linear / trees / XGBoost / LightGBM / SVM / MLP) cover single estimators;
real scikit-learn models are usually *compositions* of those — a
``Pipeline`` with scaling in front, a soft ``VotingClassifier``, a
``CalibratedClassifierCV``.  This module lifts the composition itself by
lifting the members through ``predictors.structural_lift`` and stitching
them together with torch ops:

* ``PipelinePredictor`` — transform stages (elementwise-affine scalers, NaN
  imputation, clipping, static column selects, linear projections like PCA)
  applied before an inner predictor; columnwise stages forward the inner
  model's structure-aware masked evaluation with pre-transformed sources.
  All-affine stages before a linear model fold into ONE
  ``LinearPredictor`` (:func:`_compose_linear`, float64 on the host, cast
  once), which takes the linear route and ``fused_linear_ey``;
* ``MeanEnsemblePredictor`` — weighted mean of member outputs (soft voting,
  bagging, cv-ensembled calibration); forwards the masked evaluation
  memberwise, since expectation is linear;
* ``StackingPredictor`` — member predictions (scikit-learn's column-slicing
  rules, optional feature passthrough) feeding a lifted final estimator;
* ``OneVsRestPredictor`` — per-class binary members' positive
  probabilities, row-normalised for multiclass (multilabel stays
  unnormalised and forwards the masked evaluation memberwise);
* ``CalibratedBinaryPredictor`` — a margin model followed by sigmoid
  (``1/(1+exp(a·f+b))``) or isotonic (:func:`interp` over the fitted
  thresholds) calibration;
* ``AdaBoostPredictor`` — SAMME votes of lifted members;
* ``AffineOutputPredictor`` — ``y -> a*y + b`` over an inner predictor (a
  target scaler's inverse, IsolationForest's decision offset), which the
  exact TreeSHAP path unwraps (``ops/treeshap._unwrap``).

Composites are ``nn.Module`` trees: members sit in ``nn.ModuleList``\\ s and
stage arrays, ensemble weights and ``select`` indices (int64) are buffers,
so ``.to(device)`` and ``KernelShap.save`` / ``load`` carry a whole
composite.  Constructors take numpy (or torch) stages and weights and put
them on their inner predictor's device.  Everything lifted here is probed
as one composite in ``as_predictor`` before it is trusted; any
unrecognised step declines the whole composition to the unlifted callable.
"""

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributedkernelshap_tpu_torch.models.predictors import BasePredictor, _f32

logger = logging.getLogger(__name__)

# transform stages are (kind, *params) tuples: numpy arrays as lifted,
# buffers inside a PipelinePredictor
Stage = Tuple


def _np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _apply_stage(stage: Stage, X: torch.Tensor) -> torch.Tensor:
    kind = stage[0]
    if kind == "affine":                  # x * a + b (elementwise per column)
        return X * stage[1][None, :] + stage[2][None, :]
    if kind == "linear":                  # x @ W + b (PCA / TruncatedSVD)
        return X @ stage[1] + stage[2][None, :]
    if kind == "impute":                  # NaN -> fitted statistics
        return torch.where(torch.isnan(X), stage[1][None, :], X)
    if kind == "clip":                    # MinMaxScaler(clip=True)
        return torch.clamp(X, stage[1], stage[2])
    if kind == "select":                  # static column subset (bagging)
        return X[:, stage[1]]
    raise ValueError(f"unknown stage kind {kind!r}")


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` in torch: piecewise-linear through the
    points ``(xp, fp)`` (``xp`` sorted ascending), ``fp[0]`` left of
    ``xp[0]`` and ``fp[-1]`` right of ``xp[-1]``, as ``np.interp``.  The
    same formula and operation order as JAX's (which XLA may fuse into a
    multiply-add: one float32 ulp apart); against ``np.interp`` (float64)
    it differs by rounding, and at an ``x`` equal to a repeated LAST
    threshold it takes the first of the repeats where numpy takes the last
    (JAX's convention)."""

    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _lift_transformer(tf) -> Optional[Stage]:
    """One fitted preprocessing step -> a stage of numpy float32 arrays
    (statistics combined in float64 first, as the reference combines
    them), a list of two stages, or None."""

    name = type(tf).__name__
    f32 = np.float32
    try:
        if name == "StandardScaler":
            d = tf.n_features_in_
            mean = np.asarray(tf.mean_) if tf.with_mean else np.zeros(d)
            scale = np.asarray(tf.scale_) if tf.with_std else np.ones(d)
            return ("affine", np.asarray(1.0 / scale, f32), np.asarray(-mean / scale, f32))
        if name == "MinMaxScaler":
            stage = ("affine", np.asarray(tf.scale_, f32), np.asarray(tf.min_, f32))
            if getattr(tf, "clip", False):
                lo, hi = tf.feature_range
                return [stage, ("clip", float(f32(lo)), float(f32(hi)))]
            return stage
        if name == "MaxAbsScaler":
            return ("affine", np.asarray(1.0 / np.asarray(tf.scale_), f32),
                    np.zeros(tf.n_features_in_, f32))
        if name == "RobustScaler":
            d = tf.n_features_in_
            center = np.asarray(tf.center_) if tf.with_centering else np.zeros(d)
            scale = np.asarray(tf.scale_) if tf.with_scaling else np.ones(d)
            return ("affine", np.asarray(1.0 / scale, f32), np.asarray(-center / scale, f32))
        if name == "SimpleImputer":
            mv = getattr(tf, "missing_values", np.nan)
            if not (isinstance(mv, float) and np.isnan(mv)):
                return None           # only NaN-as-missing is reproduced
            if getattr(tf, "add_indicator", False):
                return None           # appends indicator columns
            return ("impute", np.asarray(tf.statistics_, f32))
        if name == "PCA":
            W = np.asarray(tf.components_).T            # (D, C)
            if getattr(tf, "whiten", False):
                W = W / np.sqrt(np.asarray(tf.explained_variance_))[None, :]
            b = -np.asarray(tf.mean_) @ W
            return ("linear", np.asarray(W, f32), np.asarray(b, f32))
        if name == "TruncatedSVD":
            W = np.asarray(tf.components_).T
            return ("linear", np.asarray(W, f32), np.zeros(W.shape[1], f32))
    except Exception as exc:
        logger.info("transformer %s lift failed (%s)", name, exc)
    return None


def _compose_linear(stages: Sequence[Stage], inner: BasePredictor):
    """Fold all-affine/linear stages into an inner ``LinearPredictor``
    (reference ``compose.py:112-149``).

    ``Pipeline(StandardScaler, LogisticRegression)`` is one generalised
    linear model; folding it keeps the linear route (group-space products
    and ``fused_linear_ey``), which a ``PipelinePredictor`` wrapper would
    forfeit.  The fold runs in float64 numpy on the host and casts to
    float32 once, so ``W`` and ``b`` equal the JAX package's bit for bit.
    Returns None when any stage is non-affine (impute / clip / select) or
    the inner model is not linear."""

    from distributedkernelshap_tpu_torch.models.predictors import LinearPredictor

    decomp = inner.linear_decomposition
    if decomp is None or any(s[0] not in ("affine", "linear") for s in stages):
        return None
    W_in, b_in, activation = decomp
    D = stages[0][1].shape[0] if stages else W_in.shape[0]
    Mx = np.eye(D, dtype=np.float64)       # cumulative x -> x@Mx + v
    v = np.zeros(D, dtype=np.float64)
    for s in stages:
        if s[0] == "affine":
            a, b = _np64(s[1]), _np64(s[2])
            Mx = Mx * a[None, :]
            v = v * a + b
        else:                              # linear
            W, b = _np64(s[1]), _np64(s[2])
            Mx = Mx @ W
            v = v @ W + b
    W64, b64 = _np64(W_in), _np64(b_in)
    return LinearPredictor(Mx @ W64, v @ W64 + b64, activation=activation,
                           vector_out=inner.vector_out, device=W_in.device)


class PipelinePredictor(BasePredictor):
    """Transform stages applied before an inner predictor.  Stage arrays
    are buffers ``stage<i>_<j>`` on the inner predictor's device (a
    ``select`` stage's indices as int64)."""

    def __init__(self, stages: Sequence[Stage], inner: BasePredictor):
        super().__init__()
        self.inner = inner
        dev = inner._device()
        self._spec = []
        for i, stage in enumerate(stages):
            spec = [(False, stage[0])]
            for j, a in enumerate(stage[1:], 1):
                if isinstance(a, (torch.Tensor, np.ndarray)):
                    name = f"stage{i}_{j}"
                    if stage[0] == "select":
                        t = torch.as_tensor(a, dtype=torch.int64, device=dev)
                    else:
                        t = _f32(a, dev)
                    self.register_buffer(name, t)
                    spec.append((True, name))
                else:
                    spec.append((False, float(a)))
            self._spec.append(spec)
        self.n_outputs = inner.n_outputs
        self.vector_out = inner.vector_out

    @property
    def stages(self) -> List[Stage]:
        return [tuple(getattr(self, a) if is_buf else a for is_buf, a in spec)
                for spec in self._spec]

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        X = X.to(torch.float32)
        for stage in self.stages:
            X = _apply_stage(stage, X)
        return self.inner(X)

    @property
    def supports_masked_ey(self) -> bool:
        """Columnwise stages (affine / NaN-impute / clip / column select)
        commute with the KernelSHAP column mask —
        ``t(x·z + bg·(1-z)) = t(x)·z + t(bg)·(1-z)`` per column — so the
        inner predictor's masked evaluation forwards exactly with
        pre-transformed sources (a select also re-indexes the group
        matrix).  Column-mixing stages ('linear': PCA/SVD) break the
        two-source structure and take row evaluation."""

        return (all(spec[0][1] in ("affine", "impute", "clip", "select")
                    for spec in self._spec)
                and getattr(self.inner, "supports_masked_ey", False))

    def masked_ey_fits(self, **kwargs) -> bool:
        return self.inner.masked_ey_fits(**kwargs)

    def masked_ey(self, X, bg, bgw_n, mask, G, target_chunk_elems=None,
                  coalition_chunk=None):
        X = X.to(torch.float32)
        bg = bg.to(torch.float32)
        G = G.to(torch.float32)
        for stage in self.stages:
            X = _apply_stage(stage, X)
            bg = _apply_stage(stage, bg)
            if stage[0] == "select":      # groups follow the column subset
                G = G[:, stage[1]]
        return self.inner.masked_ey(X, bg, bgw_n, mask, G, target_chunk_elems,
                                    coalition_chunk=coalition_chunk)


def _weights_buffer(weights, device) -> torch.Tensor:
    return torch.tensor(np.asarray(weights, np.float64).astype(np.float32), device=device)


class MeanEnsemblePredictor(BasePredictor):
    """Weighted mean of member predictor outputs (soft voting); the
    normalised weights are a float32 buffer."""

    def __init__(self, members: Sequence[BasePredictor], weights=None):
        super().__init__()
        if not members:
            raise ValueError("MeanEnsemblePredictor needs at least one member")
        k = members[0].n_outputs
        if any(m.n_outputs != k for m in members):
            raise ValueError("members disagree on n_outputs")
        self.members = nn.ModuleList(members)
        w = np.ones(len(members)) if weights is None else np.asarray(weights, np.float64)
        self.register_buffer("weights", _weights_buffer(w / w.sum(), members[0]._device()))
        self.n_outputs = k
        self.vector_out = members[0].vector_out

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        X = X.to(torch.float32)
        outs = torch.stack([m(X) for m in self.members])     # (M, n, K)
        return torch.einsum("mnk,m->nk", outs, self.weights)

    @property
    def supports_masked_ey(self) -> bool:
        """Expectation is linear, so the ensemble's masked evaluation is the
        weighted mean of its members' — available when every member has
        one."""

        return all(getattr(m, "supports_masked_ey", False) for m in self.members)

    def masked_ey_fits(self, **kwargs) -> bool:
        return all(m.masked_ey_fits(**kwargs) for m in self.members)

    def masked_ey(self, X, bg, bgw_n, mask, G, target_chunk_elems=None,
                  coalition_chunk=None):
        parts = [m.masked_ey(X, bg, bgw_n, mask, G, target_chunk_elems,
                             coalition_chunk=coalition_chunk)
                 for m in self.members]
        return torch.einsum("mbsk,m->bsk", torch.stack(parts), self.weights)


class CalibratedBinaryPredictor(BasePredictor):
    """Binary probability calibration over a lifted margin model.

    ``inner`` produces either a margin column (``decision_function`` lifts)
    or a 2-class proba (``predict_proba`` lifts — the positive column feeds
    the calibrator, scikit-learn's ``_get_response_values`` convention).
    ``params``: ``(a, b)`` for ``kind='sigmoid'``, the fitted thresholds
    ``(X_thresholds_, y_thresholds_)`` (float32 buffers) for
    ``'isotonic'``."""

    n_outputs = 2
    vector_out = True

    def __init__(self, inner: BasePredictor, kind: str, params):
        super().__init__()
        self.inner = inner
        if kind == "sigmoid":
            self.kind = "sigmoid"
            self.a = float(params[0])
            self.b = float(params[1])
        elif kind == "isotonic":
            self.kind = "isotonic"
            dev = inner._device()
            self.register_buffer("xs", _f32(params[0], dev).reshape(-1))
            self.register_buffer("ys", _f32(params[1], dev).reshape(-1))
        else:
            raise ValueError(f"unknown calibration kind {kind!r}")

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        f = self.inner(X.to(torch.float32))
        f = f[:, -1] if self.inner.n_outputs > 1 else f[:, 0]
        if self.kind == "sigmoid":
            p1 = torch.sigmoid(-(self.a * f + self.b))
        else:
            p1 = interp(f, self.xs, self.ys)
        return torch.stack([1.0 - p1, p1], dim=1)


class OneVsRestPredictor(BasePredictor):
    """Per-class binary members' positive probabilities, row-normalised
    (scikit-learn's multiclass one-vs-rest composition)."""

    vector_out = True

    def __init__(self, members: Sequence[BasePredictor], normalise: bool = True):
        super().__init__()
        if not members:
            raise ValueError("OneVsRestPredictor needs at least one member")
        self.members = nn.ModuleList(members)
        self.normalise = normalise
        self.n_outputs = len(members)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        X = X.to(torch.float32)
        P = torch.stack([m(X)[:, -1] for m in self.members], dim=1)
        if self.normalise:
            P = P / torch.sum(P, dim=1, keepdim=True)
        return P

    @property
    def supports_masked_ey(self) -> bool:
        """The unnormalised (multilabel) composition is memberwise-linear, so
        member masked evaluations stack directly; the multiclass row
        normalisation is nonlinear per synthetic row and cannot forward."""

        return (not self.normalise
                and all(getattr(m, "supports_masked_ey", False) for m in self.members))

    def masked_ey_fits(self, **kwargs) -> bool:
        return all(m.masked_ey_fits(**kwargs) for m in self.members)

    def masked_ey(self, X, bg, bgw_n, mask, G, target_chunk_elems=None,
                  coalition_chunk=None):
        parts = [m.masked_ey(X, bg, bgw_n, mask, G, target_chunk_elems,
                             coalition_chunk=coalition_chunk)[:, :, -1]
                 for m in self.members]
        return torch.stack(parts, dim=-1)


class StackingPredictor(BasePredictor):
    """Lifted stacking: member predictions (column-sliced the way
    scikit-learn's ``_concatenate_predictions`` does, plus the raw features
    when ``passthrough``) feed a lifted final estimator."""

    def __init__(self, members: Sequence[BasePredictor],
                 slices: Sequence[Optional[Tuple[int, int]]],
                 final: BasePredictor, passthrough: bool = False):
        super().__init__()
        self.members = nn.ModuleList(members)
        self.slices = list(slices)
        self.final = final
        self.passthrough = passthrough
        self.n_outputs = final.n_outputs
        self.vector_out = final.vector_out

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        X = X.to(torch.float32)
        cols = []
        for m, sl in zip(self.members, self.slices):
            out = m(X)
            cols.append(out if sl is None else out[:, sl[0]:sl[1]])
        if self.passthrough:
            cols.append(X)
        return self.final(torch.cat(cols, dim=1))


class AdaBoostPredictor(BasePredictor):
    """SAMME AdaBoost: each member votes with its argmax class (one-hot of
    the member's lifted ``predict_proba``; ``torch.argmax`` takes the first
    maximum, as ``jnp.argmax``), votes weighted ``+w`` for the predicted
    class and ``-w/(K-1)`` elsewhere, normalised by ``Σw`` (scikit-learn
    ``AdaBoostClassifier.decision_function``).  Heads: ``'proba'`` =
    ``softmax(decision/(K-1))`` (binary: softmax of ``[-d, d]/2``),
    ``'decision'`` = the raw decision (binary: scalar).  The estimator
    weights are a float32 buffer.

    The argmax makes the model piecewise-constant — fine for KernelSHAP,
    which only evaluates the predictor; the probe in ``as_predictor`` guards
    tie-breaking and member class order numerically."""

    def __init__(self, members: Sequence[BasePredictor], weights,
                 n_classes: int, head: str = "proba"):
        super().__init__()
        if not members:
            raise ValueError("AdaBoostPredictor needs at least one member")
        if head not in ("proba", "decision"):
            raise ValueError("head must be 'proba' or 'decision'")
        self.members = nn.ModuleList(members)
        self.register_buffer("weights", _weights_buffer(weights, members[0]._device()))
        self.K = int(n_classes)
        self.head = head
        binary_decision = head == "decision" and self.K == 2
        self.n_outputs = 1 if binary_decision else self.K
        self.vector_out = not binary_decision

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        X = X.to(torch.float32)
        K = self.K
        total = X.new_zeros((X.shape[0], K))
        for m, w in zip(self.members, self.weights):
            onehot = F.one_hot(torch.argmax(m(X), dim=-1), K)
            total = total + torch.where(onehot > 0, w, -w / (K - 1))
        dec = total / torch.sum(self.weights)
        if self.head == "decision":
            if K == 2:
                return (dec[:, 1] - dec[:, 0])[:, None]
            return dec
        if K == 2:
            d = dec[:, 1] - dec[:, 0]
            return torch.softmax(torch.stack([-d, d], dim=-1) / 2.0, dim=-1)
        return torch.softmax(dec / (K - 1), dim=-1)


class AffineOutputPredictor(BasePredictor):
    """Inner predictor outputs mapped through ``y -> a*y + b`` (e.g. a
    target scaler's inverse transform, IsolationForest's decision offset).
    Expectation is linear, so the inner model's structure-aware masked
    evaluation forwards through the head.  ``a`` and ``b`` are floats; the
    inner predictor is a submodule, so ``.to(device)`` moves it."""

    def __init__(self, inner: BasePredictor, a: float, b: float):
        super().__init__()
        self.inner = inner
        self.a = float(a)
        self.b = float(b)
        self.n_outputs = inner.n_outputs
        self.vector_out = inner.vector_out

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return self.inner(X) * self.a + self.b

    @property
    def supports_masked_ey(self) -> bool:
        return getattr(self.inner, "supports_masked_ey", False)

    def masked_ey_fits(self, **kwargs) -> bool:
        return self.inner.masked_ey_fits(**kwargs)

    def masked_ey(self, *args, **kwargs):
        return self.inner.masked_ey(*args, **kwargs) * self.a + self.b


# ---------------------------------------------------------------------- #
# lifters: each takes (method, device) and returns a predictor or None


def _inner_lift(estimator, method_names, device=None) -> Optional[BasePredictor]:
    """Lift a member estimator onto ``device`` through the first of its
    ``method_names`` that exists and lifts."""

    from distributedkernelshap_tpu_torch.models.predictors import structural_lift

    for mname in method_names:
        method = getattr(estimator, mname, None)
        if method is None:
            continue
        inner = structural_lift(method, device=device)
        if inner is not None:
            return inner
    return None


def lift_pipeline(method, device=None) -> Optional[BasePredictor]:
    """Lift ``Pipeline.predict/predict_proba/decision_function`` when every
    preprocessing step and the final estimator lift."""

    owner = getattr(method, "__self__", None)
    name = getattr(method, "__name__", "")
    if owner is None or type(owner).__name__ != "Pipeline" \
            or name not in ("predict", "predict_proba", "decision_function"):
        return None
    try:
        steps = list(owner.steps)
    except Exception:
        return None
    stages: List[Stage] = []
    for _, tf in steps[:-1]:
        if tf is None or (isinstance(tf, str) and tf == "passthrough"):
            continue
        stage = _lift_transformer(tf)
        if stage is None:
            logger.info("pipeline step %s is not lifted; keeping the callable",
                        type(tf).__name__)
            return None
        stages.extend(stage if isinstance(stage, list) else [stage])
    inner = _inner_lift(steps[-1][1], (name,), device)
    if inner is None:
        return None
    composed = _compose_linear(stages, inner)
    return composed if composed is not None else PipelinePredictor(stages, inner)


def lift_voting(method, device=None) -> Optional[BasePredictor]:
    """Lift soft ``VotingClassifier.predict_proba`` /
    ``VotingRegressor.predict`` when every member lifts."""

    owner = getattr(method, "__self__", None)
    name = getattr(method, "__name__", "")
    if owner is None:
        return None
    cls = type(owner).__name__
    try:
        if cls == "VotingClassifier" and name == "predict_proba":
            if owner.voting != "soft":
                return None   # hard voting is a discontinuous argmax-of-modes
            members = [_inner_lift(e, ("predict_proba",), device) for e in owner.estimators_]
        elif cls == "VotingRegressor" and name == "predict":
            members = [_inner_lift(e, ("predict",), device) for e in owner.estimators_]
        else:
            return None
        if any(m is None for m in members):
            return None
        # scikit-learn pairs weights with NON-dropped estimators only
        # (_weights_not_none); estimators_ already excludes 'drop' members
        return MeanEnsemblePredictor(members, weights=owner._weights_not_none)
    except Exception as exc:
        logger.info("voting lift failed structurally (%s); keeping the callable", exc)
        return None


def lift_ovr(method, device=None) -> Optional[BasePredictor]:
    """Lift ``OneVsRestClassifier.predict_proba`` (multiclass, or
    multilabel: unnormalised) when every per-class binary member lifts; the
    single-estimator binary case declines (scikit-learn reshapes it
    differently)."""

    owner = getattr(method, "__self__", None)
    if owner is None or type(owner).__name__ != "OneVsRestClassifier" \
            or getattr(method, "__name__", "") != "predict_proba":
        return None
    try:
        if len(owner.estimators_) < 2:
            return None
        members = [_inner_lift(e, ("predict_proba",), device) for e in owner.estimators_]
        if any(m is None for m in members):
            return None
        return OneVsRestPredictor(members, normalise=not owner.multilabel_)
    except Exception as exc:
        logger.info("one-vs-rest lift failed structurally (%s); keeping the callable", exc)
        return None


def lift_stacking(method, device=None) -> Optional[BasePredictor]:
    """Lift ``StackingClassifier.predict_proba`` /
    ``StackingRegressor.predict`` when every member (via its fitted
    ``stack_method_``) and the final estimator lift.  Class-label
    ``predict`` stack methods are discontinuous and decline."""

    owner = getattr(method, "__self__", None)
    name = getattr(method, "__name__", "")
    if owner is None:
        return None
    cls = type(owner).__name__
    try:
        if cls == "StackingClassifier" and name == "predict_proba":
            final_method = ("predict_proba",)
            binary = len(owner.classes_) == 2
        elif cls == "StackingRegressor" and name == "predict":
            final_method = ("predict",)
            binary = False
        else:
            return None
        members, slices = [], []
        for est, mname in zip(owner.estimators_, owner.stack_method_):
            if cls == "StackingClassifier" and mname == "predict":
                return None  # hard-label stacking feature: argmax
            inner = _inner_lift(est, (mname,), device)
            if inner is None:
                return None
            members.append(inner)
            # scikit-learn drops the redundant first proba column for binary
            slices.append((1, 2) if (mname == "predict_proba" and binary) else None)
        final = _inner_lift(owner.final_estimator_, final_method, device)
        if final is None:
            return None
        return StackingPredictor(members, slices, final, passthrough=bool(owner.passthrough))
    except Exception as exc:
        logger.info("stacking lift failed structurally (%s); keeping the callable", exc)
        return None


def lift_bagging(method, device=None) -> Optional[BasePredictor]:
    """Lift ``BaggingClassifier.predict_proba`` / ``BaggingRegressor.predict``
    when every member lifts: the mean of member predictions, each member
    seeing its own bootstrap feature subset (a 'select' stage that commutes
    with the KernelSHAP column mask)."""

    owner = getattr(method, "__self__", None)
    name = getattr(method, "__name__", "")
    if owner is None:
        return None
    cls = type(owner).__name__
    try:
        if cls == "BaggingClassifier" and name == "predict_proba":
            method_names = ("predict_proba",)
        elif cls == "BaggingRegressor" and name == "predict":
            method_names = ("predict",)
        else:
            return None
        n_features = owner.n_features_in_
        members = []
        for est, feats in zip(owner.estimators_, owner.estimators_features_):
            if not all(hasattr(est, m) for m in method_names):
                return None  # scikit-learn would fall back to another method
            inner = _inner_lift(est, method_names, device)
            if inner is None:
                return None
            feats = np.asarray(feats)
            if feats.shape[0] == n_features and np.array_equal(feats, np.arange(n_features)):
                members.append(inner)
            else:
                members.append(PipelinePredictor([("select", feats.astype(np.int64))], inner))
        if not members:
            return None
        return MeanEnsemblePredictor(members)
    except Exception as exc:
        logger.info("bagging lift failed structurally (%s); keeping the callable", exc)
        return None


def lift_adaboost(method, device=None) -> Optional[BasePredictor]:
    """Lift ``AdaBoostClassifier.predict_proba`` / ``decision_function``
    (SAMME) when every member's ``predict_proba`` lifts and member class
    order matches the ensemble's.  ``AdaBoostRegressor`` (weighted-median
    aggregation) declines."""

    owner = getattr(method, "__self__", None)
    name = getattr(method, "__name__", "")
    if owner is None or type(owner).__name__ != "AdaBoostClassifier" \
            or name not in ("predict_proba", "decision_function"):
        return None
    try:
        algorithm = getattr(owner, "algorithm", "SAMME")
        if algorithm not in ("SAMME", "deprecated"):
            return None  # SAMME.R (removed upstream) used log-proba votes
        classes = np.asarray(owner.classes_)
        if classes.shape[0] < 2:
            return None
        members = []
        for est in owner.estimators_:
            if not np.array_equal(np.asarray(est.classes_), classes):
                return None  # a member trained on a class subset: its argmax
                # index would not line up with the ensemble's class axis
            inner = _inner_lift(est, ("predict_proba",), device)
            if inner is None:
                return None
            members.append(inner)
        return AdaBoostPredictor(
            members, owner.estimator_weights_[:len(members)], classes.shape[0],
            head="proba" if name == "predict_proba" else "decision")
    except Exception as exc:
        logger.info("AdaBoost lift failed structurally (%s); keeping the callable", exc)
        return None


def _affine_inverse(transformer) -> Optional[Tuple[float, float]]:
    """``(a, b)`` with ``inverse_transform(y) == a*y + b``, or None.  A
    ``TransformedTargetRegressor`` fits its transformer on
    ``y.reshape(-1, 1)``, so the fitted statistics are length-1 arrays."""

    name = type(transformer).__name__
    if name == "StandardScaler":
        a = float(transformer.scale_[0]) if transformer.with_std else 1.0
        b = float(transformer.mean_[0]) if transformer.with_mean else 0.0
        return a, b
    if name == "MinMaxScaler":
        # forward: y*scale_ + min_  ->  inverse: (y - min_) / scale_
        return 1.0 / float(transformer.scale_[0]), \
            -float(transformer.min_[0]) / float(transformer.scale_[0])
    if name == "MaxAbsScaler":
        # scale_ is the zero-handled max_abs_ (1.0 for an all-zero target)
        return float(transformer.scale_[0]), 0.0
    if name == "FunctionTransformer" and transformer.inverse_func is None:
        return 1.0, 0.0
    return None


def lift_transformed_target(method, device=None) -> Optional[BasePredictor]:
    """Lift ``TransformedTargetRegressor.predict`` when the target
    transformer's inverse is affine: ``predict = inverse(regressor_.predict)``.
    An identity-activation linear inner folds the head into its weights (the
    linear route is kept); other inners get an
    :class:`AffineOutputPredictor`; arbitrary ``inverse_func`` callables
    decline."""

    owner = getattr(method, "__self__", None)
    name = getattr(method, "__name__", "")
    if owner is None or type(owner).__name__ != "TransformedTargetRegressor" \
            or name != "predict":
        return None
    try:
        inner = _inner_lift(owner.regressor_, ("predict",), device)
        if inner is None:
            return None
        transformer = getattr(owner, "transformer_", None)
        ab = (1.0, 0.0) if transformer is None else _affine_inverse(transformer)
        if ab is None:
            return None
        a, b = ab
        from distributedkernelshap_tpu_torch.models.predictors import LinearPredictor

        if isinstance(inner, LinearPredictor) and inner.activation == "identity":
            return LinearPredictor(inner.W.cpu().numpy() * a, inner.b.cpu().numpy() * a + b,
                                   activation="identity", vector_out=inner.vector_out,
                                   device=inner.W.device)
        return AffineOutputPredictor(inner, a, b)
    except Exception as exc:
        logger.info("transformed-target lift failed structurally (%s); "
                    "keeping the callable", exc)
        return None


def lift_search_cv(method, device=None) -> Optional[BasePredictor]:
    """Lift fitted hyper-parameter searches (``GridSearchCV`` and friends)
    by delegating to ``best_estimator_``: the search routes ``predict*`` to
    the refit winner, so the winner's lift IS the search's lift."""

    owner = getattr(method, "__self__", None)
    name = getattr(method, "__name__", "")
    if owner is None or type(owner).__name__ not in (
            "GridSearchCV", "RandomizedSearchCV",
            "HalvingGridSearchCV", "HalvingRandomSearchCV"):
        return None
    if name not in ("predict", "predict_proba", "decision_function"):
        return None
    try:
        best = getattr(owner, "best_estimator_", None)
        if best is None:
            return None  # refit=False: the search cannot predict at all
        return _inner_lift(best, (name,), device)
    except Exception as exc:
        logger.info("search-cv lift failed structurally (%s); keeping the callable", exc)
        return None


def lift_calibrated(method, device=None) -> Optional[BasePredictor]:
    """Lift binary ``CalibratedClassifierCV.predict_proba``: per-fold base
    model + sigmoid/isotonic calibrator, averaged over folds."""

    owner = getattr(method, "__self__", None)
    name = getattr(method, "__name__", "")
    if owner is None or type(owner).__name__ != "CalibratedClassifierCV" \
            or name != "predict_proba":
        return None
    try:
        if len(owner.classes_) != 2:
            return None   # multiclass OvR normalisation not reproduced
        folds = []
        for cc in owner.calibrated_classifiers_:
            base = getattr(cc, "estimator", None)
            if base is None:  # pre-1.2 scikit-learn attribute; `or` would
                base = getattr(cc, "base_estimator", None)  # skip falsy bases
            inner = _inner_lift(base, ("decision_function", "predict_proba"), device)
            if inner is None or len(cc.calibrators) != 1:
                return None
            cal = cc.calibrators[0]
            cname = type(cal).__name__
            if cname == "_SigmoidCalibration":
                folds.append(CalibratedBinaryPredictor(inner, "sigmoid", (cal.a_, cal.b_)))
            elif cname == "IsotonicRegression":
                folds.append(CalibratedBinaryPredictor(
                    inner, "isotonic", (cal.X_thresholds_, cal.y_thresholds_)))
            else:
                return None
        if not folds:
            return None
        return folds[0] if len(folds) == 1 else MeanEnsemblePredictor(folds)
    except Exception as exc:
        logger.info("calibration lift failed structurally (%s); keeping the callable", exc)
        return None
