"""Public KernelShap explainer of the PyTorch port (sampled and exact paths).

Port of ``distributedkernelshap_tpu/kernel_shap.py``: the same public surface
(``KernelShap(predictor, link, feature_names, categorical_names, task,
seed).fit(background, ...).explain(X, ...) -> Explanation``, plus
``rank_by_importance`` / ``rank_interaction_pairs`` / ``sum_categories``
and the warn-and-degrade input validation), with the computation in
``ops/explain.py`` (sampled: the linear route, a predictor's
``masked_ey``, or row materialisation), ``ops/treeshap.py``
(``nsamples='exact'`` on lifted tree ensembles, with ``interactions=True``
the exact Shapley interaction matrices), ``ops/tensor_shap.py``
(``nsamples='exact'`` on tensor-train predictors) and
``attribution/deepshap.py`` (``nsamples='exact'`` on lifted neural graphs:
DeepSHAP multiplier backprop) on a torch device.  With
``EngineConfig(host_eval=True)`` a black-box predictor is evaluated on the
host (``_hosteval_stats``: the native OpenMP fill of ``runtime/`` and a
thread fan-out over coalition chunks) and only the WLS solve runs on the
device.

The sampled engine has the reference's host-side l1 feature selection
(``_lars_knots_batched``, ``_l1_select_batch``, ``_apply_l1_reg``,
``_l1_solve``), its single packed result copy (``_pack_fn``,
``ShapConfig.transfer_dtype``), the plan-constant cache
(``EngineConfig.plan_constant_cache``) and the device-side importance
reduction (``get_importance`` / ``KernelShap.rank_features``).

The serving entry points: ``EngineConfig.instance_chunk`` splits a large
batch into chunks dispatched through ``parallel/pipeline.run_pipeline`` in
a sliding window (``EngineConfig.dispatch_window``); ``stage_rows`` starts
a request's upload from pinned host memory on the engine's side CUDA
stream and ``get_explanation_async`` dispatches now and returns a
``finalize`` that another thread may run; ``anytime_begin(X).step()``
refines an explain round by round (``anytime/``); the engine's stages are
timed by ``profiling.profiler()`` phases; ``KernelShap.save`` / ``load``
checkpoint a fitted explainer.

Predictors come through ``models.as_predictor``: linear models, tree
ensembles and boosters, MLPs and torch stacks, SVMs, Gaussian quadratic
classifiers and scikit-learn compositions (pipelines, ensembles,
calibration, searches), each lifted onto the device and probed.  Lifted
ONNX graphs (``registry/onnx_lift.py``) and the MNIST CNN
(``models/cnn.py``) carry a ``graph_spec``, which the DeepSHAP flavour
reads; image explanations group pixels into superpixels (``ops/image.py``).

``KernelShap(..., distributed_opts={...})`` explains over a mesh of devices
(``parallel/distributed.DistributedExplainer``) driven from this process or
from several processes joined by ``parallel/mesh.initialize_multihost``.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``;
without a GPU and without a device they raise.  pandas is only touched when
the caller hands over a pandas object.
"""

import contextlib
import copy
import hashlib
import logging
import math
import os
import pickle
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from scipy import sparse

from distributedkernelshap_tpu_torch.anytime.convergence import calibrated_err, monotone_min
from distributedkernelshap_tpu_torch.anytime.engine import (
    AnytimeRun,
    RoundResult,
    build_anytime_consts_fn,
    build_round_fn,
)
from distributedkernelshap_tpu_torch.anytime.rounds import build_schedule, round_draw_mask
from distributedkernelshap_tpu_torch.attribution.deepshap import (
    build_deepshap_fn,
    deepshap_ready,
    supports_deepshap,
    validate_deepshap,
)
from distributedkernelshap_tpu_torch.data import Data, DenseData, DenseDataWithIndex
from distributedkernelshap_tpu_torch.interface import (
    DEFAULT_DATA_KERNEL_SHAP,
    DEFAULT_META_KERNEL_SHAP,
    Explainer,
    Explanation,
    FitMixin,
)
from distributedkernelshap_tpu_torch.models.predictors import BasePredictor, as_predictor
from distributedkernelshap_tpu_torch.observability.memledger import memledger
from distributedkernelshap_tpu_torch.ops.coalitions import coalition_plan, plan_fingerprint
from distributedkernelshap_tpu_torch.ops.explain import (
    ShapConfig,
    _auto_chunk,
    _wls_solve,
    build_explainer_fn,
    build_linear_cached_fn,
    build_linear_plan_consts_fn,
    capture_kernel_paths,
    fetch_transfer,
    groups_to_matrix,
    pack_transfer,
    plan_constants_variant,
    resolve_use_kernel,
    split_shap_values,
    unpack_transfer,
)
from distributedkernelshap_tpu_torch.ops.links import convert_to_link, convert_to_link_np
from distributedkernelshap_tpu_torch.ops.summarise import kmeans_summary, subsample
from distributedkernelshap_tpu_torch.ops.tensor_shap import (
    supports_exact_tn,
    tensor_shap_phi,
    tn_exact_ready,
    validate_exact_tn,
    weight_toeplitz,
)
from distributedkernelshap_tpu_torch.ops.treeshap import (
    background_reach,
    build_packed_plan,
    exact_shap_and_interactions,
    exact_shap_from_reach,
    exact_shap_packed,
    pack_reach,
    resolve_pack_paths,
    supports_exact,
    validate_exact,
)
from distributedkernelshap_tpu_torch.parallel.pipeline import resolve_window, run_pipeline
from distributedkernelshap_tpu_torch.profiling import profiler
from distributedkernelshap_tpu_torch.utils import methdispatch, resolve_device

logger = logging.getLogger(__name__)


def _plan_consts_owner(key) -> str:
    """Ledger owner for one ``_plan_consts_cache`` key (reference
    ``kernel_shap.py:61-76``): the cache holds linear plan consts
    (``(content_fp, plan_fp, chunk)`` tuples) next to the exact, tensor-
    network, DeepSHAP and anytime constants, whose keys lead with a string
    discriminator — route each to its own device-byte account so
    ``dks_device_bytes`` tells them apart."""

    if isinstance(key, tuple):
        for el in key:
            if el in ('exact_consts', 'exact_reach_full'):
                return 'exact_consts'
            if el in ('exact_tn_consts', 'deepshap_consts'):
                return el
            if el == 'anytime':
                return 'anytime_consts'
    return 'plan_consts'


# parameters recorded in explanation metadata (reference kernel_shap.py:23-31)
KERNEL_SHAP_PARAMS = [
    'link',
    'group_names',
    'groups',
    'weights',
    'summarise_background',
    'summarise_result',
    'kwargs',
]

KERNEL_SHAP_BACKGROUND_THRESHOLD = 300

# Distribution knobs (reference kernel_shap.py:371-385).  The unit of
# parallelism is a device in a mesh driven from this process; `n_cpus` is
# accepted as an alias so reference call sites run unchanged.
# `actor_cpu_fraction` > 1 (whole) maps to `coalition_parallel` — that many
# devices co-operate on one batch; fractions < 1 have no device analog and
# are ignored with a warning (parallel/distributed.py).
DISTRIBUTED_OPTS = {
    'n_devices': None,
    'batch_size': None,
    'actor_cpu_fraction': 1.0,
}


def _async_sync_fallback(explainer, X, nsamples, l1_reg, interactions):
    """The synchronous closure behind ``get_explanation_async``'s fallback
    routes (reference ``kernel_shap.py:92-110``): compute now on the calling
    thread, capture the per-call state eagerly (a later dispatch must not
    overwrite what this finalize returns), and hand back the ``finalize()
    -> (values, info)`` contract of the async path."""

    values = explainer.get_explanation(X, nsamples=nsamples, l1_reg=l1_reg,
                                       silent=True, interactions=interactions)
    info = {
        'raw_prediction': explainer.last_raw_prediction,
        'expected_value': np.atleast_1d(
            np.asarray(explainer.expected_value, dtype=np.float32)),
    }
    if interactions:
        info['interaction_values'] = explainer.last_interaction_values
    return lambda: (values, info)


def _on_stream(stream: Optional["torch.cuda.Stream"]):
    """Make ``stream`` the calling thread's current CUDA stream inside the
    block (nothing for ``None``: CPU work has no stream)."""

    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _fingerprint(X: np.ndarray):
    """Cheap identity for "same instances as the last explain call"."""

    X = np.ascontiguousarray(X)
    return (X.shape, str(X.dtype), hash(X.tobytes()))


def _sklearn_linear_model(route: str):
    """``sklearn.linear_model`` for an l1 ``route`` that needs it; where
    scikit-learn is not installed, an ``ImportError`` naming the route."""

    try:
        from sklearn import linear_model
    except ImportError as e:
        raise ImportError(
            f"{route} needs scikit-learn, which is not installed; l1_reg "
            "'auto', 'aic', 'bic' and 'num_features(k)' need nothing beyond "
            "numpy on well-posed designs") from e
    return linear_model


def _lars_knots_batched(G: np.ndarray, XtY: np.ndarray, max_steps: int,
                        lasso: bool) -> np.ndarray:
    """Coefficient knots of LARS (``lasso=False``) / lasso-LARS
    (``lasso=True``) regularisation paths for ``T`` targets sharing ONE
    Gram matrix, vectorized over the target axis.

    Returns ``(n_knots, p, T)`` float64 — knot 0 is the all-zero start,
    knot ``k`` the coefficients after the ``k``-th path step, exactly the
    per-target output of sklearn's ``lars_path_gram(Xy=XtY[:, t], Gram=G)``
    stacked over ``t``.  A copy of the reference's
    ``kernel_shap.py:121-262``, numpy only.

    Why not sklearn per target: the reference's surfaced ``l1_reg`` knob
    runs one selection per (instance, output) — B*K ≈ 10k targets for the
    headline task — and per-fit Python overhead dominated the wall clock
    the wall clock of the explain it decorates.  All
    targets share the design, so each path step here is a handful of
    batched O(T·p²) numpy ops + one batched ``(T, p, p)`` LAPACK solve;
    target count stops mattering.  Per step and target: the entering
    variable is the max-|correlation| inactive one, the direction solves
    ``G_AA w = sign_A`` (masked solve: inactive rows/cols replaced by
    identity so ``w`` is exactly 0 off the active set — which is what
    makes ``np.nonzero`` selection semantics survive batching), the step
    size is Efron's min-positive candidate, and the lasso variant drops a
    variable whose coefficient would cross zero mid-step.  Finished
    targets (residual correlation ~0) freeze and replay their final knot,
    which leaves the downstream criterion argmin unchanged.

    Returns ``(knots, ok)`` where ``ok`` is a ``(T,)`` bool mask: False
    marks targets whose path hit a degenerate active-set Gram (exactly or
    nearly collinear coalition columns — one target must not crash or
    silently corrupt the other ~10k) or did not converge within the step
    cap.  Such targets freeze immediately; the caller routes them through
    sklearn's per-target path, which carries its own degeneracy handling.
    """

    p, T = XtY.shape
    beta = np.zeros((p, T))
    active = np.zeros((p, T), bool)
    sign = np.zeros((p, T))
    done = np.zeros(T, bool)
    degenerate = np.zeros(T, bool)
    converged = np.zeros(T, bool)
    drop_flag = np.zeros(T, bool)
    knots = [beta.copy()]
    tiny = np.finfo(np.float64).tiny
    diag = np.arange(p)
    scale = np.maximum(1.0, np.abs(XtY).max(axis=0))
    idx = np.arange(T)
    for _ in range(max_steps):
        c = XtY - G @ beta                       # (p, T) residual correlations
        camp = np.abs(c)
        C = camp.max(axis=0)                     # (T,)
        converged |= (~degenerate) & (C < 1e-10 * scale)
        done |= converged
        if done.all():
            break
        # entering variable (skipped right after a lasso drop, per Efron)
        camp_inact = np.where(active, -np.inf, camp)
        j_star = camp_inact.argmax(axis=0)
        can_add = (~done) & (~drop_flag) & ~active.all(axis=0)
        active[j_star[can_add], idx[can_add]] = True
        sign[j_star[can_add], idx[can_add]] = np.sign(
            c[j_star[can_add], idx[can_add]])
        drop_flag[:] = False
        # equiangular direction: masked batched solve of G_AA w = sign_A
        MT = active.T                            # (T, p)
        M = np.where(MT[:, :, None] & MT[:, None, :], G[None, :, :], 0.0)
        M[:, diag, diag] = np.where(MT, G[diag, diag][None, :], 1.0)
        try:
            w = np.linalg.solve(M, sign.T[:, :, None])[:, :, 0].T  # (p, T)
        except np.linalg.LinAlgError:
            # the batched solve raises if ANY target's G_AA is exactly
            # singular (collinear coalition columns).  Exceptional path:
            # identify the offenders individually so one degenerate target
            # does not take down the other ~10k.
            w = np.zeros((p, T))
            for t in range(T):
                try:
                    w[:, t] = np.linalg.solve(M[t], sign[:, t])
                except np.linalg.LinAlgError:
                    degenerate[t] = True
            done |= degenerate
        denom = np.einsum('pt,pt->t', w, sign)
        # near-singular signature (sklearn warns + falls back on its
        # cholesky pivot): a non-positive w·sign would overflow AA and
        # silently corrupt the target's path — flag and freeze instead
        bad = (~done) & ((denom <= tiny) | ~np.isfinite(w).all(axis=0))
        if bad.any():
            degenerate |= bad
            done |= bad
        AA = 1.0 / np.sqrt(np.maximum(denom, tiny))
        w = np.where(done[None, :], 0.0, w * AA[None, :])
        a = G @ w                                # (p, T)
        with np.errstate(divide='ignore', invalid='ignore'):
            g1 = (C[None, :] - c) / (AA[None, :] - a)
            g2 = (C[None, :] + c) / (AA[None, :] + a)

        def _min_pos(x):
            x = np.where(~active & np.isfinite(x) & (x > tiny), x, np.inf)
            return x.min(axis=0)

        gamma = np.minimum(_min_pos(g1), _min_pos(g2))
        # no (valid) inactive candidate -> the full step to zero residual
        # correlation; also a numerical safety cap
        gamma = np.minimum(gamma, C / AA)
        # zero-crossing check runs in BOTH modes (sklearn: a crossing sets
        # `drop`, which skips the next iteration's add; lasso additionally
        # truncates the step at the crossing and evicts the variable, while
        # plain LARS keeps stepping but flips the crossing sign)
        with np.errstate(divide='ignore', invalid='ignore'):
            z = -beta / w
        z = np.where(active & (np.abs(w) > tiny) & (z > tiny), z, np.inf)
        z_pos = z.min(axis=0)
        hit = (~done) & (z_pos < gamma)
        if lasso:
            gamma = np.where(hit, z_pos, gamma)
        gamma = np.where(done, 0.0, gamma)
        beta = beta + gamma[None, :] * w
        crossing = hit[None, :] & (z <= z_pos[None, :])
        if lasso:
            beta = np.where(crossing, 0.0, beta)
            active &= ~crossing
            sign = np.where(crossing, 0.0, sign)
        else:
            sign = np.where(crossing, -sign, sign)
        drop_flag = hit
        knots.append(beta.copy())
    else:
        # step cap hit with unfinished targets: their truncated paths must
        # not silently masquerade as full sklearn semantics
        converged |= (~degenerate) & (np.abs(XtY - G @ beta).max(axis=0)
                                      < 1e-10 * scale)
    ok = ~degenerate & np.isfinite(knots[-1]).all(axis=0)
    if lasso:
        # full-path semantics (aic/bic): an unconverged path is a silent
        # truncation.  The 'lar' mode stops at max_steps BY DESIGN
        # (num_features(k)), so truncation is the contract there.
        ok &= converged
    return np.stack(knots), ok


def _l1_select_batch(Xw, Yw, l1_reg) -> List[np.ndarray]:
    """Feature-selection index sets for every column of ``Yw`` against the
    shared weighted design ``Xw`` (``(S, p)``; p = n_groups - 1).

    The selection semantics per target match the reference's surfaced shap
    0.35 knob (``explainers/kernel_shap.py:840-845``): ``'num_features(k)'``
    = a k-step LARS path, ``'aic'``/``'bic'`` = ``LassoLarsIC``, a float =
    ``Lasso(alpha)``.  Because the design is identical for all ``B*K``
    targets, the expensive parts are shared instead of re-done per fit
    (a copy of the reference's ``kernel_shap.py:263-371``):

    * ``Lasso``: one multi-target coordinate-descent fit (sklearn fits each
      column of a 2-D target independently — identical results);
    * LARS paths: the Gram matrix and every ``X^T y`` are precomputed (one
      BLAS call for all targets) and the path runs in Gram space
      (``lars_path_gram``), so each target pays O(p^3) instead of O(S·p)
      per step plus sklearn's per-fit validation/centering/copy overhead;
    * the AIC/BIC criterion replicates sklearn 1.9's ``LassoLarsIC``
      (centering, lasso-LARS path, OLS noise variance ``RSS/(S-p-1)``,
      ``S·log(2πσ²) + RSS/σ² + c·df``) with the pseudo-inverse behind the
      noise variance computed once and RSS evaluated through the quadratic
      form ``y'y - 2c·X'y + c'Gc`` rather than per-step residual vectors.

    The LARS routes (``'num_features(k)'``, ``'aic'``, ``'bic'``) are numpy
    only.  scikit-learn is imported only by the float route and by the
    per-target fallback of a degenerate target, which raise a named
    ``ImportError`` where it is not installed.
    """

    S, p = Xw.shape
    T = Yw.shape[1]

    if isinstance(l1_reg, (int, float)):
        # NB: includes bools — `_l1_active` classifies True as active and the
        # pre-batching implementation ran Lasso(alpha=1.0) for it
        Lasso = _sklearn_linear_model(f"l1_reg={l1_reg!r} (Lasso)").Lasso
        coef = np.atleast_2d(Lasso(alpha=float(l1_reg)).fit(Xw, Yw).coef_)
        return [np.nonzero(coef[t])[0] for t in range(T)]

    if isinstance(l1_reg, str) and l1_reg.startswith('num_features('):
        nfeat = int(l1_reg[len('num_features('):-1])
        G = Xw.T @ Xw
        XtY = Xw.T @ Yw
        knots, ok = _lars_knots_batched(G, XtY, max_steps=nfeat, lasso=False)
        last = knots[-1]                                    # (p, T)
        sels = [None] * T
        for t in range(T):
            if ok[t]:
                sels[t] = np.nonzero(last[:, t])[0]
            else:
                # degenerate design for this target: sklearn's per-target
                # path carries its own collinearity handling (warn + drop)
                logger.warning("l1_reg num_features: degenerate design for "
                               "target %d; using sklearn per-target path", t)
                lars_path_gram = _sklearn_linear_model(
                    f"l1_reg={l1_reg!r}'s degenerate-target fallback "
                    "(lars_path_gram)").lars_path_gram
                _, _, coefs = lars_path_gram(Xy=XtY[:, t], Gram=G,
                                             n_samples=S, max_iter=nfeat)
                sels[t] = np.nonzero(coefs[:, -1])[0]
        return sels

    if isinstance(l1_reg, str) and l1_reg in ('aic', 'bic'):
        if S <= p + 1:
            raise ValueError(
                "aic/bic feature selection needs more coalition rows than "
                f"features for the noise-variance estimate: {S} rows, {p} features")
        Xc = Xw - Xw.mean(axis=0)
        Yc = Yw - Yw.mean(axis=0)
        G = Xc.T @ Xc
        XtY = Xc.T @ Yc                                     # (p, T)
        yty = np.einsum('st,st->t', Yc, Yc)
        C_ols = np.linalg.pinv(Xc) @ Yc
        rss_ols = yty - 2 * np.einsum('pt,pt->t', XtY, C_ols) \
            + np.einsum('pt,pt->t', C_ols, G @ C_ols)
        sigma2 = np.maximum(rss_ols / (S - p - 1), np.finfo(np.float64).tiny)
        factor = 2.0 if l1_reg == 'aic' else np.log(S)
        # full lasso paths for ALL targets in one batched sweep (a lasso
        # path can exceed p steps via drop/re-entry; 8p+16 is far beyond
        # observed path lengths, and finished targets freeze early)
        knots, ok = _lars_knots_batched(G, XtY, max_steps=8 * p + 16,
                                        lasso=True)
        Gk = np.einsum('pq,kqt->kpt', G, knots)
        rss = yty[None, :] - 2 * np.einsum('kpt,pt->kt', knots, XtY) \
            + np.einsum('kpt,kpt->kt', knots, Gk)           # (n_knots, T)
        df = (np.abs(knots) > np.finfo(knots.dtype).eps).sum(axis=1)
        crit = S * np.log(2 * np.pi * sigma2)[None, :] \
            + rss / sigma2[None, :] + factor * df
        best = crit.argmin(axis=0)                          # (T,)
        sels = [None] * T
        for t in range(T):
            if ok[t]:
                sels[t] = np.nonzero(knots[best[t], :, t])[0]
            else:
                # degenerate or unconverged path for this target: sklearn's
                # per-target machinery handles
                # collinearity with its own warn-and-continue semantics
                logger.warning("l1_reg %s: degenerate/unconverged path for "
                               "target %d; using sklearn per-target path",
                               l1_reg, t)
                lars_path_gram = _sklearn_linear_model(
                    f"l1_reg={l1_reg!r}'s degenerate-target fallback "
                    "(lars_path_gram)").lars_path_gram
                _, _, coefs = lars_path_gram(Xy=XtY[:, t], Gram=G,
                                             n_samples=S, method='lasso',
                                             alpha_min=0.0)
                rss_t = yty[t] - 2 * XtY[:, t] @ coefs \
                    + np.einsum('ps,ps->s', coefs, G @ coefs)
                df_t = (np.abs(coefs)
                        > np.finfo(coefs.dtype).eps).sum(axis=0)
                crit_t = S * np.log(2 * np.pi * sigma2[t]) \
                    + rss_t / sigma2[t] + factor * df_t
                sels[t] = np.nonzero(coefs[:, np.argmin(crit_t)])[0]
        return sels

    raise ValueError(f"Unsupported l1_reg value: {l1_reg!r}")


def _is_pandas(obj, kind: str) -> bool:
    """Whether ``obj`` is a pandas ``kind`` ('DataFrame' | 'Series'), without
    importing pandas unless the object came from it."""

    if not type(obj).__module__.startswith("pandas"):
        return False
    import pandas as pd

    return isinstance(obj, getattr(pd, kind))


def rank_by_importance(shap_values: List[np.ndarray],
                       feature_names: Union[List[str], Tuple[str], None] = None) -> Dict:
    """Rank features by mean |SHAP| per class and aggregated over classes
    (reference ``kernel_shap.py:36-109``)."""

    if len(shap_values[0].shape) == 1:
        shap_values = [np.atleast_2d(arr) for arr in shap_values]

    imp = np.stack([np.abs(values).mean(axis=0) for values in shap_values])
    return ranking_from_importance(
        imp, _resolve_feature_names(feature_names, imp.shape[1]))


def rank_interaction_pairs(interaction_values: List[np.ndarray],
                           feature_names: Union[List[str], Tuple[str], None] = None,
                           top: Optional[int] = None) -> Dict:
    """Rank feature PAIRS by mean |interaction| — the pairwise analog of
    :func:`rank_by_importance` for the exact interaction matrices
    (``explain(..., nsamples='exact', interactions=True)``; reference
    ``kernel_shap.py:467-508``).

    ``interaction_values``: list of ``K`` ``(B, M, M)`` arrays (shap
    TreeExplainer convention — symmetric, off-diagonal ``[i, j]`` holds
    half the pairwise index, so a pair's total effect is ``2 * |[i, j]|``).
    Returns the reference-style structure ``{'0': {'ranked_effect',
    'names'}, ..., 'aggregated': {...}}`` where each name is an ``(i, j)``
    feature-name tuple, sorted most- to least-interacting; ``top`` keeps
    only the strongest pairs."""

    def batched(values: np.ndarray) -> np.ndarray:
        vals = np.asarray(values)
        return vals[None] if vals.ndim == 2 else vals   # single instance

    M = batched(interaction_values[0]).shape[-1]
    if not feature_names or len(feature_names) != M:
        if feature_names:
            logger.warning(
                "Feature names do not match the interaction matrices: got "
                "%d names for %d features; falling back to default names.",
                len(feature_names), M)
        feature_names = [f'feature_{i}' for i in range(M)]
    iu, ju = np.triu_indices(M, k=1)
    pair_names = [(feature_names[i], feature_names[j]) for i, j in zip(iu, ju)]

    # a pair's total effect is its two symmetric halves -> 2x one entry
    pair_values = [2.0 * batched(v)[:, iu, ju] for v in interaction_values]
    importances = rank_by_importance(pair_values, pair_names)
    if top is not None:
        for entry in importances.values():
            entry['ranked_effect'] = entry['ranked_effect'][:top]
            entry['names'] = entry['names'][:top]
    return importances


def _resolve_feature_names(feature_names, n_feats: int) -> List[str]:
    """Default names when missing, warn-and-default on a length mismatch."""

    if not feature_names:
        return [f'feature_{i}' for i in range(n_feats)]
    if len(feature_names) != n_feats:
        logger.warning(
            "Feature names do not match the number of shap values: got %d names "
            "for %d estimated values; falling back to default names.",
            len(feature_names), n_feats,
        )
        return [f'feature_{i}' for i in range(n_feats)]
    return list(feature_names)


def ranking_from_importance(importance: np.ndarray,
                            feature_names: Sequence[str]) -> Dict:
    """:func:`rank_by_importance`'s output structure from a ``(K, M)``
    mean-|SHAP| matrix."""

    importances: Dict[str, Dict[str, Any]] = {}
    for class_idx, avg_mag in enumerate(np.asarray(importance)):
        order = np.argsort(avg_mag)[::-1]
        importances[str(class_idx)] = {
            'ranked_effect': avg_mag[order],
            'names': [feature_names[i] for i in order],
        }

    combined = np.asarray(importance).sum(axis=0)
    order = np.argsort(combined)[::-1]
    importances['aggregated'] = {
        'ranked_effect': combined[order],
        'names': [feature_names[i] for i in order],
    }
    return importances


def _summing_matrix(start_idx: Sequence[int], enc_feat_dim: Sequence[int],
                    n_cols: int) -> np.ndarray:
    """The ``(n_cols, n_out)`` 0/1 matrix that sums encoded-categorical column
    blocks and passes the remaining columns through unchanged."""

    block_at = dict(zip(start_idx, enc_feat_dim))
    seg = np.empty(n_cols, dtype=np.int64)
    col, out = 0, 0
    while col < n_cols:
        width = block_at.get(col, 1)
        seg[col:col + width] = out
        col += width
        out += 1
    S = np.zeros((n_cols, out), dtype=np.float64)
    S[np.arange(n_cols), seg] = 1.0
    return S


def sum_categories(values: np.ndarray, start_idx: Sequence[int], enc_feat_dim: Sequence[int]):
    """Reduce one-hot-encoded categorical slices to one value per variable
    (reference ``kernel_shap.py:112-207``), as one matmul against a summing
    matrix."""

    if start_idx is None or enc_feat_dim is None:
        raise ValueError("Both the start indices and the encoding dimensions must be specified!")
    if not len(enc_feat_dim) == len(start_idx):
        raise ValueError("The lengths of the start indices and encodings sequences must be equal!")
    if sum(enc_feat_dim) > values.shape[-1]:
        raise ValueError("The sum of the encoded features dimensions exceeds the data dimension!")
    if len(values.shape) not in (2, 3):
        raise ValueError(
            f"Shap value summarisation requires a rank-2 (shap values) or rank-3 "
            f"(interaction values) tensor; got shape {values.shape}!"
        )
    for s, d in zip(start_idx, enc_feat_dim):
        if s + d > values.shape[-1]:
            raise ValueError(f"Block at {s} with width {d} exceeds dimension {values.shape[-1]}")

    S = _summing_matrix(start_idx, enc_feat_dim, values.shape[-1])
    if values.ndim == 2:
        return values @ S
    return np.einsum('bij,ik,jl->bkl', values, S, S)


@dataclass
class StagedRows:
    """A request batch whose host-to-device upload is already in flight
    (reference ``kernel_shap.py:543-563``).

    Made by :meth:`KernelExplainerEngine.stage_rows`: ``host`` is the
    original ``(B, D)`` float32 rows (a sync fallback reads them),
    ``device`` the bucket-padded copy on the engine's device, ``B`` the
    unpadded row count.  On CUDA the copy runs from the pinned host buffer
    ``pinned`` on the engine's side stream and ``ready`` is the event
    recorded after it: the consuming stream waits on it before reading
    ``device`` (``_staged_input``).  On the CPU ``device`` is a plain tensor
    and both are ``None``.  Single-use: a StagedRows feeds exactly one
    explain."""

    host: np.ndarray
    device: Any
    B: int
    ready: Optional[Any] = None
    pinned: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return self.host.shape


@dataclass
class EngineConfig:
    """Static configuration of a single-device explain engine."""

    link: str = 'identity'
    seed: Optional[int] = None
    shap: ShapConfig = field(default_factory=ShapConfig)
    # split batches larger than this into chunks dispatched through
    # parallel/pipeline.run_pipeline (None = no split): bounds the device
    # memory an explain holds at once
    instance_chunk: Optional[int] = None
    # in-flight bound of the instance-chunk dispatch/fetch pipeline (None =
    # parallel/pipeline.resolve_window: DKS_DISPATCH_WINDOW, else a live
    # round-trip probe, 2 on a locally attached card)
    dispatch_window: Optional[int] = None
    # pad batch sizes up to a bounded ladder of shapes (as the reference,
    # which bounds jit retraces; here it keeps the kernel's shapes stable)
    bucket_batches: bool = True
    # torch device of the engine: None = the current CUDA device, raising
    # when there is none
    device: Optional[Union[str, torch.device]] = None
    # plan-constant cache of the linear path (reference kernel_shap.py:
    # 586-599): keep what depends only on (model, background, plan) on the
    # device — the masked-background logits, E[f] and the factorised WLS
    # Gram matrix — keyed by content fingerprints, so a request pays only
    # its B×S×K work and a triangular solve.  None/True: the cached path
    # (where it applies: a linear predictor, and fused_linear_ey not
    # engaged unless the activation is the identity); False: the same path
    # with the constants recomputed every call (the control arm, phi
    # bit-identical to the cached arm); 'off': the classic explain function
    plan_constant_cache: Optional[Union[bool, str]] = None
    # evaluate the predictor on the host instead of on the device (reference
    # kernel_shap.py:577-580): the WLS solve stays on the device either way.
    # None resolves to False, as the reference resolves it on a backend that
    # supports host callbacks (a CUDA device: CallbackPredictor copies its
    # rows to the host per coalition chunk); only True takes the host path
    host_eval: Optional[bool] = None
    # host-eval chunk fan-out across host cores (None = the host's core
    # count; reference kernel_shap.py:600-613).  The callable IS invoked
    # from this many threads at once, so set 1 for predictors that are not
    # reentrant; each chunk writes a disjoint slice of the output.  An
    # explicit shap.coalition_chunk bypasses the memory budget, so peak host
    # memory is then workers × chunk × B × N × D floats
    host_eval_workers: Optional[int] = None


class KernelExplainerEngine:
    """Single-device KernelSHAP engine: owns the background data, the
    predictor on the device and the explain function; exposes
    ``expected_value`` / ``vector_out`` and accepts ``(batch_idx, batch)``
    work items (reference ``kernel_shap.py:217-254``)."""

    def __init__(self,
                 predictor: Union[Callable, BasePredictor],
                 data: Any,
                 link: Optional[str] = None,
                 seed: Optional[int] = None,
                 config: Optional[EngineConfig] = None):
        base = config or EngineConfig()
        self.config = replace(
            base,
            link=link if link is not None else base.link,
            seed=seed if seed is not None else base.seed,
        )
        self.device = resolve_device(self.config.device)

        bg, groups, group_names, weights = self._unpack_data(data)
        self.background = np.asarray(bg, dtype=np.float32)
        self.groups = groups
        self.group_names = group_names
        self.bg_weights = (np.ones(self.background.shape[0], dtype=np.float32)
                           if weights is None else np.asarray(weights, dtype=np.float32))

        self.n_columns = self.background.shape[1]
        self.predictor = as_predictor(predictor, example_dim=self.n_columns,
                                      probe_data=self.background, device=self.device)
        self.vector_out = self.predictor.vector_out
        self.G = groups_to_matrix(groups, self.n_columns)
        self.M = self.G.shape[0]

        self._plan_cache: Dict[Any, Any] = {}
        self._fn_cache: Dict[Any, Any] = {}
        # device-resident per-plan constants, keyed by content fingerprint;
        # OrderedDict = LRU, entry-bounded.  Both caches are ledger-tracked
        # (reference kernel_shap.py:664-679): every insert/evict charges or
        # releases computed nbytes against the process memory ledger
        # (dks_device_bytes{owner,model}); under memory pressure the ledger
        # LRU-shrinks them — only ever forcing a re-upload.
        _ledger = memledger()
        _ledger.note_device(self.device)
        self._dev_cache: "OrderedDict[str, Tuple[torch.Tensor, ...]]" = \
            _ledger.tracked_cache("dev_cache")
        # plan-constant cache: linear plan consts next to the exact tree,
        # tensor-network, DeepSHAP and anytime constants under distinct key
        # shapes, routed to per-owner ledger accounts
        self._plan_consts_cache: "OrderedDict[Any, Dict[str, Any]]" = \
            _ledger.tracked_cache("plan_consts", owner_for_key=_plan_consts_owner)
        self._content_fp: Optional[str] = None
        # _exact_async_ready's memo (host state fixed once fitted)
        self._ready_cache: Dict[bool, bool] = {}
        # the side stream stage_rows uploads on (CUDA only, made on first use)
        self._stage_stream: Optional[torch.cuda.Stream] = None
        self._stage_lock = threading.Lock()
        #: the window the last chunked explain resolved (``dispatch_window``)
        self.last_dispatch_window: Optional[int] = None
        self.last_raw_prediction: Optional[np.ndarray] = None
        #: the last explain's exact interaction matrices (``interactions=True``):
        #: a list of K ``(B, M, M)`` arrays; None after any other explain
        self.last_interaction_values: Optional[List[np.ndarray]] = None
        #: which evaluation route each explain took ({'ey': 'cuda'|'plain'|
        #: 'einsum'|'einsum_cached'|'masked_ey'|'generic'|'host',
        #: 'host_fill': 'native'|'numpy', 'exact_phi'/'exact_inter':
        #: 'cuda'|'plain'}), persisted across explains; server threads
        #: explain concurrently, so it is read and written under its lock
        self._kernel_paths: Dict[str, str] = {}
        self._kernel_paths_lock = threading.Lock()

        # host_eval=None resolves to False: a CUDA device (and the CPU)
        # serve CallbackPredictor's host round trips, as the reference's
        # gpu backend serves its callbacks
        if self.config.host_eval is None:
            self.config = replace(self.config, host_eval=False)
        if self.config.host_eval:
            logger.info("Using host-side predictor evaluation (the device keeps "
                        "the WLS solve); device=%s", self.device)

        # expected value: link-space weighted mean background prediction
        if self.config.host_eval:
            bgw = self.bg_weights / self.bg_weights.sum()
            out_bg = self.predictor.host_fn(self.background)
            e_out = convert_to_link_np(self.config.link)(
                np.einsum('nk,n->k', out_bg, bgw)).astype(np.float32)
        else:
            bgw = torch.as_tensor(self.bg_weights / self.bg_weights.sum(), device=self.device)
            with torch.no_grad():
                out_bg = self.predictor(torch.as_tensor(self.background, device=self.device))
                e_out = convert_to_link(self.config.link)(torch.einsum('nk,n->k', out_bg, bgw))
            e_out = e_out.cpu().numpy()
        self.expected_value = e_out if self.vector_out else float(e_out[0])

    @staticmethod
    def _unpack_data(data):
        if isinstance(data, Data):
            return data.data, data.groups, data.group_names, data.weights
        if _is_pandas(data, 'DataFrame'):
            return data.values, None, list(data.columns), None
        if _is_pandas(data, 'Series'):
            return data.values.reshape(1, -1), None, list(data.index), None
        if sparse.issparse(data):
            return data.toarray(), None, None, None
        return np.atleast_2d(np.asarray(data)), None, None, None

    # ------------------------------------------------------------------ #

    def _plan(self, nsamples):
        key = ('auto' if nsamples in (None, 'auto') else int(nsamples))
        if key not in self._plan_cache:
            n = None if key == 'auto' else key
            self._plan_cache[key] = coalition_plan(
                self.M, nsamples=n, seed=self.config.seed or 0)
        return self._plan_cache[key]

    def _fn(self, with_ey: bool = False):
        if with_ey not in self._fn_cache:
            self._fn_cache[with_ey] = build_explainer_fn(
                self.predictor,
                replace(self.config.shap, link=self.config.link),
                with_ey=with_ey)
        return self._fn_cache[with_ey]

    @staticmethod
    def _bucket(n: int) -> int:
        """Pad batch sizes to a bounded set of shapes: powers of two up to
        512, then multiples of 512."""

        if n <= 1:
            return 1
        if n <= 512:
            return 1 << math.ceil(math.log2(n))
        return 512 * math.ceil(n / 512)

    def _pad_to_bucket(self, X: np.ndarray):
        """``(X_padded, B)``: pad ``X`` up to its bucket by tiling the last
        row (results are sliced back to ``B`` by the caller)."""

        B = X.shape[0]
        pad = (self._bucket(B) - B) if self.config.bucket_batches else 0
        Xp = np.concatenate([X, np.tile(X[-1:], (pad, 1))], 0) if pad else X
        return Xp, B

    @property
    def kernel_path(self) -> Dict[str, Any]:
        """Which evaluation route the explains took: ``{'ey': 'cuda'}`` when
        the fused kernel launched, ``'plain'`` for its plain version,
        ``'einsum'`` for the identity collapse, ``'einsum_cached'`` for the
        plan-constant path, ``'masked_ey'`` for a predictor's structure-aware
        evaluation, ``'generic'`` for row materialisation and ``'host'`` for
        host evaluation (with ``'host_fill'``: ``'native'`` or ``'numpy'``);
        ``'exact_phi'`` and ``'exact_inter'`` likewise for the exact
        TreeSHAP and interaction kernels.  Empty until the first explain."""

        with self._kernel_paths_lock:
            return dict(self._kernel_paths)

    def _note_kernel_paths(self, paths: Dict[str, str]) -> None:
        """Record the routes an explain took (see :attr:`kernel_path`)."""

        with self._kernel_paths_lock:
            self._kernel_paths.update(paths)

    def reset_device_state(self) -> None:
        """Drop the device-resident caches (explain functions, uploaded
        constants, plan constants, exact-path constants) so the next explain
        rebuilds them from host state (reference ``kernel_shap.py:922-934``).
        The coalition plans survive: they are host numpy."""

        self._fn_cache.clear()
        self._dev_cache.clear()
        self._plan_consts_cache.clear()

    #: bound on the device-constant caches' entries (plans in play per
    #: engine: 'auto' and a few explicit nsamples values)
    _DEV_CACHE_MAX_ENTRIES = 8

    def _device_args(self, plan):
        """Device copies of the per-fit constants, uploaded once per plan
        and kept in an LRU of ``_DEV_CACHE_MAX_ENTRIES``, keyed by the
        plan's content fingerprint (reference ``kernel_shap.py:949-976``)."""

        key = plan_fingerprint(plan)
        if key not in self._dev_cache:
            self._dev_cache[key] = tuple(
                torch.as_tensor(np.asarray(a, dtype=np.float32), device=self.device)
                for a in (self.background, self.bg_weights, plan.mask,
                          plan.weights, self.G))
            while len(self._dev_cache) > self._DEV_CACHE_MAX_ENTRIES:
                self._dev_cache.popitem(last=False)
        else:
            self._dev_cache.move_to_end(key)
        return self._dev_cache[key]

    # ------------------------------------------------------------------ #
    # plan-constant device cache (linear path)

    def content_fingerprint(self) -> str:
        """sha256 over the linear decomposition (else the predictor's
        published content bytes, ``fingerprint_bytes()``, else its type),
        the background rows and weights, the group matrix, the link and the
        ridge (reference ``kernel_shap.py:978-1015``).  It keys the
        plan-constant cache, the exact paths' constants with it; a refit
        builds a new engine, and changing a predictor in place is not
        detected."""

        if self._content_fp is None:
            h = hashlib.sha256()
            linear = self.predictor.linear_decomposition
            fp_bytes = getattr(self.predictor, 'fingerprint_bytes', None)
            # equal content bytes ARE the same device constants; None means
            # no content identity, and the type's repr stands in
            content = fp_bytes() if callable(fp_bytes) else None
            if linear is not None:
                W, b, activation = linear
                h.update(W.detach().cpu().numpy().tobytes())
                h.update(b.detach().cpu().numpy().tobytes())
                h.update(activation.encode())
            elif content is not None:
                h.update(content)
            else:
                h.update(repr(type(self.predictor)).encode())
            h.update(self.background.tobytes())
            h.update(self.bg_weights.tobytes())
            h.update(self.G.tobytes())
            h.update(self.config.link.encode())
            h.update(repr(self.config.shap.ridge).encode())
            self._content_fp = h.hexdigest()
        return self._content_fp

    def _plan_consts_enabled(self) -> bool:
        """Whether the plan-constant path applies (reference
        ``kernel_shap.py:1017-1035``): a linear predictor, the knob not
        ``'off'``, and ``fused_linear_ey`` not engaged unless the activation
        is the identity (the kernel takes the raw background tensors, so
        there is nothing to hoist).  ``False`` keeps the path on with the
        constants recomputed every call."""

        if self.config.plan_constant_cache == 'off' or self.config.host_eval:
            return False
        linear = self.predictor.linear_decomposition
        if linear is None:
            return False
        if resolve_use_kernel(self.config.shap.use_kernel, self.device) \
                and linear[2] != 'identity':
            return False
        return True

    def _plan_consts(self, plan, chunk: int):
        """The device constants of (model, background, ``plan``) at
        coalition chunk ``chunk``, served from an LRU of
        ``_DEV_CACHE_MAX_ENTRIES`` keyed by content fingerprints (reference
        ``kernel_shap.py:1037-1068``); with ``plan_constant_cache=False``
        recomputed every call and never stored."""

        fnkey = ('plan_consts', chunk)
        if fnkey not in self._fn_cache:
            self._fn_cache[fnkey] = build_linear_plan_consts_fn(
                self.predictor, replace(self.config.shap, link=self.config.link), chunk)

        def build():
            with profiler().phase('plan_consts'):
                return self._fn_cache[fnkey](*self._device_args(plan))

        return self._shared_consts(
            (self.content_fingerprint(), plan_fingerprint(plan), chunk), build)

    def _shared_consts(self, key, build: Callable[[], Any]):
        """``build()``'s device constants under ``key`` in the plan-constant
        LRU of ``_DEV_CACHE_MAX_ENTRIES`` shared by the linear, exact tree
        and tensor-network paths; with ``plan_constant_cache=False`` built
        anew every call and never stored (the control arm)."""

        reuse = self.config.plan_constant_cache is not False
        if reuse and key in self._plan_consts_cache:
            self._plan_consts_cache.move_to_end(key)
            return self._plan_consts_cache[key]
        consts = build()
        if reuse:
            self._plan_consts_cache[key] = consts
            while len(self._plan_consts_cache) > self._DEV_CACHE_MAX_ENTRIES:
                self._plan_consts_cache.popitem(last=False)
        return consts

    def _linear_fast_call(self, Xp: np.ndarray, plan, packed_dtype):
        """Run the bucket-padded ``Xp`` through the plan-constant path and
        return the packed result (:func:`pack_transfer` at
        ``packed_dtype``), or ``None`` where the path does not apply: then
        the caller runs the classic function and :meth:`_pack_fn`
        (reference ``kernel_shap.py:1070-1137``).

        The footprint gate: the cached ``(padded S, N[, K])`` background
        logits must themselves fit the chunk budget, or holding them costs
        more memory than the per-call products save."""

        if not self._plan_consts_enabled():
            return None
        cfg = self.config.shap
        K = self.predictor.n_outputs
        N = self.background.shape[0]
        S = plan.n_rows
        # the chunk policy of the classic function at this padded batch
        chunk = cfg.coalition_chunk or _auto_chunk(
            S, Xp.shape[0] * N * K, cfg.target_chunk_elems)
        variant = plan_constants_variant(self.predictor.linear_decomposition[2], int(K))
        if variant != 'identity':
            c = min(S, 2 * chunk) if variant == 'binary' else chunk
            elems = math.ceil(S / c) * c * N * (1 if variant == 'binary' else K)
            if elems > cfg.target_chunk_elems:
                return None
        fnkey = ('linear_fast', chunk)
        if fnkey not in self._fn_cache:
            self._fn_cache[fnkey] = build_linear_cached_fn(
                self.predictor, replace(cfg, link=self.config.link), chunk)
        consts = self._plan_consts(plan, chunk)
        with capture_kernel_paths() as kp:
            out = self._fn_cache[fnkey](torch.as_tensor(Xp, device=self.device), consts)
        self._note_kernel_paths(kp)
        return self._pack_fn(out, packed_dtype)

    @staticmethod
    def _pack_fn(out, transfer_dtype):
        """An explain function's phi, E[f] and f(x) packed into one device
        buffer for a single copy (reference ``kernel_shap.py:1148-1163``)."""

        return pack_transfer(out['shap_values'],
                             torch.cat([out['expected_value'].reshape(-1),
                                        out['raw_prediction'].reshape(-1)]),
                             transfer_dtype)

    def _staged_input(self, staged: StagedRows) -> Tuple[torch.Tensor, int]:
        """``(device rows, B)`` of a :class:`StagedRows`, ordered after its
        upload: on CUDA the calling thread's current stream waits on the
        upload's event, and the rows are recorded as used on that stream,
        so the caching allocator does not hand their memory back to the
        side stream while this stream's kernels still read it."""

        rows = staged.device
        if staged.ready is not None:
            stream = torch.cuda.current_stream(rows.device)
            stream.wait_event(staged.ready)
            rows.record_stream(stream)
        return rows, staged.B

    def _current_stream(self) -> Optional["torch.cuda.Stream"]:
        """The calling thread's current stream on the engine's CUDA device
        (``None`` on the CPU): a dispatch's finalize copies on it, so the
        copy orders after the dispatch's kernels whatever thread runs it."""

        if self.device.type != 'cuda':
            return None
        return torch.cuda.current_stream(self.device)

    def _dispatch_array(self, X, plan):
        """Launch the device computation for ``X`` and return a zero-argument
        ``finalize`` that makes the one device-to-host copy (it waits for
        the device) and unpacks it (reference ``kernel_shap.py:1165-1227``).
        The plan-constant path goes first; where it does not apply, the
        classic function and :meth:`_pack_fn`.  With
        ``ShapConfig.transfer_dtype`` set only phi takes the narrower
        dtype.  ``X`` may be a :class:`StagedRows` from :meth:`stage_rows`,
        whose uploaded rows feed the launch directly; ``finalize`` may run
        on another thread."""

        if isinstance(X, StagedRows):
            Xp, B = self._staged_input(X)
        else:
            Xp, B = self._pad_to_bucket(X)
        td = self.config.shap.transfer_dtype
        packed = self._linear_fast_call(Xp, plan, packed_dtype=td)
        if packed is None:
            with capture_kernel_paths() as kp:
                out = self._fn()(torch.as_tensor(Xp, device=self.device),
                                 *self._device_args(plan))
            self._note_kernel_paths(kp)
            packed = self._pack_fn(out, td)
        Bp = Xp.shape[0]
        stream = self._current_stream()

        def finalize() -> Dict[str, np.ndarray]:
            K, M = self.predictor.n_outputs, self.M
            with _on_stream(stream):
                flat = fetch_transfer(packed)
            phi, tail = unpack_transfer(flat, Bp * K * M, td)
            e_val, fx = np.split(tail, [K])
            return {
                'shap_values': phi.reshape(Bp, K, M)[:B],
                'expected_value': e_val,
                'raw_prediction': fx.reshape(Bp, K)[:B],
            }

        return finalize

    def _explain_array(self, X: np.ndarray, nsamples,
                       silent: bool = True) -> Dict[str, np.ndarray]:
        if self.config.host_eval:
            return self._explain_array_hosteval(X, nsamples, silent=silent)
        with profiler().phase('coalition_plan'):
            plan = self._plan(nsamples)
        with profiler().phase('device_explain'):
            return self._dispatch_array(X, plan)()

    # ------------------------------------------------------------------ #
    # anytime refinement (progressive rounds, accumulated WLS state)

    def _anytime_schedule(self, nsamples=None):
        """The anytime round schedule at this nsamples budget (memoised next
        to the coalition plans: host numpy, survives device resets), or
        ``None`` where refinement cannot apply (exact enumeration, ``M < 2``,
        string budgets other than ``'auto'``; reference
        ``kernel_shap.py:1229-1247``)."""

        if isinstance(nsamples, str) and nsamples != 'auto':
            return None  # 'exact' etc.: analytic paths have zero error
        key = ('anytime', 'auto' if nsamples in (None, 'auto') else int(nsamples))
        if key not in self._plan_cache:
            n = None if key[1] == 'auto' else key[1]
            self._plan_cache[key] = build_schedule(
                self.M, nsamples=n, seed=self.config.seed or 0)
        return self._plan_cache[key]

    def anytime_supported(self, nsamples=None) -> bool:
        """Whether this engine serves progressive-refinement rounds at the
        given budget: the sampled estimator on the device (host eval keeps
        the evaluation off the device) with a non-degenerate schedule."""

        if self.config.host_eval:
            return False
        return self._anytime_schedule(nsamples) is not None

    def _anytime_consts(self, schedule):
        """The anytime round engine's device constants that do not depend on
        X (the background, the link-space expected value, the enumerated
        block's weighted Gram matrix), computed once and served from the
        plan-constant cache keyed by ``content_fingerprint()``, ``'anytime'``
        and the schedule's fingerprint, with the same LRU bound (reference
        ``kernel_shap.py:1259-1294``).  Shared by every run: nothing writes
        into it."""

        key = (self.content_fingerprint(), 'anytime', schedule.fingerprint())
        if key in self._plan_consts_cache:
            self._plan_consts_cache.move_to_end(key)
            return self._plan_consts_cache[key]
        fnkey = ('anytime_consts',)
        if fnkey not in self._fn_cache:
            self._fn_cache[fnkey] = build_anytime_consts_fn(
                self.predictor, replace(self.config.shap, link=self.config.link),
                self.config.link)
        dev = self.device
        with profiler().phase('plan_consts'):
            consts = self._fn_cache[fnkey](
                torch.as_tensor(self.background, device=dev),
                torch.as_tensor(self.bg_weights, device=dev),
                torch.as_tensor(schedule.enum_mask, device=dev),
                torch.as_tensor(schedule.enum_weights, device=dev),
                torch.as_tensor(self.G, device=dev))
        self._plan_consts_cache[key] = consts
        while len(self._plan_consts_cache) > self._DEV_CACHE_MAX_ENTRIES:
            self._plan_consts_cache.popitem(last=False)
        return consts

    def anytime_begin(self, X, nsamples=None) -> Optional[AnytimeRun]:
        """Begin a progressive-refinement run for ``X``: an
        :class:`~distributedkernelshap_tpu_torch.anytime.engine.AnytimeRun`
        whose ``step()`` runs one accumulated round, or ``None`` where the
        engine or budget is ineligible (host eval, string budgets other than
        ``'auto'``, a degenerate schedule, a batch over ``instance_chunk``;
        the caller then takes the classic single-shot path).  ``X`` may be
        a :class:`StagedRows`; its host rows seed the run."""

        if self.config.host_eval:
            return None
        schedule = self._anytime_schedule(nsamples)
        if schedule is None:
            return None
        X = X.host if isinstance(X, StagedRows) else X
        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        if self.config.instance_chunk and X.shape[0] > self.config.instance_chunk:
            return None
        Xp, B = self._pad_to_bucket(X)
        return AnytimeRun(owner=self, schedule=schedule, Xp=Xp, B=B)

    def _dispatch_anytime_round(self, run: AnytimeRun) -> RoundResult:
        """One anytime refinement round (reference ``kernel_shap.py:
        1321-1393``): regenerate the round's draw block (deterministic from
        ``(seed, round)``), feed it through the round function with the
        run's state, rebind the state to the round's new tensors and return
        the round's :class:`RoundResult`.  Round ``k+1`` reads round ``k``'s
        accumulated state; nothing is recomputed.  The round function is
        cached per ``(schedule, round, padded batch)``."""

        schedule = run.schedule
        r = run.round_idx
        consts = self._anytime_consts(schedule)
        draw_mask = round_draw_mask(schedule, r)
        Bp = run.Xp.shape[0]
        fnkey = ('anytime_round', schedule.fingerprint(), r, Bp)
        if fnkey not in self._fn_cache:
            self._fn_cache[fnkey] = build_round_fn(
                self.predictor, replace(self.config.shap, link=self.config.link),
                self.config.link, self.config.shap.ridge, schedule, r)
        fn = self._fn_cache[fnkey]
        dev = self.device
        t0 = time.monotonic()
        with profiler().phase('device_explain'):
            with capture_kernel_paths() as kp:
                first = (torch.as_tensor(run.Xp, device=dev) if r == 0
                         else run.state)
                phi_d, gap_d, state = fn(first, torch.as_tensor(draw_mask, device=dev),
                                         consts)
            self._note_kernel_paths(kp)
            phi = phi_d[:run.B].cpu().numpy()
            gap = gap_d[:run.B].cpu().numpy()
        run.state = state
        run.round_idx = r + 1
        if run.expected_value is None:
            run.expected_value = np.atleast_1d(
                consts['expected_value'].cpu().numpy().astype(np.float32))
        if run.raw_prediction is None:
            run.raw_prediction = state['fx'][:run.B].cpu().numpy()
        est = calibrated_err(gap, r, run.calibration)
        run.reported_err = monotone_min(run.reported_err, est)
        result = RoundResult(
            round_index=r, phi=phi,
            expected_value=run.expected_value,
            raw_prediction=run.raw_prediction,
            est_err=run.reported_err.copy(), raw_gap=gap,
            cumulative_nsamples=schedule.cumulative_nsamples(r),
            done=run.round_idx >= schedule.n_rounds)
        run.last_result = result
        run.last_round_s = time.monotonic() - t0
        return result

    # ------------------------------------------------------------------ #
    # host evaluation of black-box predictors

    def _solve_fn(self):
        """The constrained WLS alone, on the device (reference
        ``kernel_shap.py:784-801``): the host-eval path's device work."""

        if 'solve' not in self._fn_cache:
            ridge = self.config.shap.ridge

            @torch.no_grad()
            def solve(mask, w, ey_adj, fx_minus_e):
                return _wls_solve(mask, w, ey_adj, fx_minus_e, ridge)

            self._fn_cache['solve'] = solve
        return self._fn_cache['solve']

    def _hosteval_stats(self, X: np.ndarray, plan, silent: bool = True):
        """Host-side ``(ey_adj, fx, e_val)`` for black-box predictors
        (reference ``kernel_shap.py:803-895``): the masked rows are made by
        the native OpenMP fill (``runtime/masked_eval.cc``, or its numpy
        route) and fed to ``predictor.host_fn`` in coalition chunks, fanned
        out over ``host_eval_workers`` threads; each chunk writes a disjoint
        slice of ``ey``.  ``silent=False`` logs chunk progress."""

        from distributedkernelshap_tpu_torch.runtime import native

        link_np = convert_to_link_np(self.config.link)
        B, D = X.shape
        N = self.background.shape[0]
        S = plan.n_rows
        K = self.predictor.n_outputs
        zc = (plan.mask @ self.G).astype(np.float32)
        bgw = (self.bg_weights / self.bg_weights.sum()).astype(np.float32)
        self._note_kernel_paths({'host_fill': native.fill_route()})

        # parallel in-flight chunks share the memory budget: give each worker
        # at least one coalition row's worth (B*N*D elements), dropping
        # workers rather than degenerating to 1-row chunks.  Only None
        # resolves to the core count; an explicit 0 means sequential, like 1
        shap = self.config.shap
        n_workers = ((os.cpu_count() or 1) if self.config.host_eval_workers is None
                     else max(1, int(self.config.host_eval_workers)))
        per_row = B * N * D
        if shap.coalition_chunk and self.config.host_eval_workers is None:
            # an explicit chunk bypasses the memory budget, so the auto
            # fan-out must not multiply it by the core count
            cap = shap.target_chunk_elems // max(1, shap.coalition_chunk * per_row)
            n_workers = max(1, min(n_workers, cap))
        n_workers = max(1, min(n_workers, shap.target_chunk_elems // max(per_row, 1)))
        chunk = shap.coalition_chunk or _auto_chunk(
            S, per_row, shap.target_chunk_elems // n_workers)
        ey = np.empty((B, S, K), dtype=np.float32)
        starts = range(0, S, chunk)
        n_workers = min(n_workers, len(starts))
        if getattr(self, 'last_hosteval_workers', None) != n_workers \
                and n_workers > 1 and self.config.host_eval_workers is None:
            logger.info(
                "host-eval fanning predictor calls across %d workers "
                "(host_eval_workers=None resolves to the core count; set "
                "host_eval_workers=1 for non-reentrant callables)", n_workers)
        #: resolved fan-out of the last host-eval pass
        self.last_hosteval_workers = n_workers
        progress = {'done': 0}
        progress_lock = threading.Lock()
        log_every = max(1, len(starts) // 10)

        def eval_chunk(s0: int) -> None:
            zc_c = zc[s0:s0 + chunk]
            rows = native.masked_fill(X, self.background, zc_c)
            pred = self.predictor.host_fn(rows)
            ey[:, s0:s0 + chunk] = native.weighted_mean(
                pred, bgw, B * zc_c.shape[0]).reshape(B, zc_c.shape[0], K)
            if not silent:
                with progress_lock:
                    progress['done'] += 1
                    n_done = progress['done']
                if n_done % log_every == 0 or n_done == len(starts):
                    logger.info("host-eval: %d/%d coalition chunks", n_done, len(starts))

        if n_workers > 1:
            with ThreadPoolExecutor(max_workers=n_workers) as pool:
                list(pool.map(eval_chunk, starts))
        else:
            for s0 in starts:
                eval_chunk(s0)

        e_val = np.atleast_1d(np.asarray(self.expected_value, dtype=np.float32))
        fx = link_np(self.predictor.host_fn(X)).astype(np.float32)
        ey_adj = link_np(ey) - e_val[None, None, :]
        return ey_adj, fx, e_val

    def _explain_array_hosteval(self, X: np.ndarray, nsamples,
                                silent: bool = True) -> Dict[str, np.ndarray]:
        """Black-box path: the predictor runs on the host, the WLS solve on
        the device (reference ``kernel_shap.py:897-920``)."""

        plan = self._plan(nsamples)
        self._note_kernel_paths({'ey': 'host'})
        Xp, B = self._pad_to_bucket(X)
        with profiler().phase('host_eval'):
            ey_adj, fx, e_val = self._hosteval_stats(Xp, plan, silent=silent)
        fx_minus_e = fx - e_val[None, :]
        dev = self.device
        with profiler().phase('device_solve'):
            phi = self._solve_fn()(
                torch.as_tensor(plan.mask, device=dev),
                torch.as_tensor(plan.weights, device=dev),
                torch.as_tensor(ey_adj, device=dev),
                torch.as_tensor(fx_minus_e, device=dev)).cpu().numpy()
        return {
            'shap_values': phi[:B],
            'expected_value': e_val,
            'raw_prediction': fx[:B],
        }

    # ------------------------------------------------------------------ #
    # exact TreeSHAP (ops/treeshap.py)

    def _exact_flavor(self) -> Optional[str]:
        """Which sampling-free path the predictor admits under
        ``nsamples='exact'`` (reference ``kernel_shap.py:1395-1418``):
        ``'tree'`` (lifted ensemble, possibly behind an affine head),
        ``'tn'`` (tensor-train structure with raw outputs) or
        ``'deepshap'`` (a lifted neural graph whose every node has an
        attribution rule, :func:`supports_deepshap`), or ``None``: then
        ``validate_exact`` raises, as in the reference."""

        if supports_exact(self.predictor):
            return 'tree'
        if supports_exact_tn(self.predictor):
            return 'tn'
        if supports_deepshap(self.predictor):
            return 'deepshap'
        return None

    def _exact_consts(self) -> Dict[str, Any]:
        """X-independent exact-path device constants: the background reach
        tensors, the host-side packed-path plan and (when packing engages)
        the packed gathers, plus the background weights and group matrix.
        Kept in the shared plan-constant LRU under ``('exact_consts',
        content_fingerprint(), pack_paths)`` (reference ``kernel_shap.py:
        1764-1817``): flipping ``pack_paths`` on a live engine rebuilds them,
        and ``plan_constant_cache=False`` recomputes them every call."""

        pack_paths = self.config.shap.pack_paths

        def build():
            budget = self.config.shap.target_chunk_elems
            G = torch.as_tensor(self.G, device=self.device)
            with torch.no_grad(), profiler().phase('background_reach'):
                reach = background_reach(
                    self.predictor, torch.as_tensor(self.background, device=self.device),
                    G, target_chunk_elems=budget)
                plan = build_packed_plan(self.predictor, self.G)
                packed = None
                if resolve_pack_paths(pack_paths, plan):
                    packed = pack_reach(self.predictor, reach, plan)
                    # the packed route reads only onpath_g from the dense reach
                    reach = {'onpath_g': reach['onpath_g']}
            return {'reach': reach, 'plan': plan, 'packed': packed,
                    'bgw': torch.as_tensor(self.bg_weights, device=self.device),
                    'G': G}

        return self._shared_consts(('exact_consts', self.content_fingerprint(), pack_paths),
                                   build)

    def _exact_full_reach(self) -> Dict[str, torch.Tensor]:
        """The dense reach tensors for the interactions path.  When the
        packed plan engages, :meth:`_exact_consts` keeps only ``onpath_g``
        of them (the packed phi route needs nothing else), so the dense
        tensors are rebuilt here, in the shared LRU under
        ``('exact_reach_full', content_fingerprint())``."""

        consts = self._exact_consts()
        if 'z_ok' in consts['reach']:
            return consts['reach']

        def build():
            with torch.no_grad(), profiler().phase('background_reach'):
                return background_reach(
                    self.predictor,
                    torch.as_tensor(self.background, device=self.device), consts['G'],
                    target_chunk_elems=self.config.shap.target_chunk_elems)

        return self._shared_consts(('exact_reach_full', self.content_fingerprint()), build)

    def _dispatch_exact(self, X):
        """Launch the exact phi computation for one batch and return a
        ``finalize() -> {'shap_values', 'raw_prediction'}`` that copies the
        result to the host: the packed route when the plan engages, the
        dense route otherwise, :meth:`_dispatch_exact_tn` for a
        tensor-train predictor and :meth:`_dispatch_deepshap` for a lifted
        neural graph (one dispatch contract for every flavour).  ``X`` may
        be a :class:`StagedRows`, whose uploaded rows feed the launch
        directly; ``finalize`` may run on another thread."""

        flavor = self._exact_flavor()
        if flavor == 'tn':
            return self._dispatch_exact_tn(X)
        if flavor == 'deepshap':
            return self._dispatch_deepshap(X)
        if isinstance(X, StagedRows):
            Xt, B = self._staged_input(X)
        else:
            Xp, B = self._pad_to_bucket(X)
            Xt = torch.as_tensor(Xp, device=self.device)
        consts = self._exact_consts()
        shap = self.config.shap
        with torch.no_grad(), capture_kernel_paths() as kp:
            if consts['packed'] is not None:
                phi = exact_shap_packed(
                    self.predictor, Xt, consts['reach']['onpath_g'], consts['packed'],
                    consts['bgw'], consts['G'], consts['plan'].buckets,
                    target_chunk_elems=shap.target_chunk_elems,
                    use_kernel=shap.use_kernel)
            else:
                phi = exact_shap_from_reach(
                    self.predictor, Xt, consts['reach'], consts['bgw'], consts['G'],
                    target_chunk_elems=shap.target_chunk_elems,
                    use_kernel=shap.use_kernel)
            fx = self.predictor(Xt)
        self._note_kernel_paths(kp)
        stream = self._current_stream()

        def finalize() -> Dict[str, np.ndarray]:
            with _on_stream(stream):
                return {'shap_values': phi[:B].cpu().numpy(),
                        'raw_prediction': fx[:B].cpu().numpy()}

        return finalize

    def _exact_inter_explanation(self, chunks: List[np.ndarray]) -> Dict[str, np.ndarray]:
        """The interactions variant of the exact path (reference
        ``kernel_shap.py:2288-2371``): phi and the pairwise matrices from
        one reach pass over the DENSE path layout (the packed plan serves
        the phi-only path; the pairwise pass is dense), one launch per
        instance chunk through :func:`run_pipeline`; sets
        ``last_interaction_values`` (K arrays ``(B, M, M)``)."""

        consts = self._exact_consts()
        reach = self._exact_full_reach()
        shap = self.config.shap

        def dispatch(c):
            Xp, B = self._pad_to_bucket(c)
            Xt = torch.as_tensor(Xp, device=self.device)
            with torch.no_grad():
                phi, inter = exact_shap_and_interactions(
                    self.predictor, Xt, reach, consts['bgw'], consts['G'],
                    target_chunk_elems=shap.target_chunk_elems,
                    use_kernel=shap.use_kernel)
                fx = self.predictor(Xt)
            return phi, inter, fx, B, self._current_stream()

        def fetch(handle):
            phi, inter, fx, B, stream = handle
            with _on_stream(stream):
                return {'shap_values': phi[:B].cpu().numpy(),
                        'raw_prediction': fx[:B].cpu().numpy(),
                        'interaction_values': inter[:B].cpu().numpy()}

        with profiler().phase('device_explain'), capture_kernel_paths() as kp:
            results = run_pipeline(chunks, dispatch, fetch,
                                   window=self._resolve_window(len(chunks)))
        self._note_kernel_paths(kp)
        inter = np.concatenate([r['interaction_values'] for r in results], 0)  # (B, K, M, M)
        self.last_interaction_values = [inter[:, k] for k in range(inter.shape[1])]
        return {'shap_values': np.concatenate([r['shap_values'] for r in results], 0),
                'raw_prediction': np.concatenate([r['raw_prediction'] for r in results], 0)}

    def _exact_explanation(self, chunks: List[np.ndarray], l1_reg,
                           interactions: bool) -> Dict[str, np.ndarray]:
        """``nsamples='exact'``: closed-form interventional Shapley values
        (no coalition plan, no WLS) of a lifted tree ensemble's raw margin,
        with ``interactions=True`` also the interaction matrices, of a
        tensor-train predictor by the size-indexed DP, or of a lifted neural
        graph by DeepSHAP backprop; one dispatch per instance chunk through
        :func:`run_pipeline` (reference ``kernel_shap.py:2248-2286``,
        :2076-2112, :2210-2244)."""

        flavor = self._exact_flavor()
        if flavor in ('tn', 'deepshap'):
            validate = validate_exact_tn if flavor == 'tn' else validate_deepshap
            validate(self.predictor, self.config.link, self.G)
            if interactions:
                path = {'tn': "tensor-network exact", 'deepshap': "DeepSHAP backprop"}[flavor]
                raise ValueError(
                    "interactions=True requires a lifted tree ensemble "
                    f"(closed-form interaction matrices); the {path} path "
                    "computes phi only.")
        else:
            validate_exact(self.predictor, self.config.link)
        if l1_reg not in (None, False, 0, 'auto'):
            logger.warning(
                "l1_reg=%r is ignored with nsamples='exact': there is no "
                "sampling noise to regularise away.", l1_reg)
        if interactions:
            return self._exact_inter_explanation(chunks)
        with profiler().phase('device_explain'):
            results = run_pipeline(chunks, self._dispatch_exact, lambda fin: fin(),
                                   window=self._resolve_window(len(chunks)))
        return {'shap_values': np.concatenate([r['shap_values'] for r in results], 0),
                'raw_prediction': np.concatenate([r['raw_prediction'] for r in results], 0)}

    # ------------------------------------------------------------------ #
    # exact tensor-network path (ops/tensor_shap.py)

    def _exact_tn_consts(self) -> Dict[str, Any]:
        """X-independent tensor-network constants: the padded TT cores and
        head, the Shapley size-weight table, the background rows and their
        normalised weights.  In the shared plan-constant LRU under
        ``('exact_tn_consts', content_fingerprint())`` (reference
        ``kernel_shap.py:1986-2015``); ``plan_constant_cache=False``
        recomputes them every call."""

        def build():
            struct = self.predictor.tt_structure()
            bgw = self.bg_weights.astype(np.float64)
            return {
                'A': struct['A'], 'B': struct['B'], 'head': struct['head'],
                'Wt': torch.as_tensor(weight_toeplitz(self.M), device=self.device),
                'bg': torch.as_tensor(self.background, device=self.device),
                'bgw': torch.as_tensor((bgw / bgw.sum()).astype(np.float32),
                                       device=self.device),
            }

        return self._shared_consts(('exact_tn_consts', self.content_fingerprint()), build)

    def _dispatch_exact_tn(self, X):
        """The tensor-network counterpart of :meth:`_dispatch_exact`
        (reference ``kernel_shap.py:2042-2074``): the same
        :class:`StagedRows` handling and ``finalize`` contract, phi and
        f(x) brought back in one packed copy (:func:`pack_transfer`)."""

        if isinstance(X, StagedRows):
            Xt, B = self._staged_input(X)
        else:
            Xp, B = self._pad_to_bucket(X)
            Xt = torch.as_tensor(Xp, device=self.device)
        consts = self._exact_tn_consts()
        td = self.config.shap.transfer_dtype
        with torch.no_grad(), capture_kernel_paths() as kp:
            phi = tensor_shap_phi(consts['A'], consts['B'], consts['head'], consts['Wt'],
                                  Xt, consts['bg'], consts['bgw'],
                                  target_chunk_elems=self.config.shap.target_chunk_elems)
            packed = pack_transfer(phi, self.predictor(Xt), td)
        self._note_kernel_paths(kp)
        Bp = Xt.shape[0]
        stream = self._current_stream()

        def finalize() -> Dict[str, np.ndarray]:
            K, M = self.predictor.n_outputs, self.M
            with _on_stream(stream):
                flat = fetch_transfer(packed)
            phi_h, fx = unpack_transfer(flat, Bp * K * M, td)
            return {'shap_values': phi_h.reshape(Bp, K, M)[:B],
                    'raw_prediction': fx.reshape(Bp, K)[:B]}

        return finalize

    # ------------------------------------------------------------------ #
    # DeepSHAP backprop path (attribution/deepshap.py)

    def _deepshap_consts(self) -> Dict[str, Any]:
        """X-independent DeepSHAP constants: the lifted graph's float
        initializers, the background rows, their normalised weights and the
        group matrix on the device.  In the shared plan-constant LRU under
        ``('deepshap_consts', content_fingerprint())`` (reference
        ``kernel_shap.py:2117-2146``); ``plan_constant_cache=False``
        recomputes them every call."""

        def build():
            spec = self.predictor.graph_spec()
            bgw = self.bg_weights.astype(np.float64)
            return {
                'params': {name: torch.tensor(np.asarray(arr, np.float32), device=self.device)
                           for name, arr in spec.initializers.items()
                           if np.asarray(arr).dtype.kind == 'f'},
                'bg': torch.as_tensor(self.background, device=self.device),
                'bgw': torch.as_tensor((bgw / bgw.sum()).astype(np.float32),
                                       device=self.device),
                'G': torch.as_tensor(self.G, device=self.device),
            }

        return self._shared_consts(('deepshap_consts', self.content_fingerprint()), build)

    def _deepshap_fn(self):
        """The DeepSHAP batch function of this engine's graph (reference
        ``kernel_shap.py:2148-2174``), built once per engine."""

        if 'deepshap' not in self._fn_cache:
            self._fn_cache['deepshap'] = build_deepshap_fn(self.predictor.graph_spec(),
                                                           self.predictor.n_outputs)
        return self._fn_cache['deepshap']

    def _dispatch_deepshap(self, X):
        """The DeepSHAP counterpart of :meth:`_dispatch_exact` (reference
        ``kernel_shap.py:2176-2208``): the same :class:`StagedRows`
        handling and ``finalize`` contract, phi and f(x) brought back in one
        packed copy (:func:`pack_transfer`)."""

        if isinstance(X, StagedRows):
            Xt, B = self._staged_input(X)
        else:
            Xp, B = self._pad_to_bucket(X)
            Xt = torch.as_tensor(Xp, device=self.device)
        consts = self._deepshap_consts()
        td = self.config.shap.transfer_dtype
        with torch.no_grad(), capture_kernel_paths() as kp:
            phi = self._deepshap_fn()(Xt, consts['params'], consts['bg'], consts['bgw'],
                                      consts['G'])
            packed = pack_transfer(phi, self.predictor(Xt), td)
        self._note_kernel_paths(kp)
        Bp = Xt.shape[0]
        stream = self._current_stream()

        def finalize() -> Dict[str, np.ndarray]:
            K, M = self.predictor.n_outputs, self.M
            with _on_stream(stream):
                flat = fetch_transfer(packed)
            phi_h, fx = unpack_transfer(flat, Bp * K * M, td)
            return {'shap_values': phi_h.reshape(Bp, K, M)[:B],
                    'raw_prediction': fx.reshape(Bp, K)[:B]}

        return finalize

    def _resolve_window(self, n_items: int) -> int:
        """The dispatch window of an ``n_items``-chunk loop on this engine's
        device (:func:`resolve_window`), kept as ``last_dispatch_window``."""

        self.last_dispatch_window = resolve_window(
            self.config.dispatch_window, n_items=n_items, device=self.device)
        return self.last_dispatch_window

    def _chunks(self, X: np.ndarray) -> List[np.ndarray]:
        """``X`` split into ``instance_chunk`` rows a chunk (one chunk when
        unset or not exceeded)."""

        c = self.config.instance_chunk
        if c and X.shape[0] > c:
            return [X[i:i + c] for i in range(0, X.shape[0], c)]
        return [X]

    # ------------------------------------------------------------------ #
    # staging and async explains (the serving pipeline's entry points)

    def _exact_async_ready(self, interactions: bool = False) -> bool:
        """Whether ``nsamples='exact'`` rides the pipelined path (staging,
        ``finalize`` on another thread): a lifted tree ensemble with the
        identity link, a tensor-train predictor that passes
        :func:`tn_exact_ready` or a lifted neural graph that passes
        :func:`deepshap_ready`, off host eval, phi only (reference
        ``kernel_shap.py:1420-1461``).  Interactions stay on the sync path.
        Memoised: every input is fixed once the engine is fitted."""

        key = bool(interactions)
        cached = self._ready_cache.get(key)
        if cached is None:
            cached = self._exact_async_ready_uncached(interactions)
            self._ready_cache[key] = cached
        return cached

    def _exact_async_ready_uncached(self, interactions: bool) -> bool:
        if interactions or self.config.host_eval:
            return False
        flavor = self._exact_flavor()
        if flavor == 'tree':
            return self.config.link == 'identity'
        if flavor == 'tn':
            return tn_exact_ready(self.predictor, self.config.link, self.G,
                                  self.config.shap.target_chunk_elems) is None
        if flavor == 'deepshap':
            return deepshap_ready(self.predictor, self.config.link, self.G,
                                  self.config.shap.target_chunk_elems) is None
        return False

    def _staging_stream(self) -> "torch.cuda.Stream":
        """The engine's side stream for uploads (made on first use)."""

        with self._stage_lock:
            if self._stage_stream is None:
                self._stage_stream = torch.cuda.Stream(device=self.device)
            return self._stage_stream

    def stage_rows(self, X: np.ndarray,
                   nsamples: Union[str, int, None] = None,
                   l1_reg: Union[str, float, int, None] = 'auto',
                   interactions: bool = False) -> Optional[StagedRows]:
        """Start the host-to-device upload of a request batch now and return
        a :class:`StagedRows`, or ``None`` where these explain options route
        through a sync fallback that reads host rows (host eval, exact
        interactions, active l1, a batch over ``instance_chunk``, exact when
        not async-ready; reference ``kernel_shap.py:1463-1495``).

        On CUDA the bucket-padded rows are copied into pinned host memory
        and uploaded with ``non_blocking=True`` on the engine's side stream,
        which records an event after the copy; the dispatch that consumes
        the StagedRows waits on that event.  So the upload overlaps the
        previous batch's compute, and this may run on another thread than
        the dispatch.  On the CPU the rows become a plain tensor."""

        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        needs_chunking = (self.config.instance_chunk
                          and X.shape[0] > self.config.instance_chunk)
        if self.config.host_eval or needs_chunking or interactions:
            return None
        if nsamples == 'exact':
            # l1 is ignored in exact mode, so it never forces the sync path
            if not self._exact_async_ready(interactions):
                return None
        elif self._l1_active(l1_reg, nsamples):
            return None
        Xp, B = self._pad_to_bucket(X)
        if self.device.type != 'cuda':
            return StagedRows(host=X, device=torch.tensor(Xp, device=self.device), B=B)
        pinned = torch.from_numpy(np.ascontiguousarray(Xp)).pin_memory()
        stream = self._staging_stream()
        with torch.cuda.stream(stream):
            rows = pinned.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        return StagedRows(host=X, device=rows, B=B, ready=ready, pinned=pinned)

    def get_explanation_async(self,
                              X,
                              nsamples: Union[str, int, None] = None,
                              l1_reg: Union[str, float, int, None] = 'auto',
                              interactions: bool = False):
        """Asynchronous :meth:`get_explanation` for the serving pipeline
        (reference ``kernel_shap.py:1497-1595``): launches the device work
        for ``X`` now and returns ``finalize() -> (values, info)``, where
        ``values`` is what ``get_explanation`` returns and ``info`` carries
        the batch's ``expected_value`` and link-space ``raw_prediction``.

        Dispatch stays on one thread (it fills the engine's caches);
        ``finalize`` may run on another, and copies on the dispatch's
        stream, after its kernels.  ``X`` may be a :class:`StagedRows` from
        :meth:`stage_rows`.  Host eval, batches over ``instance_chunk``,
        interactions, active l1 and exact when not async-ready compute
        synchronously now (``_async_sync_fallback``)."""

        staged = X if isinstance(X, StagedRows) else None
        X = (staged.host if staged is not None
             else np.atleast_2d(np.asarray(X, dtype=np.float32)))
        needs_chunking = (self.config.instance_chunk
                          and X.shape[0] > self.config.instance_chunk)
        if (nsamples == 'exact' and not needs_chunking
                and self._exact_async_ready(interactions)):
            if l1_reg not in (None, False, 0, 'auto'):
                logger.warning(
                    "l1_reg=%r is ignored with nsamples='exact': there is "
                    "no sampling noise to regularise away.", l1_reg)
            fin0 = self._dispatch_exact(staged if staged is not None else X)

            def finalize_exact():
                with profiler().phase('device_explain'):
                    r = fin0()
                info = {
                    'raw_prediction': r['raw_prediction'],
                    'expected_value': np.atleast_1d(np.asarray(
                        self.expected_value, dtype=np.float32)),
                }
                return split_shap_values(r['shap_values'], self.vector_out), info

            return finalize_exact
        if (self.config.host_eval or needs_chunking or nsamples == 'exact'
                or interactions or self._l1_active(l1_reg, nsamples)):
            # these routes gain nothing from pipelining (host eval is
            # host-bound, l1 runs a second device pass and host selection,
            # an over-chunk batch must keep instance_chunk's memory bound)
            # and touch shared engine state: compute now, on this thread
            return _async_sync_fallback(self, X, nsamples, l1_reg, interactions)

        with profiler().phase('coalition_plan'):
            plan = self._plan(nsamples)
        fin = self._dispatch_array(staged if staged is not None else X, plan)

        def finalize():
            # the device time materialises here, at the copy, so the phase
            # lands on the thread that pays it
            with profiler().phase('device_explain'):
                r = fin()
            return split_shap_values(r['shap_values'], self.vector_out), r

        return finalize

    def _l1_active(self, l1_reg, nsamples) -> bool:
        """Whether :meth:`_apply_l1_reg` runs a host-side selection pass
        (the 'auto' rule: sampled fraction of the coalition space < 0.2)."""

        if l1_reg in (None, False, 0):
            return False
        if isinstance(l1_reg, str) and l1_reg == 'auto':
            plan = self._plan(nsamples)
            space = 2.0 ** self.M - 2 if self.M < 63 else np.inf
            return plan.n_rows / space < 0.2
        return True

    def _apply_l1_reg(self, phi, X, l1_reg, nsamples, silent: bool = True):
        """Optional host-side feature selection (reference
        ``kernel_shap.py:2373-2395``): ``'auto'`` turns into AIC selection
        when the sampled fraction of the coalition space is < 0.2, as in
        shap 0.35; the selection re-solves a restricted weighted regression
        per (instance, output) on the host.  ``silent=False`` logs the
        host-eval pass's chunk progress."""

        plan = self._plan(nsamples)
        if not self._l1_active(l1_reg, nsamples):
            return phi
        if isinstance(l1_reg, str) and l1_reg == 'auto':
            space = 2.0 ** self.M - 2 if self.M < 63 else np.inf
            l1_reg = 'aic'
            logger.warning(
                "l1_reg='auto': sampled fraction %.2e of the coalition space is "
                "< 0.2, so AIC feature selection runs per instance on the host "
                "(shap 0.35 default behaviour). Pass l1_reg=False to keep the "
                "fully on-device path.", plan.n_rows / space)
        return self._l1_solve(X, plan, l1_reg, silent=silent)

    def _l1_solve(self, X, plan, l1_reg, silent: bool = True):
        """Restricted WLS re-solve after lasso/top-k feature selection
        (reference ``kernel_shap.py:2397-2461``), in float64 numpy.

        One device pass returns the per-coalition expected outputs
        (``self._fn(with_ey=True)``: on CUDA tensors ``fused_linear_ey``
        launches, or raises); all ``B*K`` selection problems then share the
        plan's design, so its centering, Gram matrix and pseudo-inverse and
        every ``X^T y`` are computed once, and the restricted re-solves are
        batched by identical selection sets."""

        if self.config.host_eval:
            ey_adj, fx, e_val = self._hosteval_stats(X, plan, silent=silent)
            ey_adj = ey_adj.astype(np.float64)
            fx = fx.astype(np.float64)
            e_val = e_val.astype(np.float64)
        else:
            with capture_kernel_paths() as kp:
                out = self._fn(with_ey=True)(torch.as_tensor(X, device=self.device),
                                             *self._device_args(plan))
            self._note_kernel_paths(kp)
            ey_adj = out['ey_adj'].cpu().numpy().astype(np.float64)       # (B, S, K)
            fx = out['raw_prediction'].cpu().numpy().astype(np.float64)   # link space
            e_val = np.atleast_1d(out['expected_value'].cpu().numpy().astype(np.float64))

        mask = plan.mask.astype(np.float64)
        w = plan.weights.astype(np.float64)
        keep = w > 0
        mask, w, ey_adj = mask[keep], w[keep], ey_adj[:, keep]
        sw = np.sqrt(w)

        B, K, M = X.shape[0], ey_adj.shape[-1], self.M
        Zt = mask[:, :-1] - mask[:, -1:]                   # (S, M-1)
        Xw = Zt * sw[:, None]
        fxe = fx - e_val[None, :]                          # (B, K)
        # target t = b*K + k; Yr[:, t] is that target's unweighted response
        Yr = ey_adj - mask[None, :, -1:] * fxe[:, None, :]         # (B, S, K)
        Yr = np.moveaxis(Yr, 0, 1).reshape(mask.shape[0], B * K)   # (S, T)
        Yw = Yr * sw[:, None]

        sels = _l1_select_batch(Xw, Yw, l1_reg)

        phi = np.zeros((B, K, M))
        fxe_flat = fxe.reshape(-1)
        by_sel: Dict[tuple, list] = {}
        for t, sel in enumerate(sels):
            by_sel.setdefault(tuple(sel), []).append(t)
        Ztw = Zt * w[:, None]
        for sel_key, ts in by_sel.items():
            ts = np.asarray(ts)
            b_idx, k_idx = ts // K, ts % K
            if not sel_key:
                phi[b_idx, k_idx, -1] = fxe_flat[ts]
                continue
            sel = np.asarray(sel_key)
            Zs = Zt[:, sel]
            A = Ztw[:, sel].T @ Zs + 1e-10 * np.eye(sel.size)
            rhs = Ztw[:, sel].T @ Yr[:, ts]                # (|sel|, |ts|)
            sol = np.linalg.solve(A, rhs)
            phi[b_idx[:, None], k_idx[:, None], sel[None, :]] = sol.T
            phi[b_idx, k_idx, -1] = fxe_flat[ts] - sol.sum(0)
        return phi

    def get_importance(self, X: np.ndarray,
                       nsamples: Union[str, int, None] = None) -> np.ndarray:
        """``(K, M)`` mean |phi| over ``X``, reduced on the device: only
        ``K·M`` floats come back, not the ``B·K·M`` result (reference
        ``kernel_shap.py:1609-1648``).  No l1 selection (it is per-instance
        host work; ranking is about aggregate magnitude); the host-eval and
        exact paths take the full explain.  ``X`` goes to the device in
        ``instance_chunk`` chunks, whose sums add up on the device."""

        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        if self.config.host_eval or nsamples == 'exact':
            values = self.get_explanation(X, nsamples=nsamples, l1_reg=False, silent=True)
            vals = values if isinstance(values, list) else [values]
            return np.stack([np.abs(v).mean(0) for v in vals])
        with profiler().phase('coalition_plan'):
            plan = self._plan(nsamples)
        args = self._device_args(plan)
        acc = None
        with profiler().phase('device_importance'), capture_kernel_paths() as kp:
            for c in self._chunks(X):
                Xp, B = self._pad_to_bucket(c)
                out = self._fn()(torch.as_tensor(Xp, device=self.device), *args)
                part = out['shap_values'][:B].abs().sum(0)      # (K, M)
                acc = part if acc is None else acc + part
        self._note_kernel_paths(kp)
        return acc.cpu().numpy() / X.shape[0]

    def get_explanation(self,
                        X: Union[Tuple[int, np.ndarray], np.ndarray],
                        nsamples: Union[str, int, None] = None,
                        l1_reg: Union[str, float, int, None] = 'auto',
                        silent: bool = False,
                        interactions: bool = False,
                        **kwargs) -> Any:
        """Compute SHAP values for ``X``: sampled KernelSHAP, or with
        ``nsamples='exact'`` the exact interventional TreeSHAP values of a
        lifted tree ensemble's raw margin.

        Accepts a plain array or a ``(batch_idx, batch)`` tuple.  Returns a
        list of ``K`` ``(B, M)`` arrays for multi-output predictors, a single
        array otherwise; tuple input returns ``(batch_idx, result)``.

        ``interactions=True`` (``nsamples='exact'`` only) also computes the
        exact Shapley interaction matrices, exposed as
        ``last_interaction_values`` (list of ``K`` ``(B, M, M)`` arrays, shap
        TreeExplainer convention); the returned shap values are their row
        sums.  A sampled explain runs host-side l1 feature selection after
        the device pass when ``l1_reg`` asks for it (:meth:`_apply_l1_reg`).
        A batch over ``EngineConfig.instance_chunk`` rows goes to the device
        in chunks of that many, at most the resolved dispatch window of them
        at once (:func:`run_pipeline`)."""

        del kwargs
        if interactions and nsamples != 'exact':
            raise ValueError(
                "interactions=True requires nsamples='exact' (closed-form "
                "interventional TreeSHAP); the sampled KernelSHAP estimator "
                "does not produce interaction values.")
        if not interactions:
            # never let interaction tensors from an earlier explain pair
            # with this call's fingerprint/raw predictions
            self.last_interaction_values = None
        exact = nsamples == 'exact'
        batch_idx = None
        if isinstance(X, tuple):
            batch_idx, X = X

        if _is_pandas(X, 'DataFrame') or _is_pandas(X, 'Series'):
            X = np.atleast_2d(np.asarray(X.values))
        elif sparse.issparse(X):
            X = X.toarray()
        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        chunks = self._chunks(X)

        if exact:
            r = self._exact_explanation(chunks, l1_reg, interactions)
        elif len(chunks) > 1 and not self.config.host_eval:
            # dispatch ahead of the fetches in a sliding window (reference
            # kernel_shap.py:1712-1741): dispatch stays on this thread (it
            # fills the engine's caches), only the copies fan out, and at
            # most `window` chunks are on the device at once
            window = self._resolve_window(len(chunks))
            with profiler().phase('coalition_plan'):
                plan = self._plan(nsamples)
            with profiler().phase('device_explain'):
                results = run_pipeline(chunks, lambda c: self._dispatch_array(c, plan),
                                       lambda fin: fin(), window=window)
            r = {k: np.concatenate([res[k] for res in results], 0)
                 for k in ('shap_values', 'raw_prediction')}
        else:
            results = [self._explain_array(c, nsamples, silent=silent) for c in chunks]
            r = {k: np.concatenate([res[k] for res in results], 0)
                 for k in ('shap_values', 'raw_prediction')}
        # stash the link-space predictions so build_explanation doesn't need
        # a second predictor pass for the same instances
        self.last_raw_prediction = r['raw_prediction']
        self.last_X_fingerprint = _fingerprint(X)

        phi = r['shap_values'] if exact else self._apply_l1_reg(
            r['shap_values'], X, l1_reg, nsamples, silent=silent)
        values = split_shap_values(phi, self.vector_out)
        if batch_idx is not None:
            return batch_idx, values
        return values

    def predict(self, X: np.ndarray, link: bool = False) -> np.ndarray:
        """Model outputs for ``X`` (optionally in link space), on the device
        (on the host on the host-eval path)."""

        if self.config.host_eval:
            out = self.predictor.host_fn(np.asarray(X, dtype=np.float32))
            return convert_to_link_np(self.config.link)(out) if link else out
        link_fn = convert_to_link(self.config.link) if link else (lambda x: x)
        with torch.no_grad():
            out = link_fn(self.predictor(torch.as_tensor(
                np.asarray(X, dtype=np.float32), device=self.device)))
        return out.cpu().numpy()

    def return_attribute(self, name: str) -> Any:
        """Named attribute access (distributed-context parity with the
        reference's ``return_attribute``)."""

        return getattr(self, name)


class KernelShap(Explainer, FitMixin):
    """Model-agnostic KernelSHAP explainer with grouping and distribution
    (reference ``kernel_shap.py:264-1015``), on a torch device.

    ``device`` picks where the engine runs (default: the current CUDA
    device; raises without one).  ``distributed_opts`` (``n_devices`` or
    ``n_cpus``, ``batch_size``, ``actor_cpu_fraction`` and the other
    ``DistributedExplainer`` options) shards each explain over a mesh of
    devices when ``n_devices`` is set, as in the reference: on a CUDA
    device over the visible cards (or the ``devices`` option's list), with
    ``device='cpu'`` over ``n_devices`` copies of the CPU device."""

    def __init__(self,
                 predictor: Callable,
                 link: str = 'identity',
                 feature_names: Union[List[str], Tuple[str], None] = None,
                 categorical_names: Optional[Dict[int, List[str]]] = None,
                 task: str = 'classification',
                 seed: Optional[int] = None,
                 distributed_opts: Optional[Dict] = None,
                 engine_config: Optional[EngineConfig] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(meta=copy.deepcopy(DEFAULT_META_KERNEL_SHAP))
        if device is None and engine_config is not None:
            device = engine_config.device
        self.device = resolve_device(device)
        self.engine_config = replace(engine_config or EngineConfig(), device=self.device)

        # guards meta mutation + snapshot in build_explanation
        self._meta_lock = threading.Lock()
        self.link = link
        self.predictor = predictor
        self.feature_names = feature_names if feature_names else []
        self.categorical_names = categorical_names if categorical_names else {}
        self.task = task
        self.seed = seed
        self._update_metadata({"task": self.task})

        self.use_groups = False
        self.create_group_names = False
        self.transposed = False
        self.ignore_weights = False
        self.summarise_result = False
        self.summarise_background = False
        self._fitted = False

        self.distributed_opts = copy.deepcopy(DISTRIBUTED_OPTS)
        if distributed_opts:
            opts = dict(distributed_opts)
            # reference spelling: n_cpus
            if 'n_cpus' in opts and 'n_devices' not in opts:
                opts['n_devices'] = opts.pop('n_cpus')
            self.distributed_opts.update(opts)
        self.distributed_opts['algorithm'] = 'kernel_shap'
        self.distribute = bool(self.distributed_opts['n_devices'])

    def _new_engine(self, background_data):
        """The engine of a fit: a :class:`KernelExplainerEngine`, or with
        ``distribute`` a ``DistributedExplainer`` around one (reference
        ``kernel_shap.py:2845-2857``)."""

        if self.distribute:
            from distributedkernelshap_tpu_torch.parallel.distributed import (
                DistributedExplainer,
            )

            return DistributedExplainer(
                self.distributed_opts, KernelExplainerEngine,
                (self.predictor, background_data),
                {'link': self.link, 'seed': self.seed, 'config': self.engine_config})
        return KernelExplainerEngine(
            self.predictor, background_data, link=self.link,
            seed=self.seed, config=self.engine_config)

    # ------------------------------------------------------------------ #
    # input validation (reference kernel_shap.py:369-501, warn-and-degrade)

    def _check_inputs(self, background_data, group_names, groups, weights) -> None:
        if isinstance(background_data, Data):
            if not self.summarise_background:
                self.use_groups = False
                return
            background_data = background_data.data

        if isinstance(background_data, np.ndarray) and background_data.ndim == 1:
            background_data = np.atleast_2d(background_data)

        if background_data.shape[0] > KERNEL_SHAP_BACKGROUND_THRESHOLD:
            logger.warning(
                "Large background datasets slow down SHAP estimation. The provided "
                "dataset has %d records; consider passing a subset or setting "
                "summarise_background=True/'auto' (defaults to %d samples).",
                background_data.shape[0], KERNEL_SHAP_BACKGROUND_THRESHOLD,
            )

        if group_names and not groups:
            logger.info(
                "group_names specified without a corresponding 'groups' index "
                "sequence; all groups will have length 1."
            )
            if len(group_names) not in background_data.shape:
                logger.warning(
                    "Got %d group names but the data has shape %s; without group "
                    "indices the number of names must equal one of the data "
                    "dimensions. Ignoring grouping inputs!",
                    len(group_names), background_data.shape,
                )
                self.use_groups = False

        if groups and not group_names:
            logger.warning(
                "groups specified without group names; assigning 'group_<i>' names."
            )
            if self.feature_names:
                if len(self.feature_names) != len(groups):
                    logger.warning(
                        "Got %d feature names for %d groups; creating default "
                        "names for the groups.", len(self.feature_names), len(groups),
                    )
                    self.create_group_names = True
                else:
                    group_names = self.feature_names
            else:
                self.create_group_names = True

        if groups:
            if not isinstance(groups[0], (tuple, list)):
                logger.warning(
                    "groups must be a list of lists/tuples of column indices; got "
                    "elements of type %s. Ignoring grouping inputs!", type(groups[0]),
                )
                self.use_groups = False

            expected_dim = sum(len(g) for g in groups)
            actual_dim = background_data.shape[0] if background_data.ndim == 1 else background_data.shape[1]
            if expected_dim != actual_dim:
                if background_data.shape[0] == expected_dim:
                    logger.warning(
                        "Group index sum matches axis 0 rather than axis 1 of the "
                        "data; consider transposing the data!"
                    )
                    self.transposed = True
                else:
                    logger.warning(
                        "Sum of group sizes (%d) does not match the number of "
                        "features (%d). Ignoring grouping inputs!",
                        expected_dim, actual_dim,
                    )
                    self.use_groups = False

            if group_names and len(group_names) != len(groups):
                logger.warning(
                    "Got %d groups but %d group names. Ignoring grouping inputs!",
                    len(groups), len(group_names),
                )
                self.use_groups = False

        if weights is not None:
            if background_data.ndim == 1 or background_data.shape[0] == 1:
                logger.warning(
                    "weights specified but the background data has a single "
                    "record; weights will be ignored!"
                )
                self.ignore_weights = True
            else:
                data_dim, feat_dim = background_data.shape[0], background_data.shape[1]
                if data_dim != len(weights) and not (feat_dim == len(weights) and self.transposed):
                    logger.warning(
                        "Number of weights (%d) does not match the number of data "
                        "points (%d); weights will be ignored!", len(weights), data_dim,
                    )
                    self.ignore_weights = True

            if self.summarise_background and not self.ignore_weights:
                n_bg = (1 if background_data.ndim == 1 else
                        (background_data.shape[1] if self.transposed else background_data.shape[0]))
                if len(weights) != n_bg:
                    logger.warning(
                        "Number of weights (%d) does not match the summarised "
                        "background size (%d); weights will be ignored!",
                        len(weights), n_bg,
                    )
                    self.ignore_weights = True

    # ------------------------------------------------------------------ #

    def _summarise_background(self, background_data, n_background_samples: int):
        """Reduce the background set (reference kernel_shap.py:503-542):
        subsampling with grouping/categoricals/sparse inputs, weighted
        k-means centroids otherwise."""

        if isinstance(background_data, Data):
            logger.warning(
                "Received option to summarise the data but the background_data "
                "is already a summary Data object; no summarisation will take place!"
            )
            return background_data
        if background_data.ndim == 1:
            logger.warning(
                "Received option to summarise the data but it contains a single "
                "record; no summarisation will take place!"
            )
            return background_data

        self.summarise_background = True
        if self.use_groups or self.categorical_names or sparse.issparse(background_data):
            return subsample(background_data, n_background_samples, seed=self.seed)
        logger.info(
            "Summarising with k-means; samples are weighted by cluster occupancy. "
            "Pass explicit weights of len=n_background_samples to override."
        )
        return kmeans_summary(background_data, n_background_samples,
                              seed=self.seed if self.seed is not None else 0)

    # ------------------------------------------------------------------ #
    # background-data dispatch (reference kernel_shap.py:544-671)

    @methdispatch
    def _get_data(self, background_data, group_names, groups, weights, **kwargs):
        if _is_pandas(background_data, 'DataFrame'):
            return self._get_frame_data(background_data, group_names, groups,
                                        weights, **kwargs)
        if _is_pandas(background_data, 'Series'):
            if not self.use_groups:
                return background_data
            return DenseData(
                background_data.values.reshape(1, len(background_data)),
                self._frame_group_names(list(background_data.index), group_names, groups),
                groups,
            )
        raise TypeError(f"Type {type(background_data)} is not supported for background data!")

    @_get_data.register(Data)
    def _(self, background_data, *args, **kwargs):
        group_names, groups, weights = args
        if weights is not None and self.summarise_background:
            if not self.ignore_weights:
                background_data.weights = np.asarray(weights, dtype=np.float64)
                background_data.weights /= background_data.weights.sum()
            if self.use_groups:
                background_data.groups = [list(g) for g in groups]
                background_data.group_names = list(group_names)
        return background_data

    @_get_data.register(np.ndarray)  # type: ignore
    def _(self, background_data, *args, **kwargs):
        group_names, groups, weights = args
        if not self.use_groups:
            return background_data
        if self.transposed:
            background_data = background_data.T
        return DenseData(background_data, group_names, groups, weights)

    @_get_data.register(sparse.spmatrix)  # type: ignore
    def _(self, background_data, *args, **kwargs):
        group_names, groups, weights = args
        if not self.use_groups:
            return background_data
        logger.warning(
            "Grouping is not compatible with sparse background matrices; "
            "converting to dense."
        )
        dense = background_data.toarray()
        if self.transposed:
            dense = dense.T
        return DenseData(dense, group_names, groups, weights)

    def _get_frame_data(self, background_data, group_names, groups, weights, **kwargs):
        if not self.use_groups:
            return background_data
        if self.transposed:  # features-first frame: samples are the columns
            values = background_data.values.T
            headers = list(background_data.index)
        else:
            values = background_data.values
            headers = list(background_data.columns)
        names = self._frame_group_names(headers, group_names, groups)
        if kwargs.get("keep_index", False):
            index_values = (background_data.columns.values if self.transposed
                            else background_data.index.values)
            index_name = (background_data.columns.name if self.transposed
                          else background_data.index.name)
            return DenseDataWithIndex(values, names, index_values, index_name,
                                      groups, weights)
        return DenseData(values, names, groups, weights)

    @staticmethod
    def _frame_group_names(headers, group_names, groups):
        """Group names for a DataFrame/Series background: the headers when
        they line up with the groups, else the caller's group_names, else
        generated names."""

        if groups is None or len(headers) == len(groups):
            logger.info("Group names are specified by column headers; "
                        "group_names will be ignored!")
            return headers
        if group_names is not None and len(group_names) == len(groups):
            logger.warning(
                "DataFrame has %d columns but %d groups; keeping the "
                "provided group_names instead of the column headers.",
                len(headers), len(groups))
            return list(group_names)
        logger.warning(
            "DataFrame has %d columns but %d groups and no matching "
            "group_names; generating names.", len(headers), len(groups))
        return [f"group_{i}" for i in range(len(groups))]

    # ------------------------------------------------------------------ #

    def _update_metadata(self, data_dict: dict, params: bool = False) -> None:
        """Store whitelisted parameters in ``meta['params']``
        (reference kernel_shap.py:673-695)."""

        if params:
            for key, value in data_dict.items():
                if key in KERNEL_SHAP_PARAMS:
                    self.meta['params'][key] = value
        else:
            self.meta.update(data_dict)

    def fit(self,  # type: ignore[override]
            background_data: Any,
            summarise_background: Union[bool, str] = False,
            n_background_samples: int = KERNEL_SHAP_BACKGROUND_THRESHOLD,
            group_names: Union[Tuple[str], List[str], None] = None,
            groups: Optional[List[Union[Tuple[int], List[int]]]] = None,
            weights: Union[List[float], Tuple[float], np.ndarray, None] = None,
            **kwargs) -> "KernelShap":
        """Initialise the explainer with background data and grouping options
        (reference kernel_shap.py:697-808; same flow and flags)."""

        self._fitted = True
        data_provenance = kwargs.pop('data_provenance', None)
        if data_provenance is not None:
            self.meta['data_provenance'] = str(data_provenance)
        self.use_groups = groups is not None or group_names is not None

        if summarise_background:
            if isinstance(summarise_background, str):
                n_samples = (background_data.data.shape[0] if isinstance(background_data, Data)
                             else background_data.shape[0])
                n_background_samples = min(n_samples, KERNEL_SHAP_BACKGROUND_THRESHOLD)
            background_data = self._summarise_background(background_data, n_background_samples)

        self._check_inputs(background_data, group_names, groups, weights)
        if self.create_group_names:
            group_names = [f'group_{i}' for i in range(len(groups))]
        if self.ignore_weights:
            weights = None
        if not self.use_groups:
            group_names, groups = None, None
        else:
            self.feature_names = group_names

        self.background_data = self._get_data(background_data, group_names, groups, weights, **kwargs)

        self._explainer = self._new_engine(self.background_data)
        self.expected_value = self._explainer.expected_value
        if not self._explainer.vector_out:
            logger.warning(
                "Predictor returned a scalar value. Ensure the output represents "
                "a probability or decision score as opposed to a classification label!"
            )

        self._update_metadata({
            'groups': groups,
            'group_names': group_names,
            'weights': weights,
            'kwargs': kwargs,
            'summarise_background': self.summarise_background,
            'grouped': self.use_groups,
            'transpose': self.transposed,
        }, params=True)

        return self

    def explain(self,
                X: Any,
                summarise_result: bool = False,
                cat_vars_start_idx: Sequence[int] = None,
                cat_vars_enc_dim: Sequence[int] = None,
                **kwargs) -> Explanation:
        """Explain the instances in ``X`` (reference kernel_shap.py:810-898).

        Keyword arguments mirror the reference: ``nsamples`` (coalition
        budget, or ``'exact'`` for lifted tree ensembles and tensor-train
        predictors), ``interactions``
        (with ``'exact'``: the interaction matrices go to
        ``explanation.data['raw']['interaction_values']``), ``l1_reg``
        (host-side feature selection of the sampled path: ``'auto'`` (AIC
        when under 20% of the coalition space is sampled), ``'aic'``,
        ``'bic'``, ``'num_features(k)'``, a float for ``Lasso(alpha)``, or
        ``False``; the float route and the fallback for a degenerate target
        need scikit-learn), ``silent``."""

        if not self._fitted:
            raise TypeError(
                "Called explain on an unfitted object! Please fit the "
                "explainer using the .fit method first!"
            )

        if self.distribute and (sparse.issparse(X) or _is_pandas(X, 'DataFrame')):
            raise TypeError(
                "Incorrect type for `X` due to distributed context. Cast `X` to np.ndarray."
            )

        if self.use_groups and sparse.issparse(X):
            X = X.toarray()

        with profiler().phase('explain'):
            shap_values = self._explainer.get_explanation(X, **kwargs)
        self.expected_value = self._explainer.expected_value
        expected_value = self.expected_value
        if isinstance(shap_values, np.ndarray):
            shap_values = [shap_values]
        if isinstance(expected_value, (float, np.floating)):
            expected_value = [expected_value]

        explanation = self.build_explanation(
            X,
            shap_values,
            expected_value,
            summarise_result=summarise_result,
            cat_vars_start_idx=cat_vars_start_idx,
            cat_vars_enc_dim=cat_vars_enc_dim,
        )
        inter = self._explainer.last_interaction_values
        if kwargs.get('interactions') and inter is not None:
            # summarise exactly when the shap values were (the decision
            # build_explanation took after validation), so rows keep summing
            # to the shap values
            if self.summarise_result:
                inter = [sum_categories(v, cat_vars_start_idx, cat_vars_enc_dim)
                         for v in inter]
            explanation.data['raw']['interaction_values'] = inter
        return explanation

    def rank_features(self, X: Any, nsamples: Union[str, int, None] = None) -> Dict:
        """Global feature ranking over ``X`` without bringing phi back:
        :func:`rank_by_importance`'s structure, with the mean-|phi|
        reduction on the device (``KernelExplainerEngine.get_importance``;
        reference ``kernel_shap.py:2965-2992``).  No ``l1_reg`` selection
        is applied."""

        if not self._fitted:
            raise TypeError(
                "Called rank_features on an unfitted object! Please fit the "
                "explainer using the .fit method first!")
        if _is_pandas(X, 'DataFrame') or _is_pandas(X, 'Series'):
            X = np.atleast_2d(np.asarray(X.values))
        elif sparse.issparse(X):
            X = X.toarray()
        with profiler().phase('rank_features'):
            imp = self._explainer.get_importance(X, nsamples=nsamples)
        return ranking_from_importance(
            imp, _resolve_feature_names(self.feature_names, imp.shape[1]))

    @property
    def kernel_path(self) -> Dict[str, Any]:
        """Which evaluation route the explains took (see
        ``KernelExplainerEngine.kernel_path``); ``{}`` before fit."""

        if not self._fitted:
            return {}
        return self._explainer.kernel_path

    @property
    def hosteval_workers(self) -> Optional[int]:
        """Resolved host-eval fan-out of the last black-box explain (a
        ``None`` config resolves to the host's core count), or ``None``
        before any host-eval pass (reference ``kernel_shap.py:2955-2964``)."""

        if not self._fitted:
            return None
        return getattr(self._explainer, 'last_hosteval_workers', None)

    def build_explanation(self,
                          X: Any,
                          shap_values: List[np.ndarray],
                          expected_value: List[float],
                          **kwargs) -> Explanation:
        """Assemble the Explanation payload (reference kernel_shap.py:900-980)."""

        cat_vars_start_idx = kwargs.get('cat_vars_start_idx', ())
        cat_vars_enc_dim = kwargs.get('cat_vars_enc_dim', ())
        summarise_result = kwargs.get('summarise_result', False)
        if summarise_result:
            self._check_result_summarisation(summarise_result, cat_vars_start_idx, cat_vars_enc_dim)
        if self.summarise_result:
            shap_values = [
                sum_categories(values, cat_vars_start_idx, cat_vars_enc_dim)
                for values in shap_values
            ]

        X_arr = X.toarray() if sparse.issparse(X) else np.asarray(X)
        raw_predictions = kwargs.get('raw_predictions')
        if raw_predictions is None:
            raw_predictions = self._raw_predictions(X_arr)

        if self.task != 'regression':
            argmax_pred = np.argmax(np.atleast_2d(raw_predictions), axis=1)
        else:
            argmax_pred = []
        importances = rank_by_importance(shap_values, feature_names=self.feature_names)

        data = copy.deepcopy(DEFAULT_DATA_KERNEL_SHAP)
        data.update(
            shap_values=shap_values,
            expected_value=np.array(expected_value),
            link=self.link,
            categorical_names=self.categorical_names,
            feature_names=self.feature_names,
        )
        data['raw'].update(
            raw_prediction=raw_predictions,
            prediction=argmax_pred,
            instances=X_arr,
            importances=importances,
        )
        with self._meta_lock:
            self._update_metadata({"summarise_result": self.summarise_result},
                                  params=True)
            meta = copy.deepcopy(self.meta)
        return Explanation(meta=meta, data=data)

    def _raw_predictions(self, X_arr: np.ndarray) -> np.ndarray:
        """Link-transformed model outputs on the explained instances, reused
        from the last explain when it covered the same rows."""

        engine = self._explainer
        if engine.last_raw_prediction is not None and getattr(
                engine, 'last_X_fingerprint', None) == _fingerprint(
                    np.asarray(X_arr, dtype=np.float32)):
            return engine.last_raw_prediction
        return engine.predict(X_arr, link=True)

    def save(self, path: str) -> None:
        """Checkpoint the fitted explainer (reference ``kernel_shap.py:
        3066-3099``): the constructor arguments, the background container,
        the engine config and the metadata in one pickle; the engine is
        rebuilt on :meth:`load`, not pickled.  A predictor whose tensors lie
        on a CUDA device pickles as CUDA tensors, so loading such a
        checkpoint needs CUDA."""

        if not self._fitted:
            raise ValueError("Cannot save an unfitted explainer")
        state = {
            'predictor': self.predictor,
            'link': self.link,
            'feature_names': self.feature_names,
            'categorical_names': self.categorical_names,
            'task': self.task,
            'seed': self.seed,
            'distributed_opts': dict(self.distributed_opts),
            'engine_config': self.engine_config,
            'background_data': self.background_data,
            'meta': self.meta,
            'use_groups': self.use_groups,
            'summarise_background': self.summarise_background,
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, 'wb') as f:
            pickle.dump(state, f)

    @classmethod
    def load(cls, path: str,
             device: Optional[Union[str, torch.device]] = None) -> "KernelShap":
        """Rebuild a fitted explainer from :meth:`save` output (reference
        ``kernel_shap.py:3101-3147``).  The device resolves as the
        constructor resolves it: ``device`` when given, else the saved
        ``engine_config.device``.  The file is a pickle, and unpickling can
        run code: load only checkpoints this program wrote."""

        with open(path, 'rb') as f:
            state = pickle.load(f)
        opts = dict(state.get('distributed_opts') or {})
        opts.pop('algorithm', None)
        explainer = cls(
            state['predictor'],
            link=state['link'],
            feature_names=state['feature_names'],
            categorical_names=state['categorical_names'],
            task=state['task'],
            seed=state['seed'],
            distributed_opts=opts or None,
            engine_config=state.get('engine_config'),
            device=device,
        )
        explainer.use_groups = state['use_groups']
        explainer.summarise_background = state['summarise_background']
        bg = state['background_data']
        if isinstance(bg, Data):
            if state['use_groups']:
                explainer.feature_names = bg.group_names
            explainer._fitted = True
            explainer.background_data = bg
            explainer._explainer = explainer._new_engine(bg)
            explainer.expected_value = explainer._explainer.expected_value
        else:
            # ungrouped background: refit through the normal path
            explainer.fit(bg)
        explainer.meta = state['meta']
        return explainer

    def _check_result_summarisation(self,
                                    summarise_result: bool,
                                    cat_vars_start_idx: Sequence[int],
                                    cat_vars_enc_dim: Sequence[int]) -> None:
        """Guard for output summarisation (reference kernel_shap.py:982-1015)."""

        self.summarise_result = summarise_result
        if not cat_vars_start_idx or not cat_vars_enc_dim:
            logger.warning(
                "Results cannot be summarised: the categorical variable start "
                "indices or encoding dimensions were not provided!"
            )
            self.summarise_result = False
        elif self.use_groups:
            logger.warning(
                "Grouping already yields one shap value per categorical variable; "
                "result summarisation is unnecessary and will be skipped."
            )
            self.summarise_result = False
