"""Public KernelShap explainer of the PyTorch port (sampled and exact paths).

Port of ``distributedkernelshap_tpu/kernel_shap.py``: the same public surface
(``KernelShap(predictor, link, feature_names, categorical_names, task,
seed).fit(background, ...).explain(X, ...) -> Explanation``, plus
``rank_by_importance`` / ``rank_interaction_pairs`` / ``sum_categories``
and the warn-and-degrade input validation), with the computation in
``ops/explain.py`` (sampled) and ``ops/treeshap.py`` (``nsamples='exact'``
on lifted tree ensembles, with ``interactions=True`` the exact Shapley
interaction matrices) on a torch device.

Not ported yet (ROADMAP.md, queue A): the exact tensor-network and DeepSHAP
flavors, the anytime and host-eval paths,
host-side l1 feature selection, ``instance_chunk`` pipelining, staging,
the plan-constant cache, packed transfers, the memory ledger, profiler
phases, ``save``/``load`` and multi-device execution.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``;
without a GPU and without a device they raise.  pandas is only touched when
the caller hands over a pandas object.
"""

import copy
import logging
import math
import threading
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from scipy import sparse

from distributedkernelshap_tpu_torch.data import Data, DenseData, DenseDataWithIndex
from distributedkernelshap_tpu_torch.interface import (
    DEFAULT_DATA_KERNEL_SHAP,
    DEFAULT_META_KERNEL_SHAP,
    Explainer,
    Explanation,
    FitMixin,
)
from distributedkernelshap_tpu_torch.models.predictors import BasePredictor, as_predictor
from distributedkernelshap_tpu_torch.ops.coalitions import coalition_plan, plan_fingerprint
from distributedkernelshap_tpu_torch.ops.explain import (
    ShapConfig,
    build_explainer_fn,
    capture_kernel_paths,
    groups_to_matrix,
    split_shap_values,
)
from distributedkernelshap_tpu_torch.ops.links import convert_to_link
from distributedkernelshap_tpu_torch.ops.summarise import kmeans_summary, subsample
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
from distributedkernelshap_tpu_torch.utils import methdispatch, resolve_device

logger = logging.getLogger(__name__)

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


def _fingerprint(X: np.ndarray):
    """Cheap identity for "same instances as the last explain call"."""

    X = np.ascontiguousarray(X)
    return (X.shape, str(X.dtype), hash(X.tobytes()))


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
class EngineConfig:
    """Static configuration of a single-device explain engine."""

    link: str = 'identity'
    seed: Optional[int] = None
    shap: ShapConfig = field(default_factory=ShapConfig)
    # pad batch sizes up to a bounded ladder of shapes (as the reference,
    # which bounds jit retraces; here it keeps the kernel's shapes stable)
    bucket_batches: bool = True
    # torch device of the engine: None = the current CUDA device, raising
    # when there is none
    device: Optional[Union[str, torch.device]] = None


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
        self._dev_cache: Dict[str, Tuple[torch.Tensor, ...]] = {}
        self._exact_cache: Dict[Any, Dict[str, Any]] = {}
        self.last_raw_prediction: Optional[np.ndarray] = None
        #: the last explain's exact interaction matrices (``interactions=True``):
        #: a list of K ``(B, M, M)`` arrays; None after any other explain
        self.last_interaction_values: Optional[List[np.ndarray]] = None
        #: which evaluation route each explain took ({'ey': 'cuda'|'plain'|
        #: 'einsum', 'exact_phi'/'exact_inter': 'cuda'|'plain'}), persisted
        #: across explains
        self._kernel_paths: Dict[str, str] = {}

        # expected value: link-space weighted mean background prediction
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
        ``'einsum'`` for the identity collapse; ``'exact_phi'`` and
        ``'exact_inter'`` likewise for the exact TreeSHAP and interaction
        kernels.  Empty until the first explain."""

        return dict(self._kernel_paths)

    def _device_args(self, plan):
        """Device copies of the per-fit constants, uploaded once per plan
        (keyed by the plan's content fingerprint)."""

        key = plan_fingerprint(plan)
        if key not in self._dev_cache:
            self._dev_cache[key] = tuple(
                torch.as_tensor(np.asarray(a, dtype=np.float32), device=self.device)
                for a in (self.background, self.bg_weights, plan.mask,
                          plan.weights, self.G))
        return self._dev_cache[key]

    def _dispatch_array(self, X: np.ndarray, plan):
        """Launch the device computation for ``X`` and return a zero-argument
        ``finalize`` that copies the result to the host (the copy waits for
        the device)."""

        Xp, B = self._pad_to_bucket(X)
        with capture_kernel_paths() as kp:
            out = self._fn()(torch.as_tensor(Xp, device=self.device),
                             *self._device_args(plan))
        self._kernel_paths.update(kp)

        def finalize() -> Dict[str, np.ndarray]:
            return {
                'shap_values': out['shap_values'][:B].cpu().numpy(),
                'expected_value': out['expected_value'].cpu().numpy(),
                'raw_prediction': out['raw_prediction'][:B].cpu().numpy(),
            }

        return finalize

    def _explain_array(self, X: np.ndarray, nsamples) -> Dict[str, np.ndarray]:
        return self._dispatch_array(X, self._plan(nsamples))()

    # ------------------------------------------------------------------ #
    # exact TreeSHAP (ops/treeshap.py)

    def _exact_flavor(self) -> Optional[str]:
        """Which sampling-free path the predictor admits under
        ``nsamples='exact'``: ``'tree'`` (lifted ensemble), ``'tn'``
        (tensor-train structure) or ``'deepshap'`` (lifted neural graph),
        duck-typed as the reference does, or ``None``."""

        if supports_exact(self.predictor):
            return 'tree'
        if hasattr(self.predictor, 'tt_structure'):
            return 'tn'
        if hasattr(self.predictor, 'graph_spec'):
            return 'deepshap'
        return None

    def _exact_consts(self) -> Dict[str, Any]:
        """X-independent exact-path device constants, computed once per
        engine and ``pack_paths`` setting: the background reach tensors, the
        host-side packed-path plan and (when packing engages) the packed
        gathers, plus the background weights and group matrix."""

        pack_paths = self.config.shap.pack_paths
        key = ('exact', pack_paths)
        if key in self._exact_cache:
            return self._exact_cache[key]
        budget = self.config.shap.target_chunk_elems
        G = torch.as_tensor(self.G, device=self.device)
        with torch.no_grad():
            reach = background_reach(
                self.predictor, torch.as_tensor(self.background, device=self.device),
                G, target_chunk_elems=budget)
            plan = build_packed_plan(self.predictor, self.G)
            packed = None
            if resolve_pack_paths(pack_paths, plan):
                packed = pack_reach(self.predictor, reach, plan)
                # the packed route reads only onpath_g from the dense reach
                reach = {'onpath_g': reach['onpath_g']}
        consts = {'reach': reach, 'plan': plan, 'packed': packed,
                  'bgw': torch.as_tensor(self.bg_weights, device=self.device),
                  'G': G}
        self._exact_cache[key] = consts
        return consts

    def _exact_full_reach(self) -> Dict[str, torch.Tensor]:
        """The dense reach tensors for the interactions path.  When the
        packed plan engages, :meth:`_exact_consts` keeps only ``onpath_g``
        of them (the packed phi route needs nothing else), so the dense
        tensors are rebuilt here once and cached under their own key."""

        consts = self._exact_consts()
        if 'z_ok' in consts['reach']:
            return consts['reach']
        key = ('exact_reach_full',)
        if key not in self._exact_cache:
            with torch.no_grad():
                self._exact_cache[key] = background_reach(
                    self.predictor,
                    torch.as_tensor(self.background, device=self.device), consts['G'],
                    target_chunk_elems=self.config.shap.target_chunk_elems)
        return self._exact_cache[key]

    def _dispatch_exact(self, X: np.ndarray):
        """Launch the exact phi computation for ``X`` and return a
        ``finalize() -> {'shap_values', 'raw_prediction'}`` that copies the
        result to the host: the packed route when the plan engages, the
        dense route otherwise."""

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
        self._kernel_paths.update(kp)

        def finalize() -> Dict[str, np.ndarray]:
            return {'shap_values': phi[:B].cpu().numpy(),
                    'raw_prediction': fx[:B].cpu().numpy()}

        return finalize

    def _exact_inter_explanation(self, X: np.ndarray) -> Dict[str, np.ndarray]:
        """The interactions variant of the exact path: phi and the pairwise
        matrices from one reach pass over the DENSE path layout (the packed
        plan serves the phi-only path; the pairwise pass is dense), sets
        ``last_interaction_values`` (K arrays ``(B, M, M)``)."""

        Xp, B = self._pad_to_bucket(X)
        Xt = torch.as_tensor(Xp, device=self.device)
        consts = self._exact_consts()
        reach = self._exact_full_reach()
        shap = self.config.shap
        with torch.no_grad(), capture_kernel_paths() as kp:
            phi, inter = exact_shap_and_interactions(
                self.predictor, Xt, reach, consts['bgw'], consts['G'],
                target_chunk_elems=shap.target_chunk_elems,
                use_kernel=shap.use_kernel)
            fx = self.predictor(Xt)
        self._kernel_paths.update(kp)
        inter = inter[:B].cpu().numpy()                      # (B, K, M, M)
        self.last_interaction_values = [inter[:, k] for k in range(inter.shape[1])]
        return {'shap_values': phi[:B].cpu().numpy(),
                'raw_prediction': fx[:B].cpu().numpy()}

    def _exact_tree_explanation(self, X: np.ndarray, l1_reg, interactions: bool):
        """``nsamples='exact'``: closed-form interventional Shapley values
        of a lifted tree ensemble's raw margin (no coalition plan, no WLS),
        with ``interactions=True`` also the interaction matrices."""

        validate_exact(self.predictor, self.config.link)
        if l1_reg not in (None, False, 0, 'auto'):
            logger.warning(
                "l1_reg=%r is ignored with nsamples='exact': there is no "
                "sampling noise to regularise away.", l1_reg)
        if interactions:
            return self._exact_inter_explanation(X)
        return self._dispatch_exact(X)()

    def _l1_active(self, l1_reg, nsamples) -> bool:
        """Whether the reference would run host-side l1 feature selection
        (its 'auto' rule: sampled fraction of the coalition space < 0.2)."""

        if l1_reg in (None, False, 0):
            return False
        if isinstance(l1_reg, str) and l1_reg == 'auto':
            plan = self._plan(nsamples)
            space = 2.0 ** self.M - 2 if self.M < 63 else np.inf
            return plan.n_rows / space < 0.2
        return True

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
        sums."""

        del kwargs, silent
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
        if exact:
            flavor = self._exact_flavor()
            if flavor == 'tn':
                raise NotImplementedError(
                    "the exact tensor-network path is ROADMAP.md queue A "
                    "item 7 and not ported yet")
            if flavor == 'deepshap':
                raise NotImplementedError(
                    "the DeepSHAP exact path is ROADMAP.md queue A item 8 and "
                    "not ported yet")
        elif self._l1_active(l1_reg, nsamples):
            raise NotImplementedError(
                "l1_reg would run host-side feature selection here, which the "
                "PyTorch port does not have yet (ROADMAP.md queue A item 4); "
                "pass l1_reg=False or a larger nsamples")
        batch_idx = None
        if isinstance(X, tuple):
            batch_idx, X = X

        if _is_pandas(X, 'DataFrame') or _is_pandas(X, 'Series'):
            X = np.atleast_2d(np.asarray(X.values))
        elif sparse.issparse(X):
            X = X.toarray()
        X = np.atleast_2d(np.asarray(X, dtype=np.float32))

        r = (self._exact_tree_explanation(X, l1_reg, interactions) if exact
             else self._explain_array(X, nsamples))
        # stash the link-space predictions so build_explanation doesn't need
        # a second predictor pass for the same instances
        self.last_raw_prediction = r['raw_prediction']
        self.last_X_fingerprint = _fingerprint(X)

        values = split_shap_values(r['shap_values'], self.vector_out)
        if batch_idx is not None:
            return batch_idx, values
        return values

    def predict(self, X: np.ndarray, link: bool = False) -> np.ndarray:
        """Model outputs for ``X`` (optionally in link space), on the device."""

        link_fn = convert_to_link(self.config.link) if link else (lambda x: x)
        with torch.no_grad():
            out = link_fn(self.predictor(torch.as_tensor(
                np.asarray(X, dtype=np.float32), device=self.device)))
        return out.cpu().numpy()


class KernelShap(Explainer, FitMixin):
    """Model-agnostic KernelSHAP explainer with grouping (reference
    ``kernel_shap.py:264-1015``), on a torch device.

    ``device`` picks where the engine runs (default: the current CUDA
    device; raises without one).  Multi-device execution
    (``distributed_opts``) is not ported yet."""

    def __init__(self,
                 predictor: Callable,
                 link: str = 'identity',
                 feature_names: Union[List[str], Tuple[str], None] = None,
                 categorical_names: Optional[Dict[int, List[str]]] = None,
                 task: str = 'classification',
                 seed: Optional[int] = None,
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

        self._explainer = KernelExplainerEngine(
            self.predictor, self.background_data, link=self.link,
            seed=self.seed, config=self.engine_config)
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
        budget, or ``'exact'`` for lifted tree ensembles), ``interactions``
        (with ``'exact'``: the interaction matrices go to
        ``explanation.data['raw']['interaction_values']``), ``l1_reg``
        (feature selection; only its inactive settings are supported so
        far), ``silent``."""

        if not self._fitted:
            raise TypeError(
                "Called explain on an unfitted object! Please fit the "
                "explainer using the .fit method first!"
            )

        if self.use_groups and sparse.issparse(X):
            X = X.toarray()

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

    @property
    def kernel_path(self) -> Dict[str, Any]:
        """Which evaluation route the explains took (see
        ``KernelExplainerEngine.kernel_path``); ``{}`` before fit."""

        if not self._fitted:
            return {}
        return self._explainer.kernel_path

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
