"""Decision-tree ensembles evaluated on a torch device.

Port of ``distributedkernelshap_tpu/models/trees.py`` (``:49-392`` and the
lifts ``:520-793``, IsolationForest's included).  Every tree becomes padded node arrays (feature,
threshold, left, right, leaf value) held as buffers of an ``nn.Module``;
prediction runs over static leaf-path tensors (``path_sign``,
``path_offset``, ``path_len``, ``leaf_value``), which the exact TreeSHAP
path (``ops/treeshap.py``) reads as well.

Node feature values are read with a plain gather (``X[:, feature]``).  The
JAX package reads them through a one-hot contraction only to dodge an
XLA:TPU miscompile of the fused gather; the comparison semantics are the
gather's in both: NaN and +inf compare False (go right), -inf compares True
(goes left), and ``missing_left`` reroutes NaN.

Inside the sampled KernelSHAP pipeline the ``B×S×N`` synthetic tensor is
never materialised: split-condition sums separate into instance and
background halves (:meth:`TreeEnsemblePredictor.masked_ey`).

The lifts read estimator attributes only, so scikit-learn is never
imported.  IsolationForest's ``score_samples`` lifts to per-tree isolation
path lengths averaged under the ``neg_exp2`` head; its
``decision_function`` rides an affine output head
(``models/compose.AffineOutputPredictor``) for the offset.
"""

import logging
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from distributedkernelshap_tpu_torch.models._chunking import (
    DEFAULT_CHUNK_ELEMS,
    padded_chunk_map,
)
from distributedkernelshap_tpu_torch.models.predictors import BasePredictor
from distributedkernelshap_tpu_torch.utils import full_f32_matmul, resolve_device

logger = logging.getLogger(__name__)

OUT_TRANSFORMS = ("identity", "binary_sigmoid", "sigmoid", "softmax",
                  "neg_exp2")


def f32_le_threshold(t) -> np.ndarray:
    """Largest float32 ``<=`` each (double) threshold.

    Libraries compare float32 feature values against *double* thresholds;
    the device compares against float32.  A nearest-cast can round a
    threshold UP onto a representable data value ``w``, flipping
    ``w <= t`` (false in double) into ``w <= float32(t)`` (true).  For f32
    data, ``x <= t  <=>  x <= largest-f32-<=-t``, so round the cast down
    whenever it overshot.  ``inf`` (leaf padding) is preserved.
    """

    t64 = np.asarray(t, np.float64)
    t32 = t64.astype(np.float32)
    over = t32.astype(np.float64) > t64
    return np.where(over, np.nextafter(t32, np.float32(-np.inf)), t32).astype(np.float32)


def f32_lt_threshold(t) -> np.ndarray:
    """Largest float32 strictly ``<`` each (double) threshold — the
    ``x < t  <=>  x <= thr`` conversion for strict-comparison libraries."""

    t64 = np.asarray(t, np.float64)
    t32 = t64.astype(np.float32)
    ge = t32.astype(np.float64) >= t64
    return np.where(ge, np.nextafter(t32, np.float32(-np.inf)), t32).astype(np.float32)


def _finish_transform(out: torch.Tensor, transform: str) -> torch.Tensor:
    if transform == "binary_sigmoid":
        p = torch.sigmoid(out[..., 0])
        return torch.stack([1.0 - p, p], dim=-1)
    if transform == "sigmoid":
        return torch.sigmoid(out)
    if transform == "softmax":
        return torch.softmax(out, dim=-1)
    if transform == "neg_exp2":
        # IsolationForest anomaly score: -2^(-E[h]/c) with -1/c in ``scale``
        return -torch.exp2(out)
    return out


class TreeEnsemblePredictor(BasePredictor):
    """A forest evaluated over leaf-membership paths.

    A row reaches leaf ``(t, l)`` iff every split on the leaf's root path
    goes the path's way: with ``gl[n,t,j] = X[n, feature[t,j]] <=
    threshold[t,j]``, ``Σ_j gl·path_sign + path_offset == path_len`` (all
    small integers, exact in f32).  Leaf payouts are one contraction
    ``(n,T,L)×(T,L,K) -> (n,K)``.  Rows are processed in chunks so the
    intermediates stay within ``target_chunk_elems``.  Ensembles whose
    per-row path work exceeds ``max_path_flops_per_row`` have no path
    tensors (``path_sign is None``) and evaluate by iterative traversal.

    Parameters
    ----------
    feature, threshold, left, right
        ``(T, n_nodes)`` padded per-tree node tables.  Leaves self-loop
        (``left == right == own index``).
    value
        ``(T, n_nodes, K_raw)`` leaf payloads.
    depth
        Static traversal count = max depth over the ensemble.
    aggregation
        'sum' (boosting) or 'mean' (forests / single trees).
    base, scale
        ``raw * scale + base`` before the output transform.
    out_transform
        'identity' | 'binary_sigmoid' (K_raw=1 -> ``[1-p, p]``) | 'sigmoid'
        | 'softmax' | 'neg_exp2'.
    missing_left
        Optional ``(T, n_nodes)`` bool: route NaN feature values left.
    device
        Where the buffers live (default: the current CUDA device; raises
        without one).
    """

    #: per-row MAC budget above which the path strategy is declined
    max_path_flops_per_row: int = 1 << 22
    target_chunk_elems: int = DEFAULT_CHUNK_ELEMS

    def __init__(self, feature, threshold, left, right, value, depth: int,
                 aggregation: str = "sum", base=None, scale: float = 1.0,
                 out_transform: str = "identity", missing_left=None,
                 vector_out: bool = True,
                 max_path_flops_per_row: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        if max_path_flops_per_row is not None:
            self.max_path_flops_per_row = int(max_path_flops_per_row)
        if aggregation not in ("sum", "mean"):
            raise ValueError(f"aggregation must be sum|mean, got {aggregation!r}")
        if out_transform not in OUT_TRANSFORMS:
            raise ValueError(f"out_transform must be one of {OUT_TRANSFORMS}")
        dev = resolve_device(device)
        feature = np.asarray(feature, np.int64)
        left = np.asarray(left, np.int64)
        right = np.asarray(right, np.int64)
        value = np.asarray(value, np.float32)
        k_raw = int(value.shape[-1])

        def buf(name, a, dtype):
            self.register_buffer(name, torch.as_tensor(np.array(a), dtype=dtype, device=dev))

        buf("feature", feature, torch.int64)
        buf("threshold", np.asarray(threshold, np.float32), torch.float32)
        buf("left", left, torch.int64)
        buf("right", right, torch.int64)
        buf("value", value, torch.float32)
        base = np.zeros(k_raw, np.float32) if base is None else \
            np.asarray(base, np.float32).reshape(k_raw)
        buf("base", base, torch.float32)
        if missing_left is None:
            self.missing_left = None
        else:
            buf("missing_left", np.asarray(missing_left, bool), torch.bool)
        self.depth = int(depth)
        self.aggregation = aggregation
        self.scale = float(scale)
        self.out_transform = out_transform
        self.n_outputs = 2 if out_transform == "binary_sigmoid" else k_raw
        self.vector_out = vector_out
        self._build_paths(feature, left, right, value, dev)

    @property
    def n_trees(self) -> int:
        return int(self.feature.shape[0])

    def _build_paths(self, feature, left, right, value, dev) -> None:
        """Static path tensors (or ``path_sign = None`` when the ensemble is
        too deep/leafy for them): host numpy, as the JAX package builds
        them."""

        T, Nn = feature.shape
        K = value.shape[-1]
        L = 0
        for t in range(T):
            n_leaves, stack = 0, [0]
            while stack:
                j = stack.pop()
                if left[t, j] == j:          # self-loop == leaf
                    n_leaves += 1
                else:
                    stack.append(int(left[t, j]))
                    stack.append(int(right[t, j]))
            L = max(L, n_leaves)
        if T * L * (Nn + K) > self.max_path_flops_per_row:
            self.path_sign = None
            return
        per_tree = []
        for t in range(T):
            # (leaf, {node: +1 left / -1 right}) via DFS from the root
            paths = []
            stack = [(0, {})]
            while stack:
                j, path = stack.pop()
                if left[t, j] == j:
                    paths.append((j, path))
                else:
                    stack.append((int(left[t, j]), {**path, j: 1}))
                    stack.append((int(right[t, j]), {**path, j: -1}))
            per_tree.append(paths)
        sign = np.zeros((T, L, Nn), np.float32)
        n_right = np.zeros((T, L), np.float32)
        pathlen = np.full((T, L), -1.0, np.float32)   # padded slots never match
        leaf_value = np.zeros((T, L, K), np.float32)
        for t, paths in enumerate(per_tree):
            for l, (j, path) in enumerate(paths):
                for node, s in path.items():
                    sign[t, l, node] = s
                n_right[t, l] = sum(1 for s in path.values() if s < 0)
                pathlen[t, l] = len(path)
                leaf_value[t, l] = value[t, j]
        for name, a in (("path_sign", sign), ("path_offset", n_right),
                        ("path_len", pathlen), ("leaf_value", leaf_value)):
            self.register_buffer(name, torch.as_tensor(a, device=dev))
        self.n_leaves = L

    def _split_conditions(self, X: torch.Tensor) -> torch.Tensor:
        """``gl[n,t,j]`` (bool): does row ``n`` go left at node ``(t,j)``?"""

        xv = X[:, self.feature]                          # (n, T, Nn)
        gl = xv <= self.threshold
        if self.missing_left is not None:
            gl = torch.where(torch.isnan(xv), self.missing_left, gl)
        return gl

    def _eval_paths(self, X: torch.Tensor) -> torch.Tensor:
        gl = self._split_conditions(X).to(torch.float32)  # (n, T, Nn)
        # integer-exact in f32: gl ∈ {0,1}, signs ∈ {-1,0,1}, |Σ| ≤ depth
        hits = torch.einsum("ntj,tlj->ntl", gl, self.path_sign)
        at_leaf = (hits + self.path_offset == self.path_len).to(torch.float32)
        out = torch.einsum("ntl,tlk->nk", at_leaf, self.leaf_value)
        return out / self.n_trees if self.aggregation == "mean" else out

    def _eval_iterative(self, X: torch.Tensor) -> torch.Tensor:
        T = self.feature.shape[0]
        t_idx = torch.arange(T, device=X.device)[None, :]          # (1, T)
        node = torch.zeros((X.shape[0], T), dtype=torch.int64, device=X.device)
        for _ in range(self.depth):
            xv = torch.gather(X, 1, self.feature[t_idx, node])
            go_left = xv <= self.threshold[t_idx, node]
            if self.missing_left is not None:
                go_left = torch.where(torch.isnan(xv), self.missing_left[t_idx, node],
                                      go_left)
            node = torch.where(go_left, self.left[t_idx, node], self.right[t_idx, node])
        leaf = self.value[t_idx, node]                              # (n, T, K_raw)
        return leaf.mean(dim=1) if self.aggregation == "mean" else leaf.sum(dim=1)

    def _finish(self, raw: torch.Tensor) -> torch.Tensor:
        """scale/base/output-transform tail, for any leading dims."""

        return _finish_transform(raw * self.scale + self.base, self.out_transform)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        X = X.to(torch.float32)
        if self.path_sign is None:
            return self._finish(self._eval_iterative(X))
        T, Nn = self.feature.shape
        per_row = T * max(Nn, self.n_leaves)
        chunk = max(1, min(X.shape[0], self.target_chunk_elems // per_row))
        raw = torch.cat([self._eval_paths(X[i:i + chunk])
                         for i in range(0, X.shape[0], chunk)]) \
            if X.shape[0] > chunk else self._eval_paths(X)
        return self._finish(raw)

    # ------------------------------------------------------------------
    # structure-aware masked evaluation for the KernelSHAP pipeline
    # ------------------------------------------------------------------

    @property
    def supports_masked_ey(self) -> bool:
        # depth ≤ 256, the reference's gate: its separable-hits einsums carry
        # the per-path integer counts through bf16, exact only up to 256.
        # Here they are float32 (exact up to 2^24); the gate is kept so both
        # packages route the same ensembles
        return self.path_sign is not None and self.depth <= 256

    def masked_ey_fits(self, B: int, N: int, S: int, M: int,
                       budget: int) -> bool:
        """Whether the persistent separable-hits tensors (R: ``N·T·L·M``,
        per-instance-chunk Q: ``T·L·M``) stay within a few chunk budgets —
        otherwise the row-evaluating generic path is the better choice."""

        T, L = self.path_len.shape
        return N * T * L * M <= 4 * budget and T * L * M <= budget

    @full_f32_matmul()
    def masked_ey(self, X, bg, bgw_n, mask, G, target_chunk_elems=None,
                  coalition_chunk=None):
        """Expected outputs over the KernelSHAP synthetic tensor without
        materialising it (reference ``models/trees.py:425-518``).

        Every synthetic row mixes ONE instance and ONE background row
        columnwise (``m = x_b·z_s + bg_n·(1-z_s)``), so each node's split
        condition is the instance's or the background row's depending only
        on whether the node's feature group is masked.  The leaf-path hit
        count therefore separates::

            hits[b,s,n,t,l] = hx[b,s,t,l] + hb[s,n,t,l]
            hx = Σ_m mask[s,m] · Q[b,t,l,m]
            hb = C[n,t,l] − Σ_m mask[s,m] · R[n,t,l,m]

        with ``Q/R/C`` small per-instance / per-background contractions of
        the path-sign tensor.  ``Q``, ``R``, ``C``, ``hx`` and ``hb`` are
        small integers formed in float32, and the whole evaluation runs
        with TF32 off (``full_f32_matmul``, whatever the caller set), so they
        are exact and the ``==`` against the path length sees exact
        integers; only the leaf-value and background sums round, in f32.

        Returns raw (pre-link) expected outputs ``(B, S, K)``, the contract
        of ``ops.explain._ey_generic``.
        """

        f32 = torch.float32
        X = X.to(f32)
        bg = bg.to(f32)
        mask = mask.to(f32)
        B, N, S = X.shape[0], bg.shape[0], mask.shape[0]
        M = mask.shape[1]
        T, L = self.path_len.shape
        Nn = self.feature.shape[1]
        sign = self.path_sign                            # (T, L, Nn)
        Gsel = G.to(f32)[:, self.feature]                # (M, T, Nn)
        target = self.path_len - self.path_offset        # (T, L); padded: -1
        leaf_v = self.leaf_value                         # (T, L, K)
        budget = target_chunk_elems or self.target_chunk_elems

        # background-side contractions, chunked over N so the (nc, M, T, Nn)
        # intermediate respects the budget; R/C themselves are size-gated by
        # masked_ey_fits
        def bg_chunk(bg_c):
            glb = self._split_conditions(bg_c).to(f32)   # (nc, T, Nn)
            gb = torch.einsum("mtj,ntj->nmtj", Gsel, glb)
            R_c = torch.einsum("tlj,nmtj->ntlm", sign, gb)
            C_c = torch.einsum("tlj,ntj->ntl", sign, glb)
            return torch.cat([R_c, C_c[..., None]], dim=-1)

        RC = padded_chunk_map(bg_chunk, bg, budget // max(1, M * T * Nn))
        R, C = RC[..., :M], RC[..., M]                   # (N,T,L,M), (N,T,L)

        # instance chunk bounds the (bc, M, T, Nn) conditions intermediate;
        # coalition chunk bounds hx (sc·bc·T·L), hb (sc·N·T·L) and the
        # per-tree compare (sc·bc·N·L)
        bc = max(1, min(B, budget // max(1, M * T * Nn, T * L * M)))
        sc = coalition_chunk or max(
            1, min(S, budget // max(1, bc * T * L, N * T * L, bc * N * L)))

        def b_chunk(Xc):
            glx = self._split_conditions(Xc).to(f32)     # (bc, T, Nn)
            gx = torch.einsum("mtj,btj->bmtj", Gsel, glx)
            # Q[b,t,l,m] = Σ_j sign[t,l,j]·Gsel[m,t,j]·glx[b,t,j] (ints ≤ depth)
            Q = torch.einsum("tlj,bmtj->btlm", sign, gx)  # (bc,T,L,M)

            def s_chunk(mask_c):
                hx = torch.einsum("cm,btlm->cbtl", mask_c, Q)
                hb = C[None] - torch.einsum("cm,ntlm->cntl", mask_c, R)
                raw = self._tree_steps(hx, hb, target, leaf_v)
                if self.aggregation == "mean":
                    raw = raw / self.n_trees
                out = self._finish(raw)                  # (sc,bc,N,K')
                return torch.einsum("cbnk,n->cbk", out, bgw_n)

            ey_c = padded_chunk_map(s_chunk, mask, sc)   # (S,bc,K')
            return ey_c.movedim(0, 1)                    # (bc,S,K')

        return padded_chunk_map(b_chunk, X, bc)          # (B,S,K')

    @staticmethod
    def _tree_steps(hx, hb, target, leaf_v):
        """The per-tree leaf sum of one coalition chunk (the reference's
        ``lax.scan`` over trees): ``raw[c,b,n] = Σ_t Σ_l [hx[c,b,t,l] +
        hb[c,n,t,l] == target[t,l]] · leaf_v[t,l]``."""

        c, b, T, _ = hx.shape
        raw = hx.new_zeros((c, b, hb.shape[1], leaf_v.shape[-1]))
        for t in range(T):
            eq = hx[:, :, None, t, :] + hb[:, None, :, t, :] == target[t]   # (c,b,N,L)
            raw = raw + torch.einsum("cbnl,lk->cbnk", eq.to(torch.float32), leaf_v[t])
        return raw


def _pack_tables(tables: Sequence[dict]) -> dict:
    """Pad per-tree node tables to a common node count and stack.

    Each table: ``feature/left/right`` int arrays, ``threshold`` float,
    ``value (n_nodes, K)`` float, optional ``missing_left`` bool.  Leaves must
    already self-loop.
    """

    n_nodes = max(t["feature"].shape[0] for t in tables)
    K = tables[0]["value"].shape[1]
    T = len(tables)
    out = {
        "feature": np.zeros((T, n_nodes), np.int32),
        "threshold": np.full((T, n_nodes), np.inf, np.float32),
        "left": np.tile(np.arange(n_nodes, dtype=np.int32), (T, 1)),
        "right": np.tile(np.arange(n_nodes, dtype=np.int32), (T, 1)),
        "value": np.zeros((T, n_nodes, K), np.float32),
    }
    has_missing = any("missing_left" in t for t in tables)
    if has_missing:
        out["missing_left"] = np.ones((T, n_nodes), bool)
    for i, t in enumerate(tables):
        n = t["feature"].shape[0]
        out["feature"][i, :n] = t["feature"]
        out["threshold"][i, :n] = t["threshold"]
        out["left"][i, :n] = t["left"]
        out["right"][i, :n] = t["right"]
        out["value"][i, :n] = t["value"]
        if has_missing:
            out["missing_left"][i, :n] = t.get("missing_left", np.ones(n, bool))
    return out


def _sklearn_tree_table(tree, k_slot: Optional[int] = None, k_total: int = 1,
                        normalise: bool = False) -> Optional[dict]:
    """Node table from an sklearn ``Tree`` (the ``.tree_`` attribute).

    ``k_slot`` places a scalar-leaf regression tree's value into one column of
    a ``k_total``-wide payload (boosted multiclass stages).  ``normalise``
    turns per-leaf class counts into probabilities (plain classifier trees).
    """

    if tree.n_outputs != 1:
        return None  # multi-output trees are out of scope for the lift
    n = tree.node_count
    feature = tree.feature.astype(np.int32)
    left = tree.children_left.astype(np.int32)
    right = tree.children_right.astype(np.int32)
    is_leaf = left < 0
    idx = np.arange(n, dtype=np.int32)
    feature = np.where(is_leaf, 0, np.maximum(feature, 0))
    left = np.where(is_leaf, idx, left)
    right = np.where(is_leaf, idx, right)
    threshold = f32_le_threshold(np.where(is_leaf, np.inf, tree.threshold))
    raw = tree.value[:, 0, :].astype(np.float64)           # (n_nodes, C)
    if normalise:
        raw = raw / np.clip(raw.sum(axis=1, keepdims=True), 1e-12, None)
    if k_slot is None:
        value = raw
    else:
        if raw.shape[1] != 1:
            return None
        value = np.zeros((n, k_total))
        value[:, k_slot] = raw[:, 0]
    return {"feature": feature, "threshold": threshold, "left": left,
            "right": right, "value": value.astype(np.float32)}


def _average_path_length(n) -> np.ndarray:
    """scikit-learn's ``_average_path_length``: the expected external path
    length of an unsuccessful BST search among ``n`` samples, the c(n)
    normaliser of Isolation Forests (reimplemented: it is private there)."""

    n = np.asarray(n, np.float64)
    out = np.zeros_like(n)
    out[n == 2] = 1.0
    big = n > 2
    nb = n[big]
    out[big] = 2.0 * (np.log(nb - 1.0) + np.euler_gamma) - 2.0 * (nb - 1.0) / nb
    return out


def _iforest_tree_table(tree, features: Optional[np.ndarray]) -> Optional[dict]:
    """Node table whose leaf payload is the isolation path length
    ``h = depth(leaf) + c(n_node_samples(leaf))``.  ``features`` maps the
    tree's subset-relative feature ids to absolute columns
    (``estimators_features_``); the structure comes from
    :func:`_sklearn_tree_table`."""

    table = _sklearn_tree_table(tree)
    if table is None:
        return None
    if features is not None:
        table["feature"] = np.asarray(features, np.int64)[
            table["feature"]].astype(np.int32)
    left = table["left"]
    depth = np.zeros(len(left), np.float64)
    stack = [(0, 0.0)]
    while stack:
        j, d = stack.pop()
        depth[j] = d
        if left[j] != j:                 # self-loop == leaf
            stack.append((int(left[j]), d + 1.0))
            stack.append((int(table["right"][j]), d + 1.0))
    value = depth + _average_path_length(tree.n_node_samples)
    table["value"] = value[:, None].astype(np.float32)
    return table


def _lift_isolation_forest(owner, method_name: str, device=None):
    """IsolationForest ``score_samples`` (``-2^(-E[h]/c(max_samples))``) or
    ``decision_function`` (``score_samples - offset_``): the per-tree path
    lengths averaged, ``-1/c`` folded into ``scale`` and the anomaly
    transform into ``out_transform='neg_exp2'``; the decision offset rides
    an affine output head."""

    feats = getattr(owner, "estimators_features_", [None] * len(owner.estimators_))
    tables = [_iforest_tree_table(e.tree_, f) for e, f in zip(owner.estimators_, feats)]
    c_norm = float(_average_path_length([owner.max_samples_])[0])
    inner = _finalise(tables, device=device, aggregation="mean",
                      out_transform="neg_exp2", scale=-1.0 / c_norm, vector_out=False)
    if inner is None:
        return None
    if method_name == "decision_function":
        from distributedkernelshap_tpu_torch.models.compose import AffineOutputPredictor

        return AffineOutputPredictor(inner, 1.0, -float(owner.offset_))
    return inner


def _hist_tree_table(predictor, k_slot: int, k_total: int) -> Optional[dict]:
    """Node table from a HistGradientBoosting ``TreePredictor``."""

    nodes = predictor.nodes
    if nodes["is_categorical"].any():
        return None  # categorical bitset splits are not lifted
    n = nodes.shape[0]
    idx = np.arange(n, dtype=np.int32)
    is_leaf = nodes["is_leaf"].astype(bool)
    feature = np.where(is_leaf, 0, nodes["feature_idx"]).astype(np.int32)
    threshold = f32_le_threshold(np.where(is_leaf, np.inf, nodes["num_threshold"]))
    left = np.where(is_leaf, idx, nodes["left"].astype(np.int32))
    right = np.where(is_leaf, idx, nodes["right"].astype(np.int32))
    value = np.zeros((n, k_total), np.float32)
    value[:, k_slot] = np.where(is_leaf, nodes["value"], 0.0)
    return {"feature": feature, "threshold": threshold, "left": left,
            "right": right, "value": value,
            "missing_left": nodes["missing_go_to_left"].astype(bool)}


def _tree_depth(left: np.ndarray, right: np.ndarray) -> int:
    """Max root-to-leaf depth of a self-looping node table (iterative)."""

    depth = np.zeros(left.shape[0], np.int32)
    stack: List[int] = [0]
    while stack:
        i = stack.pop()
        for c in (int(left[i]), int(right[i])):
            if c != i:
                depth[c] = depth[i] + 1
                stack.append(c)
    return int(depth.max()) if left.shape[0] > 1 else 0


def _finalise(tables: Sequence[Optional[dict]], device=None,
              **kwargs) -> Optional[TreeEnsemblePredictor]:
    if not tables or any(t is None for t in tables):
        return None
    packed = _pack_tables(list(tables))
    depth = max(_tree_depth(packed["left"][i], packed["right"][i])
                for i in range(len(tables)))
    return TreeEnsemblePredictor(
        packed["feature"], packed["threshold"], packed["left"], packed["right"],
        packed["value"], depth=depth, missing_left=packed.get("missing_left"),
        device=device, **kwargs)


def lift_tree_ensemble(method, device=None) -> Optional[BasePredictor]:
    """Lift a bound ``predict_proba`` / ``predict`` / ``decision_function``
    / ``score_samples`` of a scikit-learn tree model into a
    :class:`TreeEnsemblePredictor` on ``device`` (IsolationForest's
    ``decision_function`` behind an affine output head), or None when the
    estimator does not match a supported family (decision trees,
    random/extra forests, gradient boosting, histogram gradient boosting,
    isolation forests).  The caller (``as_predictor``) checks the lift
    numerically against the original callable before trusting it."""

    owner = getattr(method, "__self__", None)
    name = getattr(method, "__name__", "")
    if owner is None or name not in ("predict", "predict_proba", "decision_function",
                                     "score_samples"):
        return None
    cls = type(owner).__name__
    try:
        if cls == "IsolationForest" and name in ("score_samples", "decision_function"):
            return _lift_isolation_forest(owner, name, device)
        if cls in ("DecisionTreeClassifier", "DecisionTreeRegressor",
                   "ExtraTreeClassifier", "ExtraTreeRegressor"):
            return _lift_forest([owner], cls.endswith("Classifier"), name, device)
        if cls in ("RandomForestClassifier", "RandomForestRegressor",
                   "ExtraTreesClassifier", "ExtraTreesRegressor"):
            return _lift_forest(list(owner.estimators_), cls.endswith("Classifier"),
                                name, device)
        if cls in ("GradientBoostingClassifier", "GradientBoostingRegressor"):
            return _lift_gradient_boosting(owner, name, device)
        if cls in ("HistGradientBoostingClassifier", "HistGradientBoostingRegressor"):
            return _lift_hist_gradient_boosting(owner, name, device)
    except Exception as exc:  # unexpected estimator internals: not liftable
        logger.info("tree lift failed structurally (%s)", exc)
    return None


def _lift_forest(estimators, is_classifier: bool, method_name: str, device=None):
    if is_classifier and method_name != "predict_proba":
        return None  # class-label predict is a discontinuous argmax
    if not is_classifier and method_name != "predict":
        return None
    tables = [_sklearn_tree_table(e.tree_, normalise=is_classifier)
              for e in estimators]
    return _finalise(tables, device=device, aggregation="mean",
                     out_transform="identity", vector_out=is_classifier)


def _lift_gradient_boosting(owner, method_name: str, device=None):
    raw_k = owner.estimators_.shape[1]          # 1 binary / C multiclass
    base = np.asarray(
        owner._raw_predict_init(np.zeros((1, owner.n_features_in_))),
        np.float64).reshape(raw_k)
    tables = [_sklearn_tree_table(owner.estimators_[s, k].tree_,
                                  k_slot=k, k_total=raw_k)
              for s in range(owner.estimators_.shape[0]) for k in range(raw_k)]
    is_classifier = hasattr(owner, "classes_")
    if is_classifier and method_name == "predict_proba":
        transform = "binary_sigmoid" if raw_k == 1 else "softmax"
        vector_out = True
    elif is_classifier and method_name == "decision_function":
        transform, vector_out = "identity", raw_k > 1
    elif not is_classifier and method_name == "predict":
        transform, vector_out = "identity", False
    else:
        return None
    return _finalise(tables, device=device, aggregation="sum",
                     scale=owner.learning_rate, base=base,
                     out_transform=transform, vector_out=vector_out)


def _lift_hist_gradient_boosting(owner, method_name: str, device=None):
    base = np.asarray(owner._baseline_prediction, np.float64).reshape(-1)
    raw_k = base.shape[0]
    tables = [_hist_tree_table(p, k_slot=k, k_total=raw_k)
              for row in owner._predictors for k, p in enumerate(row)]
    is_classifier = hasattr(owner, "classes_")
    if is_classifier and method_name == "predict_proba":
        transform = "binary_sigmoid" if raw_k == 1 else "softmax"
        vector_out = True
    elif is_classifier and method_name == "decision_function":
        transform, vector_out = "identity", raw_k > 1
    elif not is_classifier and method_name == "predict":
        # non-identity losses (poisson/gamma) predict through an inverse
        # link; the faithfulness probe rejects those, this skips the obvious
        loss = getattr(owner, "loss", "squared_error")
        if loss not in ("squared_error", "absolute_error", "quantile"):
            return None
        transform, vector_out = "identity", False
    else:
        return None
    return _finalise(tables, device=device, aggregation="sum", base=base,
                     out_transform=transform, vector_out=vector_out)
