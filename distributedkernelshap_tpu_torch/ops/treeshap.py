"""Exact interventional TreeSHAP main effects and Shapley interactions on a
torch device.

Port of ``distributedkernelshap_tpu/ops/treeshap.py`` (``:112-950`` and
``exact_tree_shap`` ``:1003-1040``).  For one instance
``x``, one background row ``z`` and one leaf with value ``val``, each group
on the leaf's path is satisfied by both rows, by ``x`` only (the leaf needs
the group IN the coalition), by ``z`` only (needs it OUT) or by neither (the
leaf is unreachable).  With ``u`` x-only and ``v`` z-only groups the reach
indicator is a conjunction game whose Shapley values are

    phi_g = val * (u-1)! v! / (u+v)!    for g in U
    phi_g = -val * u! (v-1)! / (u+v)!   for g in V        (0 elsewhere)

summed over leaves, trees and weighted background rows.  Scope: lifted
ensembles with raw-margin outputs (``out_transform='identity'``) and path
tensors, bare or behind an affine output head (``a*f + b``: phi scales by
``a``, the offset moves into the expected value), explained with
``link='identity'``.

The pairwise Shapley interaction index of the same conjunction game pairs
groups of U with weight ``(u-2)! v! / (u+v-1)!``, groups of V with
``u! (v-2)! / (u+v-1)!`` and one of each with ``-(u-1)! (v-1)! / (u+v-1)!``
(:func:`_interaction_tables`); ``exact_interactions_from_reach`` returns
the shap TreeExplainer convention of it.

The reach indicators (``background_reach``, ``_x_reach``) are plain torch
products.  The contraction over (instance, path, background row) is the
hand-written kernel ``exact_tree_phi`` (``ops/cuda_kernels.py``), launched
once per call on the dense route and once per depth bucket on the packed
route (``ops/treeshap_pack.py``); the interactions take one
``exact_tree_inter`` launch and one dense ``exact_tree_phi`` launch for the
diagonal.  Every non-kernel branch is the kernel's plain version — there is
no second plain route.  The TPU gates of the JAX package's VMEM footprint
and its 256-row background slice do not exist here: one launch takes any N
and any M.  Its dmax cap of 64 does: from 64 groups on the kernel runs by
path slot and raises above the cap, naming ``ShapConfig(use_kernel=False)``;
and the interactions stop at 64 groups, as the reference's do.  The port
never demotes an exact explain off its kernel: ``dks_treeshap_fallback_total``
(:func:`attach_treeshap_metrics`) is registered as in the reference and
always reads empty (ROADMAP.md C.10).
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from distributedkernelshap_tpu_torch.models.compose import AffineOutputPredictor
from distributedkernelshap_tpu_torch.models.trees import TreeEnsemblePredictor
from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
    exact_tree_inter,
    exact_tree_inter_plain,
    exact_tree_phi,
    exact_tree_phi_plain,
)
from distributedkernelshap_tpu_torch.ops.explain import (
    record_kernel_path,
    resolve_use_kernel,
)
from distributedkernelshap_tpu_torch.ops.treeshap_pack import (
    DEFAULT_TILE,
    PACK_AUTO_GAIN,
    leaf_group_counts,
    plan_packed_paths,
)


def exact_fallback_counts() -> Dict[Tuple[str, ...], float]:
    """``{(reason,): count}`` — the registry-callback shape.  Always empty:
    the port has no demotion off the exact kernels (a kernel that cannot
    run raises)."""

    return {}


def attach_treeshap_metrics(registry) -> None:
    """Register ``dks_treeshap_fallback_total{reason}`` on ``registry`` as
    a callback counter over :func:`exact_fallback_counts`, with the
    reference's family and label."""

    registry.counter(
        "dks_treeshap_fallback_total",
        "Exact-TreeSHAP demotion EVENTS off the fused-kernel hot path, by "
        "reason.  The PyTorch port never demotes (a kernel that cannot run "
        "raises), so this family is always empty.",
        labelnames=("reason",)).set_function(exact_fallback_counts)


def _unwrap(pred):
    """``(tree_predictor, scale)`` behind an affine output head (reference
    ``ops/treeshap.py:112-124``).  A head ``a*f + b`` scales Shapley values
    by ``a`` and moves ``b`` into the expected value (the engine's ``E`` and
    ``raw_prediction`` come from the whole predictor), so e.g. a
    target-scaled GBT still takes the exact path."""

    if isinstance(pred, AffineOutputPredictor) \
            and isinstance(pred.inner, TreeEnsemblePredictor):
        return pred.inner, float(pred.a)
    return pred, 1.0


def supports_exact(pred) -> bool:
    """Whether ``pred`` can take the exact path: a lifted tree ensemble with
    raw-margin outputs and materialised path tensors, possibly behind an
    affine output head."""

    tree, _ = _unwrap(pred)
    return (isinstance(tree, TreeEnsemblePredictor)
            and tree.out_transform == "identity"
            and getattr(tree, "path_sign", None) is not None)


def validate_exact(pred, link: str) -> None:
    """Raise with an actionable message when ``nsamples='exact'`` cannot
    apply."""

    if not supports_exact(pred):
        raise ValueError(
            "nsamples='exact' requires a device-lifted tree ensemble with "
            "raw-margin outputs (out_transform='identity') and path tensors; "
            f"this predictor is {type(pred).__name__}. Use a sampled nsamples "
            "instead.")
    if link != "identity":
        raise ValueError(
            "nsamples='exact' explains the ensemble's raw margin; "
            f"link={link!r} would change the target quantity. "
            "Use link='identity'.")


def _beta_tables(dmax: int):
    """``W_plus[u, v] = (u-1)! v! / (u+v)!`` (0 for u=0) and
    ``W_minus[u, v] = u! (v-1)! / (u+v)!`` (0 for v=0), for u, v <= dmax, in
    float64 via ``gammaln`` — the oracle the kernel's weights are held to."""

    from scipy.special import gammaln

    u = np.arange(dmax + 1)[:, None].astype(np.float64)
    v = np.arange(dmax + 1)[None, :].astype(np.float64)
    wp = np.exp(gammaln(np.maximum(u, 1)) + gammaln(v + 1) - gammaln(u + v + 1))
    wm = np.exp(gammaln(u + 1) + gammaln(np.maximum(v, 1)) - gammaln(u + v + 1))
    wp[0, :] = 0.0
    wm[:, 0] = 0.0
    return wp.astype(np.float32), wm.astype(np.float32)


def _interaction_tables(dmax: int):
    """``(W_uu, W_vv, W_uv)`` for u, v <= dmax: the pairwise interaction
    weights ``(u-2)! v! / (u+v-1)!`` (0 for u < 2), ``u! (v-2)! /
    (u+v-1)!`` (0 for v < 2) and ``-(u-1)! (v-1)! / (u+v-1)!`` (0 unless
    u, v >= 1), in float64 via ``gammaln`` — the oracle the kernel's weights
    are held to."""

    from scipy.special import gammaln

    u = np.arange(dmax + 1)[:, None].astype(np.float64)
    v = np.arange(dmax + 1)[None, :].astype(np.float64)
    lg_uv = gammaln(np.maximum(u + v, 1.0))
    w_uu = np.exp(gammaln(np.maximum(u - 1.0, 1.0)) + gammaln(v + 1.0) - lg_uv)
    w_vv = np.exp(gammaln(u + 1.0) + gammaln(np.maximum(v - 1.0, 1.0)) - lg_uv)
    w_uv = -np.exp(gammaln(np.maximum(u, 1.0)) + gammaln(np.maximum(v, 1.0))
                   - lg_uv)
    w_uu[u[:, 0] < 2, :] = 0.0
    w_vv[:, v[0] < 2] = 0.0
    w_uv[u[:, 0] < 1, :] = 0.0
    w_uv[:, v[0] < 1] = 0.0
    return (w_uu.astype(np.float32), w_vv.astype(np.float32),
            w_uv.astype(np.float32))


def _unsat(pred, rows, onpath, want_left):
    """``unsat[r, t, l, j]``: on-path node ``j`` of leaf ``(t, l)`` whose
    branch row ``r`` does NOT take (0 off-path)."""

    gl = pred._split_conditions(rows).to(torch.float32)     # (R, T, Nn)
    return onpath[None] * (gl[:, :, None, :] - want_left[None]).abs()


def _chunked_rows(fn, rows, chunk: int, n: int):
    """Apply per-row ``fn`` over ``rows`` in ``chunk``-row blocks (rows are
    independent in every reach computation, so chunking is numerically
    invariant); ``fn`` returns a tensor or a tuple of tensors."""

    if chunk >= n:
        return fn(rows)
    parts = [fn(rows[i:i + chunk]) for i in range(0, n, chunk)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def _row_chunk(n: int, pred, M: int, target_chunk_elems: Optional[int]) -> int:
    """Rows per chunk bounding the transient ``(chunk, T, L, Nn)`` unsat
    tensor by ``target_chunk_elems`` (``None``: one pass)."""

    if not target_chunk_elems:
        return n
    T, L, Nn = pred.path_sign.shape
    return max(1, min(n, int(target_chunk_elems) // max(1, T * L * max(Nn, M))))


def background_reach(pred, bg, G, target_chunk_elems: Optional[int] = None):
    """Background-side reach tensors, computed once per (background, G):
    ``z_ok (N, T, L, M)`` per-group satisfaction, ``z_ung_dead (N, T, L)``
    (bool) leaves a background row already kills through a split on an
    UNGROUPED column (ungrouped columns stay at their background values in
    every coalition), and ``onpath_g (T, L, M)``.  ``target_chunk_elems``
    bounds the transient ``(chunk, T, L, Nn)`` tensor by chunking the rows."""

    pred, _ = _unwrap(pred)
    bg = bg.to(torch.float32)
    G = G.to(torch.float32)
    sign = pred.path_sign
    onpath = sign.abs()
    want_left = (sign > 0).to(torch.float32)
    GH = G.T[pred.feature]                                   # (T, Nn, M)
    ung_node = (GH.sum(-1) < 0.5).to(torch.float32)         # (T, Nn)
    onpath_g = (torch.einsum("tlj,tjg->tlg", onpath, GH) > 0.5).to(torch.float32)

    def rows_reach(rows):
        uz = _unsat(pred, rows, onpath, want_left)         # (c, T, L, Nn)
        z_ok = (torch.einsum("ntlj,tjg->ntlg", uz, GH) < 0.5).to(torch.float32)
        z_ung_dead = torch.einsum("ntlj,tj->ntl", uz, ung_node) > 0.5
        return z_ok, z_ung_dead

    N = bg.shape[0]
    z_ok, z_ung_dead = _chunked_rows(
        rows_reach, bg, _row_chunk(N, pred, G.shape[0], target_chunk_elems), N)
    return {"z_ok": z_ok, "z_ung_dead": z_ung_dead, "onpath_g": onpath_g}


def pad_background(z_ok, z_ung_dead, bgw, multiple: int):
    """Pad the background axis of the reach tensors to a whole number of
    ``multiple``-row blocks with ZERO-WEIGHT rows (reference
    ``ops/treeshap.py:310-327``): ``z_ok`` pads with ones (the row looks
    alive — a zero would interact with the dead-group count) and the weight
    of 0 makes its contribution to phi and to the interactions exactly 0.
    The background-sharded exact path (``parallel/distributed.py``) uses it
    to split the background evenly over the coalition axis."""

    N = z_ok.shape[0]
    pad = (-N) % multiple
    if not pad:
        return z_ok, z_ung_dead, bgw
    z_ok_p = torch.cat([z_ok, z_ok.new_ones((pad,) + tuple(z_ok.shape[1:]))], 0)
    z_ung_p = torch.cat([z_ung_dead,
                         z_ung_dead.new_zeros((pad,) + tuple(z_ung_dead.shape[1:]))], 0)
    bgw_p = torch.cat([bgw, bgw.new_zeros((pad,))], 0)
    return z_ok_p, z_ung_p, bgw_p


def _x_reach(pred, X, G, onpath_g, target_chunk_elems: Optional[int] = None):
    """Instance-side reach indicators ``(x_only, x_not)``, each ``(B, T, L,
    M)``: the groups ``x`` satisfies / fails on each path."""

    sign = pred.path_sign
    onpath = sign.abs()
    want_left = (sign > 0).to(torch.float32)
    GH = G.T[pred.feature]

    def rows_ok(rows):
        ux = _unsat(pred, rows, onpath, want_left)
        return (torch.einsum("btlj,tjg->btlg", ux, GH) < 0.5).to(torch.float32)

    B = X.shape[0]
    x_ok = _chunked_rows(rows_ok, X,
                         _row_chunk(B, pred, G.shape[0], target_chunk_elems), B)
    return x_ok * onpath_g[None], (1.0 - x_ok) * onpath_g[None]


def _exact_dmax(pred, M: int) -> int:
    """Bound on the conjunction counts ``u + v``: a leaf's relevant groups
    cannot exceed its on-path node count or the group count."""

    onpath_nodes = int(pred.path_sign.abs().sum(-1).max())
    return max(1, min(int(M), onpath_nodes))


def _kernel_args(xo, xn, zo, zd, lv, bgw):
    """The kernels' six inputs, contiguous, ``z_dead`` as 0/1 floats."""

    return (xo.contiguous(), xn.contiguous(), zo.contiguous(),
            zd.to(torch.float32).contiguous(), lv.contiguous(), bgw.contiguous())


def _phi_call(xo, xn, zo, zd, lv, bgw, dmax: int, use_kernel: bool):
    """One contraction: the kernel's wrapper (which runs the plain version
    for CPU tensors) or, with ``use_kernel=False``, the plain version."""

    args = _kernel_args(xo, xn, zo, zd, lv, bgw)
    if use_kernel:
        record_kernel_path("exact_phi", "cuda" if xo.is_cuda else "plain")
        return exact_tree_phi(*args, dmax=dmax)
    record_kernel_path("exact_phi", "plain")
    return exact_tree_phi_plain(*args, dmax=dmax)


def _inter_call(xo, xn, zo, zd, lv, bgw, dmax: int, use_kernel: bool):
    """:func:`_phi_call`'s twin for the raw pairwise sum ``(B, M, M, K)``."""

    args = _kernel_args(xo, xn, zo, zd, lv, bgw)
    if use_kernel:
        record_kernel_path("exact_inter", "cuda" if xo.is_cuda else "plain")
        return exact_tree_inter(*args, dmax=dmax)
    record_kernel_path("exact_inter", "plain")
    return exact_tree_inter_plain(*args, dmax=dmax)


def _finish_phi(tree, phi, head_scale: float):
    """Scale (learning rate), forest mean and the ``(B, K, M)`` layout."""

    phi = phi * (tree.scale * head_scale)
    if tree.aggregation == "mean":
        phi = phi / tree.n_trees
    return phi.transpose(1, 2)


def _dense_inputs(tree, X, reach, G, target_chunk_elems: Optional[int]):
    """The kernels' dense inputs for ``X``: ``x_only/x_not (B, P, M)``,
    ``z_ok (N, P, M)``, ``z_dead (N, P)`` and ``leaf_val (P, K)`` over all
    ``P = T·L`` paths, and ``dmax``."""

    T, L, _ = tree.path_sign.shape
    M = int(G.shape[0])
    B = X.shape[0]
    N = reach["z_ok"].shape[0]
    P = T * L
    x_only, x_not = _x_reach(tree, X, G, reach["onpath_g"], target_chunk_elems)
    return ((x_only.reshape(B, P, M), x_not.reshape(B, P, M),
             reach["z_ok"].reshape(N, P, M), reach["z_ung_dead"].reshape(N, P),
             tree.leaf_value.reshape(P, -1)), _exact_dmax(tree, M))


def exact_shap_from_reach(pred, X, reach, bgw, G, normalized: bool = False,
                          target_chunk_elems: Optional[int] = None,
                          use_kernel: Optional[bool] = None):
    """Exact phi ``(B, K, M)`` for ``X`` on the dense path layout, given
    :func:`background_reach`'s tensors: one ``exact_tree_phi`` call over all
    ``T·L`` paths and the whole background.  ``normalized=True`` skips the
    weight normalisation (the caller normalised globally)."""

    tree, head_scale = _unwrap(pred)
    X = X.to(torch.float32)
    bgw = bgw.to(torch.float32)
    if not normalized:
        bgw = bgw / bgw.sum()
    G = G.to(torch.float32)
    args, dmax = _dense_inputs(tree, X, reach, G, target_chunk_elems)
    phi = _phi_call(*args, bgw, dmax, resolve_use_kernel(use_kernel, X.device))
    return _finish_phi(tree, phi, head_scale)


def exact_shap_and_interactions(pred, X, reach, bgw, G, normalized: bool = False,
                                target_chunk_elems: Optional[int] = None,
                                use_kernel: Optional[bool] = None):
    """Exact phi ``(B, K, M)`` and Shapley **interaction** values ``(B, K,
    M, M)`` for ``X`` on the dense path layout, from one :func:`_x_reach`:
    one ``exact_tree_phi`` and one ``exact_tree_inter`` call.

    The matrices follow the shap TreeExplainer convention: symmetric,
    off-diagonal ``[i, j]`` carries half the pairwise interaction index
    ``I_ij`` (the other half sits at ``[j, i]``), and the diagonal absorbs
    the rest of the main effect, so each row sums to ``phi_i`` and the
    matrix to ``f(x) - E[f]``.  Raises above 64 groups, as the reference."""

    M = int(G.shape[0])
    if M > 64:
        raise ValueError(
            f"exact interactions scale as M x the main-effect pass; M={M} "
            "groups is beyond the supported 64")
    tree, head_scale = _unwrap(pred)
    X = X.to(torch.float32)
    bgw = bgw.to(torch.float32)
    if not normalized:
        bgw = bgw / bgw.sum()
    G = G.to(torch.float32)
    kernel = resolve_use_kernel(use_kernel, X.device)
    args, dmax = _dense_inputs(tree, X, reach, G, target_chunk_elems)
    phi = _finish_phi(tree, _phi_call(*args, bgw, dmax, kernel), head_scale)
    inter = _inter_call(*args, bgw, dmax, kernel) * (tree.scale * head_scale)
    if tree.aggregation == "mean":
        inter = inter / tree.n_trees
    inter = inter.permute(0, 3, 1, 2)           # (B, K, M, M)
    # the raw sum pairs every (g, h), g == h included; the diagonal of the
    # pairwise index is not defined, and the shap convention replaces it
    # with the residual main effect
    eye = torch.eye(M, dtype=inter.dtype, device=inter.device)
    off = inter * (1.0 - eye) * 0.5
    diag = phi - off.sum(-1)
    return phi, off + diag[..., None] * eye


def exact_interactions_from_reach(pred, X, reach, bgw, G, normalized: bool = False,
                                  target_chunk_elems: Optional[int] = None,
                                  use_kernel: Optional[bool] = None):
    """Exact Shapley interaction values ``(B, K, M, M)`` for ``X`` given
    :func:`background_reach`'s tensors (see
    :func:`exact_shap_and_interactions`, which also returns phi)."""

    return exact_shap_and_interactions(
        pred, X, reach, bgw, G, normalized=normalized,
        target_chunk_elems=target_chunk_elems, use_kernel=use_kernel)[1]


def build_packed_plan(pred, G, tile: Optional[int] = None, shards: int = 1):
    """Host-side packed-path plan for ``pred``'s path tensors, or ``None``
    when the predictor has none."""

    tree, _ = _unwrap(pred)
    if getattr(tree, "path_sign", None) is None:
        return None
    counts = leaf_group_counts(tree.path_sign.cpu().numpy(),
                               tree.feature.cpu().numpy(), np.asarray(G))
    return plan_packed_paths(counts, tile=tile or DEFAULT_TILE,
                             shards=max(1, int(shards)))


def resolve_pack_paths(pack_paths: Optional[bool], plan) -> bool:
    """``ShapConfig.pack_paths`` against a plan: ``None`` = auto (pack when
    the modelled work saving clears ``PACK_AUTO_GAIN``), bools win."""

    if plan is None or plan.n_live == 0:
        return False
    if pack_paths is None:
        return plan.gain >= PACK_AUTO_GAIN
    return bool(pack_paths)


def pack_reach(pred, reach, plan):
    """Gather the dense reach tensors into the plan's packed path layout:
    ``z_ok (N, Pp, M)``, ``z_dead (N, Pp)`` (bool; pad slots forced dead),
    ``lv (Pp, K)`` (pad slots zeroed), ``perm (Pp,)`` and ``live (Pp,)``.
    X-independent: the engine computes it once per fit."""

    tree, _ = _unwrap(pred)
    dev = reach["z_ok"].device
    perm = torch.as_tensor(plan.perm, dtype=torch.int64, device=dev)
    live = torch.as_tensor(plan.live, device=dev)
    z_ok = reach["z_ok"]
    N, T, L, M = z_ok.shape
    K = tree.leaf_value.shape[-1]
    z_ok_p = z_ok.reshape(N, T * L, M)[:, perm]
    z_dead_p = reach["z_ung_dead"].reshape(N, T * L)[:, perm] | ~live[None, :]
    lv_p = tree.leaf_value.reshape(T * L, K)[perm] * live[:, None].to(torch.float32)
    return {"z_ok": z_ok_p, "z_dead": z_dead_p, "lv": lv_p,
            "perm": perm, "live": live.to(torch.float32)}


def exact_shap_packed(pred, X, onpath_g, packed, bgw, G, buckets,
                      normalized: bool = False,
                      target_chunk_elems: Optional[int] = None,
                      use_kernel: Optional[bool] = None):
    """Exact phi ``(B, K, M)`` over a packed path layout: one
    ``exact_tree_phi`` call per depth bucket ``(start, stop, dmax)`` with
    the bucket's tight ``dmax``, partial phi summed in bucket order."""

    tree, head_scale = _unwrap(pred)
    X = X.to(torch.float32)
    bgw = bgw.to(torch.float32)
    if not normalized:
        bgw = bgw / bgw.sum()
    G = G.to(torch.float32)
    T, L, _ = tree.path_sign.shape
    M = int(G.shape[0])
    B = X.shape[0]
    kernel = resolve_use_kernel(use_kernel, X.device)
    x_only, x_not = _x_reach(tree, X, G, onpath_g, target_chunk_elems)
    xo = x_only.reshape(B, T * L, M)
    xn = x_not.reshape(B, T * L, M)
    perm = packed["perm"]
    phi = None
    for start, stop, dmax in buckets:
        idx = perm[start:stop]
        part = _phi_call(xo[:, idx], xn[:, idx], packed["z_ok"][:, start:stop],
                         packed["z_dead"][:, start:stop], packed["lv"][start:stop],
                         bgw, int(dmax), kernel)
        phi = part if phi is None else phi + part
    return _finish_phi(tree, phi, head_scale)


def exact_tree_shap(pred, X, bg, bgw, G):
    """Exact interventional Shapley values of ``pred``'s raw margin, dense
    layout: ``X (B, D)`` instances, ``bg (N, D)`` background rows with
    weights ``bgw (N,)`` (normalised here), ``G (M, D)`` the 0/1 group
    matrix, all tensors on one device.  Returns ``shap_values (B, K, M)``,
    ``expected_value (K,)`` and ``raw_prediction (B, K)``."""

    if not supports_exact(pred):
        raise ValueError(
            "exact_tree_shap needs a lifted TreeEnsemblePredictor with "
            "out_transform='identity' and path tensors")
    X = X.to(torch.float32)
    bg = bg.to(torch.float32)
    bgw_n = bgw.to(torch.float32) / bgw.sum()
    with torch.no_grad():
        reach = background_reach(pred, bg, G)
        phi = exact_shap_from_reach(pred, X, reach, bgw_n, G, normalized=True)
        return {
            "shap_values": phi,
            "expected_value": torch.einsum("nk,n->k", pred(bg), bgw_n),
            "raw_prediction": pred(X),
        }
