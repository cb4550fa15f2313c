"""Sampling-free exact Shapley values for tensor-train predictors.

Port of ``distributedkernelshap_tpu/ops/tensor_shap.py``.  For a predictor
with tensor-train structure (``models/tensor_net.py``: ``f(x) = e0 ·
Π_i (A_i + x_i B_i) · head``) the interventional Shapley values that
KernelSHAP estimates by sampling have a closed form ("SHAP Meets Tensor
Networks", arXiv:2510.21599):

* **Per background row the game is a product game.**  With ``P_i = A_i +
  x_i B_i`` (site ``i`` in the coalition) and ``Q_i = A_i + z_i B_i`` (from
  background row ``z``), the composite model value is the ordered product
  ``e0 · Π_i C_i · head``, ``C_i ∈ {P_i, Q_i}``.  Shapley values are linear
  in the game, so ``phi = Σ_n w_n phi_n``.

* **Size-indexed DP instead of 2^M enumeration.**  Carrying one
  accumulator per coalition size,

      L_j(a) = Σ_{S ⊆ {0..j-1}, |S|=a} e0 · Π_{i<j} C_i          (1, r)
      T_j(b) = Σ_{S ⊆ {j+1..M-1}, |S|=b} Π_{i>j} C_i · head      (r, K)

  with ``L_{j+1}(a) = L_j(a-1) P_j + L_j(a) Q_j`` and the mirrored suffix
  recursion, then

      phi_j = Σ_{a,b} w_{a+b} L_j(a) (P_j - Q_j) T_j(b),   w_s = s!(M-1-s)!/M!

  in ``O(M² r² K)`` per (instance, background row).

The reference scans sites with ``lax.scan``, ``vmap``s instances and
``lax.map``s background rows.  Here the sites are a Python loop of batched
matmuls over (background-row chunk, instance, size) at once; the forward
sweep keeps only ``L_j (P_j - Q_j)`` with the size weights folded in, and
the reverse sweep contracts each ``T_j`` as it forms, so the live state of
a chunk of ``n`` rows is ``n·B·M²·r`` floats plus one sweep's carries.
The rows are chunked to the ``target_chunk_elems`` budget; the weighted row
sum is one contraction over the stacked per-row phi ``(N, B, K, M)``, as
in the reference.  The DP is plain PyTorch (the JAX package computes it
outside any Pallas kernel), under full f32 matmuls.

Scope: identity link, identity grouping (each feature group one tensor
site, in column order) and raw TT outputs; the gates and fallback reasons
are the reference's.  The ``dks_tensor_shap_fallback_total`` metric
(``attach_tensor_shap_metrics``) waits for the metrics registry (ROADMAP.md
queue A item 12); the counts are kept here.
"""

import logging
import threading
from math import factorial
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from distributedkernelshap_tpu_torch.ops.explain import record_kernel_path
from distributedkernelshap_tpu_torch.utils import full_f32_matmul

logger = logging.getLogger(__name__)

_fallback_lock = threading.Lock()
_fallback_counts: Dict[str, float] = {}
_fallback_logged: set = set()

#: rank ceiling for the serving auto-selection: past this the O(M²r²K) DP
#: stops being obviously cheaper than the sampled estimator; pin
#: ``nsamples='exact'`` to force the path anyway
TN_MAX_RANK = 64

#: nominal batch size of the X-independent footprint gate (it runs before
#: any request batch exists)
_NOMINAL_GATE_B = 256


def record_tn_fallback(reason: str, detail: str = "") -> None:
    """Count one tensor-network exact-path demotion; warn on the first of
    each reason."""

    with _fallback_lock:
        _fallback_counts[reason] = _fallback_counts.get(reason, 0.0) + 1.0
        first = reason not in _fallback_logged
        if first:
            _fallback_logged.add(reason)
    if first:
        logger.warning(
            "exact tensor-network Shapley declined a TT-structured predictor "
            "(reason=%s%s); further occurrences are counted silently "
            "(tn_fallback_counts)", reason, f": {detail}" if detail else "")


def tn_fallback_counts() -> Dict[Tuple[str, ...], float]:
    """``{(reason,): count}`` — the registry-callback shape."""

    with _fallback_lock:
        return {(r,): n for r, n in _fallback_counts.items()}


# ---------------------------------------------------------------------- #
# Structure probes and gates


def tt_structure(pred) -> Optional[Dict]:
    """The predictor's padded tensor-train structure (``A``/``B`` ``(M, r,
    r)``, ``head (r, K)``, ``rank``, ``M``, ``K``; ``models/tensor_net.py``)
    or ``None`` when it has none.  Duck-typed on the ``tt_structure``
    method."""

    fn = getattr(pred, "tt_structure", None)
    if fn is None:
        return None
    try:
        return fn()
    except Exception:  # a broken structure probe must never crash a path
        logger.debug("tt_structure probe failed", exc_info=True)
        return None


def supports_exact_tn(pred) -> bool:
    """Whether ``pred`` carries tensor-train structure with raw (identity)
    outputs — the structural precondition of the exact contraction (the
    other gates: :func:`tn_exact_ready`)."""

    return (tt_structure(pred) is not None
            and getattr(pred, "out_transform", "identity") == "identity")


def _grouping_is_identity(G) -> bool:
    G = np.asarray(G)
    return (G.shape[0] == G.shape[1]
            and np.array_equal(G, np.eye(G.shape[0], dtype=G.dtype)))


def tn_exact_ready(pred, link: str, G,
                   target_chunk_elems: Optional[int] = None) -> Optional[str]:
    """``None`` when the exact tensor-network path can serve this
    (predictor, link, grouping), else the fallback reason: ``'structure'``,
    ``'link'``, ``'grouping'``, ``'rank'`` or ``'footprint'``."""

    struct = tt_structure(pred)
    if struct is None or getattr(pred, "out_transform", "identity") != "identity":
        return "structure"
    if link != "identity":
        return "link"
    if not _grouping_is_identity(G):
        return "grouping"
    r, M, K = struct["rank"], struct["M"], struct["K"]
    if r > TN_MAX_RANK:
        return "rank"
    # footprint gate: one background row's DP intermediates at the nominal
    # batch must fit the chunk budget every other path honours
    budget = target_chunk_elems or (1 << 25)
    if _NOMINAL_GATE_B * M * M * r * (max(K, 1) + 1) > budget:
        return "footprint"
    return None


def validate_exact_tn(pred, link: str, G) -> None:
    """Raise with an actionable message when ``nsamples='exact'`` cannot run
    the tensor-network contraction for this configuration."""

    reason = tn_exact_ready(pred, link, G)
    if reason is None:
        return
    detail = {
        "structure": "the predictor exposes no tensor-train structure "
                     "(lift it via models/tensor_net.py)",
        "link": f"link={link!r} would change the target quantity; the "
                "contraction explains the raw TT output — use "
                "link='identity'",
        "grouping": "the contraction treats each feature group as one "
                    "tensor site in column order; non-identity groupings "
                    "stay on the sampled path",
        "rank": f"TT rank exceeds TN_MAX_RANK={TN_MAX_RANK}; pin a "
                "sampled nsamples or refit a lower-rank surrogate",
        "footprint": "the size-indexed DP intermediates exceed the chunk "
                     "budget at this (M, rank); use the sampled path",
    }[reason]
    raise ValueError(
        f"nsamples='exact' (tensor-network contraction) cannot apply: {detail}.")


# ---------------------------------------------------------------------- #
# Shapley size weights (host, exact integer arithmetic)


def shapley_size_weights(M: int) -> np.ndarray:
    """``(M,)`` float32: ``w_s = s! (M-1-s)! / M!`` for ``s = 0..M-1``,
    computed with Python integers and rounded once to float32."""

    if M < 1:
        raise ValueError(f"Need at least one site, got M={M}")
    fM = factorial(M)
    w = [factorial(s) * factorial(M - 1 - s) / fM for s in range(M)]
    return np.asarray(w, dtype=np.float32)


def weight_toeplitz(M: int) -> np.ndarray:
    """``(M, M)`` float32 table ``Wt[a, b] = w_{a+b}`` (0 past ``M-1``): the
    prefix-size × suffix-size weight the DP contracts against."""

    w = shapley_size_weights(M)
    idx = np.arange(M)[:, None] + np.arange(M)[None, :]
    return np.where(idx < M, w[np.minimum(idx, M - 1)], 0.0).astype(np.float32)


# ---------------------------------------------------------------------- #
# The size-indexed DP contraction


def _rows_per_chunk(B: int, M: int, r: int, K: int,
                    target_chunk_elems: Optional[int]) -> int:
    """Background rows per DP chunk: the stacked forward terms (``B·M²·r``
    a row) and the sweeps' carries (``B·M·r·(3K + 3)``) within the budget,
    at least one row."""

    per_row = B * M * (M * r + 3 * r * (K + 1))
    return max(1, (target_chunk_elems or (1 << 25)) // max(per_row, 1))


def _phi_chunk(A, Bc, head, Wt, X, Z):
    """Exact phi ``(n, B, K, M)`` of the product games of instances ``X (B,
    M)`` against background rows ``Z (n, M)``.

    Forward sweep: the size-indexed prefix ``L (n, B, S, r)`` before site
    ``j`` gives the marginal's left factor ``L (P_j - Q_j)``, kept with the
    size weights folded in (``Ajw``); then ``L`` moves past site ``j``.
    Reverse sweep: the suffix ``T (n, B, S, r, K)`` after site ``j`` is
    contracted with ``Ajw[j]`` as it forms, then moves before site ``j``.
    A size index shifts by one where the site joins the coalition (the
    ``P`` branch)."""

    M, r, _ = A.shape
    K = head.shape[1]
    Bx, n = X.shape[0], Z.shape[0]
    P = A[:, None] + X.T[:, :, None, None] * Bc[:, None]      # (M, B, r, r)
    Q = A[:, None] + Z.T[:, :, None, None] * Bc[:, None]      # (M, n, r, r)

    # letters: n background row, i instance, a prefix size, c suffix size,
    # r/s ranks, k output
    L = X.new_zeros((n, Bx, M, r))
    L[:, :, 0, 0] = 1.0                                        # e0, size 0
    Ajw = []
    for j in range(M):
        LP = torch.einsum("niar,irs->nias", L, P[j])
        LQ = torch.einsum("niar,nrs->nias", L, Q[j])
        Ajw.append(torch.einsum("ac,nias->nics", Wt, LP - LQ))
        if j + 1 < M:
            L = LQ
            L[:, :, 1:] += LP[:, :, :-1]

    phi = X.new_empty((n, Bx, K, M))
    T = X.new_zeros((n, Bx, M, r, K))
    T[:, :, 0] = head                                          # size 0: head
    for j in range(M - 1, -1, -1):
        phi[..., j] = torch.einsum("nics,nicsk->nik", Ajw[j], T)
        if j > 0:
            PT = torch.einsum("irs,nicsk->nicrk", P[j], T)
            T = torch.einsum("nrs,nicsk->nicrk", Q[j], T)
            T[:, :, 1:] += PT[:, :, :-1]
    return phi


def tn_phi_rows(A, B, head, Wt, X, Z, target_chunk_elems: Optional[int] = None):
    """Per-background-row exact phi ``(N, B, K, M)``: the rows in chunks of
    :func:`_rows_per_chunk`, so one chunk's DP intermediates are live at a
    time."""

    record_kernel_path("exact_phi", "tn_dp")
    M, r, _ = A.shape
    chunk = _rows_per_chunk(X.shape[0], M, r, head.shape[1], target_chunk_elems)
    with full_f32_matmul():
        return torch.cat([_phi_chunk(A, B, head, Wt, X, Z[i:i + chunk])
                          for i in range(0, Z.shape[0], chunk)])


def tensor_shap_phi(A, B, head, Wt, X, Z, bgw_n,
                    target_chunk_elems: Optional[int] = None):
    """Exact Shapley values ``(B, K, M)`` of the TT predictor for the batch
    ``X`` against the (weight-normalised) background ``Z`` / ``bgw_n``: one
    contraction of the stacked per-row phi, as in the reference."""

    X = X.to(torch.float32)
    Z = Z.to(torch.float32)
    rows = tn_phi_rows(A, B, head, Wt, X, Z, target_chunk_elems)   # (N, B, K, M)
    with full_f32_matmul():
        return torch.einsum("n,nbkm->bkm", bgw_n, rows)
