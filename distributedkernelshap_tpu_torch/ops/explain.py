"""The KernelSHAP pipeline in PyTorch: masked evaluation + constrained WLS.

Port of ``distributedkernelshap_tpu/ops/explain.py``:

1. ``ey[b,s,k] = Σ_n bgw[n] · f(x_b ⊙ z_s + bg_n ⊙ (1-z_s))[k]`` by one of
   three routes (``build_explainer_fn``): for logits-linear predictors the
   group masks stay in group space (the model's matmul is pushed through
   the mask, so the ``B×S×N×D`` synthetic-data tensor never exists) and the
   reduction runs in the hand-written CUDA kernel ``fused_linear_ey``
   (``ops/cuda_kernels.py``) or its plain, chunked PyTorch version; tree
   ensembles, MLPs, SVMs and forwarding compositions take their
   structure-aware ``masked_ey`` (a linear member's runs ``_ey_linear``,
   so it launches the kernel too); any other
   predictor the row-materialising ``_ey_generic``;
2. the link, and the expected value over the background;
3. the Shapley-kernel weighted least squares with the additivity constraint
   eliminated by substitution, with one Cholesky factor shared by all
   ``B·K`` right-hand sides (NaN where the Gram matrix is not positive
   definite, as in the reference, and with no host sync);
4. the plan-constant pair (``build_linear_plan_consts_fn`` /
   ``build_linear_cached_fn``): what depends only on (model, background,
   plan) computed once, so a request pays only its ``B×S×K`` work and a
   triangular solve;
5. ``pack_transfer`` / ``unpack_transfer``: phi, E[f] and f(x) in one
   device buffer, so the result comes back in one copy.

Matrix products run in full float32 as long as PyTorch's float32 matmul
precision is left at its default ("highest": no TF32), which is the
reference's ``matmul_precision="highest"``.  The coalition axis is a Python
loop of chunks (JAX's ``lax.map``); PyTorch runs eagerly, so there is no jit.
"""

import contextvars
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from distributedkernelshap_tpu_torch.models.predictors import ACTIVATIONS, BasePredictor
from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
    fused_linear_ey,
    fused_linear_ey_plain,
)
from distributedkernelshap_tpu_torch.ops.links import convert_to_link
from distributedkernelshap_tpu_torch.profiling import span

# ---------------------------------------------------------------------- #
# Kernel-path recording: every result must say which evaluation route ran.
# Tags: 'ey' (sampled masked eval), 'exact_phi' (exact TreeSHAP).  Paths:
# 'cuda' (the kernel launched), 'plain' (the kernel's plain version: CPU
# tensors, or use_kernel=False), 'einsum' ('ey' with the identity
# activation: the background axis collapses analytically), 'einsum_cached'
# (the plan-constant path, build_linear_cached_fn), 'masked_ey' (a
# predictor's structure-aware masked evaluation), 'generic' (row
# materialisation).  Recorded where the route is taken, on every call; the
# engine adds 'host' for 'ey' and 'host_fill' ('native' | 'numpy') on its
# host-eval path.

_KERNEL_PATHS: contextvars.ContextVar = contextvars.ContextVar(
    "dks_torch_kernel_paths", default=None)


class capture_kernel_paths:
    """Context manager collecting the ``{tag: path}`` choices made inside it."""

    def __enter__(self):
        self._d: dict = {}
        self._token = _KERNEL_PATHS.set(self._d)
        return self._d

    def __exit__(self, *exc):
        _KERNEL_PATHS.reset(self._token)
        return False


def record_kernel_path(tag: str, path: str) -> None:
    """Record a kernel choice into the active capture (no-op without one)."""

    d = _KERNEL_PATHS.get()
    if d is not None:
        d[tag] = path


def shared_program_key(model) -> Optional[str]:
    """Digest under which two registered tenants' dispatches run the
    IDENTICAL device program over IDENTICAL device constants — the
    shared-padded-program gate of cross-tenant continuous batching
    (reference ``ops/explain.py:83-143``).

    Two deployments whose keys MATCH may have their request rows
    coalesced into ONE padded device call (per-leader ``split_sizes``
    carry the tenant boundaries): because every engine path has per-row
    reduction scope (each request's phi is a function of its own rows
    plus X-independent constants only — no cross-row reductions), and
    the program + constants are bit-equal by construction of this key,
    the coalesced call's per-slot phi is bit-identical to a dedicated
    dispatch at the same padded bucket.

    The digest covers the engine's content fingerprint (predictor
    parameters, background, weights, grouping, link, ridge), the FULL
    engine config (seed drives coalition sampling; the device, host
    eval, the kernel choice, chunking and bucketing change the program),
    the pinned explain kwargs (``nsamples`` selects the plan) and the
    explainer/engine class names.  Returns ``None`` for deployments that
    must never share (the eligibility gate lives in
    ``registry/classify.share_eligible``)."""

    import hashlib

    from distributedkernelshap_tpu_torch.registry.classify import share_eligible
    from distributedkernelshap_tpu_torch.scheduling.result_cache import (
        predictor_fingerprint,
    )

    engine = share_eligible(model)
    if engine is None:
        return None
    try:
        content = engine.content_fingerprint()
        # content_fingerprint falls back to repr(type(predictor)) for
        # predictors with no linear decomposition / fingerprint_bytes —
        # NOT content identity (two differently-fitted tree ensembles on
        # the same background would collide, and a collision here means
        # serving tenant B with tenant A's model).  Close the hole with
        # the strong/weak-aware parameter hash: weak (host callbacks,
        # stubs) ⇒ never share.
        pred_digest, weak = predictor_fingerprint(engine.predictor)
        if weak:
            return None
    except Exception:
        return None
    h = hashlib.sha256()
    h.update(content.encode())
    h.update(pred_digest.encode())
    h.update(repr(engine.config).encode())
    h.update(repr(sorted(
        (getattr(model, "explain_kwargs", None) or {}).items())).encode())
    explainer = getattr(model, "explainer", None)
    inner = getattr(explainer, "_explainer", None)
    h.update(type(explainer).__name__.encode())
    h.update(type(inner).__name__.encode())
    return h.hexdigest()


@dataclass(frozen=True)
class ShapConfig:
    """Static configuration of the explain pipeline."""

    link: str = "identity"
    ridge: float = 1e-6
    # target element count of the per-chunk synthetic tensor (f32: 4 bytes/el)
    target_chunk_elems: int = 1 << 25
    coalition_chunk: Optional[int] = None  # override auto chunking
    # the hand-written CUDA kernels (fused_linear_ey on the linear masked
    # eval, exact_tree_phi on the exact tree path): None = on for CUDA
    # tensors, off elsewhere; True on CPU tensors runs the kernel's plain
    # version; False runs the plain version on any device
    use_kernel: Optional[bool] = None
    # exact TreeSHAP path layout: None = auto (packed when the planner's
    # modelled gain clears treeshap_pack.PACK_AUTO_GAIN), True/False force
    # the packed/dense layout
    pack_paths: Optional[bool] = None
    # dtype of phi in the packed result copied to the host (pack_transfer):
    # None keeps float32; 'float16' or 'bfloat16' halve phi's bytes at the
    # cost of its rounding (E[f] and f(x) stay float32 either way)
    transfer_dtype: Optional[str] = None


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown transfer_dtype {name!r}")
    return dtype


def pack_transfer(wide, narrow, transfer_dtype):
    """Pack a device result into ONE tensor for a single device-to-host
    copy, casting only the dominant segment to ``transfer_dtype``
    (reference ``ops/explain.py:183-208``).

    ``wide`` is the segment that dominates the copy (phi); ``narrow`` the
    small remainder (E[f(x)] and f(x): K and B·K floats), kept float32 so
    its rounding does not inflate the reported additivity error.  For a
    16-bit ``transfer_dtype`` both segments are reinterpreted as 16-bit
    words (the wide one in that dtype, the narrow one as float32 bit
    patterns), so the copy stays one tensor with the reference's byte
    layout.  :func:`fetch_transfer` copies it to the host and
    :func:`unpack_transfer` is the host-side inverse."""

    wide = wide.reshape(-1)
    narrow = narrow.reshape(-1).to(torch.float32)
    if not transfer_dtype:
        return torch.cat([wide.to(torch.float32), narrow])
    td = _torch_dtype(transfer_dtype)
    if torch.empty(0, dtype=td).element_size() != 2:
        return torch.cat([wide.to(td), narrow.to(td)])
    return torch.cat([wide.to(td).view(torch.int16), narrow.view(torch.int16)])


def fetch_transfer(packed: torch.Tensor) -> np.ndarray:
    """The one device-to-host copy of a :func:`pack_transfer` result (it
    waits for the device), a ``phase.fetch_transfer`` span (its
    ``bytes``); 16-bit words come back as ``np.uint16``, the reference's
    host dtype."""

    with span("phase.fetch_transfer") as sp:
        host = packed.cpu().numpy()
        if sp is not None:
            sp.annotate(bytes=host.nbytes)
    return host.view(np.uint16) if host.dtype == np.int16 else host


def unpack_transfer(flat: np.ndarray, n_wide: int, transfer_dtype) -> tuple:
    """Host-side inverse of :func:`pack_transfer` (reference
    ``ops/explain.py:211-228``): ``(wide_f32, narrow_f32)`` 1-D arrays from
    the fetched copy ``flat``, whose wide segment has ``n_wide`` elements.
    bfloat16 is widened exactly by moving its bits into the top half of a
    float32 (numpy has no bfloat16).  A ``phase.unpack_transfer`` span (its
    ``elements``: the copy's)."""

    flat = np.asarray(flat)
    with span("phase.unpack_transfer", elements=flat.size):
        if flat.dtype != np.uint16:
            flat = flat.astype(np.float32, copy=False)
            return flat[:n_wide], flat[n_wide:]
        if str(transfer_dtype) == "bfloat16":
            wide = (flat[:n_wide].astype(np.uint32) << 16).view(np.float32)
        else:
            wide = flat[:n_wide].view(np.dtype(transfer_dtype)).astype(np.float32)
        # .copy(): the tail's byte offset (2*n_wide) need not be 4-aligned,
        # and numpy refuses misaligned views; the tail is K + B*K floats
        narrow = flat[n_wide:].copy().view(np.float32)
        return wide, narrow


def groups_to_matrix(groups: Optional[Sequence[Sequence[int]]], n_columns: int) -> np.ndarray:
    """Build the static ``(M, D)`` 0/1 group-assignment matrix (identity
    without grouping: each column is its own group)."""

    if groups is None:
        return np.eye(n_columns, dtype=np.float32)
    G = np.zeros((len(groups), n_columns), dtype=np.float32)
    for i, cols in enumerate(groups):
        G[i, list(cols)] = 1.0
    return G


def resolve_use_kernel(use_kernel: Optional[bool], device: torch.device) -> bool:
    """``ShapConfig.use_kernel`` for tensors on ``device``: ``None`` = the
    kernel exactly when the tensors are on a CUDA device."""

    if use_kernel is None:
        return torch.device(device).type == "cuda"
    return bool(use_kernel)


def _auto_chunk(S: int, per_row_elems: int, target: int) -> int:
    return max(1, min(S, target // max(per_row_elems, 1)))


def _chunked(zc: torch.Tensor, chunk: int):
    """Pad the coalition axis to a multiple of ``chunk`` and reshape to
    ``(n_chunks, chunk, M)``; returns it with the unpadded ``S``.  Padded
    rows are all-zero masks (the pure background: harmless, and sliced
    off)."""

    S, D = zc.shape
    n_chunks = math.ceil(S / chunk)
    pad = n_chunks * chunk - S
    if pad:
        zc = torch.cat([zc, zc.new_zeros((pad, D))], 0)
    return zc.reshape(n_chunks, chunk, D), S


def _use_masked_ey(predictor, B: int, N: int, S: int, M: int,
                   config: ShapConfig) -> bool:
    """Dispatch to the structure-aware masked evaluation when the predictor
    offers it AND its persistent tensors fit the budget at these shapes
    (otherwise the row-materialising path is the better choice)."""

    return getattr(predictor, "supports_masked_ey", False) and \
        predictor.masked_ey_fits(B=B, N=N, S=S, M=M,
                                 budget=config.target_chunk_elems)


def _ey_generic(predictor: BasePredictor, X, bg, bgw_n, zc, chunk: int):
    """Synthetic-data expected outputs for an arbitrary predictor on the
    device: per coalition chunk, the ``(B, c, N, D)`` masked rows
    (instance where present, background where absent) go through the
    predictor as one ``(B·c·N, D)`` batch."""

    B, D = X.shape
    N = bg.shape[0]
    zc_chunks, S = _chunked(zc, chunk)
    parts = []
    for zc_c in zc_chunks:
        masked = (X[:, None, None, :] * zc_c[None, :, None, :]
                  + bg[None, None, :, :] * (1.0 - zc_c[None, :, None, :]))
        out = predictor(masked.reshape(-1, D))               # (B*c*N, K)
        out = out.reshape(B, zc_c.shape[0], N, -1)
        parts.append(torch.einsum("bcnk,n->bck", out, bgw_n))
    return torch.cat(parts, 1)[:, :S]


def _ey_linear(W, b, activation: str, X, bg, bgw_n, mask, G, chunk: int,
               use_kernel: bool = False):
    """Fast path for logits-linear predictors, in **group space**.

    For masked input ``m = x⊙z + bg⊙(1-z)`` with ``z = mask @ G`` the logits
    decompose as ``m @ W + b = p1[b,s] + bgW[n] - t2[s,n]`` where
    ``p1 = mask @ XWg``, ``XWg[b,m,k] = Σ_{d∈group m} X[b,d] W[d,k]``,
    ``t2 = mask @ bgWg`` (the same per-group reduction of the background)
    and ``bgW = bg @ W + b``.  For ``activation='identity'`` the whole N axis
    collapses analytically; otherwise ``use_kernel`` selects the fused
    kernel or its plain version, chunked over the coalition axis."""

    GW = G[:, :, None] * W[None, :, :]                    # (M, D, K)
    XWg = torch.einsum("bd,mdk->bmk", X, GW)              # (B, M, K)
    bgWg = torch.einsum("nd,mdk->nmk", bg, GW)            # (N, M, K)
    bgW = bg @ W + b                                      # (N, K)

    if activation == "identity":
        # E_n[p1 + bgW - t2] = p1 + E[bgW] - E_n[t2]: no (B,S,N,K) tensor
        record_kernel_path("ey", "einsum")
        p1 = torch.einsum("sm,bmk->bsk", mask, XWg)
        e_bgW = torch.einsum("nk,n->k", bgW, bgw_n)
        t2w = torch.einsum("sm,nmk,n->sk", mask, bgWg, bgw_n)
        return p1 + e_bgW[None, None, :] - t2w[None, :, :]

    args = (XWg.contiguous(), bgWg.contiguous(), bgW.contiguous(),
            bgw_n.contiguous(), mask.contiguous(), activation)
    if use_kernel:
        # a CUDA tensor launches the kernel or raises; a CPU tensor runs
        # the kernel's plain version
        record_kernel_path("ey", "cuda" if X.is_cuda else "plain")
        return fused_linear_ey(*args)
    record_kernel_path("ey", "plain")
    return fused_linear_ey_plain(*args, chunk=chunk)


def normal_equations(mask, w, ey_adj, fx_minus_e):
    """Gram matrix and right-hand sides of the constrained WLS."""

    zl = mask[:, -1]
    Zt = mask[:, :-1] - zl[:, None]            # (S, M-1)
    Aw = Zt * w[:, None]                       # (S, M-1)
    A = Aw.T @ Zt
    rhs = torch.einsum("sm,bsk->bkm", Aw,
                       ey_adj - zl[None, :, None] * fx_minus_e[:, None, :])
    return A, rhs


def solve_from_factor(chol, rhs, fx_minus_e):
    """Solve the eliminated system from a lower Cholesky factor and restore
    the last coefficient from the additivity constraint."""

    B, K = fx_minus_e.shape
    M1 = chol.shape[0]
    sol = torch.cholesky_solve(rhs.reshape(B * K, M1).T, chol)   # (M1, B*K)
    phi_rest = sol.T.reshape(B, K, M1)
    phi_last = fx_minus_e - phi_rest.sum(-1)
    return torch.cat([phi_rest, phi_last[..., None]], dim=-1)


def cholesky_or_nan(A):
    """Lower Cholesky factor of ``A``, all NaN where ``A`` is not positive
    definite, as the reference's ``jax.scipy.linalg.cho_factor`` gives it
    (``cholesky_ex`` alone leaves a partial factor).  The failure stays in a
    device tensor and the fill is a device-side select: nothing raises and
    nothing syncs with the host."""

    chol, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], chol, float("nan"))


def solve_from_normal(A, rhs, fx_minus_e, ridge):
    """Cholesky-solve the eliminated system (ridge on the diagonal) and
    restore the last coefficient from the additivity constraint; a Gram
    matrix that is not positive definite gives NaN phi."""

    M1 = A.shape[0]
    A = A + ridge * torch.eye(M1, dtype=A.dtype, device=A.device)
    return solve_from_factor(cholesky_or_nan(A), rhs, fx_minus_e)


def _wls_solve(mask, w, ey_adj, fx_minus_e, ridge):
    """Constrained weighted least squares, shared Gram matrix: eliminates the
    last group's coefficient with the additivity constraint, then solves the
    ``(M-1)``-dim normal equations once for all ``B·K`` right-hand sides."""

    if mask.shape[1] == 1:
        return fx_minus_e[:, :, None]
    A, rhs = normal_equations(mask, w, ey_adj, fx_minus_e)
    return solve_from_normal(A, rhs, fx_minus_e, ridge)


def build_explainer_fn(predictor: BasePredictor, config: ShapConfig = ShapConfig(),
                       with_ey: bool = False):
    """Build the explain function for ``predictor`` (reference
    ``ops/explain.py:646-721``).

    Returns ``explain(X, bg, bgw, mask, weights, G) -> dict`` over tensors on
    one device, with ``shap_values (B, K, M)``, ``expected_value (K,)`` and
    ``raw_prediction (B, K)`` (both in link space), plus ``ey_adj
    (B, S, K)`` when ``with_ey``.  The masked evaluation takes the linear
    route for a logits-linear predictor, else the predictor's
    ``masked_ey`` where it has one that fits, else ``_ey_generic``."""

    link_fn = convert_to_link(config.link)
    linear = predictor.linear_decomposition

    @torch.no_grad()
    def explain(X, bg, bgw, mask, weights, G):
        X = X.to(torch.float32)
        bg = bg.to(torch.float32)
        B, D = X.shape
        S, M = mask.shape
        K = predictor.n_outputs
        N = bg.shape[0]
        bgw_n = bgw / bgw.sum()

        if linear is not None:
            W, b, activation = linear
            chunk = config.coalition_chunk or _auto_chunk(S, B * N * K,
                                                          config.target_chunk_elems)
            ey = _ey_linear(W, b, activation, X, bg, bgw_n, mask, G, chunk,
                            use_kernel=resolve_use_kernel(config.use_kernel, X.device))
        elif _use_masked_ey(predictor, B, N, S, M, config):
            # structure-aware path: split-condition / first-layer sums
            # separate into instance and background halves
            ey = predictor.masked_ey(X, bg, bgw_n, mask, G,
                                     config.target_chunk_elems,
                                     coalition_chunk=config.coalition_chunk)
            # recorded after the call: a linear member's _ey_linear records
            # its own route inside it
            record_kernel_path("ey", "masked_ey")
        else:
            record_kernel_path("ey", "generic")
            zc = mask @ G                                         # (S, D)
            chunk = config.coalition_chunk or _auto_chunk(S, B * N * D,
                                                          config.target_chunk_elems)
            ey = _ey_generic(predictor, X, bg, bgw_n, zc, chunk)

        fx = link_fn(predictor(X))                                # (B, K)
        e_out = torch.einsum("nk,n->k", predictor(bg), bgw_n)     # raw expected output
        expected_value = link_fn(e_out)                           # (K,)

        ey_adj = link_fn(ey) - expected_value[None, None, :]
        fx_minus_e = fx - expected_value[None, :]
        phi = _wls_solve(mask, weights, ey_adj, fx_minus_e, config.ridge)

        out = {
            "shap_values": phi,                # (B, K, M)
            "expected_value": expected_value,  # (K,)
            "raw_prediction": fx,              # (B, K) in link space
        }
        if with_ey:
            out["ey_adj"] = ey_adj
        return out

    return explain


def plan_constants_variant(activation: str, K: int) -> str:
    """Which plan-constant variant a linear predictor maps to: the same
    dispatch as :func:`_ey_linear` and ``fused_linear_ey_plain``
    (``'identity'``, ``'binary'`` softmax at K = 2, else ``'general'``)."""

    if activation == "identity":
        return "identity"
    if activation == "softmax" and K == 2:
        return "binary"
    return "general"


def build_linear_plan_consts_fn(predictor: BasePredictor, config: ShapConfig,
                                chunk: int):
    """The precompute half of the plan-constant path (reference
    ``ops/explain.py:432-498``): everything of the linear path that depends
    only on (model, background, plan), computed once and kept on the
    device — the masked-background logits (``t2w``, or ``dt2c`` / ``t2c``
    stored pre-chunked in the layout :func:`build_linear_cached_fn` walks),
    the background logits, E[f] and the factorised WLS Gram matrix.

    Returns ``precompute(bg, bgw, mask, weights, G) -> dict``.  ``chunk`` is
    the coalition chunk of the per-request function, baked in here because
    the cached tensors are stored in its chunks."""

    link_fn = convert_to_link(config.link)
    W, b, activation = predictor.linear_decomposition
    variant = plan_constants_variant(activation, int(W.shape[1]))

    @torch.no_grad()
    def precompute(bg, bgw, mask, weights, G):
        bg = bg.to(torch.float32)
        bgw_n = bgw / bgw.sum()
        GW = G[:, :, None] * W[None, :, :]                # (M, D, K)
        bgWg = torch.einsum("nd,mdk->nmk", bg, GW)        # (N, M, K)
        bgW = bg @ W + b                                  # (N, K)
        e_out = torch.einsum("nk,n->k", predictor(bg), bgw_n)
        consts = {"mask": mask, "bgw_n": bgw_n, "GW": GW,
                  "expected_value": link_fn(e_out)}
        S, M = mask.shape
        if M > 1:
            # the Gram matrix factorised here (normal_equations' formula):
            # a request pays only the triangular solve
            zl = mask[:, -1]
            Zt = mask[:, :-1] - zl[:, None]
            Aw = Zt * weights[:, None]
            A = Aw.T @ Zt + config.ridge * torch.eye(M - 1, dtype=mask.dtype,
                                                      device=mask.device)
            consts.update(zl=zl, Aw=Aw, chol=cholesky_or_nan(A))
        if variant == "identity":
            consts["e_bgW"] = torch.einsum("nk,n->k", bgW, bgw_n)
            consts["t2w"] = torch.einsum("sm,nmk,n->sk", mask, bgWg, bgw_n)
        elif variant == "binary":
            dbgWg = bgWg[:, :, 1] - bgWg[:, :, 0]         # (N, M)
            dbgW = bgW[:, 1] - bgW[:, 0]                  # (N,)
            mask_chunks, _ = _chunked(mask, min(S, 2 * chunk))
            consts["dt2c"] = torch.stack([mc @ dbgWg.T - dbgW[None, :]
                                          for mc in mask_chunks])   # (n_chunks, c, N)
        else:
            mask_chunks, _ = _chunked(mask, chunk)
            consts["t2c"] = torch.stack([torch.einsum("sm,nmk->snk", mc, bgWg)
                                         for mc in mask_chunks])    # (n_chunks, c, N, K)
            consts["bgW"] = bgW
        return consts

    return precompute


def build_linear_cached_fn(predictor: BasePredictor, config: ShapConfig, chunk: int):
    """The per-request half of the plan-constant path (reference
    ``ops/explain.py:501-586``): ``explain(X, consts) -> dict`` over
    :func:`build_linear_plan_consts_fn`'s constants, with the same formulas,
    chunks and order as :func:`_ey_linear`'s plain route and
    :func:`_wls_solve`.

    Phi is bit-identical between constants served from the engine's cache
    and constants recomputed for the call (the same function on the same
    values); against the classic function (``plan_constant_cache='off'``)
    the products are batched differently, so the last bits may differ.
    ``fused_linear_ey`` has no cached variant (it takes the raw background
    tensors): the engine does not use this path while the kernel is on."""

    link_fn = convert_to_link(config.link)
    W, b, activation = predictor.linear_decomposition
    K = int(W.shape[1])
    variant = plan_constants_variant(activation, K)
    act = ACTIVATIONS[activation]

    @torch.no_grad()
    def explain(X, consts):
        record_kernel_path("ey", "einsum_cached")
        X = X.to(torch.float32)
        mask = consts["mask"]
        S, M = mask.shape
        bgw_n = consts["bgw_n"]
        XWg = torch.einsum("bd,mdk->bmk", X, consts["GW"])  # (B, M, K)
        if variant == "identity":
            p1 = torch.einsum("sm,bmk->bsk", mask, XWg)
            ey = p1 + consts["e_bgW"][None, None, :] - consts["t2w"][None, :, :]
        elif variant == "binary":
            dXWg = XWg[:, :, 1] - XWg[:, :, 0]              # (B, M)
            mask_chunks, _ = _chunked(mask, min(S, 2 * chunk))
            ey1 = torch.cat([
                torch.sigmoid((mc @ dXWg.T).T[:, :, None] - dt2[None]) @ bgw_n
                for mc, dt2 in zip(mask_chunks, consts["dt2c"])], 1)[:, :S]
            ey = torch.stack([1.0 - ey1, ey1], dim=-1)
        else:
            bgW = consts["bgW"]
            mask_chunks, _ = _chunked(mask, chunk)
            ey = torch.cat([
                torch.einsum("bcnk,n->bck",
                             act(torch.einsum("sm,bmk->bsk", mc, XWg)[:, :, None, :]
                                 + bgW[None, None] - t2[None]), bgw_n)
                for mc, t2 in zip(mask_chunks, consts["t2c"])], 1)[:, :S]
        expected_value = consts["expected_value"]
        fx = link_fn(predictor(X))
        ey_adj = link_fn(ey) - expected_value[None, None, :]
        fx_minus_e = fx - expected_value[None, :]
        if M == 1:
            phi = fx_minus_e[:, :, None]
        else:
            zl = consts["zl"]
            rhs = torch.einsum("sm,bsk->bkm", consts["Aw"],
                               ey_adj - zl[None, :, None] * fx_minus_e[:, None, :])
            phi = solve_from_factor(consts["chol"], rhs, fx_minus_e)
        return {
            "shap_values": phi,                # (B, K, M)
            "expected_value": expected_value,  # (K,)
            "raw_prediction": fx,              # (B, K) in link space
        }

    return explain


def split_shap_values(phi: np.ndarray, vector_out: bool = True) -> List[np.ndarray]:
    """Convert the packed ``(B, K, M)`` array into the reference's output
    layout: a list of ``K`` arrays of shape ``(B, M)`` (multi-output), or a
    single ``(B, M)`` array for scalar-output models."""

    phi = np.asarray(phi)
    if not vector_out:
        return phi[:, 0, :]
    return [phi[:, k, :] for k in range(phi.shape[1])]
