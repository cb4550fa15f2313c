"""Support-vector machines evaluated on a torch device.

Port of ``distributedkernelshap_tpu/models/svm.py``.  The decision function
of a fitted SVM is a kernel expansion over its support vectors,
``f(x) = Σ_i α_i K(sv_i, x) + b``, and every kernel scikit-learn ships
('linear' | 'rbf' | 'poly' | 'sigmoid') is an elementwise map of the Gram
product ``X @ SV.T``: one matmul against the support-vector matrix, then
the map and the dual contraction.

Lifted surface (``lift_svm``):

* binary ``SVC``/``NuSVC`` ``decision_function`` — exact;
* ``SVR``/``NuSVR`` ``predict`` — exact.

Not lifted, as in the reference: ``predict_proba`` (libsvm's Platt scaling
is fit by internal cross-validation and is not a function of the final
decision values), multiclass one-vs-one votes, class-label ``predict`` and
callable or precomputed kernels; ``as_predictor`` then keeps the unlifted
callable.

The Gram products run with TF32 off (``utils.full_f32_matmul``, whatever
the caller set): the reference computes them at
``matmul_precision="highest"``, and rbf's ``exp`` amplifies TF32's error.
"""

import logging
from typing import Optional, Union

import numpy as np
import torch

from distributedkernelshap_tpu_torch.models._chunking import (
    DEFAULT_CHUNK_ELEMS,
    padded_chunk_map,
)
from distributedkernelshap_tpu_torch.models.predictors import BasePredictor, _f32
from distributedkernelshap_tpu_torch.utils import full_f32_matmul, resolve_device

logger = logging.getLogger(__name__)

SVM_KERNELS = ("linear", "rbf", "poly", "sigmoid")


class SVMPredictor(BasePredictor):
    """``f(x) = Σ_i α_i K(sv_i, x) + b`` evaluated as one Gram matmul.

    ``support_vectors``: ``(V, D)``; ``dual_coef``: ``(V,)``; kernel
    parameters follow scikit-learn's conventions (``gamma`` is the resolved
    value, e.g. the computed 'scale' gamma).  The support vectors, dual
    coefficients and ``|sv|²`` are float32 buffers on ``device``."""

    n_outputs = 1
    target_chunk_elems: int = DEFAULT_CHUNK_ELEMS
    supports_masked_ey = True

    def __init__(self, support_vectors, dual_coef, intercept: float,
                 kernel: str = "rbf", gamma: float = 1.0, coef0: float = 0.0,
                 degree: int = 3, vector_out: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        if kernel not in SVM_KERNELS:
            raise ValueError(f"kernel must be one of {SVM_KERNELS}")
        dev = resolve_device(device)
        sv = _f32(support_vectors, dev)
        dual = _f32(dual_coef, dev).reshape(-1)
        if sv.shape[0] != dual.shape[0]:
            raise ValueError(
                f"support_vectors {tuple(sv.shape)} vs dual_coef {tuple(dual.shape)}")
        self.register_buffer("sv", sv)
        self.register_buffer("dual_coef", dual)
        self.register_buffer("sv_sq", torch.sum(sv ** 2, dim=1))   # (V,) for rbf
        self.intercept = float(intercept)
        self.kernel = kernel
        self.gamma = float(gamma)
        self.coef0 = float(coef0)
        self.degree = int(degree)
        self.vector_out = vector_out

    def _kernel_map(self, g: torch.Tensor) -> torch.Tensor:
        """Kernel value from the Gram product (for rbf, ``g`` is the squared
        distance ``|sv - x|²``)."""

        if self.kernel == "linear":
            return g
        if self.kernel == "rbf":
            return torch.exp(-self.gamma * torch.clamp(g, min=0.0))
        if self.kernel == "poly":
            return (self.gamma * g + self.coef0) ** self.degree
        return torch.tanh(self.gamma * g + self.coef0)      # sigmoid

    @full_f32_matmul()
    def forward(self, X: torch.Tensor) -> torch.Tensor:
        X = X.to(torch.float32)
        G = X @ self.sv.T                                    # (n, V)
        if self.kernel == "rbf":
            # the expansion |x|² + |sv|² − 2·x·sv (not cdist, which rounds
            # differently), clamped at 0 in _kernel_map
            g = torch.sum(X ** 2, dim=1)[:, None] + self.sv_sq[None, :] - 2.0 * G
        else:
            g = G
        return (self._kernel_map(g) @ self.dual_coef + self.intercept)[:, None]

    # ------------------------------------------------------------------
    # structure-aware masked evaluation for the KernelSHAP pipeline
    # ------------------------------------------------------------------

    def masked_ey_fits(self, B: int, N: int, S: int, M: int,
                       budget: int) -> bool:
        """Whether the persistent per-background partial products
        (``DB: N·V·M``) stay within a few chunk budgets."""

        V = self.sv.shape[0]
        return N * V * M <= 4 * budget and V * M <= budget

    @full_f32_matmul()
    def masked_ey(self, X, bg, bgw_n, mask, G, target_chunk_elems=None,
                  coalition_chunk=None):
        """Expected decision values over the KernelSHAP synthetic tensor
        without materialising it (reference ``models/svm.py:104-193``).

        A synthetic row mixes one instance and one background row
        columnwise, and both the Gram product and the squared distance to a
        support vector are columnwise sums, so they separate::

            g[b,s,n,v] = Σ_m mask[s,m]·DX[b,v,m] + C[n,v] − Σ_m mask[s,m]·DB[n,v,m]

        with ``DX (B, V, M)`` / ``DB (N, V, M)`` the per-group partial dot
        products (or squared differences, for rbf) against each support
        vector and ``C (N, V)`` their full sums over the background row.
        rbf factorises the exponential over the two halves and contracts
        them in one batched product; linear takes separate sums; poly and
        sigmoid broadcast, then map.  Returns raw ``(B, S, 1)``, the
        contract of ``ops.explain._ey_generic``."""

        f32 = torch.float32
        X = X.to(f32)
        bg = bg.to(f32)
        mask = mask.to(f32)
        Gm = G.to(f32)                                       # (M, D)
        B, D = X.shape
        S = mask.shape[0]
        V = self.sv.shape[0]
        M = mask.shape[1]
        N = bg.shape[0]
        sv = self.sv
        budget = target_chunk_elems or self.target_chunk_elems

        # per-background partial products, chunked over N so the (nc, V, D)
        # differences intermediate respects the budget
        def bg_chunk(bg_c):
            if self.kernel == "rbf":
                d = (bg_c[:, None, :] - sv[None, :, :]) ** 2     # (nc, V, D)
            else:
                d = bg_c[:, None, :] * sv[None, :, :]
            DB_c = torch.einsum("nvd,md->nvm", d, Gm)
            return torch.cat([DB_c, torch.sum(d, dim=-1)[..., None]], -1)

        DBC = padded_chunk_map(bg_chunk, bg, budget // max(1, V * D))
        DB, C = DBC[..., :M], DBC[..., M]                    # (N,V,M), (N,V)

        bc = max(1, min(B, budget // max(1, V * D, V * M)))
        if coalition_chunk:
            sc = coalition_chunk
        elif self.kernel in ("rbf", "linear"):
            # the factorised paths materialise only (sc, ·, V) tensors
            sc = max(1, min(S, budget // max(1, max(bc, N) * V)))
        else:
            sc = max(1, min(S, budget // max(1, bc * N * V)))

        def b_chunk(Xc):
            if self.kernel == "rbf":
                dx = (Xc[:, None, :] - sv[None, :, :]) ** 2      # (bc, V, D)
            else:
                dx = Xc[:, None, :] * sv[None, :, :]
            DX = torch.einsum("bvd,md->bvm", dx, Gm)

            def s_chunk(mask_c):
                hx = torch.einsum("cm,bvm->cbv", mask_c, DX)     # (sc, bc, V)
                hb = C[None] - torch.einsum("cm,nvm->cnv", mask_c, DB)
                if self.kernel == "rbf":
                    # exp(-γ(hx+hb)) = exp(-γhx)·exp(-γhb): the N×V
                    # contraction is one batched product and no (sc,bc,N,V)
                    # tensor exists; both halves are sums of squares, so the
                    # row path's clamp is not needed
                    K1 = torch.exp(-self.gamma * hx)
                    K2w = torch.exp(-self.gamma * hb) * self.dual_coef[None, None, :]
                    f = torch.einsum("cbv,cnv->cbn", K1, K2w) + self.intercept
                elif self.kernel == "linear":
                    # the kernel is linear in the row: separate sums
                    fx = hx @ self.dual_coef                     # (sc, bc)
                    fb = hb @ self.dual_coef                     # (sc, N)
                    f = fx[:, :, None] + fb[:, None, :] + self.intercept
                else:  # poly / sigmoid: no factorisation; broadcast + map
                    g = hx[:, :, None, :] + hb[:, None, :, :]
                    f = self._kernel_map(g) @ self.dual_coef + self.intercept
                return torch.einsum("cbn,n->cb", f, bgw_n)

            ey_c = padded_chunk_map(s_chunk, mask, sc)           # (S, bc)
            return ey_c.movedim(0, 1)                            # (bc, S)

        ey = padded_chunk_map(b_chunk, X, bc)                    # (B, S)
        return ey[:, :, None]                                    # (B, S, 1)


def lift_svm(method, device=None) -> Optional[SVMPredictor]:
    """Lift a bound binary ``SVC.decision_function`` / ``SVR.predict`` into
    an :class:`SVMPredictor` on ``device``, or None when the estimator or
    method is outside the exactly-liftable surface (module docstring)."""

    owner = getattr(method, "__self__", None)
    name = getattr(method, "__name__", "")
    if owner is None:
        return None
    cls = type(owner).__name__
    is_svc = cls in ("SVC", "NuSVC")
    is_svr = cls in ("SVR", "NuSVR")
    if not ((is_svc and name == "decision_function")
            or (is_svr and name == "predict")):
        return None
    kernel = getattr(owner, "kernel", None)
    if kernel not in SVM_KERNELS:
        return None  # callable / precomputed kernels stay unlifted
    try:  # unfitted / unexpected internals: decline
        dual = owner.dual_coef_
        if hasattr(dual, "toarray"):      # sparse-input fit
            dual = dual.toarray()
        dual = np.asarray(dual)
        if dual.ndim != 2 or dual.shape[0] != 1:
            return None  # multiclass one-vs-one: vote aggregation not lifted
        sv = owner.support_vectors_
        if hasattr(sv, "toarray"):
            sv = sv.toarray()
        return SVMPredictor(
            np.asarray(sv), dual[0], float(owner.intercept_[0]),
            kernel=kernel, gamma=float(owner._gamma),
            coef0=float(owner.coef0), degree=int(owner.degree), device=device)
    except Exception as exc:
        logger.info("SVM lift failed structurally (%s); keeping the callable", exc)
        return None
