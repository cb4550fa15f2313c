"""Tensor-train predictor lift — the structured-model family whose exact
Shapley values are tractable by contraction (``ops/tensor_shap.py``).

Port of ``distributedkernelshap_tpu/models/tensor_net.py``.
``TensorTrainPredictor`` evaluates

    f(x) = e0 · Π_{i=1..M} (A_i + x_i B_i) · head

on a torch device: one affine core per feature site, chained as an ordered
matrix product.  The family is closed over sums and products of
per-feature functions, so it covers multilinear polynomial models,
factorisation-machine-style interactions and fitted low-rank surrogates of
black boxes:

* :meth:`TensorTrainPredictor.from_linear` lifts a (multi-output) linear
  model EXACTLY — the carry state is ``[1, running sums]``, one rank per
  output beyond the constant lane.
* :meth:`TensorTrainPredictor.from_cp` lifts a CP / factorised model
  ``f(x)[k] = Σ_ρ head[ρ, k] Π_i (a_{iρ} + b_{iρ} x_i)`` exactly with
  diagonal cores.
* :func:`fit_tt_surrogate` fits a TT surrogate to an arbitrary numpy
  callable by alternating least squares (host float64).

Cores are stored zero-padded to one square rank ``r`` (boundary ``e0``
picks row 0, ``head`` selects the first ``K`` columns) as device buffers
``A, B (M, r, r)`` and ``head (r, K)``, so the evaluator and the exact
contraction walk one stacked layout; the reference's ``lax.scan`` over
sites is a loop of batched ``(n, r) × (n, r, r)`` products here.
"""

import logging
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from distributedkernelshap_tpu_torch.models.predictors import BasePredictor
from distributedkernelshap_tpu_torch.utils import full_f32_matmul, resolve_device

logger = logging.getLogger(__name__)


def _host(a) -> np.ndarray:
    """A numpy copy of an array or tensor."""

    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class TensorTrainPredictor(BasePredictor):
    """Affine tensor-train model evaluated on a torch device.

    ``cores`` is a sequence of ``(A_i, B_i)`` pairs with
    ``A_i, B_i: (r_{i-1}, r_i)``, ``r_0 == 1`` and ``r_M == K`` (the
    output dimension); site ``i`` contributes the matrix
    ``A_i + x_i B_i``.  Outputs are raw (identity transform) — exactly
    the quantity the exact contraction path explains.  ``device``: where
    the padded cores live (default: the current CUDA device; raises
    without one).
    """

    #: symmetry with TreeEnsemblePredictor: raw outputs qualify for the
    #: exact path, a transformed head would not
    out_transform = "identity"

    def __init__(self, cores: Sequence[Tuple[np.ndarray, np.ndarray]],
                 vector_out: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        if not cores:
            raise ValueError("TensorTrainPredictor needs at least one core")
        host = []
        prev = 1
        for i, (A, B) in enumerate(cores):
            A = np.asarray(A, dtype=np.float32)
            B = np.asarray(B, dtype=np.float32)
            if A.shape != B.shape or A.ndim != 2:
                raise ValueError(
                    f"core {i}: A{A.shape} and B{B.shape} must be equal-shape "
                    f"rank-2 matrices")
            if A.shape[0] != prev:
                raise ValueError(
                    f"core {i}: input rank {A.shape[0]} does not chain with "
                    f"the previous core's output rank {prev}")
            prev = A.shape[1]
            host.append((A, B))
        self._host_cores = host
        self.M = len(host)
        self.K = prev
        self.ranks = (1,) + tuple(A.shape[1] for A, _ in host)
        self.rank = max(max(self.ranks), 1)
        self.n_outputs = int(self.K)
        self.vector_out = vector_out

        r = self.rank
        A_pad = np.zeros((self.M, r, r), dtype=np.float32)
        B_pad = np.zeros((self.M, r, r), dtype=np.float32)
        for i, (A, B) in enumerate(host):
            A_pad[i, :A.shape[0], :A.shape[1]] = A
            B_pad[i, :B.shape[0], :B.shape[1]] = B
        head = np.zeros((r, self.K), dtype=np.float32)
        head[:self.K, :self.K] = np.eye(self.K, dtype=np.float32)
        dev = resolve_device(device)
        self.register_buffer("A", torch.as_tensor(A_pad, device=dev))
        self.register_buffer("B", torch.as_tensor(B_pad, device=dev))
        self.register_buffer("head", torch.as_tensor(head, device=dev))

    # ------------------------------------------------------------------ #

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        X = X.to(torch.float32)
        v = X.new_zeros((X.shape[0], self.rank))
        v[:, 0] = 1.0
        with full_f32_matmul():
            for j in range(self.M):
                C = self.A[j][None] + X[:, j, None, None] * self.B[j][None]
                v = torch.einsum('br,brs->bs', v, C)
            return v @ self.head

    def tt_structure(self):
        """The padded device structure the exact contraction consumes
        (``ops/tensor_shap.tt_structure`` duck-types on this method)."""

        return {"A": self.A, "B": self.B, "head": self.head,
                "M": self.M, "K": self.K, "rank": self.rank,
                "ranks": self.ranks}

    def fingerprint_bytes(self) -> bytes:
        """Content bytes for the engine's device-cache fingerprint: two
        TT predictors with equal core bytes ARE the same contraction
        constants (mirrors the linear decomposition's weight-byte key)."""

        parts = [b"tt", repr(self.ranks).encode()]
        for A, B in self._host_cores:
            parts.append(A.tobytes())
            parts.append(B.tobytes())
        return b"".join(parts)

    # ------------------------------------------------------------------ #
    # exact lifts

    @classmethod
    def from_linear(cls, W, b, vector_out: bool = True,
                    device=None) -> "TensorTrainPredictor":
        """EXACT tensor-train form of the linear model
        ``f(x) = x @ W + b`` (``W: (D, K)``, ``b: (K,)``).

        The carry state is ``[1, acc_1..acc_K]`` (rank ``K+1``): every
        middle core adds its site's contribution to the per-output
        accumulators, the last core folds in the bias — the lifted model
        reproduces the linear fast path's predictions exactly, which
        pins the contraction against ``build_linear_cached_fn`` phi in
        the tests."""

        W = np.asarray(W, dtype=np.float32)
        b = np.atleast_1d(np.asarray(b, dtype=np.float32))
        if W.ndim != 2 or b.ndim != 1 or W.shape[1] != b.shape[0]:
            raise ValueError(f"Bad linear shapes W={W.shape} b={b.shape}")
        D, K = W.shape
        if D == 1:
            return cls([(b[None, :], W[0][None, :])], vector_out=vector_out,
                       device=device)
        r = K + 1
        cores: List[Tuple[np.ndarray, np.ndarray]] = []
        # first core: row vector [1, w_1k x]
        A1 = np.zeros((1, r), np.float32)
        A1[0, 0] = 1.0
        B1 = np.zeros((1, r), np.float32)
        B1[0, 1:] = W[0]
        cores.append((A1, B1))
        for i in range(1, D - 1):
            Ai = np.eye(r, dtype=np.float32)
            Bi = np.zeros((r, r), np.float32)
            Bi[0, 1:] = W[i]
            cores.append((Ai, Bi))
        # last core maps [1, acc] -> acc + w_Dk x + b_k
        Al = np.zeros((r, K), np.float32)
        Al[0, :] = b
        Al[1:, :] = np.eye(K, dtype=np.float32)
        Bl = np.zeros((r, K), np.float32)
        Bl[0, :] = W[-1]
        cores.append((Al, Bl))
        return cls(cores, vector_out=vector_out, device=device)

    @classmethod
    def from_linear_predictor(cls, pred) -> "TensorTrainPredictor":
        """Exact lift of a fitted :class:`LinearPredictor` with identity
        activation (the decomposition the linear fast path exploits), on
        the predictor's device."""

        linear = getattr(pred, "linear_decomposition", None)
        if linear is None:
            raise ValueError("predictor exposes no linear decomposition")
        W, b, activation = linear
        if activation != "identity":
            raise ValueError(
                f"only identity-activation linear models lift exactly to "
                f"TT form; got activation={activation!r}")
        return cls.from_linear(_host(W), _host(b),
                               vector_out=getattr(pred, "vector_out", True),
                               device=pred._device())

    @classmethod
    def from_cp(cls, a, b, head, vector_out: bool = True,
                device=None) -> "TensorTrainPredictor":
        """Exact TT form of the CP / factorised model
        ``f(x)[k] = Σ_ρ head[ρ, k] Π_i (a_{iρ} + b_{iρ} x_i)`` with
        ``a, b: (M, R)`` and ``head: (R, K)`` — diagonal cores of rank
        ``R``.  A pure product of per-feature factors (the factorised
        lifts' building block) is the ``R == 1`` case."""

        a = np.asarray(a, dtype=np.float32)
        b = np.asarray(b, dtype=np.float32)
        head = np.atleast_2d(np.asarray(head, dtype=np.float32))
        if a.shape != b.shape or a.ndim != 2:
            raise ValueError(f"a{a.shape}/b{b.shape} must be equal (M, R)")
        M, R = a.shape
        if head.shape[0] != R:
            raise ValueError(f"head{head.shape} must have {R} rows")
        if M == 1:
            return cls([((a[0] @ head)[None, :], (b[0] @ head)[None, :])],
                       vector_out=vector_out, device=device)
        cores: List[Tuple[np.ndarray, np.ndarray]] = [
            (a[0][None, :], b[0][None, :])]
        for i in range(1, M - 1):
            cores.append((np.diag(a[i]), np.diag(b[i])))
        cores.append((a[-1][:, None] * head, b[-1][:, None] * head))
        return cls(cores, vector_out=vector_out, device=device)


def fit_tt_surrogate(predict_fn: Callable[[np.ndarray], np.ndarray],
                     X: np.ndarray,
                     rank: int = 4,
                     n_sweeps: int = 4,
                     ridge: float = 1e-6,
                     seed: int = 0,
                     vector_out: bool = True,
                     device=None) -> TensorTrainPredictor:
    """Fit a rank-``rank`` TT surrogate of ``predict_fn`` on sample rows
    ``X`` by alternating least squares.

    Holding every core but site ``j`` fixed, the model is LINEAR in
    ``(A_j, B_j)``: with prefix ``l_n = e0 Π_{i<j} C_i(x_{n,i})`` and
    suffix ``t_n = Π_{i>j} C_i(x_{n,i}) · head``, the prediction is
    ``Σ_{p,q} (A_j[p,q] + x_{n,j} B_j[p,q]) l_n[p] t_n[q, k]`` — a
    ridge-regularised least squares per site, swept forward a few times
    with incrementally-updated prefixes.  ``predict_fn`` takes and returns
    numpy; the fit runs in float64 on the host, and the fitted surrogate
    (on ``device``) is evaluated through the port's predictor for
    ``fit_mse_``.  The A/B constructor behind the estimator-accuracy
    benchmark, not a production trainer.
    """

    X = np.asarray(X, dtype=np.float64)
    n, D = X.shape
    y = np.asarray(predict_fn(X.astype(np.float32)), dtype=np.float64)
    if y.ndim == 1:
        y = y[:, None]
    K = y.shape[1]
    rng = np.random.default_rng(seed)
    r = max(1, int(rank))
    dims = [1] + [r] * (D - 1) + [K]
    scale = 1.0 / np.sqrt(r)
    A = [rng.normal(scale=scale, size=(dims[i], dims[i + 1]))
         for i in range(D)]
    B = [rng.normal(scale=scale * 0.1, size=(dims[i], dims[i + 1]))
         for i in range(D)]

    def suffixes():
        """t[j]: (n, r_j, K) products over sites j+1..D (t[D-1] = head)."""
        t = [None] * D
        cur = np.broadcast_to(np.eye(K)[None], (n, K, K)).copy()
        for j in range(D - 1, -1, -1):
            t[j] = cur
            C = A[j][None] + X[:, j][:, None, None] * B[j][None]
            cur = np.einsum('npq,nqk->npk', C, cur)
        return t

    for _ in range(max(1, int(n_sweeps))):
        t = suffixes()
        left = np.ones((n, 1))                       # prefix over sites < j
        for j in range(D):
            p, q = A[j].shape
            # design F[(n,k), (t,p,q)]: constant and x-scaled lanes
            base = np.einsum('np,nqk->npqk', left, t[j])   # (n, p, q, K)
            F = np.concatenate(
                [base.reshape(n, p * q, K),
                 (X[:, j][:, None, None] * base.reshape(n, p * q, K))],
                axis=1)                                    # (n, 2pq, K)
            Fm = np.moveaxis(F, 1, 2).reshape(n * K, 2 * p * q)
            yv = y.reshape(n * K)
            G = Fm.T @ Fm + ridge * np.eye(2 * p * q)
            theta = np.linalg.solve(G, Fm.T @ yv)
            A[j] = theta[:p * q].reshape(p, q)
            B[j] = theta[p * q:].reshape(p, q)
            C = A[j][None] + X[:, j][:, None, None] * B[j][None]
            left = np.einsum('np,npq->nq', left, C)

    pred = TensorTrainPredictor(list(zip(A, B)), vector_out=vector_out, device=device)
    with torch.no_grad():
        fitted = pred(torch.as_tensor(X, dtype=torch.float32, device=pred._device()))
    fitted = fitted.cpu().numpy().astype(np.float64)
    pred.fit_mse_ = float(np.mean((fitted - y) ** 2))
    logger.info("fit_tt_surrogate: rank=%d sweeps=%d mse=%.3e",
                r, n_sweeps, pred.fit_mse_)
    return pred
