"""Gaussian generative classifiers evaluated on a torch device.

Port of ``distributedkernelshap_tpu/models/quadratic.py``.  ``GaussianNB``
and ``QuadraticDiscriminantAnalysis`` share one prediction form: per-class
log-densities that are quadratic in the input,

    z_k(x) = -0.5 * || (x - mu_k) @ W_k ||^2 + u_k,      proba = softmax(z)

with ``W_k`` the whitening transform of class k's Gaussian (diagonal
``1/sigma`` for naive Bayes; ``rotations_k / sqrt(scalings_k)`` for QDA) and
``u_k`` absorbing the log prior and normalisation.  The transforms are
folded in float64 on the host, as the reference folds them, and cast to
float32 once.

As with every lift, ``as_predictor`` checks the result numerically against
the original ``predict_proba`` before trusting it.
"""

import logging
from typing import Optional, Union

import numpy as np
import torch

from distributedkernelshap_tpu_torch.models.predictors import BasePredictor, _f32
from distributedkernelshap_tpu_torch.utils import resolve_device

logger = logging.getLogger(__name__)


class QuadraticDiscriminantPredictor(BasePredictor):
    """``softmax_k(-0.5·||(x-mu_k)@W_k||^2 + u_k)``.

    ``W``: per-class whitening — ``(K, D, R)`` full transforms (zero-padded
    on the rank axis; QDA) or ``(K, D)`` diagonal scales (naive Bayes, which
    at high ``D`` must never materialise a ``D×D`` matrix).  ``mu``:
    ``(K, D)``, ``u``: ``(K,)``; all float32 buffers on ``device``."""

    def __init__(self, W, mu, u, device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        dev = resolve_device(device)
        W, mu, u = _f32(W, dev), _f32(mu, dev), _f32(u, dev)
        if W.ndim not in (2, 3) or tuple(mu.shape) != tuple(W.shape[:2]) \
                or tuple(u.shape) != (W.shape[0],):
            raise ValueError(f"Bad shapes W={tuple(W.shape)} mu={tuple(mu.shape)} "
                             f"u={tuple(u.shape)}")
        self.register_buffer("W", W)
        self.register_buffer("mu", mu)
        self.register_buffer("u", u)
        self.n_outputs = int(W.shape[0])
        self.vector_out = True

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        X = X.to(torch.float32)
        if self.W.ndim == 2:          # diagonal: elementwise, O(n·K·D)
            Y = (X[:, None, :] - self.mu[None]) * self.W[None]
        else:
            Y = torch.einsum("nd,kdr->nkr", X, self.W) \
                - torch.einsum("kd,kdr->kr", self.mu, self.W)[None]
        z = -0.5 * torch.sum(Y ** 2, dim=-1) + self.u[None, :]
        return torch.softmax(z, dim=-1)


def lift_gaussian_quadratic(method, device=None) -> Optional[QuadraticDiscriminantPredictor]:
    """Lift ``GaussianNB.predict_proba`` / ``QDA.predict_proba`` onto
    ``device``; None when the estimator is out of scope (the caller probes
    the lift regardless)."""

    owner = getattr(method, "__self__", None)
    if owner is None or getattr(method, "__name__", "") != "predict_proba":
        return None
    cls = type(owner).__name__
    try:
        if cls == "GaussianNB":
            theta = np.asarray(owner.theta_, np.float64)       # (K, D)
            var = np.asarray(owner.var_, np.float64)
            prior = np.asarray(owner.class_prior_, np.float64)
            u = (np.log(prior) - 0.5 * np.sum(np.log(2.0 * np.pi * var), axis=1))
            return QuadraticDiscriminantPredictor(1.0 / np.sqrt(var), theta, u,
                                                  device=device)
        if cls == "QuadraticDiscriminantAnalysis":
            rotations = [np.asarray(r, np.float64) for r in owner.rotations_]
            scalings = [np.asarray(s, np.float64) for s in owner.scalings_]
            means = np.asarray(owner.means_, np.float64)       # (K, D)
            prior = np.asarray(owner.priors_, np.float64)
            K, D = means.shape
            R = max(r.shape[1] for r in rotations)
            W = np.zeros((K, D, R), np.float64)
            u = np.zeros(K, np.float64)
            # the fitted scalings_ already include reg_param; predict uses
            # them as they are
            for k in range(K):
                s2 = scalings[k]
                W[k, :, :rotations[k].shape[1]] = rotations[k] / np.sqrt(s2)
                u[k] = np.log(prior[k]) - 0.5 * np.sum(np.log(s2))
            return QuadraticDiscriminantPredictor(W, means, u, device=device)
    except Exception as exc:
        logger.info("quadratic lift failed structurally (%s); keeping the callable", exc)
    return None
