"""Predictor protocol — how models under explanation run on the device.

Port of ``distributedkernelshap_tpu/models/predictors.py`` (``:97-192``,
``:469-555``, ``:614-676``) for the linear and tree lifts only.  A predictor
is an ``nn.Module`` of signature ``(n, D) -> (n, K)``; ``LinearPredictor``
exposes its ``(W, b, activation)`` decomposition, which the explain pipeline
uses to collapse the ``B×S×N×D`` synthetic-data tensor into group-space
products and the fused ``fused_linear_ey`` kernel.

``as_predictor`` lifts linear scikit-learn estimators by duck typing (a bound
``predict_proba``/``decision_function``/``predict`` whose owner carries
``coef_`` and ``intercept_``), then tree ensembles (``models/trees.py``),
each checked numerically against the original callable; scikit-learn is
never imported.  Black-box callables need the host-eval, generic and
masked-eval paths, which the port does not have yet (ROADMAP.md, queue A
item 2): they raise.
"""

import logging
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from distributedkernelshap_tpu_torch.utils import resolve_device

logger = logging.getLogger(__name__)

ACTIVATIONS = {
    "identity": lambda z: z,
    "softmax": lambda z: torch.softmax(z, dim=-1),
    "sigmoid": torch.sigmoid,
}

_UNLIFTABLE = (
    "the PyTorch port evaluates only logits-linear predictors and lifted "
    "tree ensembles so far; "
    "host-eval, generic and masked-eval predictors are ROADMAP.md queue A "
    "item 2 (models/predictors.py) and not ported yet")


class BasePredictor(nn.Module):
    """Protocol: a device-side model of signature ``(n, D) -> (n, K)``.

    Attributes
    ----------
    n_outputs
        Output dimension K (1 for scalar-output models).
    vector_out
        False when the underlying user callable returned a scalar per row
        (reference reads ``vector_out`` at ``kernel_shap.py:790``).
    """

    n_outputs: int = 1
    vector_out: bool = True

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def linear_decomposition(self):
        """``(W, b, activation_name)`` when the model is logits-linear, else None."""
        return None


class LinearPredictor(BasePredictor):
    """Generalised linear model: ``activation(X @ W + b)`` with ``W: (D, K)``,
    ``b: (K,)`` held as float32 buffers on ``device`` and ``activation`` one
    of 'identity' | 'softmax' | 'sigmoid'."""

    def __init__(self, W, b, activation: str = "identity", vector_out: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of {sorted(ACTIVATIONS)}")
        dev = resolve_device(device)
        W = torch.tensor(np.asarray(W, dtype=np.float32), device=dev)
        b = torch.tensor(np.asarray(b, dtype=np.float32), device=dev)
        if W.ndim != 2 or b.ndim != 1 or W.shape[1] != b.shape[0]:
            raise ValueError(f"Bad linear shapes W={tuple(W.shape)} b={tuple(b.shape)}")
        self.register_buffer("W", W)
        self.register_buffer("b", b)
        self.activation = activation
        self.n_outputs = int(W.shape[1])
        self.vector_out = vector_out

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return ACTIVATIONS[self.activation](X @ self.W + self.b)

    @property
    def linear_decomposition(self):
        return self.W, self.b, self.activation


def _lift_sklearn(method, device=None) -> Optional[LinearPredictor]:
    """Lift a bound method of a linear estimator into a LinearPredictor."""

    owner = getattr(method, "__self__", None)
    if owner is None:
        return None
    coef = getattr(owner, "coef_", None)
    intercept = getattr(owner, "intercept_", None)
    if coef is None or intercept is None:
        return None
    coef = np.atleast_2d(np.asarray(coef, dtype=np.float32))  # (K_raw, D)
    intercept = np.atleast_1d(np.asarray(intercept, dtype=np.float32))
    name = getattr(method, "__name__", "")

    if name == "predict_proba":
        if coef.shape[0] == 1:
            # binary LR: predict_proba == [1-sigmoid(z), sigmoid(z)] == softmax([0, z])
            W = np.concatenate([np.zeros_like(coef), coef], axis=0).T
            b = np.concatenate([np.zeros_like(intercept), intercept])
        else:
            W, b = coef.T, intercept
        return LinearPredictor(W, b, activation="softmax", device=device)
    if name == "decision_function":
        return LinearPredictor(coef.T, intercept, activation="identity",
                               vector_out=coef.shape[0] > 1, device=device)
    if name == "predict" and not hasattr(owner, "classes_"):
        # linear regression: scalar margin output
        return LinearPredictor(coef.T, intercept, activation="identity",
                               vector_out=coef.shape[0] > 1, device=device)
    return None


def _lift_is_faithful(lifted: BasePredictor, method, example_dim: int,
                      tol: float = 1e-4,
                      probe_data: Optional[np.ndarray] = None) -> bool:
    """Numerically check that the lifted predictor reproduces the original
    callable.  Guards against estimators that expose ``coef_`` but whose
    ``predict_proba`` is NOT softmax-of-margin (Platt-scaled SVC, one-vs-rest
    logistic regression, ...).  ``probe_data`` rows (the caller's background
    set) join the synthetic Gaussian probe so the check sees the real input
    distribution."""

    rng = np.random.default_rng(0)
    probe = rng.normal(scale=0.5, size=(16, example_dim)).astype(np.float32)
    if probe_data is not None:
        rows = np.asarray(probe_data, dtype=np.float32)
        if rows.ndim == 2 and rows.shape[1] == example_dim and rows.shape[0]:
            take = rows[:: -(-rows.shape[0] // 32)][:32]  # spread, cap 32
            probe = np.concatenate([probe, take], axis=0)
    try:
        expected = np.asarray(method(probe), dtype=np.float32)
    except Exception:
        return False
    try:
        with torch.no_grad():
            device = next(lifted.buffers()).device
            got = lifted(torch.as_tensor(probe, device=device)).cpu().numpy()
    except RuntimeError:
        # structurally mismatched lift (shape errors): reject
        return False
    if expected.ndim == 1:
        expected = expected[:, None]
    if expected.shape != got.shape:
        return False
    # relative tolerance: regression outputs can be large, where f32 evaluation
    # legitimately deviates by more than an absolute 1e-4
    scale = max(1.0, float(np.abs(expected).max()))
    return bool(np.abs(expected - got).max() < tol * scale)


def as_predictor(predictor, example_dim: Optional[int] = None,
                 probe_data: Optional[np.ndarray] = None,
                 device: Optional[Union[str, torch.device]] = None) -> BasePredictor:
    """Normalise what the user passed into a :class:`BasePredictor` on
    ``device``: port predictors pass through (moved to ``device``), linear
    estimators and then tree ensembles are lifted and probe-checked (the
    tree lift only when ``example_dim`` lets the probe run); anything else
    raises ``NotImplementedError``."""

    dev = resolve_device(device)
    if isinstance(predictor, BasePredictor):
        return predictor.to(dev)

    lifted = _lift_sklearn(predictor, device=dev)
    if lifted is not None and (example_dim is None or _lift_is_faithful(
            lifted, predictor, example_dim, probe_data=probe_data)):
        logger.info("Lifted linear model into a LinearPredictor "
                    "(K=%d, activation=%s)", lifted.n_outputs, lifted.activation)
        return lifted
    if lifted is not None:
        raise NotImplementedError(
            "estimator exposes linear coefficients but its outputs do not "
            "match the lifted linear model; " + _UNLIFTABLE)
    if example_dim is not None:
        from distributedkernelshap_tpu_torch.models.trees import lift_tree_ensemble

        tree = lift_tree_ensemble(predictor, device=dev)
        if tree is not None and _lift_is_faithful(tree, predictor, example_dim,
                                                  probe_data=probe_data):
            logger.info("Lifted tree ensemble into a TreeEnsemblePredictor "
                        "(T=%d, K=%d)", tree.n_trees, tree.n_outputs)
            return tree
        if tree is not None:
            raise NotImplementedError(
                "the tree lift did not reproduce the original callable; "
                + _UNLIFTABLE)
    raise NotImplementedError(f"cannot lift {predictor!r}: " + _UNLIFTABLE)
