"""Predictor protocol — how models under explanation run on the device.

Port of ``distributedkernelshap_tpu/models/predictors.py``.  A predictor is
an ``nn.Module`` of signature ``(n, D) -> (n, K)``:

* ``LinearPredictor`` — (generalised) linear models; exposes its
  ``(W, b, activation)`` decomposition, which the explain pipeline uses to
  collapse the ``B×S×N×D`` synthetic-data tensor into group-space products
  and the fused ``fused_linear_ey`` kernel;
* ``TorchPredictor`` — any torch callable or ``nn.Module`` that runs on the
  device (the reference's ``JaxPredictor``);
* ``CallbackPredictor`` — an arbitrary host callable (numpy in, numpy out):
  on the device path each call copies the rows to the host and the result
  back (the reference's ``jax.pure_callback``); with
  ``EngineConfig(host_eval=True)`` the engine calls it on the host directly.

``as_predictor`` lifts linear scikit-learn estimators by duck typing (a bound
``predict_proba``/``decision_function``/``predict`` whose owner carries
``coef_`` and ``intercept_``), then the non-linear families (tree ensembles,
Gaussian quadratic classifiers, XGBoost and LightGBM boosters, SVMs,
scikit-learn MLPs and torch ``nn.Sequential`` stacks, both as
``models.torch_lift.TorchMLPPredictor``, and the scikit-learn compositions
of ``models/compose.py``, whose members lift through
:func:`structural_lift`), each checked numerically against the original
callable; scikit-learn is never imported.  What none
lifts becomes a ``TorchPredictor`` when it is torch-native (an ``nn.Module``,
or a function that returns a tensor on a ``meta`` probe) and a
``CallbackPredictor`` otherwise.  An unlifted ``nn.Module`` therefore runs
on the device, where the reference sends it to the host (JAX cannot trace
torch); the answers are the same.
"""

import copy
import logging
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from distributedkernelshap_tpu_torch.models._chunking import DEFAULT_CHUNK_ELEMS
from distributedkernelshap_tpu_torch.utils import resolve_device

logger = logging.getLogger(__name__)

ACTIVATIONS = {
    "identity": lambda z: z,
    "softmax": lambda z: torch.softmax(z, dim=-1),
    "sigmoid": torch.sigmoid,
}


def _f32(a, device) -> torch.Tensor:
    """A float32 copy of ``a`` (array or tensor) on ``device``."""

    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32).clone()
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


class BasePredictor(nn.Module):
    """Protocol: a device-side model of signature ``(n, D) -> (n, K)``.

    Attributes
    ----------
    n_outputs
        Output dimension K (1 for scalar-output models).
    vector_out
        False when the underlying user callable returned a scalar per row
        (reference reads ``vector_out`` at ``kernel_shap.py:790``).
    supports_masked_ey
        Whether the predictor implements the structure-aware ``masked_ey``
        protocol — expected outputs over the KernelSHAP synthetic tensor
        without materialising it (``ops/explain.py`` dispatches on this,
        gated by :meth:`masked_ey_fits`).
    """

    n_outputs: int = 1
    vector_out: bool = True
    supports_masked_ey: bool = False

    def masked_ey_fits(self, **kwargs) -> bool:
        """Whether ``masked_ey``'s persistent tensors fit the chunk budget at
        the given ``B/N/S/M`` shapes; only consulted when
        ``supports_masked_ey`` is True."""

        return True

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _device(self) -> torch.device:
        """Where the predictor computes: its first buffer's or parameter's
        device, else ``self.device`` when set, else the CPU."""

        for t in self.buffers():
            return t.device
        for t in self.parameters():
            return t.device
        return getattr(self, "device", None) or torch.device("cpu")

    def host_fn(self, X: np.ndarray) -> np.ndarray:
        """Evaluate on the host, returning a numpy ``(n, K)`` array.

        The default runs the device computation; ``CallbackPredictor``
        overrides it with the raw host callable (no device involvement)."""

        with torch.no_grad():
            out = self(torch.as_tensor(np.asarray(X, dtype=np.float32),
                                       device=self._device()))
        out = out.cpu().numpy()
        return out[:, None] if out.ndim == 1 else out

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

    # the explain builder takes the decomposition branch directly; this
    # uniform masked_ey exists so composite predictors (soft-voting means,
    # bagging, multilabel one-vs-rest) can forward their members through
    # one protocol
    supports_masked_ey = True
    target_chunk_elems: int = DEFAULT_CHUNK_ELEMS

    def masked_ey(self, X, bg, bgw_n, mask, G, target_chunk_elems=None,
                  coalition_chunk=None):
        """Raw expected outputs ``(B, S, K)`` over the KernelSHAP synthetic
        tensor through ``ops.explain._ey_linear``, chunked as the reference
        chunks it (reference ``models/predictors.py:168-190``).  The
        reference keeps its Pallas kernel off here, because a
        ``pallas_call`` has no partitioning rule under a sharded jit; one
        card has no such rule to keep, so CUDA tensors launch
        ``fused_linear_ey`` (or raise) and CPU tensors run its plain
        version.  The identity activation keeps its einsum route."""

        from distributedkernelshap_tpu_torch.ops.explain import (
            _auto_chunk,
            _ey_linear,
            resolve_use_kernel,
        )

        f32 = torch.float32
        budget = target_chunk_elems or self.target_chunk_elems
        S = mask.shape[0]
        chunk = coalition_chunk or _auto_chunk(
            S, X.shape[0] * bg.shape[0] * self.n_outputs, budget)
        return _ey_linear(self.W, self.b, self.activation, X.to(f32), bg.to(f32),
                          bgw_n, mask.to(f32), G.to(f32), chunk,
                          use_kernel=resolve_use_kernel(None, X.device))


class TorchPredictor(BasePredictor):
    """Wraps a user's torch callable or ``nn.Module`` ``(n, D) -> (n, K)``
    that runs on the device (the reference's ``JaxPredictor``).

    A module is registered as a submodule (``.to(device)`` moves it)."""

    def __init__(self, fn: Callable, n_outputs: int, vector_out: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.fn = fn
        self.n_outputs = int(n_outputs)
        self.vector_out = vector_out
        self.device = None if device is None else torch.device(device)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        out = self.fn(X)
        if out.ndim == 1:
            out = out[:, None]
        return out.to(torch.float32)

    def fingerprint_bytes(self) -> Optional[bytes]:
        """Content bytes of a wrapped ``nn.Module`` (the counterpart of the
        reference's ``JaxPredictor`` parameter bytes): the qualified class
        name and scalar attributes of every submodule and the bytes of its
        ``state_dict``, plus the output count — two modules of one class
        that differ only in weights never share a cache key.  ``None`` for
        a plain function, whose captured state no bytes describe (the
        result cache then falls back to in-process identity)."""

        if not isinstance(self.fn, nn.Module):
            return None
        parts = [b"torch_module", str(self.n_outputs).encode(),
                 str(self.vector_out).encode()]
        for name, sub in self.fn.named_modules():
            cls = type(sub)
            parts.append(f"{name}:{cls.__module__}.{cls.__qualname__}".encode())
            for key in sorted(vars(sub)):
                value = vars(sub)[key]
                if not key.startswith("_") and isinstance(
                        value, (str, int, float, bool, tuple, type(None))):
                    parts.append(f"{key}={value!r}".encode())
        for key, tensor in self.fn.state_dict().items():
            parts.append(f"{key}:{tensor.dtype}:{tuple(tensor.shape)}".encode())
            parts.append(tensor.detach().cpu().contiguous().reshape(-1)
                         .view(torch.uint8).numpy().tobytes())
        return b"\x00".join(parts)

def _lift_sklearn_mlp(method, device=None):
    """Lift ``MLPClassifier.predict_proba`` / ``MLPRegressor.predict`` into a
    ``TorchMLPPredictor`` (scikit-learn stores per-layer ``coefs_`` /
    ``intercepts_`` and names its output activation in ``out_activation_``)."""

    from distributedkernelshap_tpu_torch.models.torch_lift import (
        TorchMLPPredictor,
        mlp_stages,
    )

    owner = getattr(method, "__self__", None)
    name = getattr(method, "__name__", "")
    if owner is None or type(owner).__name__ not in ("MLPClassifier", "MLPRegressor"):
        return None
    coefs = getattr(owner, "coefs_", None)
    intercepts = getattr(owner, "intercepts_", None)
    hidden = getattr(owner, "activation", None)
    out_act = getattr(owner, "out_activation_", None)
    if coefs is None or intercepts is None \
            or hidden not in ("identity", "relu", "tanh", "logistic"):
        return None
    k_raw = int(np.asarray(coefs[-1]).shape[1])
    is_classifier = hasattr(owner, "classes_")
    if is_classifier and name == "predict_proba":
        if out_act == "logistic":
            # one logit = binary ([1-p, p]); several = multilabel per-label
            # sigmoids (scikit-learn returns the elementwise probabilities)
            head = "binary_sigmoid" if k_raw == 1 else "sigmoid"
        elif out_act == "softmax":
            head = "softmax"
        else:
            return None
        return TorchMLPPredictor(mlp_stages(zip(coefs, intercepts), hidden, head),
                                 n_outputs=2 if head == "binary_sigmoid" else k_raw,
                                 device=device)
    if not is_classifier and name == "predict":
        return TorchMLPPredictor(mlp_stages(zip(coefs, intercepts), hidden, "identity"),
                                 n_outputs=k_raw, vector_out=k_raw > 1, device=device)
    return None  # class-label predict is a discontinuous argmax; host path


class CallbackPredictor(BasePredictor):
    """Host-side black-box predictor.

    The callable receives a numpy ``(n, D)`` float32 array and must return
    ``(n, K)`` (scalar-per-row outputs are reshaped).  :meth:`forward` on a
    device tensor copies it to the host, calls the function and copies the
    result back (the reference's ``jax.pure_callback``); inside the explain
    pipeline that happens once per coalition chunk.  :meth:`host_fn` is the
    raw host call, which the host-eval path uses."""

    def __init__(self, fn: Callable, n_outputs: Optional[int] = None,
                 example_dim: Optional[int] = None, vector_out: Optional[bool] = None):
        super().__init__()
        self.raw_fn = fn
        if n_outputs is None:
            if example_dim is None:
                raise ValueError("CallbackPredictor needs n_outputs or example_dim "
                                 "to probe the model")
            probe = np.asarray(fn(np.zeros((2, example_dim), dtype=np.float32)))
            vector_out = probe.ndim > 1
            n_outputs = probe.shape[1] if probe.ndim > 1 else 1
        self.n_outputs = int(n_outputs)
        self.vector_out = bool(vector_out) if vector_out is not None else True

    def host_fn(self, X: np.ndarray) -> np.ndarray:
        out = np.asarray(self.raw_fn(np.asarray(X)), dtype=np.float32)
        if out.ndim == 1:
            out = out[:, None]
        return out

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        out = self.host_fn(X.detach().to(torch.float32).cpu().numpy())
        if out.shape != (X.shape[0], self.n_outputs):
            raise ValueError(
                f"host callable returned shape {out.shape} for {X.shape[0]} rows; "
                f"expected ({X.shape[0]}, {self.n_outputs})")
        return torch.as_tensor(out, device=X.device)


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
        # torch modules want tensors, not numpy — retry through the converter
        # (only the module itself / its bound forward, never a custom method)
        from distributedkernelshap_tpu_torch.models.torch_lift import (
            module_of,
            torch_callback,
        )

        target = module_of(method)
        if target is None:
            return False
        try:
            expected = np.asarray(torch_callback(target)(probe), dtype=np.float32)
        except Exception:
            return False
    try:
        with torch.no_grad():
            got = lifted(torch.as_tensor(probe, device=lifted._device())).cpu().numpy()
    except Exception:
        # structurally mismatched lift (shape errors etc.): reject
        return False
    if expected.ndim == 1:
        expected = expected[:, None]
    if expected.shape != got.shape:
        return False
    # relative tolerance: regression outputs can be large, where f32 evaluation
    # legitimately deviates by more than an absolute 1e-4
    scale = max(1.0, float(np.abs(expected).max()))
    return bool(np.abs(expected - got).max() < tol * scale)


def _nonlinear_lifters():
    """``(family name, lifter)`` pairs for every structural lift beyond the
    plain linear one, in the reference's order (``predictors.py:557-595``):
    single estimators first, then compositions, which recurse through
    :func:`structural_lift` for their members.  Each lifter takes
    ``(method, device)``."""

    from distributedkernelshap_tpu_torch.models.compose import (
        lift_adaboost,
        lift_bagging,
        lift_calibrated,
        lift_ovr,
        lift_pipeline,
        lift_search_cv,
        lift_stacking,
        lift_transformed_target,
        lift_voting,
    )
    from distributedkernelshap_tpu_torch.models.lgbm import lift_lightgbm
    from distributedkernelshap_tpu_torch.models.quadratic import lift_gaussian_quadratic
    from distributedkernelshap_tpu_torch.models.svm import lift_svm
    from distributedkernelshap_tpu_torch.models.torch_lift import lift_torch
    from distributedkernelshap_tpu_torch.models.trees import lift_tree_ensemble
    from distributedkernelshap_tpu_torch.models.xgb import lift_xgboost

    return (("tree ensemble", lift_tree_ensemble),
            ("Gaussian quadratic classifier", lift_gaussian_quadratic),
            ("XGBoost ensemble", lift_xgboost),
            ("LightGBM ensemble", lift_lightgbm),
            ("SVM", lift_svm),
            ("MLP", _lift_sklearn_mlp),
            ("torch feed-forward", lift_torch),
            ("pipeline", lift_pipeline),
            ("voting ensemble", lift_voting),
            ("bagging ensemble", lift_bagging),
            ("stacking ensemble", lift_stacking),
            ("one-vs-rest classifier", lift_ovr),
            ("calibrated classifier", lift_calibrated),
            ("hyper-parameter search", lift_search_cv),
            ("AdaBoost ensemble", lift_adaboost),
            ("transformed-target regressor", lift_transformed_target))


def structural_lift(method, device=None) -> Optional[BasePredictor]:
    """Structure-only lift of a bound estimator method across every family
    onto ``device``, with NO numerical check (reference
    ``predictors.py:598-611``): the composite lifts (``models/compose.py``)
    lift their members through it, and ``as_predictor`` probes the
    composite as a whole."""

    lifted = _lift_sklearn(method, device=device)
    if lifted is not None:
        return lifted
    for _, lifter in _nonlinear_lifters():
        candidate = lifter(method, device=device)
        if candidate is not None:
            return candidate
    return None


def _on_device(module: nn.Module, dev: torch.device) -> nn.Module:
    """``module`` itself when its tensors are on ``dev``, else a copy moved
    there (the caller's module is never moved in place)."""

    tensors = list(module.parameters()) + list(module.buffers())
    if all(t.device == dev for t in tensors):
        return module
    return copy.deepcopy(module).to(dev)


def _meta_probe(fn, example_dim: int) -> Optional[torch.Tensor]:
    """``fn`` on a ``(2, example_dim)`` tensor on the ``meta`` device: a
    torch-native function returns a meta tensor (shapes only, no compute);
    a host (numpy) function raises, and then this returns None."""

    try:
        out = fn(torch.empty((2, example_dim), device="meta"))
    except Exception:
        return None
    if isinstance(out, torch.Tensor) and out.device.type == "meta" and out.ndim in (1, 2):
        return out
    return None


def as_predictor(predictor, example_dim: Optional[int] = None,
                 n_outputs: Optional[int] = None,
                 probe_data: Optional[np.ndarray] = None,
                 device: Optional[Union[str, torch.device]] = None) -> BasePredictor:
    """Normalise what the user passed into a :class:`BasePredictor` on
    ``device`` (reference ``predictors.py:614-677``).

    Port predictors pass through (moved to ``device``).  Linear estimators,
    then the non-linear families of :func:`_nonlinear_lifters` are lifted
    and probe-checked against the original callable (the non-linear lifts
    only when ``example_dim`` lets the probe run).  Otherwise an
    ``nn.Module`` (or its bound ``forward``/``__call__``) becomes a
    :class:`TorchPredictor` on ``device``; a callable that returns a tensor
    on a ``meta`` probe becomes a :class:`TorchPredictor` too, and any other
    callable a :class:`CallbackPredictor` (numpy in, numpy out)."""

    dev = resolve_device(device)
    if isinstance(predictor, BasePredictor):
        return predictor.to(dev)

    lifted = _lift_sklearn(predictor, device=dev)
    if lifted is not None:
        if example_dim is None or _lift_is_faithful(lifted, predictor, example_dim,
                                                    probe_data=probe_data):
            logger.info("Lifted linear model into a LinearPredictor "
                        "(K=%d, activation=%s)", lifted.n_outputs, lifted.activation)
            return lifted
        logger.warning(
            "Estimator exposes linear coefficients but its outputs do not match "
            "the lifted linear model; falling back to the unlifted callable.")

    # non-linear lifts are only trusted when the numerical probe can run:
    # structural extraction cannot see e.g. a data-dependent GradientBoosting
    # init estimator, whose lifted constant base would be silently wrong
    if example_dim is not None:
        for family, lifter in _nonlinear_lifters():
            candidate = lifter(predictor, device=dev)
            if candidate is None:
                continue
            if _lift_is_faithful(candidate, predictor, example_dim,
                                 probe_data=probe_data):
                logger.info("Lifted %s onto the device (%s)",
                            family, type(candidate).__name__)
                return candidate
            logger.warning("%s lift did not reproduce the original callable; "
                           "falling back to the unlifted callable.", family)

    # an unlifted torch module runs on the device as it is — only the module
    # itself or its bound forward; a custom bound method (e.g. model.predict)
    # is the user's chosen callable and stays as-is
    from distributedkernelshap_tpu_torch.models.torch_lift import module_of

    module = module_of(predictor)
    if module is not None and example_dim is not None:
        module = _on_device(module, dev)
        with torch.no_grad():
            out = module(torch.zeros((2, example_dim), device=dev))
        return TorchPredictor(module, n_outputs=out.shape[1] if out.ndim > 1 else 1,
                              vector_out=out.ndim > 1, device=dev)
    if module is not None and n_outputs is not None:
        return TorchPredictor(_on_device(module, dev), n_outputs=n_outputs, device=dev)

    if example_dim is not None:
        out = _meta_probe(predictor, example_dim)
        if out is not None:
            return TorchPredictor(predictor, n_outputs=out.shape[1] if out.ndim > 1 else 1,
                                  vector_out=out.ndim > 1, device=dev)
        return CallbackPredictor(predictor, n_outputs=n_outputs, example_dim=example_dim)

    if n_outputs is None:
        raise ValueError("Cannot infer predictor output dim; pass example_dim or n_outputs")
    return CallbackPredictor(predictor, n_outputs=n_outputs)

