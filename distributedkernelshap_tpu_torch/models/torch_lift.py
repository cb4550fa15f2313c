"""Dense feed-forward networks as stage chains with a structure-aware
``masked_ey``.

Port of ``distributedkernelshap_tpu/models/torch_lift.py``.  A
:class:`TorchMLPPredictor` is a chain of stages that starts with a dense
layer: ``linear``, then last-axis maps (activations, eval-mode affines,
layer norm, a softmax or ``binary_sigmoid`` head).  The first layer's
pre-activations separate into instance and background group-space terms, so
the KernelSHAP synthetic rows never exist (``first_layer_separated_ey``).
Two lifts build it: ``lift_torch`` walks an ``nn.Sequential`` and copies its
weights out once as float32 buffers (or returns a ``LinearPredictor`` for a
logits-linear network), and :func:`mlp_stages` lays out a scikit-learn MLP's
``(W, b)`` layers (``predictors._lift_sklearn_mlp``).

Layers ``lift_torch`` takes: ``Linear``, ``ReLU``/``LeakyReLU``/``ELU``/
``GELU``/``SiLU``/``Tanh``/``Sigmoid``/``Softmax``/``LogSoftmax``
(last-dim), ``BatchNorm1d`` (folded to its eval-mode affine using running
statistics), ``LayerNorm`` (last-dim), ``Dropout``/``Identity`` (no-ops at
inference) and nested ``Sequential``, with a ``Linear`` first.  Anything
else declines — a CNN, a chain that starts with another layer, a custom
``forward`` — and ``as_predictor`` runs the module itself on the device
(``TorchPredictor``, the generic route).  The reference lifts CNN stacks
too and sends what it cannot lift to a host callback (``torch_callback``),
because JAX cannot run torch; the port runs the user's module as it is.

The lift reproduces **eval-mode** semantics (dropout off, batch-norm running
stats); the numerical probe in ``as_predictor`` compares against the module
as given, so a module left in training mode fails the probe and runs
unlifted.
"""

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributedkernelshap_tpu_torch.models._chunking import (
    DEFAULT_CHUNK_ELEMS,
    first_layer_separated_ey,
)
from distributedkernelshap_tpu_torch.models.predictors import BasePredictor, _f32
from distributedkernelshap_tpu_torch.utils import resolve_device

logger = logging.getLogger(__name__)

Stage = Tuple


def is_torch_module(obj) -> bool:
    return isinstance(obj, nn.Module)


def module_of(predictor):
    """The torch module behind ``predictor`` — itself, or the owner of its
    bound ``forward``/``__call__`` — else None.  A bound method with any
    OTHER name (e.g. a custom ``model.predict``) is the user's chosen
    callable and must NOT be replaced by the raw forward."""

    if is_torch_module(predictor):
        return predictor
    owner = getattr(predictor, "__self__", None)
    # nn.Module.__call__ is bound through torch's dispatch wrappers, whose
    # __name__ is _wrapped_call_impl / _call_impl rather than "__call__"
    if owner is not None and is_torch_module(owner) \
            and getattr(predictor, "__name__", "") in (
                "forward", "__call__", "_wrapped_call_impl", "_call_impl"):
        return owner
    return None


def torch_callback(module):
    """Host-callable wrapper: numpy in, numpy out, no grad, eval semantics
    preserved as-is.  The input is moved to the module's own parameter
    dtype/device."""

    try:
        p = next(module.parameters())
        dtype, device = p.dtype, p.device
    except StopIteration:
        dtype, device = torch.float32, torch.device("cpu")

    def fn(a: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
            out = module(t.to(device=device, dtype=dtype))
        return out.detach().cpu().numpy()

    return fn


_ACT_STAGES = {
    "ReLU": lambda layer: ("act_relu",),
    "Tanh": lambda layer: ("act_tanh",),
    "Sigmoid": lambda layer: ("act_sigmoid",),
    "SiLU": lambda layer: ("act_silu",),
    "Softmax": lambda layer: ("softmax",) if layer.dim in (-1, 1) else None,
    "LogSoftmax": lambda layer: ("log_softmax",) if layer.dim in (-1, 1) else None,
    "LeakyReLU": lambda layer: ("act_leaky_relu", float(layer.negative_slope)),
    "ELU": lambda layer: ("act_elu", float(layer.alpha)),
    "GELU": lambda layer: ("act_gelu", getattr(layer, "approximate", "none") == "tanh"),
}


def _apply_stage(stage: Stage, X):
    kind = stage[0]
    if kind == "linear":
        return X @ stage[1] + stage[2]
    if kind == "affine":
        return X * stage[1] + stage[2]
    if kind == "layernorm":
        mu = X.mean(dim=-1, keepdim=True)
        var = ((X - mu) ** 2).mean(dim=-1, keepdim=True)
        return (X - mu) / torch.sqrt(var + stage[3]) * stage[1] + stage[2]
    if kind == "act_relu":
        return torch.relu(X)
    if kind == "act_tanh":
        return torch.tanh(X)
    if kind == "act_sigmoid":
        return torch.sigmoid(X)
    if kind == "act_silu":
        return F.silu(X)
    if kind == "act_leaky_relu":
        return F.leaky_relu(X, negative_slope=stage[1])
    if kind == "act_elu":
        return F.elu(X, alpha=stage[1])
    if kind == "act_gelu":
        return F.gelu(X, approximate="tanh" if stage[1] else "none")
    if kind == "softmax":
        return torch.softmax(X, dim=-1)
    if kind == "log_softmax":
        return torch.log_softmax(X, dim=-1)
    if kind == "binary_sigmoid":                 # one logit -> [1 - p, p]
        p = torch.sigmoid(X[..., 0])
        return torch.stack([1.0 - p, p], dim=-1)
    raise ValueError(f"unknown stage kind {stage[0]!r}")


#: a scikit-learn MLP's hidden activations and output heads as stages
#: (None: no stage)
_MLP_HIDDEN_STAGES = {"identity": None, "relu": ("act_relu",),
                      "tanh": ("act_tanh",), "logistic": ("act_sigmoid",)}
_MLP_HEAD_STAGES = {"identity": None, "softmax": ("softmax",),
                    "sigmoid": ("act_sigmoid",), "binary_sigmoid": ("binary_sigmoid",)}


def mlp_stages(layers, hidden_activation: str = "relu",
               out_activation: str = "identity") -> List[Stage]:
    """The stages of a dense MLP given as ``(W, b)`` layers with ``W:
    (D_in, D_out)`` (scikit-learn's ``coefs_``/``intercepts_`` layout, and
    the JAX package's ``MLPPredictor.layers``): ``hidden_activation``
    ('identity' | 'relu' | 'tanh' | 'logistic') between layers and the
    ``out_activation`` head ('identity' | 'softmax' | 'sigmoid' —
    elementwise, for multilabel classifiers — | 'binary_sigmoid' — a single
    logit mapped to ``[1-p, p]``)."""

    if hidden_activation not in _MLP_HIDDEN_STAGES:
        raise ValueError(f"hidden_activation must be one of {sorted(_MLP_HIDDEN_STAGES)}")
    if out_activation not in _MLP_HEAD_STAGES:
        raise ValueError(f"out_activation must be one of {sorted(_MLP_HEAD_STAGES)}")
    hidden, head = _MLP_HIDDEN_STAGES[hidden_activation], _MLP_HEAD_STAGES[out_activation]
    stages: List[Stage] = []
    for i, (W, b) in enumerate(layers):
        if i and hidden is not None:
            stages.append(hidden)
        stages.append(("linear", W, b))
    if head is not None:
        stages.append(head)
    return stages


class TorchMLPPredictor(BasePredictor):
    """A dense feed-forward network: a list of stages, the first a
    ``linear``, whose tensors are float32 buffers ``stage<i>_<j>`` on
    ``device``."""

    target_chunk_elems: int = DEFAULT_CHUNK_ELEMS
    supports_masked_ey = True

    def __init__(self, stages: List[Stage], n_outputs: int, vector_out: bool = True,
                 device=None):
        super().__init__()
        if not stages or stages[0][0] != "linear":
            raise ValueError("a TorchMLPPredictor's stages start with a 'linear' stage")
        dev = resolve_device(device)
        self._spec = []
        for i, stage in enumerate(stages):
            spec = []
            for j, a in enumerate(stage):
                if isinstance(a, (torch.Tensor, np.ndarray)):
                    name = f"stage{i}_{j}"
                    self.register_buffer(name, _f32(a, dev))
                    spec.append((True, name))
                else:
                    spec.append((False, a))
            self._spec.append(spec)
        self.n_outputs = int(n_outputs)
        self.vector_out = vector_out

    @property
    def stages(self) -> List[Stage]:
        return [tuple(getattr(self, a) if is_buf else a for is_buf, a in spec)
                for spec in self._spec]

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        X = X.to(torch.float32)
        for stage in self.stages:
            X = _apply_stage(stage, X)
        return X

    # ------------------------------------------------------------------
    # structure-aware masked evaluation for the KernelSHAP pipeline
    # ------------------------------------------------------------------

    def masked_ey_fits(self, B: int, N: int, S: int, M: int,
                       budget: int) -> bool:
        # only per-chunk tensors scale with B; the persistent background
        # terms are N·M·H
        H = int(self.stages[0][1].shape[1])
        return N * M * H <= 4 * budget

    def masked_ey(self, X, bg, bgw_n, mask, G, target_chunk_elems=None,
                  coalition_chunk=None):
        """Expected outputs over the KernelSHAP synthetic tensor: the first
        linear stage is linear in the row, so its pre-activations separate
        into instance + background group-space terms; the remaining stages
        act on the last axis and run on the assembled ``(chunk, B, N, H)``
        hidden tensor, and the ``(rows, D)`` synthetic matrix never exists."""

        stages = self.stages
        rest = stages[1:]

        def tail(z1):
            for stage in rest:
                z1 = _apply_stage(stage, z1)
            return z1

        return first_layer_separated_ey(
            stages[0][1], stages[0][2], tail, X, bg, bgw_n, mask, G,
            budget=target_chunk_elems or self.target_chunk_elems,
            coalition_chunk=coalition_chunk,
            h_max=max([int(stages[0][1].shape[1])]
                      + [int(s[1].shape[1]) for s in rest if s[0] == "linear"]))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _stages_from_module(module) -> Optional[List[Stage]]:
    """The module's stages with numpy float32 weights, or None when a layer
    is outside the dense feed-forward surface."""

    if isinstance(module, nn.Linear):
        children = [module]
    elif isinstance(module, nn.Sequential):
        children = list(module)
    else:
        return None

    f32 = np.float32
    stages: List[Stage] = []
    for layer in children:
        name = type(layer).__name__
        if isinstance(layer, nn.Sequential):
            sub = _stages_from_module(layer)
            if sub is None:
                return None
            stages.extend(sub)
        elif isinstance(layer, nn.Linear):
            W = _np(layer.weight).T.astype(f32)
            b = (_np(layer.bias).astype(f32) if layer.bias is not None
                 else np.zeros(W.shape[1], f32))
            stages.append(("linear", W, b))
        elif isinstance(layer, nn.BatchNorm1d):
            if layer.running_mean is None:
                return None          # track_running_stats=False: batch-dependent
            mean = _np(layer.running_mean)
            var = _np(layer.running_var)
            scale = 1.0 / np.sqrt(var + layer.eps)
            shift = -mean * scale
            if layer.affine:
                g = _np(layer.weight)
                be = _np(layer.bias)
                shift = shift * g + be
                scale = scale * g
            stages.append(("affine", scale.astype(f32), shift.astype(f32)))
        elif isinstance(layer, nn.LayerNorm):
            if len(layer.normalized_shape) != 1:
                return None
            d = layer.normalized_shape[0]
            g = _np(layer.weight) if layer.elementwise_affine else np.ones(d)
            be = (_np(layer.bias) if layer.elementwise_affine and layer.bias is not None
                  else np.zeros(d))
            stages.append(("layernorm", g.astype(f32), be.astype(f32), float(layer.eps)))
        elif isinstance(layer, (nn.Dropout, nn.Dropout2d, nn.Identity)):
            continue                 # inference no-ops
        elif name in _ACT_STAGES:
            stage = _ACT_STAGES[name](layer)
            if stage is None:
                return None
            stages.append(stage)
        else:
            return None              # conv/recurrent/attention/custom: runs unlifted
    return stages


def lift_torch(predictor, device=None) -> Optional[BasePredictor]:
    """Lift a ``torch.nn.Module`` (or its bound ``forward``/``__call__``)
    into a :class:`TorchMLPPredictor` on ``device``, or None when it is not
    a dense chain that starts with ``Linear``.  Numerically probe-gated by
    the caller."""

    module = module_of(predictor)
    if module is None:
        return None
    try:
        stages = _stages_from_module(module)
        if not stages or stages[0][0] != "linear":
            return None
        k = int(next(s for s in reversed(stages) if s[0] == "linear")[1].shape[1])
        # a logits-linear network (one Linear, optionally under softmax /
        # sigmoid) gets the LinearPredictor decomposition and its fast path
        if len(stages) == 1:
            return _as_linear(stages[0], "identity", device)
        if len(stages) == 2 and stages[1][0] in ("softmax", "act_sigmoid"):
            act = "softmax" if stages[1][0] == "softmax" else "sigmoid"
            return _as_linear(stages[0], act, device)
        return TorchMLPPredictor(stages, n_outputs=k, vector_out=True, device=device)
    except Exception as exc:  # unexpected layer internals: not liftable
        logger.info("torch lift failed structurally (%s); running unlifted", exc)
        return None


def _as_linear(stage: Stage, activation: str, device=None):
    from distributedkernelshap_tpu_torch.models.predictors import LinearPredictor

    return LinearPredictor(np.asarray(stage[1]), np.asarray(stage[2]),
                           activation=activation, device=device)
