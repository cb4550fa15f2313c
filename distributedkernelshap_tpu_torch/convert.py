"""Carry the JAX package's parameters and fitted state over to the port.

Both directions go through numpy, so neither package imports the other: a
caller holding a JAX predictor passes ``np.asarray(jax_pred.W)`` and so on,
and gets the port's objects on ``device`` (default: the current CUDA
device; raises without one).
"""

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from distributedkernelshap_tpu_torch.kernel_shap import EngineConfig, KernelShap
from distributedkernelshap_tpu_torch.models.cnn import CNNPredictor, _CNN
from distributedkernelshap_tpu_torch.models.predictors import LinearPredictor
from distributedkernelshap_tpu_torch.models.quadratic import QuadraticDiscriminantPredictor
from distributedkernelshap_tpu_torch.models.svm import SVMPredictor
from distributedkernelshap_tpu_torch.models.torch_lift import TorchMLPPredictor
from distributedkernelshap_tpu_torch.models.trees import TreeEnsemblePredictor


def linear_predictor_from_numpy(W: np.ndarray, b: np.ndarray, activation: str,
                                vector_out: bool = True,
                                device: Optional[Union[str, torch.device]] = None
                                ) -> LinearPredictor:
    """The port's :class:`LinearPredictor` with the same ``(W, b)`` float32
    parameters and activation as a JAX ``LinearPredictor``."""

    return LinearPredictor(np.asarray(W, dtype=np.float32),
                           np.asarray(b, dtype=np.float32), activation,
                           vector_out=vector_out, device=device)


def torch_mlp_from_numpy(stages: Sequence[tuple], n_outputs: int, vector_out: bool = True,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> TorchMLPPredictor:
    """The port's :class:`TorchMLPPredictor` over the same stages as a JAX
    ``TorchMLPPredictor`` (pass its ``stages`` with every array entry as a
    numpy array, e.g. ``[tuple(np.asarray(a) if hasattr(a, 'shape') else a
    for a in s) for s in jax_pred.stages]``, and its ``n_outputs`` and
    ``vector_out``), or over the layers of a JAX ``MLPPredictor`` (pass
    ``models.torch_lift.mlp_stages([(np.asarray(W), np.asarray(b)) for W, b
    in jax_pred.layers], jax_pred.hidden_activation,
    jax_pred.out_activation)``)."""

    return TorchMLPPredictor([tuple(np.asarray(a, np.float32) if isinstance(a, np.ndarray)
                                    else a for a in stage) for stage in stages],
                             n_outputs=n_outputs, vector_out=vector_out, device=device)


def tree_ensemble_from_numpy(feature: np.ndarray, threshold: np.ndarray,
                             left: np.ndarray, right: np.ndarray, value: np.ndarray,
                             depth: int, aggregation: str = "sum",
                             base: Optional[np.ndarray] = None, scale: float = 1.0,
                             out_transform: str = "identity",
                             missing_left: Optional[np.ndarray] = None,
                             vector_out: bool = True,
                             device: Optional[Union[str, torch.device]] = None
                             ) -> TreeEnsemblePredictor:
    """The port's :class:`TreeEnsemblePredictor` over the same node tables
    as a JAX ``TreeEnsemblePredictor`` (pass ``np.asarray`` of its
    ``feature``, ``threshold``, ``left``, ``right``, ``value``, ``base`` and
    ``missing_left``, and its ``depth``, ``aggregation``, ``scale``,
    ``out_transform`` and ``vector_out``)."""

    return TreeEnsemblePredictor(
        np.asarray(feature), np.asarray(threshold, np.float32), np.asarray(left),
        np.asarray(right), np.asarray(value, np.float32), depth=int(depth),
        aggregation=aggregation, base=None if base is None else np.asarray(base),
        scale=float(scale), out_transform=out_transform,
        missing_left=None if missing_left is None else np.asarray(missing_left),
        vector_out=vector_out, device=device)


def svm_from_numpy(support_vectors: np.ndarray, dual_coef: np.ndarray, intercept: float,
                   kernel: str = "rbf", gamma: float = 1.0, coef0: float = 0.0,
                   degree: int = 3, vector_out: bool = False,
                   device: Optional[Union[str, torch.device]] = None) -> SVMPredictor:
    """The port's :class:`SVMPredictor` over the same support vectors and
    kernel as a JAX ``SVMPredictor`` (pass ``np.asarray`` of its ``sv`` and
    ``dual_coef``, and its ``intercept``, ``kernel``, ``gamma``, ``coef0``,
    ``degree`` and ``vector_out``)."""

    return SVMPredictor(np.asarray(support_vectors, np.float32),
                        np.asarray(dual_coef, np.float32), float(intercept),
                        kernel=kernel, gamma=float(gamma), coef0=float(coef0),
                        degree=int(degree), vector_out=vector_out, device=device)


def quadratic_from_numpy(W: np.ndarray, mu: np.ndarray, u: np.ndarray,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> QuadraticDiscriminantPredictor:
    """The port's :class:`QuadraticDiscriminantPredictor` with the same
    whitening ``W`` (``(K, D)`` diagonal or ``(K, D, R)`` full), means and
    offsets as a JAX one (pass ``np.asarray`` of its ``W``, ``mu``, ``u``).
    Composites (``models/compose.py``) are built from converted members by
    their own constructors, which take numpy stages and weights."""

    return QuadraticDiscriminantPredictor(np.asarray(W, np.float32),
                                          np.asarray(mu, np.float32),
                                          np.asarray(u, np.float32), device=device)


def cnn_from_numpy(params, image_shape: Tuple[int, int, int], n_classes: int = 10,
                   output: str = "probs",
                   device: Optional[Union[str, torch.device]] = None) -> CNNPredictor:
    """The port's :class:`CNNPredictor` over the parameters of a JAX
    ``CNNPredictor`` (pass its flax parameter tree with every leaf as a
    numpy array: ``Conv_i`` ``kernel`` HWIO and ``bias``, ``Dense_i``
    ``kernel`` ``(in, out)`` and ``bias``, e.g. ``jax.tree_util.tree_map(
    np.asarray, jax_pred.params)``), and its image shape, class count and
    output head."""

    net = _CNN(image_shape, n_classes)
    with torch.no_grad():
        for layer in ("Conv_0", "Conv_1", "Dense_0", "Dense_1"):
            mod = getattr(net, layer)
            kern = np.asarray(params[layer]["kernel"], np.float32)
            # HWIO -> OIHW for the convolutions, (in, out) -> (out, in) for nn.Linear
            kern = kern.transpose(3, 2, 0, 1) if kern.ndim == 4 else kern.T
            if tuple(kern.shape) != tuple(mod.weight.shape):
                raise ValueError(f"{layer} kernel has shape {kern.shape}; the CNN over "
                                 f"{tuple(image_shape)} needs {tuple(mod.weight.shape)}")
            mod.weight.copy_(torch.tensor(kern))
            mod.bias.copy_(torch.tensor(np.asarray(params[layer]["bias"], np.float32)))
    return CNNPredictor(net, n_classes=n_classes, output=output, device=device)


def kernel_shap_from_numpy(W: np.ndarray, b: np.ndarray, activation: str,
                           background: np.ndarray,
                           group_names: Optional[Sequence[str]] = None,
                           groups: Optional[Sequence[Sequence[int]]] = None,
                           weights: Optional[np.ndarray] = None,
                           link: str = 'identity',
                           seed: Optional[int] = None,
                           vector_out: bool = True,
                           engine_config: Optional[EngineConfig] = None,
                           device: Optional[Union[str, torch.device]] = None
                           ) -> KernelShap:
    """A fitted port :class:`KernelShap` over a linear predictor with the
    given parameters, on the same background, grouping, weights, link and
    seed as the JAX explainer it mirrors (the seed fixes the coalition plan,
    which both packages build identically)."""

    predictor = linear_predictor_from_numpy(W, b, activation, vector_out, device)
    explainer = KernelShap(predictor, link=link, seed=seed,
                           engine_config=engine_config, device=predictor.W.device)
    return explainer.fit(np.asarray(background, dtype=np.float32),
                         group_names=group_names,
                         groups=None if groups is None else [list(g) for g in groups],
                         weights=weights)
