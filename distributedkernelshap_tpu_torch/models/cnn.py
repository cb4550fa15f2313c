"""The CNN predictor of the MNIST image-explanation configuration.

Port of ``distributedkernelshap_tpu/models/cnn.py`` (BASELINE.json: "MNIST
CNN, 10k instances, image KernelSHAP with superpixel masking").  The
network is the reference's flax ``_CNN`` — ``Conv(16, 3×3, s2) → Relu →
Conv(32, 3×3, s2) → Relu → Dense(64) → Relu → Dense(K)`` — as an
``nn.Module``, NCHW inside:

* the flat ``(n, H·W·C)`` rows are row-major HWC, so they are reshaped to
  NHWC and permuted to NCHW;
* flax's ``'SAME'`` padding is asymmetric at stride 2 (``_same_pads(28, 2,
  3) = (0, 1)``), so each convolution pads explicitly and convolves with
  ``padding=0``;
* the activations go back to NHWC before the flatten, so ``Dense_0`` sees
  flax's column order.

The weights come from flax's parameter tree through
``convert.cnn_from_numpy`` (HWIO conv kernels become OIHW, ``(in, out)``
dense kernels become ``nn.Linear``'s ``(out, in)``).  The forward runs in
full float32 (``utils.full_f32_matmul``: no TF32 in cuDNN convolutions or
matmuls), the reference's ``matmul_precision="highest"``.
:meth:`CNNPredictor.graph_spec` exports the same graph, node for node and
initializer for initializer, as the reference's, for the DeepSHAP path.

:func:`train_mnist_cnn` trains the network with Adam on softmax cross
entropy, as the reference's does with optax.
"""

from typing import Iterable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributedkernelshap_tpu_torch.models.predictors import BasePredictor
from distributedkernelshap_tpu_torch.utils import full_f32_matmul, resolve_device

_LAYERS = ("Conv_0", "Conv_1", "Dense_0", "Dense_1")
_STRIDE = 2


def _same_pads(size: int, stride: int, kernel: int) -> Tuple[int, int]:
    """Flax/XLA 'SAME' padding for one spatial dim: ``(low, high)``."""

    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _CNN(nn.Module):
    """Conv(16)-Conv(32)-Dense(64)-Dense(K) classifier over ``(H, W, C)``
    images, named as flax names its layers."""

    def __init__(self, image_shape: Tuple[int, int, int], n_classes: int = 10):
        super().__init__()
        H, W, C = image_shape
        self.image_shape = tuple(int(d) for d in image_shape)
        self.Conv_0 = nn.Conv2d(C, 16, 3, stride=_STRIDE)
        self.Conv_1 = nn.Conv2d(16, 32, 3, stride=_STRIDE)
        h, w = H, W
        self.pads = []
        for _ in range(2):
            ph, pw = _same_pads(h, _STRIDE, 3), _same_pads(w, _STRIDE, 3)
            self.pads.append((pw[0], pw[1], ph[0], ph[1]))    # F.pad order
            h, w = -(-h // _STRIDE), -(-w // _STRIDE)
        self.Dense_0 = nn.Linear(32 * h * w, 64)
        self.Dense_1 = nn.Linear(64, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of NHWC images ``x``."""

        x = x.permute(0, 3, 1, 2)
        for conv, pad in zip((self.Conv_0, self.Conv_1), self.pads):
            x = F.relu(conv(F.pad(x, pad)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.Dense_1(F.relu(self.Dense_0(x)))


class CNNPredictor(BasePredictor):
    """Image classifier predictor: flattened pixels in, class probabilities
    out (``output='logits'`` serves the raw margins — the form the DeepSHAP
    path explains at the identity link)."""

    def __init__(self, net: _CNN, n_classes: int = 10, output: str = "probs",
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        if output not in ("probs", "logits"):
            raise ValueError("output must be 'probs' or 'logits'")
        self.net = net.to(resolve_device(device))
        self.image_shape = net.image_shape
        self.n_classes = int(n_classes)
        self.n_outputs = int(n_classes)
        self.vector_out = True
        self.output = output
        self._graph_spec = None

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        with full_f32_matmul():
            logits = self.net(X.to(torch.float32).reshape((-1,) + self.image_shape))
        return torch.softmax(logits, -1) if self.output == "probs" else logits

    def _numpy_params(self):
        """flax-layout parameters as float32 numpy: conv kernels OIHW (the
        ONNX layout), dense kernels ``(in, out)``."""

        out = {}
        for layer in _LAYERS:
            mod = getattr(self.net, layer)
            W = mod.weight.detach().cpu().numpy().astype(np.float32)
            out[layer] = {"kernel": W if layer.startswith("Conv") else np.ascontiguousarray(W.T),
                          "bias": mod.bias.detach().cpu().numpy().astype(np.float32)}
        return out

    def graph_spec(self):
        """Export the CNN as a ``registry/onnx_lift.GraphSpec`` (ONNX
        conventions: NCHW data, OIHW conv weights, explicit SAME pads) —
        equal, node for node and initializer for initializer, to the
        reference's export of the same parameters.  With ``output='probs'``
        the trailing Softmax keeps the graph off the DeepSHAP path."""

        if self._graph_spec is not None:
            return self._graph_spec
        from distributedkernelshap_tpu_torch.registry.onnx_lift import GraphSpec, NodeSpec

        params = self._numpy_params()
        H, W, C = self.image_shape
        inits = {"shape_img": np.asarray([0, H, W, C], np.int64)}
        nodes = [
            NodeSpec("Reshape", ("x", "shape_img"), ("img",), {}),
            NodeSpec("Transpose", ("img",), ("nchw",), {"perm": [0, 3, 1, 2]}),
        ]
        tensor, size = "nchw", (H, W)
        for i, layer in enumerate(("Conv_0", "Conv_1")):
            kern = params[layer]["kernel"]
            kh, kw = int(kern.shape[2]), int(kern.shape[3])
            ph = _same_pads(size[0], _STRIDE, kh)
            pw = _same_pads(size[1], _STRIDE, kw)
            inits[f"W{i}"] = kern
            inits[f"b{i}"] = params[layer]["bias"]
            nodes.append(NodeSpec(
                "Conv", (tensor, f"W{i}", f"b{i}"), (f"c{i}",),
                {"strides": [_STRIDE, _STRIDE],
                 "pads": [ph[0], pw[0], ph[1], pw[1]]}, layer))
            nodes.append(NodeSpec("Relu", (f"c{i}",), (f"r{i}",), {}))
            tensor = f"r{i}"
            size = (-(-size[0] // _STRIDE), -(-size[1] // _STRIDE))
        # flax flattens NHWC: transpose back before Flatten so the dense
        # weights see the training-time column order
        nodes.append(NodeSpec("Transpose", (tensor,), ("nhwc",), {"perm": [0, 2, 3, 1]}))
        nodes.append(NodeSpec("Flatten", ("nhwc",), ("flat",), {"axis": 1}))
        tensor = "flat"
        for i, layer in enumerate(("Dense_0", "Dense_1")):
            inits[f"Wd{i}"] = params[layer]["kernel"]
            inits[f"bd{i}"] = params[layer]["bias"]
            nodes.append(NodeSpec("Gemm", (tensor, f"Wd{i}", f"bd{i}"), (f"d{i}",), {},
                                  layer))
            tensor = f"d{i}"
            if i == 0:
                nodes.append(NodeSpec("Relu", (tensor,), ("rd0",), {}))
                tensor = "rd0"
        if self.output == "probs":
            nodes.append(NodeSpec("Softmax", (tensor,), ("probs",), {"axis": -1}))
            tensor = "probs"
        self._graph_spec = GraphSpec(nodes, inits, "x", tensor, H * W * C)
        return self._graph_spec

    def fingerprint_bytes(self) -> bytes:
        """Content bytes for the engine's device-cache fingerprint: the
        parameters, the image shape, the class count and the output head —
        two heads over the same parameters are different models."""

        parts = [b"cnn", self.output.encode(), repr(self.image_shape).encode(),
                 str(self.n_classes).encode()]
        for layer, p in sorted(self._numpy_params().items()):
            parts.append(layer.encode())
            parts.append(p["kernel"].tobytes())
            parts.append(p["bias"].tobytes())
        return b"".join(parts)


def _init_params(net: _CNN, generator: torch.Generator) -> None:
    """Draw the initial parameters from ``generator`` with flax's default
    scheme, as the reference initialises them: kernels LeCun normal
    (truncated at two standard deviations, variance ``1/fan_in``), biases
    zero.  The draws themselves differ from JAX's PRNG, so the parity tests
    start both packages from equal parameters instead."""

    with torch.no_grad():
        for layer in _LAYERS:
            mod = getattr(net, layer)
            w = torch.randn(mod.weight.shape, generator=generator)
            out = w.abs() > 2.0
            while bool(out.any()):
                w[out] = torch.randn(int(out.sum()), generator=generator)
                out = w.abs() > 2.0
            # 0.8796 = the std of a standard normal truncated to [-2, 2]
            std = float(np.sqrt(1.0 / mod.weight[0].numel())) / 0.87962566103423978
            mod.weight.copy_(w * std)
            mod.bias.zero_()


def _adam_steps(net: _CNN, batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                lr: float) -> None:
    """Adam on the mean softmax cross entropy, one step per ``(images,
    integer labels)`` batch (optax ``adam(lr)`` with its defaults:
    ``b1=0.9``, ``b2=0.999``, ``eps=1e-8``), in full float32."""

    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    with full_f32_matmul():
        for xb, yb in batches:
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(net(xb.reshape((-1,) + net.image_shape)), yb)
            loss.backward()
            opt.step()


def train_mnist_cnn(images: np.ndarray, labels: np.ndarray,
                    image_shape: Tuple[int, int, int] = (28, 28, 1),
                    n_classes: int = 10, epochs: int = 2,
                    batch_size: int = 256, lr: float = 1e-3,
                    seed: int = 0, output: str = "probs",
                    device: Optional[Union[str, torch.device]] = None) -> CNNPredictor:
    """Train the small CNN and wrap it as a predictor (reference
    ``models/cnn.py:135-174``).

    ``images``: ``(n, H*W)`` or ``(n, H, W[, C])`` float in [0, 1].  The
    initial parameters come from a ``torch.Generator`` seeded with ``seed``;
    each epoch visits full batches in the order of numpy's
    ``default_rng(seed).permutation``, as the reference does.
    ``output='logits'`` serves raw margins — the DeepSHAP-attributable form
    (a Softmax head keeps the graph off the attribution path)."""

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    flat = images.reshape(images.shape[0], -1).astype(np.float32)
    net = _CNN(image_shape, n_classes)
    _init_params(net, torch.Generator().manual_seed(int(seed)))
    net = net.to(dev)
    X = torch.as_tensor(flat, device=dev)
    y = torch.as_tensor(np.asarray(labels, np.int64), device=dev)

    def batches():
        n = flat.shape[0]
        for _ in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = torch.as_tensor(order[i:i + batch_size], device=dev)
                yield X[idx], y[idx]

    net.train()
    _adam_steps(net, batches(), lr)
    net.eval()
    for p in net.parameters():
        p.requires_grad_(False)
    return CNNPredictor(net, n_classes=n_classes, output=output, device=dev)
