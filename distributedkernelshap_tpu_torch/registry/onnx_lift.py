"""ONNX ingest: translate a supported op subset into a port predictor.

Port of ``distributedkernelshap_tpu/registry/onnx_lift.py``.  A customer
hands over an ONNX graph and this module turns it into a
:class:`~distributedkernelshap_tpu_torch.models.predictors.BasePredictor`
on a torch device: a logistic-regression export lands on the linear fast
path (``fused_linear_ey``), an MLP or CNN export becomes an
:class:`ONNXPredictor`, which the engine's ``nsamples='exact'`` explains by
DeepSHAP (``attribution/deepshap.py``) when every node has a rule.

Two layers, as in the reference:

* :class:`GraphSpec` — a framework-free description of a feed-forward
  graph (nodes, initializers, one input, one output).  The translator
  (:func:`lift_graph`) and its parity tests need only this, so the
  translation core runs without the ``onnx`` package.
* :func:`lift_onnx` — parse an ONNX ``ModelProto`` / bytes / file path
  into a :class:`GraphSpec` and lift it.  ``onnx`` is imported lazily;
  without it the reference's ``ImportError`` is raised.

Supported ops (:data:`SUPPORTED_ONNX_OPS`): ``Gemm``, ``MatMul``,
``Add``, ``Relu``, ``Sigmoid``, ``Tanh``, ``Softmax``, ``Identity``,
``Reshape``, ``Flatten``, ``Transpose``, ``Conv``, ``MaxPool``,
``AveragePool`` and ``BatchNormalization`` (inference mode).  Anything else
raises :class:`UnsupportedOpError` listing every unsupported node with its
name and position.

Each op has two evaluations, one in numpy (``_eval_np``, the host oracle
that the linear extraction, the readiness probe and ``host_fn`` use) and
one in torch (``_eval_torch``, the device path and the DeepSHAP engine's
forward and VJPs).  The torch one keeps the reference's formulas where
PyTorch's own functions round differently: Sigmoid is ``1/(1+exp(-x))``,
Softmax subtracts the max first, BatchNormalization is ``(X − mean)·(scale
/ √(var+ε)) + bias``, AveragePool is the window sum over ``kh·kw``.  Conv
pads explicitly with ``F.pad`` (ONNX pads may be asymmetric, which
``conv2d(padding=…)`` cannot express) and adds its bias after the
convolution, as the reference does.  Integer initializers (Reshape's shape
vectors) stay host numpy, never tensors.  The torch evaluation runs in
full float32 (``utils.full_f32_matmul``: no TF32 in matmuls or cuDNN
convolutions), the reference's ``matmul_precision="highest"``.

Convolutional graphs follow ONNX layout conventions (``NCHW`` data,
``OIHW`` conv weights, a leading ``Reshape``/``Transpose`` lifting the
engine's flattened rows into image form).  A graph whose compute is purely
affine (Gemm/MatMul/Add/Identity) with at most one trailing ``Sigmoid`` /
``Softmax`` is lowered to a :class:`LinearPredictor` whose ``W``/``b`` are
recovered exactly by probing the affine part with the identity basis.
"""

import logging
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from distributedkernelshap_tpu_torch.models.predictors import BasePredictor
from distributedkernelshap_tpu_torch.utils import full_f32_matmul, resolve_device

logger = logging.getLogger(__name__)

SUPPORTED_ONNX_OPS = ("Gemm", "MatMul", "Add", "Relu", "Sigmoid", "Tanh",
                      "Softmax", "Identity", "Reshape", "Flatten",
                      "Transpose", "Conv", "MaxPool", "AveragePool",
                      "BatchNormalization")

#: ops that keep a row-wise affine function affine (the linear-extraction
#: closure); a trailing Sigmoid/Softmax on top still maps onto a
#: LinearPredictor activation
_AFFINE_OPS = frozenset({"Gemm", "MatMul", "Add", "Identity"})
_LINEAR_HEADS = {"Sigmoid": "sigmoid", "Softmax": "softmax"}


class UnsupportedOpError(ValueError):
    """The graph uses ops outside the supported subset.  ``ops`` lists
    every offending op type (sorted, deduplicated) and ``sites`` every
    offending node as ``"Op (node 'name', #position)"``."""

    def __init__(self, ops: Sequence[str],
                 sites: Optional[Sequence[str]] = None):
        self.ops = sorted(set(ops))
        self.sites = list(sites) if sites is not None else list(self.ops)
        super().__init__(
            f"ONNX graph uses unsupported op(s) {self.sites}; this "
            f"translator speaks {list(SUPPORTED_ONNX_OPS)}")


class NodeSpec(NamedTuple):
    op: str
    inputs: tuple
    outputs: tuple
    attrs: dict
    #: the ONNX node name (optional in the format; empty for hand-built
    #: specs), carried so errors can point at the node
    name: str = ""


class GraphSpec(NamedTuple):
    """Framework-free feed-forward graph: topologically ordered ``nodes``
    over ``initializers`` (numpy weights) and ONE dynamic ``input_name``
    of width ``input_dim``, producing ``output_name``."""

    nodes: List[NodeSpec]
    initializers: Dict[str, np.ndarray]
    input_name: str
    output_name: str
    input_dim: int


def node_site(node: NodeSpec, position: Optional[int] = None) -> str:
    """``"Op (node 'name'[, #position])"`` — how errors locate a node.  A
    nameless node is identified by its first output."""

    label = node.name or (node.outputs[0] if node.outputs else "?")
    pos = f", #{position}" if position is not None else ""
    return f"{node.op} (node {label!r}{pos})"


def _check_ops(spec: GraphSpec) -> None:
    bad = [(n.op, node_site(n, i)) for i, n in enumerate(spec.nodes)
           if n.op not in SUPPORTED_ONNX_OPS]
    if bad:
        raise UnsupportedOpError([op for op, _ in bad],
                                 sites=[site for _, site in bad])


def _attr_ints(attrs: dict, key: str, default) -> tuple:
    value = attrs.get(key, default)
    return tuple(int(v) for v in value)


def _attr_str(attrs: dict, key: str, default: str) -> str:
    value = attrs.get(key, default)
    return value.decode() if isinstance(value, (bytes, bytearray)) \
        else str(value)


def conv_pads(node: NodeSpec) -> Tuple[tuple, tuple]:
    """Resolve a Conv/pool node's explicit spatial padding to
    ``((top, bottom), (left, right))``.  Only ``auto_pad=NOTSET`` (explicit
    ``pads``) is spoken; SAME_*/VALID get a located error."""

    if _attr_str(node.attrs, "auto_pad", "NOTSET") != "NOTSET":
        raise ValueError(
            f"{node.op} auto_pad is not supported (export with explicit "
            f"pads): {node_site(node)}")
    pads = _attr_ints(node.attrs, "pads", (0, 0, 0, 0))
    if len(pads) != 4:
        raise ValueError(
            f"{node.op} expects 2 spatial dims (pads of length 4, got "
            f"{list(pads)}): {node_site(node)}")
    # ONNX order: [top, left, bottom, right]
    return (pads[0], pads[2]), (pads[1], pads[3])


def _np_conv(X, W, bias, strides, pads, dilations, group):
    """Reference NCHW/OIHW convolution in plain numpy: strided-slice
    accumulation over kernel taps (the parity oracle, not a fast path)."""

    N, C, H, Wd = X.shape
    O, Cg, kH, kW = W.shape
    sh, sw = strides
    dh, dw = dilations
    Xp = np.pad(X, ((0, 0), (0, 0), pads[0], pads[1]))
    Hp, Wp = Xp.shape[2], Xp.shape[3]
    Ho = (Hp - ((kH - 1) * dh + 1)) // sh + 1
    Wo = (Wp - ((kW - 1) * dw + 1)) // sw + 1
    Og = O // group
    out = np.zeros((N, O, Ho, Wo), dtype=np.float32)
    for g in range(group):
        Xg = Xp[:, g * Cg:(g + 1) * Cg]
        Wg = W[g * Og:(g + 1) * Og]
        for i in range(kH):
            for j in range(kW):
                patch = Xg[:, :, i * dh:i * dh + (Ho - 1) * sh + 1:sh,
                           j * dw:j * dw + (Wo - 1) * sw + 1:sw]
                out[:, g * Og:(g + 1) * Og] += np.einsum(
                    "nchw,oc->nohw", patch, Wg[:, :, i, j])
    if bias is not None:
        out += np.asarray(bias).reshape(1, -1, 1, 1)
    return out.astype(np.float32)


def _np_pool(X, kernel, strides, reduce_fn):
    """Reference 2-D windowed pooling (zero pads only — enforced by the
    caller): loops output positions, fine at oracle scale."""

    N, C, H, W = X.shape
    kh, kw = kernel
    sh, sw = strides
    Ho = (H - kh) // sh + 1
    Wo = (W - kw) // sw + 1
    out = np.empty((N, C, Ho, Wo), dtype=np.float32)
    for i in range(Ho):
        for j in range(Wo):
            win = X[:, :, i * sh:i * sh + kh, j * sw:j * sw + kw]
            out[:, :, i, j] = reduce_fn(win, axis=(2, 3))
    return out


def _pool_geometry(node: NodeSpec):
    """``(kernel, strides)`` for a MaxPool/AveragePool node; rejects the
    attribute corners (pads, dilation, ceil rounding) whose semantics the
    attribution rules do not model, with the node located in the error."""

    kernel = _attr_ints(node.attrs, "kernel_shape", ())
    if len(kernel) != 2:
        raise ValueError(f"{node.op} expects a 2-D kernel_shape: "
                         f"{node_site(node)}")
    strides = _attr_ints(node.attrs, "strides", kernel)
    pads = conv_pads(node)
    if any(p for pair in pads for p in pair) \
            or _attr_ints(node.attrs, "dilations", (1, 1)) != (1, 1) \
            or int(node.attrs.get("ceil_mode", 0)):
        raise ValueError(
            f"{node.op} supports only unpadded, undilated, floor-mode "
            f"windows: {node_site(node)}")
    return kernel, strides


def data_shape(arr) -> tuple:
    return tuple(int(d) for d in arr.shape)


def _reshape_target(data, shape) -> tuple:
    """ONNX Reshape semantics: 0 copies the input dim (allowzero=0), -1
    infers; the shape vector is a host integer array."""

    shape = np.asarray(shape).astype(np.int64)
    return tuple(int(data.shape[i]) if int(d) == 0 else int(d)
                 for i, d in enumerate(shape))


def _flatten_target(data, axis: int) -> tuple:
    lead = int(np.prod(data_shape(data)[:axis])) if axis else 1
    return (lead, -1)


def _eval_np(node: NodeSpec, args: list):
    """One node in numpy (the reference's ``_eval_node(np, ...)``)."""

    op, attrs = node.op, node.attrs
    if op == "Gemm":
        a = args[0].T if attrs.get("transA", 0) else args[0]
        b = args[1].T if attrs.get("transB", 0) else args[1]
        y = float(attrs.get("alpha", 1.0)) * (a @ b)
        if len(args) > 2:
            y = y + float(attrs.get("beta", 1.0)) * args[2]
        return y
    if op == "MatMul":
        return args[0] @ args[1]
    if op == "Add":
        return args[0] + args[1]
    if op == "Relu":
        return np.maximum(args[0], 0)
    if op == "Sigmoid":
        return 1.0 / (1.0 + np.exp(-args[0]))
    if op == "Tanh":
        return np.tanh(args[0])
    if op == "Softmax":
        axis = int(attrs.get("axis", -1))
        z = args[0] - np.max(args[0], axis=axis, keepdims=True)
        e = np.exp(z)
        return e / np.sum(e, axis=axis, keepdims=True)
    if op == "Identity":
        return args[0]
    if op == "Reshape":
        return np.reshape(args[0], _reshape_target(args[0], args[1]))
    if op == "Flatten":
        return np.reshape(args[0], _flatten_target(args[0], int(attrs.get("axis", 1))))
    if op == "Transpose":
        perm = _attr_ints(attrs, "perm", tuple(reversed(range(args[0].ndim))))
        return np.transpose(args[0], perm)
    if op == "Conv":
        bias = args[2] if len(args) > 2 else None
        return _np_conv(np.asarray(args[0], np.float32), np.asarray(args[1], np.float32),
                        bias, _attr_ints(attrs, "strides", (1, 1)), conv_pads(node),
                        _attr_ints(attrs, "dilations", (1, 1)), int(attrs.get("group", 1)))
    if op in ("MaxPool", "AveragePool"):
        kernel, strides = _pool_geometry(node)
        fn = np.max if op == "MaxPool" else np.mean
        return _np_pool(np.asarray(args[0], np.float32), kernel, strides, fn)
    if op == "BatchNormalization":
        X, scale, bias, mean, var = args[:5]
        eps = float(attrs.get("epsilon", 1e-5))
        shape = (1, -1) + (1,) * (X.ndim - 2)
        scale, bias, mean, var = (np.reshape(np.asarray(a), shape)
                                  for a in (scale, bias, mean, var))
        # inference-mode BN is the folded per-channel affine transform
        return (X - mean) * (scale / np.sqrt(var + eps)) + bias
    raise UnsupportedOpError([op], sites=[node_site(node)])


def window_sum(X: torch.Tensor, kernel, strides) -> torch.Tensor:
    """The sum over each unpadded window of an NCHW tensor (the
    reference's ``reduce_window(add, 'VALID')``): trailing rows and
    columns that fill no window are dropped."""

    return F.avg_pool2d(X, tuple(kernel), tuple(strides), divisor_override=1)


def window_max(X: torch.Tensor, kernel, strides) -> torch.Tensor:
    """The max over each unpadded window of an NCHW tensor (the
    reference's ``reduce_window(max, -inf, 'VALID')``); its VJP routes to
    the first maximum of a window, as XLA's select-and-scatter does."""

    return F.max_pool2d(X, tuple(kernel), tuple(strides))


def _eval_torch(node: NodeSpec, args: list):
    """One node in torch (the reference's ``_eval_node(jnp, ...)``), with
    the reference's formulas; the caller holds the full-f32 span."""

    op, attrs = node.op, node.attrs
    if op == "Gemm":
        a = args[0].T if attrs.get("transA", 0) else args[0]
        b = args[1].T if attrs.get("transB", 0) else args[1]
        y = float(attrs.get("alpha", 1.0)) * (a @ b)
        if len(args) > 2:
            y = y + float(attrs.get("beta", 1.0)) * args[2]
        return y
    if op == "MatMul":
        return args[0] @ args[1]
    if op == "Add":
        return args[0] + args[1]
    if op == "Relu":
        return torch.clamp_min(args[0], 0.0)
    if op == "Sigmoid":
        return 1.0 / (1.0 + torch.exp(-args[0]))
    if op == "Tanh":
        return torch.tanh(args[0])
    if op == "Softmax":
        axis = int(attrs.get("axis", -1))
        z = args[0] - torch.amax(args[0], dim=axis, keepdim=True)
        e = torch.exp(z)
        return e / torch.sum(e, dim=axis, keepdim=True)
    if op == "Identity":
        return args[0]
    if op == "Reshape":
        return torch.reshape(args[0], _reshape_target(args[0], args[1]))
    if op == "Flatten":
        return torch.reshape(args[0], _flatten_target(args[0], int(attrs.get("axis", 1))))
    if op == "Transpose":
        perm = _attr_ints(attrs, "perm", tuple(reversed(range(args[0].ndim))))
        return args[0].permute(perm)
    if op == "Conv":
        X, W = args[0], args[1]
        (top, bottom), (left, right) = conv_pads(node)
        y = F.conv2d(F.pad(X, (left, right, top, bottom)), W, None,
                     stride=_attr_ints(attrs, "strides", (1, 1)),
                     dilation=_attr_ints(attrs, "dilations", (1, 1)),
                     groups=int(attrs.get("group", 1)))
        if len(args) > 2:
            y = y + torch.reshape(args[2], (1, -1, 1, 1))
        return y
    if op == "MaxPool":
        return window_max(args[0], *_pool_geometry(node))
    if op == "AveragePool":
        kernel, strides = _pool_geometry(node)
        return window_sum(args[0], kernel, strides) / float(kernel[0] * kernel[1])
    if op == "BatchNormalization":
        X, scale, bias, mean, var = args[:5]
        eps = float(attrs.get("epsilon", 1e-5))
        shape = (1, -1) + (1,) * (X.ndim - 2)
        scale, bias, mean, var = (torch.reshape(a, shape)
                                  for a in (scale, bias, mean, var))
        return (X - mean) * (scale / torch.sqrt(var + eps)) + bias
    raise UnsupportedOpError([op], sites=[node_site(node)])


def _eval_node(xp, node: NodeSpec, values: dict):
    """Evaluate one node with array module ``xp`` (numpy or torch): the
    single op-semantics implementation shared by the device predictor, the
    linear-extraction probe, the output-shape probe and the DeepSHAP
    engine's forward and VJP passes."""

    args = [values[name] for name in node.inputs]
    return (_eval_np if xp is np else _eval_torch)(node, args)


def _run_graph(xp, spec: GraphSpec, values: dict, X):
    values = dict(values)
    values[spec.input_name] = X
    for node in spec.nodes:
        out = _eval_node(xp, node, values)
        for name in node.outputs:
            values[name] = out
    return values[spec.output_name]


def run_graph_reference(spec: GraphSpec, X: np.ndarray) -> np.ndarray:
    """Numpy reference evaluation of the graph — the parity-test oracle
    (and the linear-extraction probe's engine)."""

    values = {name: np.asarray(arr) for name, arr in spec.initializers.items()}
    return np.asarray(_run_graph(np, spec, values, np.asarray(X, np.float32)),
                      dtype=np.float32)


def run_graph_torch(spec: GraphSpec, X: torch.Tensor) -> torch.Tensor:
    """Torch evaluation of the graph on ``X``'s device (float initializers
    copied there, integer ones kept host numpy), in full float32."""

    values = {name: (torch.tensor(np.asarray(arr, np.float32), device=X.device)
                     if np.asarray(arr).dtype.kind == "f" else np.asarray(arr))
              for name, arr in spec.initializers.items()}
    with full_f32_matmul():
        return _run_graph(torch, spec, values, X.to(torch.float32))


def _try_linear(spec: GraphSpec, device=None):
    """Lower an affine(+head) graph to ``LinearPredictor`` — or ``None``.

    The affine part is recovered exactly by probing with the identity
    basis: for row-wise affine ``f``, ``b = f(0)`` and ``W = f(I) - b``,
    in float32 numpy on the values the graph itself computes."""

    ops = [n.op for n in spec.nodes]
    head = None
    if ops and ops[-1] in _LINEAR_HEADS:
        head = _LINEAR_HEADS[ops[-1]]
        body = spec.nodes[:-1]
    else:
        body = spec.nodes
    if not body or not all(n.op in _AFFINE_OPS for n in body):
        return None
    pre = GraphSpec(list(body), spec.initializers, spec.input_name,
                    body[-1].outputs[0], spec.input_dim)
    D = spec.input_dim
    try:
        b = run_graph_reference(pre, np.zeros((1, D), np.float32))
        WI = run_graph_reference(pre, np.eye(D, dtype=np.float32))
    except Exception:
        return None  # shape-incompatible probe: not a row-wise affine map
    if b.ndim != 2 or b.shape[0] != 1 or WI.shape != (D, b.shape[1]):
        return None
    from distributedkernelshap_tpu_torch.models.predictors import LinearPredictor

    W = WI - b  # (D, K)
    # faithfulness probe: a Gemm with transA (or any other batch-coupling
    # oddity) is not row-wise affine even though its ops are in the affine
    # set — verify the extraction reproduces the graph before trusting it
    rng = np.random.default_rng(0)
    probe = rng.normal(size=(5, D)).astype(np.float32)
    try:
        want = run_graph_reference(pre, probe)
    except Exception:
        return None
    if want.shape != (5, W.shape[1]) \
            or not np.allclose(probe @ W + b[0], want, atol=1e-4):
        return None
    activation = head or "identity"
    if activation == "sigmoid" and W.shape[1] == 1:
        # binary logistic regression: a single sigmoid logit is
        # softmax([0, z]) — the two-column form of the predict_proba lift
        W2 = np.concatenate([np.zeros_like(W), W], axis=1)
        b2 = np.concatenate([np.zeros_like(b[0]), b[0]])
        return LinearPredictor(W2, b2, activation="softmax", device=device)
    return LinearPredictor(W, b[0], activation=activation,
                           vector_out=W.shape[1] > 1, device=device)


class ONNXPredictor(BasePredictor):
    """A lifted graph the linear lowering declines (MLPs, CNNs): ``(n, D)
    -> (n, K)`` over the graph's initializers on the device.

    Float initializers are buffers, so ``.to()`` and ``save`` / ``load``
    carry them.  ONNX tensor names may hold ``.`` or ``/``, which buffer
    names may not, so the buffers are named ``init_<i>`` and ``_buffer_of``
    maps graph names to them.  Integer initializers (Reshape shape
    vectors) stay host numpy.  :meth:`graph_spec` is the hook the DeepSHAP
    path classifies on."""

    vector_out = True
    supports_masked_ey = False

    def __init__(self, spec: GraphSpec,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        dev = resolve_device(device)
        self.spec = spec
        self.device = dev
        self._buffer_of: Dict[str, str] = {}
        self._static: Dict[str, np.ndarray] = {}
        for i, (name, arr) in enumerate(spec.initializers.items()):
            arr = np.asarray(arr)
            if arr.dtype.kind == "f":
                self._buffer_of[name] = f"init_{i}"
                self.register_buffer(f"init_{i}", torch.tensor(arr.astype(np.float32),
                                                               device=dev))
            else:
                self._static[name] = arr
        probe = run_graph_reference(spec, np.zeros((2, spec.input_dim), np.float32))
        self.n_outputs = int(probe.shape[1]) if probe.ndim > 1 else 1
        self.vector_out = probe.ndim > 1

    def float_initializers(self) -> Dict[str, torch.Tensor]:
        """The float initializers on the device, by graph name."""

        return {name: getattr(self, buf) for name, buf in self._buffer_of.items()}

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        values = dict(self._static)
        values.update(self.float_initializers())
        with full_f32_matmul():
            out = _run_graph(torch, self.spec, values, X.to(torch.float32))
        return out[:, None] if out.ndim == 1 else out

    def host_fn(self, X: np.ndarray) -> np.ndarray:
        out = run_graph_reference(self.spec, X)
        return out[:, None] if out.ndim == 1 else out

    def graph_spec(self) -> GraphSpec:
        """The lifted graph, with numpy initializers (``attribution/
        deepshap.py`` duck-types on this method)."""

        return self.spec

    def fingerprint_bytes(self) -> bytes:
        """Content bytes for the engine's device-cache fingerprint, equal
        to the reference's for the same spec: equal topology and equal
        initializer bytes are the same attribution program."""

        parts = [b"onnx-graph",
                 repr([(n.op, n.inputs, n.outputs, sorted(n.attrs.items(), key=repr))
                       for n in self.spec.nodes]).encode(),
                 self.spec.input_name.encode(),
                 self.spec.output_name.encode()]
        for name in sorted(self.spec.initializers):
            arr = np.asarray(self.spec.initializers[name])
            parts.append(name.encode())
            parts.append(str(arr.shape).encode())
            parts.append(arr.tobytes())
        return b"".join(parts)


def lift_graph(spec: GraphSpec, device: Optional[Union[str, torch.device]] = None):
    """Translate a :class:`GraphSpec` into a predictor on ``device``: a
    ``LinearPredictor`` when the graph is affine(+head), else an
    :class:`ONNXPredictor`.  Raises :class:`UnsupportedOpError` listing
    every op outside the subset."""

    _check_ops(spec)
    linear = _try_linear(spec, device)
    if linear is not None:
        logger.info("ONNX graph lowered to a LinearPredictor (D=%d, K=%d, %s) — "
                    "linear fast path", spec.input_dim, linear.n_outputs, linear.activation)
        return linear
    pred = ONNXPredictor(spec, device)
    logger.info("ONNX graph lifted to a device predictor (%d nodes, D=%d, K=%d)",
                len(spec.nodes), spec.input_dim, pred.n_outputs)
    return pred


# --------------------------------------------------------------------- #
# ONNX ModelProto -> GraphSpec (the optional-import half)


def _require_onnx():
    try:
        import onnx  # noqa: F401

        return onnx
    except ImportError as e:
        raise ImportError(
            "ONNX ingest needs the optional 'onnx' package "
            "(requirements_advanced.txt); the rest of the registry works "
            "without it") from e


def graph_spec_from_onnx(model) -> GraphSpec:
    """Decode an ONNX ``ModelProto`` into a :class:`GraphSpec`."""

    onnx = _require_onnx()
    from onnx import numpy_helper

    graph = model.graph
    initializers = {init.name: np.asarray(numpy_helper.to_array(init))
                    for init in graph.initializer}
    dynamic_inputs = [i for i in graph.input if i.name not in initializers]
    if len(dynamic_inputs) != 1:
        raise ValueError(
            f"expected exactly one dynamic graph input, got "
            f"{[i.name for i in dynamic_inputs]}")
    if len(graph.output) != 1:
        raise ValueError(
            f"expected exactly one graph output, got "
            f"{[o.name for o in graph.output]}")
    inp = dynamic_inputs[0]
    dims = inp.type.tensor_type.shape.dim
    if len(dims) != 2 or not dims[1].dim_value:
        raise ValueError(
            "expected a (batch, features) input with a static feature "
            "dim; got "
            + str([d.dim_value or d.dim_param for d in dims]))
    nodes = []
    for node in graph.node:
        attrs = {a.name: onnx.helper.get_attribute_value(a) for a in node.attribute}
        nodes.append(NodeSpec(node.op_type, tuple(node.input),
                              tuple(node.output), attrs, node.name))
    return GraphSpec(nodes, initializers, inp.name, graph.output[0].name,
                     int(dims[1].dim_value))


def lift_onnx(source, device: Optional[Union[str, torch.device]] = None):
    """Lift an ONNX model — a ``ModelProto``, serialized ``bytes``, or a
    file path — into a predictor on ``device`` (see :func:`lift_graph`)."""

    onnx = _require_onnx()
    if isinstance(source, (bytes, bytearray)):
        model = onnx.load_model_from_string(bytes(source))
    elif isinstance(source, str):
        model = onnx.load(source)
    else:
        model = source
    return lift_graph(graph_spec_from_onnx(model), device)
