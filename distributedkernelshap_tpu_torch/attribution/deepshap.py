"""DeepSHAP/DeepLIFT backprop attribution for lifted neural graphs.

Port of ``distributedkernelshap_tpu/attribution/deepshap.py``.  KernelSHAP
estimates interventional Shapley values by sampling coalitions and
re-evaluating the model over the synthetic composites.  DeepSHAP (Lundberg
& Lee 2017's DeepLIFT-as-SHAP formulation; ONNXExplainer, arXiv
2309.16916) rewrites the computation instead: for each (instance ``x``,
background row ``z``) pair, propagate *multipliers* ``m = Δoutput/Δinput``
from the graph output back to the input through per-layer rules, and read
the attribution off as ``phi_d = m_d · (x_d - z_d)``.

Layer rules:

* **linear rule** — Gemm / MatMul / Add / Conv / AveragePool /
  BatchNormalization / Transpose / Reshape / Flatten / Identity: affine
  maps, so the multiplier backprop is the transposed linear map — the
  ``torch.func.vjp`` of the node's own torch evaluation
  (``registry/onnx_lift._eval_node``), the K output multipliers taken by
  ``torch.func.vmap`` over the VJP.  The same evaluation defines the
  forward and the backward pass.
* **rescale rule** — Relu / Sigmoid / Tanh: ``m_in = m_out · (f(a_x) -
  f(a_z)) / (a_x - a_z)``, with the derivative at the midpoint where
  ``|a_x - a_z| <= 1e-6``.
* **maxpool rule** — MaxPool with non-overlapping windows: each window's
  multiplier routes to the position of its largest ``|Δin|`` (the VJP of
  a windowed max; on a tie the first position of the window, as XLA's
  select-and-scatter and ``F.max_pool2d`` both pick), rescaled so the
  window's contribution telescopes to ``m_out·Δout``.  Unpadded windows
  drop the trailing rows and columns, whose multiplier is zero.

Completeness holds for every supported graph (``Σ_d phi_d = f(x) - Σ_n w_n
f(z_n)``), and the values are exact Shapley values for feature-separable
and coalition-stable piecewise-linear nets (see the reference's
docstring); :func:`brute_force_shapley` is the float64 oracle.

The batch entry maps instances with ``torch.func.vmap`` over the
reference's per-instance function (each instance evaluated as a batch of
one, ``x[None]``), loops over background rows one at a time (the
reference's ``lax.map``: one row's multiplier tensors live at once),
contracts the stacked rows with the normalised weights in one einsum and
folds features into groups (superpixels) with a second, inside the full
float32 span (``utils.full_f32_matmul``: no TF32 in matmuls or cuDNN) with
cuDNN held to deterministic algorithms, so an explain repeats bit for bit.
No hand kernel: the JAX package computes this outside any Pallas kernel.

Every reason the path declines a graph-bearing predictor is counted
(:func:`deepshap_fallback_counts`; :func:`attach_deepshap_metrics` takes a
metrics registry by duck typing).
"""

import contextlib
import logging
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import vjp, vmap

from distributedkernelshap_tpu_torch.ops.explain import record_kernel_path
from distributedkernelshap_tpu_torch.registry.onnx_lift import (
    GraphSpec,
    NodeSpec,
    _eval_node,
    _pool_geometry,
    run_graph_reference,
    window_max,
    window_sum,
)
from distributedkernelshap_tpu_torch.utils import full_f32_matmul

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------- #
# Layer-rule table

#: affine maps: multiplier backprop == transposed linear map == VJP
LINEAR_RULE_OPS = frozenset({
    "Gemm", "MatMul", "Add", "Conv", "AveragePool", "BatchNormalization",
    "Transpose", "Reshape", "Flatten", "Identity",
})
#: elementwise nonlinearities: the DeepLIFT rescale rule
RESCALE_RULE_OPS = frozenset({"Relu", "Sigmoid", "Tanh"})
#: windowed max: argmax routing + per-window rescale
POOL_RULE_OPS = frozenset({"MaxPool"})

RULE_COVERED_OPS = LINEAR_RULE_OPS | RESCALE_RULE_OPS | POOL_RULE_OPS

#: |Δin| below this uses the derivative-at-midpoint limit instead of the
#: difference quotient (rescale rule) / zeroes the window ratio (maxpool)
_EPS = 1e-6

#: nominal batch size for the X-independent footprint gate
_NOMINAL_GATE_B = 256


# ---------------------------------------------------------------------- #
# Fallback accounting (as ops/tensor_shap.py)

_fallback_lock = threading.Lock()
_fallback_counts: Dict[str, float] = {}
_fallback_logged: set = set()


def record_deepshap_fallback(reason: str, detail: str = "") -> None:
    """Count one DeepSHAP demotion back to the sampled estimator; warn
    on the first occurrence of each reason."""

    with _fallback_lock:
        _fallback_counts[reason] = _fallback_counts.get(reason, 0.0) + 1.0
        first = reason not in _fallback_logged
        if first:
            _fallback_logged.add(reason)
    if first:
        logger.warning(
            "DeepSHAP attribution declined a graph-bearing predictor "
            "(reason=%s%s); counted in dks_deepshap_fallback_total — "
            "further occurrences are counted silently", reason,
            f": {detail}" if detail else "")


def deepshap_fallback_counts() -> Dict[Tuple[str, ...], float]:
    """``{(reason,): count}`` — the registry-callback shape."""

    with _fallback_lock:
        return {(r,): n for r, n in _fallback_counts.items()}


def attach_deepshap_metrics(registry) -> None:
    """Register ``dks_deepshap_fallback_total{reason}`` on ``registry``
    as a callback counter over the process-global fallback accounting."""

    registry.counter(
        "dks_deepshap_fallback_total",
        "DeepSHAP attribution demotion EVENTS back to the sampled "
        "estimator for predictors that carry a lifted neural graph, by "
        "reason (rule = a node outside the layer-rule table, e.g. "
        "Softmax; bilinear = a product node with more than one dynamic "
        "input; pool_overlap = MaxPool windows overlap; link = "
        "non-identity link would change the target quantity; "
        "output_shape = graph output is not (batch, K); footprint = "
        "multiplier tensors exceed the chunk budget; auto_disabled = "
        "DKS_DEEPSHAP_AUTO opt-out).  Counted when the path decision is "
        "made (auto-select / readiness probe), not per served request.",
        labelnames=("reason",)).set_function(deepshap_fallback_counts)


# ---------------------------------------------------------------------- #
# Structure probes and gates


def graph_spec_of(pred) -> Optional[GraphSpec]:
    """The predictor's lifted graph, or ``None``.  Duck-typed on the
    ``graph_spec`` method (``registry/onnx_lift.ONNXPredictor``,
    ``models/cnn.CNNPredictor``)."""

    fn = getattr(pred, "graph_spec", None)
    if fn is None:
        return None
    try:
        spec = fn()
    except Exception:  # a broken structure probe must never crash a path
        logger.debug("graph_spec probe failed", exc_info=True)
        return None
    return spec if isinstance(spec, GraphSpec) else None


def supports_deepshap(pred) -> bool:
    """Whether ``pred`` carries a lifted neural graph whose every node
    has an attribution rule — the structural precondition of the
    DeepSHAP path (gates beyond structure: :func:`deepshap_ready`)."""

    spec = graph_spec_of(pred)
    return (spec is not None
            and all(n.op in RULE_COVERED_OPS for n in spec.nodes))


def _produced_names(spec: GraphSpec) -> set:
    names = {spec.input_name}
    for node in spec.nodes:
        names.update(node.outputs)
    return names


def _structure_reason(spec: GraphSpec) -> Optional[str]:
    """Graph-shape gates shared by readiness and validation: every node
    rule-covered, product nodes single-dynamic, pools non-overlapping."""

    uncovered = sorted({n.op for n in spec.nodes
                        if n.op not in RULE_COVERED_OPS})
    if uncovered:
        return "rule"
    dynamic = _produced_names(spec)
    for node in spec.nodes:
        dyn = [n for n in node.inputs if n in dynamic]
        if node.op in ("Gemm", "MatMul", "Conv") and len(dyn) > 1:
            # a product of two data-dependent tensors is bilinear, not
            # affine — the linear rule's VJP-at-x would be wrong
            return "bilinear"
        if node.op in ("BatchNormalization", "Reshape") \
                and any(n in dynamic for n in node.inputs[1:]):
            # BN is affine only for constant scale/mean/var, and a
            # Reshape's shape must be a static initializer
            return "bilinear"
        if node.op in POOL_RULE_OPS:
            kernel, strides = _pool_geometry(node)
            if strides[0] < kernel[0] or strides[1] < kernel[1]:
                return "pool_overlap"
    return None


def deepshap_ready(pred, link: str, G=None,
                   target_chunk_elems: Optional[int] = None) -> Optional[str]:
    """``None`` when the DeepSHAP path can serve this (predictor, link,
    grouping), else the fallback reason string.  Any 0/1 ``(M, D)``
    grouping is accepted: group phi is the sum of the member features'
    phi (the superpixel convention of image SHAP)."""

    spec = graph_spec_of(pred)
    if spec is None:
        return "structure"
    try:
        reason = _structure_reason(spec)
    except Exception:
        return "rule"
    if reason is not None:
        return reason
    if link != "identity":
        return "link"
    D = spec.input_dim
    try:
        probe = run_graph_reference(spec, np.zeros((2, D), np.float32))
    except Exception:
        return "rule"
    if probe.ndim != 2 or probe.shape[0] != 2:
        return "output_shape"
    K = int(probe.shape[1])
    if G is not None and np.asarray(G).shape[-1] != D:
        return "grouping"
    # footprint gate: one background row's live multiplier state is
    # ~B×K×D for the input multipliers plus the forward activation pair;
    # bound it by the same chunk budget every other path honours
    budget = target_chunk_elems or (1 << 25)
    if _NOMINAL_GATE_B * max(K, 1) * D * 4 > budget:
        return "footprint"
    return None


def validate_deepshap(pred, link: str, G=None) -> None:
    """Raise with an actionable message when ``nsamples='exact'`` cannot
    run the DeepSHAP backprop for this configuration."""

    reason = deepshap_ready(pred, link, G)
    if reason is None:
        return
    detail = {
        "structure": "the predictor exposes no lifted graph (lift it "
                     "via registry/onnx_lift or models/cnn.graph_spec)",
        "rule": "the graph contains a node outside the attribution rule "
                "table (e.g. Softmax — export the logits head instead)",
        "bilinear": "a Gemm/MatMul/Conv node multiplies two "
                    "data-dependent tensors; the linear rule only "
                    "covers affine maps",
        "pool_overlap": "MaxPool windows overlap (stride < kernel); "
                        "the maxpool rule needs disjoint windows",
        "link": f"link={link!r} would change the target quantity; the "
                "backprop attributes the raw graph output — use "
                "link='identity'",
        "grouping": "the group matrix does not span the graph's input "
                    "features",
        "output_shape": "the graph output is not a (batch, K) tensor",
        "footprint": "the multiplier tensors exceed the chunk budget at "
                     "this (D, K); use the sampled path",
    }[reason]
    raise ValueError(
        f"nsamples='exact' (DeepSHAP backprop) cannot apply: {detail}.")


# ---------------------------------------------------------------------- #
# The multiplier propagation engine


def _split_initializers(spec: GraphSpec):
    """``(float_names, static_vals)``: float initializers are tensor
    arguments of the attribution function (the engine keeps them on the
    device in its content-fingerprint cache); integer ones (Reshape shape
    vectors) stay host numpy."""

    float_names: List[str] = []
    static_vals: Dict[str, np.ndarray] = {}
    for name, arr in spec.initializers.items():
        if np.asarray(arr).dtype.kind == "f":
            float_names.append(name)
        else:
            static_vals[name] = np.asarray(arr)
    return sorted(float_names), static_vals


def _forward_values(spec: GraphSpec, base: dict, X) -> dict:
    """Forward pass recording every edge tensor (the rescale rule needs
    the activation pair at each nonlinearity)."""

    values = dict(base)
    values[spec.input_name] = X
    for node in spec.nodes:
        out = _eval_node(torch, node, values)
        for name in node.outputs:
            values[name] = out
    return values


def _rescale_ratio(op: str, ax, az):
    """Elementwise ``Δout/Δin`` with the derivative-at-midpoint limit
    where ``|Δin|`` vanishes."""

    if op == "Relu":
        fx, fz = torch.clamp_min(ax, 0.0), torch.clamp_min(az, 0.0)
        mid_deriv = (0.5 * (ax + az) > 0).to(ax.dtype)
    elif op == "Sigmoid":
        fx, fz = torch.sigmoid(ax), torch.sigmoid(az)
        s = torch.sigmoid(0.5 * (ax + az))
        mid_deriv = s * (1.0 - s)
    else:  # Tanh
        fx, fz = torch.tanh(ax), torch.tanh(az)
        t = torch.tanh(0.5 * (ax + az))
        mid_deriv = 1.0 - t * t
    din = ax - az
    big = torch.abs(din) > _EPS
    safe = torch.where(big, din, torch.ones_like(din))
    return torch.where(big, (fx - fz) / safe, mid_deriv)


def _accumulate(mult: dict, name: str, m) -> None:
    prev = mult.get(name)
    mult[name] = m if prev is None else prev + m


def _backprop_node(node: NodeSpec, m_out, vx: dict, vz: dict,
                   dynamic: set, mult: dict) -> None:
    """Propagate the output multiplier ``m_out`` (leading K axis over
    graph outputs) of one node onto its dynamic inputs."""

    dyn = [n for n in node.inputs if n in dynamic]
    if not dyn:
        return
    if node.op in RESCALE_RULE_OPS:
        inp = dyn[0]
        _accumulate(mult, inp, m_out * _rescale_ratio(node.op, vx[inp], vz[inp]))
        return
    if node.op in POOL_RULE_OPS:
        inp = dyn[0]
        ax, az = vx[inp], vz[inp]
        diff = ax - az
        kernel, strides = _pool_geometry(node)

        def maxw(t):
            return window_max(t, kernel, strides)

        def sumw(t):
            return window_sum(t, kernel, strides)

        dout = maxw(ax) - maxw(az)
        # route each window's multiplier to its argmax-|Δin| position (the
        # VJP of the windowed max over |Δin|), rescaled so the window's
        # contribution telescopes to m_out·Δout exactly; routing by |Δin|
        # bounds the eps-guard leak (reference deepshap.py:388-397)
        _, vjp_abs = vjp(maxw, torch.abs(diff))
        sel = vjp_abs(torch.ones_like(dout))[0]
        din_sel = sumw(sel * diff)
        big = torch.abs(din_sel) > _EPS
        safe = torch.where(big, din_sel, torch.ones_like(din_sel))
        ratio = torch.where(big, dout / safe, torch.zeros_like(dout))
        _, vjp_sum = vjp(sumw, diff)  # linear: broadcast to windows
        m_in = vmap(lambda mo: sel * vjp_sum(mo * ratio)[0])(m_out)
        _accumulate(mult, inp, m_in)
        return
    # linear rule: the node is an affine map of its dynamic inputs, so
    # its VJP (which linearises and drops constants) is the multiplier
    # backprop — evaluated at x, though any point would do
    statics = {n: vx[n] for n in node.inputs if n not in dynamic}

    def node_fn(*dargs):
        local = dict(statics)
        for name, arg in zip(dyn, dargs):
            local[name] = arg
        return _eval_node(torch, node, local)

    _, vjp_fn = vjp(node_fn, *[vx[n] for n in dyn])
    cots = vmap(vjp_fn)(m_out)
    for name, cot in zip(dyn, cots):
        _accumulate(mult, name, cot)


def _phi_pair(spec: GraphSpec, base: dict, dynamic: set, K: int, x, z):
    """Per-feature attribution ``(K, D)`` of one instance ``x`` against
    one background row ``z``: forward both, propagate multipliers output
    → input through the rule table, read off ``m · (x - z)``."""

    vx = _forward_values(spec, base, x[None])
    vz = _forward_values(spec, base, z[None])
    out = vx[spec.output_name]
    mult = {spec.output_name:
            torch.eye(K, dtype=out.dtype, device=out.device).reshape(K, 1, K)}
    for node in reversed(spec.nodes):
        m_out = mult.pop(node.outputs[0], None)
        if m_out is None:
            continue  # branch not reaching the explained output
        _backprop_node(node, m_out, vx, vz, dynamic, mult)
    m_in = mult.get(spec.input_name)
    if m_in is None:
        # output independent of the input (constant graph): zero phi
        return torch.zeros((K, x.shape[0]), dtype=out.dtype, device=out.device)
    return m_in[:, 0, :] * (x - z)[None, :]


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms inside the block (the
    caller's setting is back on exit): some of cuDNN's backward-data
    convolutions accumulate with atomics, and the exact path's answers must
    repeat bit for bit (a cached explain equals a rebuilt one, a staged one
    the synchronous one), as the reference's do."""

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def build_deepshap_fn(spec: GraphSpec, K: int):
    """Build the batch attribution entry for ``spec``: ``fn(X (B, D),
    params, bg (N, D), bgw_n (N,), G (M, D)) -> phi (B, K, M)``.

    ``params`` is the dict of float initializers on the device (the engine
    serves it from its content-fingerprint cache); integer initializers are
    host values.  Instances are vmapped over the per-instance function,
    background rows taken one at a time, and the weighted background
    reduction and the feature→group fold are each one einsum, in full
    float32."""

    float_names, static_vals = _split_initializers(spec)
    dynamic = _produced_names(spec)

    def phi_fn(X, params, bg, bgw_n, G):
        record_kernel_path("exact_phi", "deepshap")
        base = dict(static_vals)
        for name in float_names:
            base[name] = params[name]
        with full_f32_matmul(), _deterministic_cudnn():
            rows = torch.stack([
                vmap(lambda x, z=z: _phi_pair(spec, base, dynamic, K, x, z))(X)
                for z in bg])                                 # (N, B, K, D)
            feat = torch.einsum("n,nbkd->bkd", bgw_n, rows)  # (B, K, D)
            return torch.einsum("bkd,md->bkm", feat, G)      # (B, K, M)

    return phi_fn


# ---------------------------------------------------------------------- #
# Brute-force ground truth (tests / accuracy gate — never a serving path)


def brute_force_shapley(host_fn, x: np.ndarray, bg: np.ndarray,
                        bgw: Optional[np.ndarray] = None,
                        G: Optional[np.ndarray] = None) -> np.ndarray:
    """Exact interventional Shapley values ``(K, M)`` for ONE instance by
    full ``2^M`` coalition enumeration — the ground-truth oracle the
    DeepSHAP exactness claims are held to.  ``host_fn`` is a host ``(n, D)
    -> (n, K)`` callable; ``G`` the 0/1 ``(M, D)`` group matrix (identity
    when omitted).  Float64 accumulation; refuses M > 16."""

    x = np.asarray(x, np.float64).reshape(-1)
    bg = np.atleast_2d(np.asarray(bg, np.float64))
    D = x.shape[0]
    G = np.eye(D) if G is None else np.asarray(G, np.float64)
    M = G.shape[0]
    if M > 16:
        raise ValueError(f"brute force is 2^M; M={M} is past the oracle "
                         "ceiling of 16")
    N = bg.shape[0]
    w = (np.ones(N) if bgw is None else np.asarray(bgw, np.float64))
    w = w / w.sum()

    n_coal = 1 << M
    masks = ((np.arange(n_coal)[:, None] >> np.arange(M)[None, :]) & 1
             ).astype(np.float64)                     # (2^M, M)
    cols = np.clip(masks @ G, 0.0, 1.0)               # (2^M, D)
    # composite rows: coalition features from x, the rest from each bg row
    rows = (cols[:, None, :] * x[None, None, :]
            + (1.0 - cols)[:, None, :] * bg[None, :, :])  # (2^M, N, D)
    fx = np.asarray(host_fn(rows.reshape(-1, D).astype(np.float32)), np.float64)
    K = fx.shape[1] if fx.ndim > 1 else 1
    v = (fx.reshape(n_coal, N, K) * w[None, :, None]).sum(1)  # (2^M, K)

    from math import factorial

    fM = factorial(M)
    size_w = np.array([factorial(s) * factorial(M - 1 - s) / fM
                       for s in range(M)])
    sizes = masks.sum(1).astype(int)                  # (2^M,)
    phi = np.zeros((K, M))
    for m in range(M):
        without = masks[:, m] == 0
        idx = np.nonzero(without)[0]
        with_m = idx | (1 << m)                       # S ∪ {m}
        wgt = size_w[sizes[idx]]
        phi[:, m] = ((v[with_m] - v[idx]) * wgt[:, None]).sum(0)
    return phi
