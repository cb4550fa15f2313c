"""The PyTorch port's ONNX graph lift (``registry/onnx_lift.py``) against
the JAX package's, on the CPU.

Each of the 15 ops is evaluated at the cases of ``tests/test_onnx_lift.py``
(``chip_smoke.graph_op_cases``, which phase 34 runs on the card): the
port's torch evaluation against the JAX package's ``_eval_node(jnp, ...)``
and its numpy reference within 1e-5 · max(1, |y|), and the port's numpy
reference equal to the JAX one bit for bit.  Affine graphs lower to
``LinearPredictor``s whose ``W``, ``b`` and activation are ``array_equal``
to the JAX lift's; error messages, rejected attribute corners and
fingerprint bytes compare exactly.  ``onnx`` is installed nowhere, so the
ModelProto half is tested only for its ``ImportError``.
"""

import builtins
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from distributedkernelshap_tpu.registry import onnx_lift as jol
from distributedkernelshap_tpu_torch.models.predictors import LinearPredictor
from distributedkernelshap_tpu_torch.registry import onnx_lift as tol

REL = 1e-5
CASES = chip_smoke.graph_op_cases(np.random.default_rng(34))


def to_jax(spec):
    """The same graph as a JAX-package ``GraphSpec``."""

    return jol.GraphSpec([jol.NodeSpec(*n) for n in spec.nodes], dict(spec.initializers),
                         spec.input_name, spec.output_name, spec.input_dim)


def test_cases_cover_every_supported_op():
    assert tol.SUPPORTED_ONNX_OPS == jol.SUPPORTED_ONNX_OPS
    assert {n.op for _, spec, _ in CASES for n in spec.nodes} == set(tol.SUPPORTED_ONNX_OPS)


@pytest.mark.parametrize("label,spec,X", CASES, ids=[c[0] for c in CASES])
def test_torch_evaluation_matches_the_jax_and_numpy_references(label, spec, X):
    ref = tol.run_graph_reference(spec, X)
    assert np.array_equal(ref, jol.run_graph_reference(to_jax(spec), X))
    jax_y = np.asarray(jol._run_graph(jnp, to_jax(spec), jnp.asarray(X)))
    got = tol.run_graph_torch(spec, torch.as_tensor(X)).numpy()
    assert got.shape == ref.shape == jax_y.shape
    assert chip_smoke.graph_rel_err(got, jax_y) <= REL
    assert chip_smoke.graph_rel_err(got, ref) <= REL


def _affine_spec(K, head, seed):
    rng = np.random.default_rng(seed)
    nodes = [tol.NodeSpec("Gemm", ("X", "W", "b"), ("z",), {})]
    if head:
        nodes.append(tol.NodeSpec(head, ("z",), ("y",), {"axis": -1} if head == "Softmax"
                                  else {}))
    return tol.GraphSpec(nodes, {"W": rng.normal(size=(4, K)).astype(np.float32),
                                 "b": rng.normal(size=(K,)).astype(np.float32)},
                         "X", "y" if head else "z", 4)


@pytest.mark.parametrize("K,head", [(1, "Sigmoid"), (3, "Softmax"), (2, None), (3, "Sigmoid")],
                         ids=["logreg", "multiclass", "affine", "multilabel"])
def test_affine_graphs_lower_to_the_references_linear_predictor(K, head):
    spec = _affine_spec(K, head, seed=K)
    got = tol.lift_graph(spec, device="cpu")
    want = jol.lift_graph(to_jax(spec))
    assert isinstance(got, LinearPredictor)
    assert got.activation == want.activation and got.vector_out == want.vector_out
    assert np.array_equal(got.W.numpy(), np.asarray(want.W))
    assert np.array_equal(got.b.numpy(), np.asarray(want.b))
    X = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(got(torch.as_tensor(X)).numpy(), np.asarray(want(X)),
                               atol=1e-6)


def test_non_affine_graphs_lift_to_an_onnx_predictor():
    rng = np.random.default_rng(4)
    spec = tol.GraphSpec(
        [tol.NodeSpec("Gemm", ("X", "W1", "b1"), ("h",), {}),
         tol.NodeSpec("Relu", ("h",), ("a",), {}),
         tol.NodeSpec("Gemm", ("a", "W2", "b2"), ("z",), {}),
         tol.NodeSpec("Softmax", ("z",), ("y",), {"axis": -1})],
        {"W1": rng.normal(size=(4, 8)).astype(np.float32),
         "b1": rng.normal(size=(8,)).astype(np.float32),
         "W2": rng.normal(size=(8, 3)).astype(np.float32),
         "b2": rng.normal(size=(3,)).astype(np.float32)}, "X", "y", 4)
    pred = tol.lift_graph(spec, device="cpu")
    want = jol.lift_graph(to_jax(spec))
    assert isinstance(pred, tol.ONNXPredictor) and isinstance(want, jol.ONNXPredictor)
    assert (pred.n_outputs, pred.vector_out) == (want.n_outputs, want.vector_out)
    X = rng.normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(pred(torch.as_tensor(X)).numpy(), np.asarray(want(X)),
                               atol=1e-6)
    assert np.array_equal(pred.host_fn(X), want.host_fn(X))
    assert pred.graph_spec() is spec
    # the transA probe declines the linear lowering, as in the reference
    transA = tol.GraphSpec([tol.NodeSpec("Gemm", ("X", "W"), ("y",), {"transA": 1})],
                           {"W": np.eye(4, dtype=np.float32)}, "X", "y", 4)
    assert tol._try_linear(transA, "cpu") is None and jol._try_linear(to_jax(transA)) is None


def test_unsupported_ops_listed_with_the_references_message():
    spec = tol.GraphSpec(
        [tol.NodeSpec("Gemm", ("X", "W"), ("a",), {}),
         tol.NodeSpec("LSTM", ("a",), ("b",), {}, "recurrent_1"),
         tol.NodeSpec("Resize", ("b",), ("c",), {}),
         tol.NodeSpec("LSTM", ("c",), ("y",), {})],
        {"W": np.eye(4, dtype=np.float32)}, "X", "y", 4)
    with pytest.raises(tol.UnsupportedOpError) as got:
        tol.lift_graph(spec, device="cpu")
    with pytest.raises(jol.UnsupportedOpError) as want:
        jol.lift_graph(to_jax(spec))
    assert str(got.value) == str(want.value)
    assert got.value.ops == want.value.ops == ["LSTM", "Resize"]
    assert got.value.sites == want.value.sites
    assert "LSTM (node 'recurrent_1', #1)" in str(got.value)
    assert "Resize (node 'c', #2)" in str(got.value)


def _corner_specs():
    for attrs in ({"kernel_shape": [2, 2], "pads": [1, 0, 0, 0]},
                  {"kernel_shape": [2, 2], "ceil_mode": 1},
                  {"kernel_shape": [2, 2], "dilations": [2, 2]},
                  {"kernel_shape": [2]}):
        yield "pool_k", tol.GraphSpec(
            [tol.NodeSpec("Reshape", ("X", "s"), ("img",), {}),
             tol.NodeSpec("MaxPool", ("img",), ("p",), attrs, "pool_k"),
             tol.NodeSpec("Flatten", ("p",), ("y",), {"axis": 1})],
            {"s": np.asarray([0, 1, 4, 4], np.int64)}, "X", "y", 16)
    for attrs in ({"auto_pad": b"SAME_UPPER"}, {"pads": [1, 1]}):
        yield "conv_k", tol.GraphSpec(
            [tol.NodeSpec("Reshape", ("X", "s"), ("img",), {}),
             tol.NodeSpec("Conv", ("img", "Wc"), ("c",), attrs, "conv_k"),
             tol.NodeSpec("Flatten", ("c",), ("y",), {"axis": 1})],
            {"s": np.asarray([0, 1, 4, 4], np.int64),
             "Wc": np.ones((1, 1, 3, 3), np.float32)}, "X", "y", 16)


@pytest.mark.parametrize("where,spec", list(_corner_specs()),
                         ids=["pool_pads", "pool_ceil", "pool_dilated", "pool_1d",
                              "conv_auto_pad", "conv_pads_1d"])
def test_attribute_corners_rejected_with_the_references_message(where, spec):
    X = np.zeros((1, 16), np.float32)
    for run in (lambda: tol.run_graph_reference(spec, X),
                lambda: tol.run_graph_torch(spec, torch.as_tensor(X)),
                lambda: tol.lift_graph(spec, device="cpu")):
        with pytest.raises(ValueError, match=where) as got:
            run()
        with pytest.raises(ValueError) as want:
            jol.run_graph_reference(to_jax(spec), X)
        assert str(got.value) == str(want.value)


def test_lift_onnx_without_the_package_raises_importerror(monkeypatch):
    if "onnx" in sys.modules:
        pytest.skip("onnx installed: the missing-package path cannot trigger")
    real_import = builtins.__import__

    def no_onnx(name, *args, **kwargs):
        if name == "onnx":
            raise ImportError("No module named 'onnx'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_onnx)
    for call in (lambda: tol.lift_onnx(b"not-a-model", device="cpu"),
                 lambda: tol.graph_spec_from_onnx(object())):
        with pytest.raises(ImportError, match="requirements_advanced"):
            call()


@pytest.mark.parametrize("which", ["mlp", "cnn"])
def test_onnx_predictor_fingerprint_equals_the_references(which):
    spec = chip_smoke.additive_mlp_spec(seed=1) if which == "mlp" else \
        chip_smoke.stable_cnn_spec(6, seed=2, nonneg=False, batchnorm=True, maxpool=True)
    got = tol.ONNXPredictor(spec, device="cpu")
    want = jol.ONNXPredictor(to_jax(spec))
    assert got.fingerprint_bytes() == want.fingerprint_bytes()
    other = spec._replace(initializers={**spec.initializers, "bd": spec.initializers["bd"]
                                        + np.float32(1.0)} if "bd" in spec.initializers
                          else {**spec.initializers, "b2": spec.initializers["b2"] + 1})
    assert tol.ONNXPredictor(other, device="cpu").fingerprint_bytes() != got.fingerprint_bytes()
    X = np.random.default_rng(2).uniform(0, 1, size=(3, spec.input_dim)).astype(np.float32)
    np.testing.assert_allclose(got(torch.as_tensor(X)).numpy(), np.asarray(want(X)), atol=1e-5)


def test_initializers_with_dotted_names_are_buffers_that_move():
    rng = np.random.default_rng(5)
    spec = tol.GraphSpec(
        [tol.NodeSpec("Gemm", ("input/0", "fc.weight", "fc.bias"), ("fc/out",), {}),
         tol.NodeSpec("Tanh", ("fc/out",), ("out.0",), {})],
        {"fc.weight": rng.normal(size=(3, 2)).astype(np.float32),
         "fc.bias": rng.normal(size=(2,)).astype(np.float32)}, "input/0", "out.0", 3)
    pred = tol.lift_graph(spec, device="cpu")
    assert isinstance(pred, tol.ONNXPredictor)
    inits = pred.float_initializers()
    assert set(inits) == {"fc.weight", "fc.bias"}
    assert {name for name, _ in pred.named_buffers()} == {"init_0", "init_1"}
    X = rng.normal(size=(4, 3)).astype(np.float32)
    want = tol.run_graph_reference(spec, X)
    np.testing.assert_allclose(pred(torch.as_tensor(X)).numpy(), want, atol=1e-6)
    moved = pred.to(torch.float64).to("meta")
    assert all(t.device.type == "meta" for t in moved.float_initializers().values())
    state = pred.state_dict()
    assert set(state) == {"init_0", "init_1"}
