"""The PyTorch port's DeepSHAP (``attribution/deepshap.py`` and the engine's
``'deepshap'`` flavour) against the JAX package and brute force, on the CPU.

Inputs are made from a seed with numpy; the CNN's parameters by flax's own
initialiser.  Tolerances: ``build_deepshap_fn`` against the JAX one within
1e-5 · max(1, max|φ|) (f32 sums in another order); the port's float64
brute force equal to the JAX oracle within 1e-12, the exact cases within
1e-4 of it; through the engine, phi, E and f(x) against the JAX engine
within 1e-4 · max(1, max|φ|) and completeness within 1e-4; cached,
rebuilt, staged, synchronous and reloaded explains bit for bit, chunked
within 1e-4 of unchunked; the sampled probs head through the logit link
within 1e-3 plus 16 f32 ulps of p (``chip_smoke.logit_tol``); readiness
reasons equal to the JAX ones.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from distributedkernelshap_tpu import KernelShap as JaxKernelShap
from distributedkernelshap_tpu.attribution import deepshap as jds
from distributedkernelshap_tpu.models.cnn import _CNN as JaxCNN
from distributedkernelshap_tpu.models.cnn import CNNPredictor as JaxCNNPredictor
from distributedkernelshap_tpu.registry import onnx_lift as jol
from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
from distributedkernelshap_tpu_torch.attribution import deepshap as tds
from distributedkernelshap_tpu_torch.convert import cnn_from_numpy
from distributedkernelshap_tpu_torch.kernel_shap import StagedRows
from distributedkernelshap_tpu_torch.ops.explain import groups_to_matrix
from distributedkernelshap_tpu_torch.ops.image import superpixel_groups
from distributedkernelshap_tpu_torch.registry import onnx_lift as tol

FN_REL, ENGINE_REL, EXACT_ABS, ORACLE_ABS = 1e-5, 1e-4, 1e-4, 1e-12


def to_jax(spec):
    return jol.GraphSpec([jol.NodeSpec(*n) for n in spec.nodes], dict(spec.initializers),
                         spec.input_name, spec.output_name, spec.input_dim)


class _Graph:
    """A bare predictor carrying a graph (the reference tests' stand-in)."""

    def __init__(self, spec):
        self._spec = spec

    def graph_spec(self):
        return self._spec


def _phis(spec, X, bg, bgw=None, G=None):
    """``(port phi, JAX phi)`` of ``build_deepshap_fn`` on the same inputs."""

    K = tol.run_graph_reference(spec, X[:1]).shape[1]
    D = spec.input_dim
    bgw = np.full(bg.shape[0], 1.0 / bg.shape[0], np.float32) if bgw is None else bgw
    G = np.eye(D, dtype=np.float32) if G is None else np.asarray(G, np.float32)
    floats = {k: v for k, v in spec.initializers.items() if np.asarray(v).dtype.kind == "f"}
    with torch.no_grad():
        got = tds.build_deepshap_fn(spec, K)(
            torch.as_tensor(X), {k: torch.as_tensor(v) for k, v in floats.items()},
            torch.as_tensor(bg), torch.as_tensor(bgw), torch.as_tensor(G)).numpy()
    want = np.asarray(jax.jit(jds.build_deepshap_fn(to_jax(spec), K))(
        jnp.asarray(X), {k: jnp.asarray(v) for k, v in floats.items()}, jnp.asarray(bg),
        jnp.asarray(bgw), jnp.asarray(G)))
    return got, want


def _general_cnn_spec(seed=7, side=6, K=3):
    """Conv → BN → Tanh → MaxPool → Flatten → Gemm → Sigmoid → Gemm: every
    rule, mixed signs (the DeepLIFT approximation regime)."""

    rng = np.random.default_rng(seed)
    N = tol.NodeSpec
    nodes = [N("Reshape", ("x", "s"), ("img",), {}),
             N("Transpose", ("img",), ("t",), {"perm": [0, 3, 1, 2]}),
             N("Conv", ("t", "Wc", "bc"), ("c",), {"strides": [1, 1], "pads": [1, 1, 1, 1]}),
             N("BatchNormalization", ("c", "sc", "bi", "mu", "va"), ("n",), {"epsilon": 1e-5}),
             N("Tanh", ("n",), ("h",), {}),
             N("MaxPool", ("h",), ("p",), {"kernel_shape": [2, 2], "strides": [2, 2]}),
             N("Flatten", ("p",), ("f",), {"axis": 1}),
             N("Gemm", ("f", "W1", "b1"), ("z",), {}),
             N("Sigmoid", ("z",), ("a",), {}),
             N("Gemm", ("a", "W2", "b2"), ("y",), {})]
    half = side // 2
    inits = {"s": np.asarray([0, side, side, 1], np.int64),
             "Wc": rng.normal(scale=0.5, size=(3, 1, 3, 3)).astype(np.float32),
             "bc": rng.normal(scale=0.1, size=3).astype(np.float32),
             "sc": rng.uniform(0.5, 1.5, 3).astype(np.float32),
             "bi": rng.normal(scale=0.1, size=3).astype(np.float32),
             "mu": rng.normal(scale=0.1, size=3).astype(np.float32),
             "va": rng.uniform(0.5, 1.5, 3).astype(np.float32),
             "W1": rng.normal(scale=0.4, size=(3 * half * half, 5)).astype(np.float32),
             "b1": rng.normal(scale=0.1, size=5).astype(np.float32),
             "W2": rng.normal(size=(5, K)).astype(np.float32),
             "b2": rng.normal(size=K).astype(np.float32)}
    return tol.GraphSpec(nodes, inits, "x", "y", side * side)


def _tied_pool_spec(side=6, K=2, seed=8):
    """MaxPool straight over the pixels: quantised images against a constant
    fill background tie ``|Δin|`` inside most windows; a 5-wide image drops
    its last row and column (``VALID`` windows)."""

    rng = np.random.default_rng(seed)
    N = tol.NodeSpec
    out = side // 2
    return tol.GraphSpec(
        [N("Reshape", ("x", "s"), ("img",), {}),
         N("MaxPool", ("img",), ("p",), {"kernel_shape": [2, 2], "strides": [2, 2]}),
         N("Flatten", ("p",), ("f",), {"axis": 1}),
         N("Gemm", ("f", "W", "b"), ("y",), {})],
        {"s": np.asarray([0, 1, side, side], np.int64),
         "W": rng.normal(size=(out * out, K)).astype(np.float32),
         "b": rng.normal(size=K).astype(np.float32)}, "x", "y", side * side)


def _close(got, want, rel):
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= rel * scale


# --------------------------------------------------------------------- #
# the rule engine against the JAX one and the oracle


def test_additive_relu_mlp_matches_the_jax_engine_and_brute_force():
    spec = chip_smoke.additive_mlp_spec(seed=3, M=6, H=8)
    rng = np.random.default_rng(10)
    X = rng.normal(size=(3, 6)).astype(np.float32)
    bg = rng.normal(size=(4, 6)).astype(np.float32)
    got, want = _phis(spec, X, bg)
    _close(got, want, FN_REL)
    host = (lambda r: tol.run_graph_reference(spec, r))
    for i in range(X.shape[0]):
        ref = tds.brute_force_shapley(host, X[i], bg)
        assert np.abs(ref - jds.brute_force_shapley(host, X[i], bg)).max() <= ORACLE_ABS
        assert np.abs(got[i] - ref).max() <= EXACT_ABS


def test_stable_conv_net_grouped_matches_the_jax_engine_and_brute_force():
    spec = chip_smoke.stable_cnn_spec(6, seed=1)
    rng = np.random.default_rng(11)
    X = rng.uniform(0, 1, size=(2, 36)).astype(np.float32)
    bg = rng.uniform(0, 1, size=(3, 36)).astype(np.float32)
    bgw = np.asarray([0.2, 0.5, 0.3], np.float32)
    groups, _ = superpixel_groups(6, 6, patch=2)
    G = groups_to_matrix(groups, 36)
    got, want = _phis(spec, X, bg, bgw=bgw, G=G)
    _close(got, want, FN_REL)
    host = (lambda r: tol.run_graph_reference(spec, r))
    for i in range(X.shape[0]):
        ref = tds.brute_force_shapley(host, X[i], bg, bgw=bgw, G=G)
        assert np.abs(ref - jds.brute_force_shapley(host, X[i], bg, bgw=bgw, G=G)).max() \
            <= ORACLE_ABS
        assert np.abs(got[i] - ref).max() <= EXACT_ABS


def test_general_cnn_with_bn_maxpool_sigmoid_tanh_matches_the_jax_engine():
    spec = _general_cnn_spec()
    rng = np.random.default_rng(12)
    X = rng.uniform(0, 1, size=(4, 36)).astype(np.float32)
    bg = rng.uniform(0, 1, size=(3, 36)).astype(np.float32)
    got, want = _phis(spec, X, bg)
    _close(got, want, FN_REL)
    fx = tol.run_graph_reference(spec, X)
    ef = tol.run_graph_reference(spec, bg).mean(0)
    np.testing.assert_allclose(got.sum(2), fx - ef, atol=1e-5)


def test_zero_delta_rescale_is_finite_and_matches_the_jax_engine():
    spec = chip_smoke.additive_mlp_spec(seed=4, M=6, H=8)
    rng = np.random.default_rng(13)
    bg = rng.normal(size=(2, 6)).astype(np.float32)
    X = np.repeat(bg[:1], 2, 0)
    X[0, 0] += 1.0          # only feature 0 differs from background row 0
    got, want = _phis(spec, X, bg)
    assert np.isfinite(got).all()
    _close(got, want, FN_REL)
    assert np.array_equal(got[1] == 0, want[1] == 0)


@pytest.mark.parametrize("side", [6, 5], ids=["even", "valid_drop"])
def test_tied_maxpool_routes_to_the_first_position_as_the_reference(side):
    spec = _tied_pool_spec(side)
    rng = np.random.default_rng(14)
    X = rng.integers(0, 3, size=(6, side * side)).astype(np.float32) / 2.0
    bg = np.full((2, side * side), 0.5, np.float32)
    d = np.abs(X - bg[0]).reshape(6, side, side)[:, :side // 2 * 2, :side // 2 * 2]
    wins = d.reshape(6, side // 2, 2, side // 2, 2).transpose(0, 1, 3, 2, 4).reshape(6, -1, 4)
    ties = (wins == wins.max(-1, keepdims=True)).sum(-1) > 1
    assert ties.mean() > 0.3     # the case does exercise tied windows
    got, want = _phis(spec, X, bg)
    _close(got, want, FN_REL)
    if side % 2:
        # the dropped last row and column carry no attribution
        last = np.zeros((side, side), bool)
        last[-1, :] = last[:, -1] = True
        assert not got[:, :, last.ravel()].any()


def test_brute_force_refuses_oracle_scale():
    with pytest.raises(ValueError, match="2\\^M"):
        tds.brute_force_shapley(lambda r: r, np.zeros(17), np.zeros((1, 17)))


# --------------------------------------------------------------------- #
# gates


def _gate_cases():
    spec = chip_smoke.stable_cnn_spec(6, seed=4)
    N = tol.NodeSpec
    softmax = spec._replace(nodes=spec.nodes + [N("Softmax", ("y",), ("p",), {})],
                            output_name="p")
    bilinear = tol.GraphSpec([N("Gemm", ("x", "W"), ("h",), {}), N("MatMul", ("x", "h"),
                                                                     ("y",), {})],
                             {"W": np.eye(4, dtype=np.float32)}, "x", "y", 4)
    dyn_bn = tol.GraphSpec(
        [N("Gemm", ("x", "W"), ("s",), {}),
         N("BatchNormalization", ("x", "s", "o", "m", "v"), ("y",), {})],
        {"W": np.eye(4, dtype=np.float32), "o": np.zeros(4, np.float32),
         "m": np.zeros(4, np.float32), "v": np.ones(4, np.float32)}, "x", "y", 4)
    overlap = chip_smoke.stable_cnn_spec(6, seed=5, maxpool=True)
    overlap = overlap._replace(nodes=[n._replace(attrs={"kernel_shape": [2, 2],
                                                        "strides": [1, 1]})
                                      if n.op == "MaxPool" else n for n in overlap.nodes])
    shape3 = tol.GraphSpec([N("Reshape", ("x", "s"), ("y",), {})],
                           {"s": np.asarray([0, 2, 2], np.int64)}, "x", "y", 4)
    return [("ready", spec, "identity", None, None),
            ("link", spec, "logit", None, None),
            ("footprint", spec, "identity", None, 1024),
            ("grouping", spec, "identity", np.eye(5, dtype=np.float32), None),
            ("rule", softmax, "identity", None, None),
            ("bilinear", bilinear, "identity", None, None),
            ("bilinear_bn", dyn_bn, "identity", None, None),
            ("pool_overlap", overlap, "identity", None, None),
            ("output_shape", shape3, "identity", None, None)]


@pytest.mark.parametrize("label,spec,link,G,budget", _gate_cases(),
                         ids=[c[0] for c in _gate_cases()])
def test_readiness_reason_equals_the_references(label, spec, link, G, budget):
    got = tds.deepshap_ready(_Graph(spec), link, G, target_chunk_elems=budget)
    want = jds.deepshap_ready(_Graph(to_jax(spec)), link, G, target_chunk_elems=budget)
    assert got == want
    assert (got is None) == (label == "ready")
    assert tds.supports_deepshap(_Graph(spec)) == jds.supports_deepshap(_Graph(to_jax(spec)))
    if got is not None and budget is None:
        with pytest.raises(ValueError) as e_got:
            tds.validate_deepshap(_Graph(spec), link, G)
        with pytest.raises(ValueError) as e_want:
            jds.validate_deepshap(_Graph(to_jax(spec)), link, G)
        assert str(e_got.value) == str(e_want.value)


def test_structure_gate_and_fallback_accounting():
    assert tds.deepshap_ready(object(), "identity") == "structure"
    assert not tds.supports_deepshap(object())
    before = tds.deepshap_fallback_counts().get(("rule",), 0.0)
    tds.record_deepshap_fallback("rule", "a Softmax head")
    assert tds.deepshap_fallback_counts()[("rule",)] == before + 1

    class _Registry:
        def counter(self, name, doc, labelnames):
            self.name, self.labelnames = name, labelnames
            return self

        def set_function(self, fn):
            self.fn = fn

    reg = _Registry()
    tds.attach_deepshap_metrics(reg)
    assert reg.name == "dks_deepshap_fallback_total" and reg.labelnames == ("reason",)
    assert reg.fn() == tds.deepshap_fallback_counts()


# --------------------------------------------------------------------- #
# the engine end to end: the 12x12 CNN over 9 superpixels


@pytest.fixture(scope="module")
def cnn_setup():
    params = JaxCNN(n_classes=4).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 12, 12, 1), jnp.float32))["params"]
    np_params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(21)
    bg = rng.uniform(0, 1, size=(2, 144)).astype(np.float32)
    X = rng.uniform(0, 1, size=(6, 144)).astype(np.float32)
    groups, names = superpixel_groups(12, 12, patch=4)

    def jax_fit(output, link="identity"):
        ex = JaxKernelShap(JaxCNNPredictor(params, (12, 12, 1), n_classes=4, output=output),
                           link=link, seed=0)
        return ex.fit(bg, groups=groups, group_names=names)

    def port_fit(output, link="identity", config=None):
        ex = KernelShap(cnn_from_numpy(np_params, (12, 12, 1), 4, output, device="cpu"),
                        link=link, seed=0, device="cpu",
                        engine_config=config or EngineConfig(device="cpu"))
        return ex.fit(bg, groups=groups, group_names=names)

    jax_exact = jax_fit("logits").explain(X, nsamples="exact", silent=True)
    port = port_fit("logits")
    return dict(X=X, bg=bg, groups=groups, names=names, jax_fit=jax_fit, port_fit=port_fit,
                jax_exact=jax_exact, port=port,
                port_exact=port.explain(X, nsamples="exact", silent=True))


def _stack(expl):
    return np.stack(expl.shap_values, 1)


def test_engine_deepshap_matches_the_jax_engine(cnn_setup):
    s = cnn_setup
    got, want = s["port_exact"], s["jax_exact"]
    _close(_stack(got), _stack(want), ENGINE_REL)
    scale = max(1.0, float(np.abs(_stack(want)).max()))
    assert np.abs(np.asarray(got.expected_value) - np.asarray(want.expected_value)).max() \
        <= ENGINE_REL * scale
    assert np.abs(np.asarray(got.data["raw"]["raw_prediction"])
                  - np.asarray(want.data["raw"]["raw_prediction"])).max() <= ENGINE_REL * scale
    assert s["port"].kernel_path == {"exact_phi": "deepshap"}
    assert chip_smoke.completeness(got) <= 1e-4


def test_engine_deepshap_cache_reuse_reset_and_recompute(cnn_setup):
    s = cnn_setup
    engine = s["port"]._explainer
    key = ("deepshap_consts", engine.content_fingerprint())
    consts = engine._plan_consts_cache[key]
    again = engine.get_explanation(s["X"], nsamples="exact")
    assert engine._plan_consts_cache[key] is consts
    engine.reset_device_state()
    assert not engine._plan_consts_cache
    rebuilt = engine.get_explanation(s["X"], nsamples="exact")
    assert engine._plan_consts_cache[key] is not consts
    assert all(np.array_equal(a, b) for a, b in zip(again, rebuilt))
    assert all(np.array_equal(a, b) for a, b in zip(rebuilt, s["port_exact"].shap_values))
    off = s["port_fit"]("logits", config=EngineConfig(device="cpu",
                                                      plan_constant_cache=False))
    values = off._explainer.get_explanation(s["X"], nsamples="exact")
    assert not off._explainer._plan_consts_cache
    assert all(np.array_equal(a, b) for a, b in zip(values, rebuilt))


def test_engine_deepshap_staged_chunked_and_reloaded(cnn_setup, tmp_path):
    s = cnn_setup
    engine, X = s["port"]._explainer, s["X"]
    want = engine.get_explanation(X, nsamples="exact")
    staged = engine.stage_rows(X, nsamples="exact")
    assert isinstance(staged, StagedRows)
    values, info = engine.get_explanation_async(staged, nsamples="exact")()
    assert all(np.array_equal(a, b) for a, b in zip(values, want))
    assert np.array_equal(info["raw_prediction"], engine.last_raw_prediction)
    chunked = s["port_fit"]("logits", config=EngineConfig(device="cpu", instance_chunk=4))
    got = chunked.explain(X, nsamples="exact", silent=True)
    _close(_stack(got), _stack(s["port_exact"]), 1e-4)
    assert chunked._explainer.last_dispatch_window is not None
    path = os.path.join(tmp_path, "cnn.pkl")
    s["port"].save(path)
    loaded = KernelShap.load(path, device="cpu")
    assert np.array_equal(_stack(loaded.explain(X, nsamples="exact", silent=True)),
                          _stack(s["port_exact"]))


def test_group_phi_is_summed_feature_phi(cnn_setup):
    s = cnn_setup
    flat = KernelShap(s["port"].predictor, seed=0, device="cpu")
    flat.fit(s["bg"])
    phi_f = _stack(flat.explain(s["X"][:2], nsamples="exact", silent=True))
    G = groups_to_matrix(s["groups"], 144)
    np.testing.assert_allclose(_stack(s["port_exact"])[:2], phi_f @ G.T, atol=1e-5)


def test_probs_head_under_exact_raises_as_the_reference(cnn_setup):
    """A graph whose Softmax head has no rule is not a DeepSHAP predictor:
    ``nsamples='exact'`` falls through to the tree validation and raises
    ``ValueError``, as the reference does (the port used to route it to the
    DeepSHAP flavour)."""

    s = cnn_setup
    port = s["port_fit"]("probs")
    assert port._explainer._exact_flavor() is None
    assert not port._explainer._exact_async_ready()
    with pytest.raises(ValueError, match="nsamples='exact' requires"):
        port.explain(s["X"], nsamples="exact", silent=True)
    with pytest.raises(ValueError, match="nsamples='exact' requires"):
        s["jax_fit"]("probs").explain(s["X"], nsamples="exact", silent=True)


def test_exact_rejects_interactions_and_the_logit_link(cnn_setup):
    s = cnn_setup
    with pytest.raises(ValueError, match="DeepSHAP backprop path computes phi only"):
        s["port"].explain(s["X"], nsamples="exact", interactions=True, silent=True)
    logit = s["port_fit"]("logits", link="logit")
    with pytest.raises(ValueError, match="link='logit' would change"):
        logit.explain(s["X"], nsamples="exact", silent=True)


def test_sampled_probs_head_matches_the_jax_engine(cnn_setup):
    s = cnn_setup
    X = s["X"][:4]
    got = s["port_fit"]("probs", link="logit").explain(X, l1_reg=False, silent=True)
    want = s["jax_fit"]("probs", link="logit").explain(X, l1_reg=False, silent=True)
    d = np.abs(_stack(got) - _stack(want)).max(2)
    assert (d <= chip_smoke.logit_tol(np.asarray(want.data["raw"]["raw_prediction"]))).all()
    assert chip_smoke.additivity(got) < 1e-3


def test_port_reproduces_the_mnist_fixture():
    """``chip_smoke.mnist_fixture_checks`` (phases 37–38) on the CPU, over
    the first 8 images of ``tests/fixtures/deepshap_parity.npz`` (the JAX
    package's answers on its synthetic digits, not MNIST)."""

    fx = chip_smoke.load_deepshap_fixture()
    reports = chip_smoke.mnist_fixture_checks(fx, "cpu", n_rows=8)
    assert reports["deep"]["ok"], reports["deep"]
    assert reports["sampled"]["ok"], reports["sampled"]
