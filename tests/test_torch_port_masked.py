"""The PyTorch port's non-linear sampled paths against the JAX package, on
the CPU: the tree ensembles' and MLPs' structure-aware ``masked_ey``, the
row-materialising ``_ey_generic``, the three-way dispatch of
``build_explainer_fn``, the scikit-learn MLP and torch ``nn.Sequential``
lifts, ``TorchPredictor``, the routing of ``as_predictor`` and the
full-precision guard of the tree ``masked_ey``.

Inputs are made from a seed with numpy (D = 10 columns in M = 5 groups,
N ≤ 20 background rows, B ≤ 8, ≤ 6 trees, hidden widths ≤ 16) and go through
the JAX function and its counterpart in ``distributedkernelshap_tpu_torch``.
Tolerances: the tree ``masked_ey`` counts path hits exactly in both packages
(small integers), so only the f32 leaf-value and background sums differ,
``EY_ATOL``; the MLP sums its hidden units in another order, ``EY_ATOL``
too; link-space phi after the WLS solve ``PHI_ATOL``, as in
``tests/test_torch_port_slice.py``; an exhaustive coalition plan recovers
exact Shapley values up to the 1e-6 ridge, ``EXACT_REL · max(1, max|φ|)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from distributedkernelshap_tpu import KernelShap as JaxKernelShap
from distributedkernelshap_tpu.models import predictors as jpred
from distributedkernelshap_tpu.models import torch_lift as jlift
from distributedkernelshap_tpu.models.trees import lift_tree_ensemble as jax_lift_tree
from distributedkernelshap_tpu.ops import explain as jexp
from distributedkernelshap_tpu.ops.coalitions import coalition_plan
from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
from distributedkernelshap_tpu_torch.convert import torch_mlp_from_numpy
from distributedkernelshap_tpu_torch.kernel_shap import KernelExplainerEngine
from distributedkernelshap_tpu_torch.models import predictors as tpred
from distributedkernelshap_tpu_torch.models import torch_lift as tlift
from distributedkernelshap_tpu_torch.models._chunking import padded_chunk_map
from distributedkernelshap_tpu_torch.models.trees import (
    TreeEnsemblePredictor,
    lift_tree_ensemble,
)
from distributedkernelshap_tpu_torch.ops import explain as texp

EY_ATOL = 1e-5        # raw expected outputs, port vs JAX and masked vs rows
PHI_ATOL = 1e-4       # link-space phi of O(1), port vs JAX
EXACT_REL = 1e-4      # x max(1, max|phi|): exhaustive sampled vs exact
PRED_ATOL = 2e-5      # lifted forward vs the library's own, x max(1, max|out|)

GROUPS = [[0, 1], [2], [3, 4, 5], [6], [7, 8, 9]]
NAMES = [f"g{i}" for i in range(len(GROUPS))]


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(300, 10))
    y3 = ((X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(int) + (X[:, 3] > 1).astype(int))
    yr = 2.0 * X[:, 0] + np.where(X[:, 1] > 0, 1.5, -0.5) * X[:, 2] + X[:, 5]
    return X.astype(np.float32), y3, yr


def _masked_inputs(X, groups, nsamples, B=8, N=20):
    G = texp.groups_to_matrix(groups, X.shape[1])
    mask = np.asarray(coalition_plan(G.shape[0], nsamples=nsamples, seed=0).mask, np.float32)
    Xe, bg = X[:B], X[100:100 + N]
    bgw = np.full(N, 1.0 / N, np.float32)
    return Xe, bg, bgw, mask, G


# ---------------------------------------------------------------------------
# trees


@pytest.fixture(scope="module")
def gbc(data):
    from sklearn.ensemble import GradientBoostingClassifier

    X, y3, _ = data
    binary = GradientBoostingClassifier(n_estimators=6, max_depth=3, random_state=0).fit(
        X, (y3 > 0).astype(int))
    multi = GradientBoostingClassifier(n_estimators=2, max_depth=3, random_state=0).fit(X, y3)
    return {"binary": binary, "multiclass": multi}


TREE_CASES = {
    # (model, grouping, nsamples, chunk budget)
    "grouped": ("binary", GROUPS, 24, None),
    "ungrouped": ("binary", None, 64, None),
    "multiclass": ("multiclass", GROUPS, 24, None),
    "tiny_chunks": ("binary", GROUPS, 25, 1 << 9),
}


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_tree_masked_ey_matches_jax_and_rows(data, gbc, case):
    """The separable-hits evaluation equals the JAX package's and the
    port's own row evaluation (``_ey_generic``), grouped, multiclass and
    with instance and coalition chunks small enough to pad both axes."""

    which, groups, nsamples, budget = TREE_CASES[case]
    X = data[0]
    method = gbc[which].predict_proba
    port = lift_tree_ensemble(method, device="cpu")
    ref_pred = jax_lift_tree(method)
    assert port.supports_masked_ey and ref_pred.supports_masked_ey
    Xe, bg, bgw, mask, G = _masked_inputs(X, groups, nsamples, B=7, N=13)
    got = port.masked_ey(_t(Xe), _t(bg), _t(bgw), _t(mask), _t(G),
                         target_chunk_elems=budget).numpy()
    ref = np.asarray(ref_pred.masked_ey(Xe, bg, bgw, mask, G, target_chunk_elems=budget))
    assert got.shape == ref.shape == (7, mask.shape[0], port.n_outputs)
    np.testing.assert_allclose(got, ref, atol=EY_ATOL)
    rows = texp._ey_generic(port, _t(Xe), _t(bg), _t(bgw), _t(mask @ G), 16).numpy()
    np.testing.assert_allclose(got, rows, atol=EY_ATOL)


def test_tree_masked_ey_guards_match_jax(data, gbc):
    """Depth > 256 and oversized persistent tensors decline the masked path
    in both packages, at the same shapes."""

    method = gbc["binary"].predict_proba
    port, ref = lift_tree_ensemble(method, device="cpu"), jax_lift_tree(method)
    cfg, jcfg = texp.ShapConfig(), jexp.ShapConfig()
    for B, N, S, M in ((8, 20, 64, 6), (8, 10 ** 7, 64, 6), (256, 100, 2072, 12)):
        want = jexp._use_masked_ey(ref, B=B, N=N, S=S, M=M, config=jcfg)
        assert texp._use_masked_ey(port, B=B, N=N, S=S, M=M, config=cfg) == want
    assert not port.masked_ey_fits(B=8, N=10 ** 7, S=64, M=6, budget=cfg.target_chunk_elems)
    port.depth = ref.depth = 300
    assert not port.supports_masked_ey and not ref.supports_masked_ey
    port.depth = 256
    assert port.supports_masked_ey


def test_padded_chunk_map_pads_and_slices():
    arr = torch.arange(7 * 3, dtype=torch.float32).reshape(7, 3)
    seen = []

    def fn(c):
        seen.append(c.shape[0])
        return c * 2.0

    out = padded_chunk_map(fn, arr, 3)
    assert seen == [3, 3, 3]
    np.testing.assert_array_equal(out.numpy(), 2.0 * arr.numpy())


@pytest.fixture(scope="module")
def hgb(data):
    from sklearn.ensemble import HistGradientBoostingClassifier, HistGradientBoostingRegressor

    X, y3, yr = data
    clf = HistGradientBoostingClassifier(max_iter=6, max_leaf_nodes=8, random_state=0).fit(
        X, (y3 > 0).astype(int))
    reg = HistGradientBoostingRegressor(max_iter=6, max_leaf_nodes=8, random_state=0).fit(X, yr)
    return clf, reg


def _explain_both(method, X, link, nsamples=None, l1_reg=False, groups=GROUPS):
    names = None if groups is None else NAMES
    port = KernelShap(method, link=link, seed=0, device="cpu").fit(
        X[100:118], group_names=names, groups=groups)
    ref = JaxKernelShap(method, link=link, seed=0).fit(
        X[100:118], group_names=names, groups=groups)
    kw = {"silent": True, "nsamples": nsamples, "l1_reg": l1_reg}
    return port, port.explain(X[:8], **kw), ref, ref.explain(X[:8], **kw)


def _phi(expl):
    return np.stack([np.asarray(v) for v in expl.shap_values], 1)


@pytest.mark.parametrize("which", ["classifier_logit", "regressor_identity"])
def test_sampled_hist_gbt_explain_matches_jax(data, hgb, which):
    """A lifted scikit-learn HistGBT explained by sampling goes through
    ``masked_ey`` in both packages and agrees."""

    method, link = ((hgb[0].predict_proba, "logit") if which == "classifier_logit"
                    else (hgb[1].predict, "identity"))
    port, got, ref, want = _explain_both(method, data[0], link)
    assert isinstance(port._explainer.predictor, TreeEnsemblePredictor)
    assert port.kernel_path == {"ey": "masked_ey"}
    assert ref.kernel_path["ey"] == "masked_ey"
    np.testing.assert_allclose(_phi(got), _phi(want), atol=PHI_ATOL)
    np.testing.assert_allclose(got.expected_value, np.asarray(want.expected_value), atol=2e-5)
    total = _phi(got).sum(-1) + np.asarray(got.expected_value)[None]
    np.testing.assert_allclose(total, np.atleast_2d(got.data["raw"]["raw_prediction"]).reshape(
        total.shape), atol=1e-4)


def test_l1_over_the_masked_path_matches_jax(data, hgb):
    """l1 selection reads the per-coalition ey of the masked path
    (reference ``tests/test_trees.py:461``): the same features selected,
    phi within ``PHI_ATOL``, at most 4 selected plus the constrained last."""

    port, got, ref, want = _explain_both(hgb[0].predict_proba, data[0], "logit",
                                         nsamples=40, l1_reg="num_features(4)", groups=None)
    assert port.kernel_path == {"ey": "masked_ey"}
    phi, phi_ref = _phi(got), _phi(want)
    np.testing.assert_array_equal(phi != 0, phi_ref != 0)
    np.testing.assert_allclose(phi, phi_ref, atol=PHI_ATOL)
    assert ((np.abs(phi[:, 1]) > 0).sum(1) <= 5).all()


def test_exhaustive_sampled_tree_matches_exact(data, hgb):
    """At M = 5 an nsamples of 2^5 - 2 enumerates every coalition, so the
    sampled φ of the raw-margin tree (masked_ey, WLS) equals the exact
    interventional TreeSHAP values: an independent check of the masks and
    the solve."""

    X = data[0]
    ks = KernelShap(hgb[1].predict, seed=0, device="cpu").fit(
        X[100:118], group_names=NAMES, groups=GROUPS)
    sampled = ks.explain(X[:8], silent=True, nsamples=30, l1_reg=False)
    assert ks.kernel_path["ey"] == "masked_ey"
    assert ks._explainer._plan(30).exact
    exact = ks.explain(X[:8], silent=True, nsamples="exact")
    phi, phi_exact = _phi(sampled), _phi(exact)
    assert np.abs(phi - phi_exact).max() <= EXACT_REL * max(1.0, np.abs(phi_exact).max())


# ---------------------------------------------------------------------------
# scikit-learn MLPs


@pytest.fixture(scope="module")
def mlps(data):
    from sklearn.neural_network import MLPClassifier, MLPRegressor

    X, y3, yr = data
    Y2 = np.stack([(y3 > 0).astype(int), (y3 > 1).astype(int)], axis=1)
    return {
        "binary_sigmoid": MLPClassifier((8,), max_iter=80, random_state=0).fit(
            X, (y3 > 0).astype(int)).predict_proba,
        "softmax": MLPClassifier((8, 6), activation="tanh", max_iter=80,
                                 random_state=0).fit(X, y3).predict_proba,
        "sigmoid": MLPClassifier((8,), activation="logistic", max_iter=80,
                                 random_state=0).fit(X, Y2).predict_proba,
        "identity": MLPRegressor(hidden_layer_sizes=(10,), max_iter=150, random_state=0).fit(X, yr).predict,
    }


#: the stage each scikit-learn head ends in (identity: the last linear)
HEAD_STAGES = {"binary_sigmoid": "binary_sigmoid", "softmax": "softmax",
               "sigmoid": "act_sigmoid", "identity": "linear"}


@pytest.mark.parametrize("head", list(HEAD_STAGES))
def test_sklearn_mlp_lift_heads_match_sklearn_and_jax(data, mlps, head):
    X = data[0][:64]
    port = tpred._lift_sklearn_mlp(mlps[head], device="cpu")
    ref = jpred._lift_sklearn_mlp(mlps[head])
    assert isinstance(port, tlift.TorchMLPPredictor) and port.supports_masked_ey
    assert ref.out_activation == head
    assert port.stages[-1][0] == HEAD_STAGES[head]
    assert (port.n_outputs, port.vector_out) == (ref.n_outputs, ref.vector_out)
    with torch.no_grad():
        got = port(_t(X)).numpy()
    expected = np.asarray(mlps[head](X.astype(np.float64)))
    expected = expected[:, None] if expected.ndim == 1 else expected
    scale = max(1.0, float(np.abs(expected).max()))
    np.testing.assert_allclose(got, expected, atol=PRED_ATOL * scale)
    with jax.default_matmul_precision("highest"):
        np.testing.assert_allclose(got, np.asarray(ref(jnp.asarray(X))), atol=PRED_ATOL * scale)
    # the JAX MLPPredictor's layers carried over through numpy
    carried = torch_mlp_from_numpy(
        tlift.mlp_stages([(np.asarray(W), np.asarray(b)) for W, b in ref.layers],
                         ref.hidden_activation, ref.out_activation),
        ref.n_outputs, vector_out=ref.vector_out, device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(carried(_t(X)).numpy(), got)


@pytest.mark.parametrize("case", ["ungrouped", "grouped", "tiny_chunks"])
def test_mlp_masked_ey_matches_jax_and_rows(data, mlps, case):
    X = data[0]
    groups = None if case == "ungrouped" else GROUPS
    budget = (1 << 9) if case == "tiny_chunks" else None
    port = tpred._lift_sklearn_mlp(mlps["softmax"], device="cpu")
    ref = jpred._lift_sklearn_mlp(mlps["softmax"])
    Xe, bg, bgw, mask, G = _masked_inputs(X, groups, 25, B=7, N=13)
    got = port.masked_ey(_t(Xe), _t(bg), _t(bgw), _t(mask), _t(G),
                         target_chunk_elems=budget).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(ref.masked_ey(Xe, bg, bgw, mask, G, target_chunk_elems=budget))
    np.testing.assert_allclose(got, want, atol=EY_ATOL)
    rows = texp._ey_generic(port, _t(Xe), _t(bg), _t(bgw), _t(mask @ G), 8).numpy()
    np.testing.assert_allclose(got, rows, atol=EY_ATOL)


def test_mlp_explain_matches_jax(data, mlps):
    port, got, ref, want = _explain_both(mlps["binary_sigmoid"], data[0], "logit")
    assert isinstance(port._explainer.predictor, tlift.TorchMLPPredictor)
    assert port.kernel_path == {"ey": "masked_ey"}
    assert ref.kernel_path["ey"] == "masked_ey"
    np.testing.assert_allclose(_phi(got), _phi(want), atol=PHI_ATOL)


# ---------------------------------------------------------------------------
# torch modules


def _sequential(kind):
    torch.manual_seed(3)
    if kind == "relu":
        return nn.Sequential(nn.Linear(10, 16), nn.ReLU(), nn.Linear(16, 2),
                             nn.Softmax(dim=-1)).eval()
    if kind == "layernorm_gelu":
        return nn.Sequential(nn.Sequential(nn.Linear(10, 12), nn.LayerNorm(12), nn.GELU()),
                             nn.Dropout(0.5), nn.Linear(12, 3)).eval()
    net = nn.Sequential(nn.Linear(10, 8), nn.BatchNorm1d(8), nn.Tanh(), nn.Linear(8, 8),
                        nn.LeakyReLU(0.2), nn.Linear(8, 2), nn.Sigmoid())
    net.train()
    with torch.no_grad():
        for _ in range(3):
            net(torch.randn(64, 10))
    return net.eval()


@pytest.mark.parametrize("kind", ["relu", "layernorm_gelu", "batchnorm_tanh"])
def test_sequential_lift_matches_jax(data, kind):
    """An ``nn.Sequential`` lifts to ``TorchMLPPredictor`` in both packages:
    the forward and the first-layer-separated ``masked_ey`` agree, and the
    JAX stages carried over through numpy give the same predictor."""

    X = data[0]
    net = _sequential(kind)
    port = tlift.lift_torch(net, device="cpu")
    ref = jlift.lift_torch(net)
    assert isinstance(port, tlift.TorchMLPPredictor) and port.supports_masked_ey
    assert [s[0] for s in port.stages] == [s[0] for s in ref.stages]
    with torch.no_grad():
        got = port(_t(X[:32])).numpy()
        expected = net(_t(X[:32])).numpy()
    np.testing.assert_allclose(got, expected, atol=PRED_ATOL)
    with jax.default_matmul_precision("highest"):
        np.testing.assert_allclose(got, np.asarray(ref(jnp.asarray(X[:32]))), atol=PRED_ATOL)
        Xe, bg, bgw, mask, G = _masked_inputs(X, GROUPS, 20, B=6, N=12)
        want = np.asarray(ref.masked_ey(Xe, bg, bgw, mask, G))
    ey = port.masked_ey(_t(Xe), _t(bg), _t(bgw), _t(mask), _t(G)).numpy()
    np.testing.assert_allclose(ey, want, atol=EY_ATOL)
    carried = torch_mlp_from_numpy(
        [tuple(np.asarray(a) if hasattr(a, "shape") else a for a in s) for s in ref.stages],
        ref.n_outputs, device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(carried(_t(X[:32])).numpy(), got)


class SkipNet(nn.Module):
    """A forward with a skip term, which ``_stages_from_module`` refuses."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(11)
        self.hidden = nn.Linear(10, 8)
        self.out = nn.Linear(8, 2)

    def forward(self, x):
        return torch.softmax(self.out(torch.relu(self.hidden(x))) + 0.1 * x[:, :2], dim=-1)


def _unlifted(kind):
    torch.manual_seed(5)
    if kind == "cnn":
        net = nn.Sequential(nn.Unflatten(1, (1, 2, 5)), nn.Conv2d(1, 3, 3, padding=1),
                            nn.BatchNorm2d(3), nn.ReLU(), nn.MaxPool2d(2), nn.Flatten(),
                            nn.Linear(6, 2), nn.Softmax(dim=-1))
    else:
        net = nn.Sequential(nn.BatchNorm1d(10), nn.Linear(10, 8), nn.Tanh(),
                            nn.Linear(8, 2), nn.Softmax(dim=-1))
    net.train()
    with torch.no_grad():
        for _ in range(3):
            net(torch.randn(64, 10))
    return net.eval()


@pytest.mark.parametrize("kind", ["cnn", "batchnorm_first"])
def test_non_dense_sequential_runs_as_module_and_matches_jax(data, kind):
    """A ``Sequential`` that is not a dense chain starting with ``Linear`` (a
    CNN; a batch norm first) is not lifted: the module itself runs on the
    port's device as a ``TorchPredictor`` through the generic route.  The
    JAX package lifts it into stages without a ``masked_ey``, which also
    take the generic route.  The answers agree."""

    net = _unlifted(kind)
    assert tlift.lift_torch(net, device="cpu") is None
    port, got, ref, want = _explain_both(net, data[0], "logit", nsamples=40)
    assert type(port._explainer.predictor) is tpred.TorchPredictor
    assert port._explainer.predictor.fn is net
    assert type(ref._explainer.predictor).__name__ == "TorchMLPPredictor"
    assert port.kernel_path == {"ey": "generic"} and ref.kernel_path["ey"] == "generic"
    np.testing.assert_allclose(_phi(got), _phi(want), atol=PHI_ATOL)


def test_unliftable_module_runs_generic_and_matches_jax_callback(data):
    """An unliftable module runs on the port's device as a ``TorchPredictor``
    through the generic route; the JAX package sends it to a host callback.
    The answers agree."""

    net = SkipNet().eval()
    port, got, ref, want = _explain_both(net, data[0], "logit", nsamples=40)
    assert isinstance(port._explainer.predictor, tpred.TorchPredictor)
    assert isinstance(ref._explainer.predictor, jpred.CallbackPredictor)
    assert port.kernel_path == {"ey": "generic"}
    np.testing.assert_allclose(_phi(got), _phi(want), atol=PHI_ATOL)


# ---------------------------------------------------------------------------
# routing, the plan-constant cache and the precision guard


def _numpy_softmax(x):
    z = np.asarray(x, np.float64) @ np.linspace(-1, 1, 20).reshape(10, 2)
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


ROUTES = {
    # case: (port class, JAX class or None when JAX cannot run it)
    "tree": (TreeEnsemblePredictor, "TreeEnsemblePredictor"),
    "mlp": (tlift.TorchMLPPredictor, "MLPPredictor"),
    "sequential": (tlift.TorchMLPPredictor, "TorchMLPPredictor"),
    "unliftable_module": (tpred.TorchPredictor, "CallbackPredictor"),
    "numpy_callable": (tpred.CallbackPredictor, "CallbackPredictor"),
    "torch_function": (tpred.TorchPredictor, None),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_as_predictor_routes_like_the_reference(data, gbc, mlps, case):
    """Each kind of model lands where the reference puts it; where the
    reference needs a host callback for a torch module (JAX cannot trace
    torch), the port's meta probe keeps it on the device."""

    X = data[0]
    W = torch.linspace(-1, 1, 20).reshape(10, 2)
    model = {"tree": gbc["binary"].predict_proba, "mlp": mlps["softmax"],
             "sequential": _sequential("relu"), "unliftable_module": SkipNet().eval(),
             "numpy_callable": _numpy_softmax,
             "torch_function": lambda x: torch.softmax(x @ W, dim=-1)}[case]
    port_cls, jax_cls = ROUTES[case]
    port = tpred.as_predictor(model, example_dim=10, probe_data=X[:16], device="cpu")
    assert type(port) is port_cls
    if jax_cls is not None:
        assert type(jpred.as_predictor(model, example_dim=10, probe_data=X[:16])).__name__ \
            == jax_cls
    with torch.no_grad():
        out = port(_t(X[:5])).numpy()
    assert out.shape == (5, port.n_outputs) and np.isfinite(out).all()


def test_meta_probe_tells_torch_from_numpy():
    W = torch.ones(4, 3)
    out = tpred._meta_probe(lambda x: x @ W, 4)
    assert out is not None and out.shape == (2, 3) and out.device.type == "meta"
    assert tpred._meta_probe(lambda x: np.asarray(x) @ np.ones((4, 3)), 4) is None
    assert tpred._meta_probe(lambda x: x.sum(1), 4).shape == (2,)


@pytest.mark.parametrize("case", ["tree", "mlp", "unliftable_module"])
def test_plan_constant_cache_is_linear_only(data, gbc, mlps, case):
    """Only a linear predictor reaches the plan-constant cache, so the
    content fingerprint that keys it needs no bytes of a non-linear model."""

    X = data[0]
    model = {"tree": gbc["binary"].predict_proba, "mlp": mlps["softmax"],
             "unliftable_module": SkipNet().eval()}[case]
    engine = KernelExplainerEngine(
        tpred.as_predictor(model, example_dim=10, probe_data=X[:16], device="cpu"),
        X[:6], seed=0, config=EngineConfig(device="cpu"))
    assert not engine._plan_consts_enabled()
    assert engine._linear_fast_call(X[:2], engine._plan(24), np.float32) is None


def test_tree_masked_ey_turns_tf32_off(data, gbc, monkeypatch):
    """The tree ``masked_ey`` runs with TF32 off even when the caller turned
    it on (its integer path counts and leaf sums need full f32), and gives
    the caller's setting back."""

    seen = []
    steps = TreeEnsemblePredictor._tree_steps

    def spy(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return steps(*args)

    monkeypatch.setattr(TreeEnsemblePredictor, "_tree_steps", staticmethod(spy))
    port = lift_tree_ensemble(gbc["binary"].predict_proba, device="cpu")
    Xe, bg, bgw, mask, G = _masked_inputs(data[0], GROUPS, 24, B=4, N=6)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        port.masked_ey(_t(Xe), _t(bg), _t(bgw), _t(mask), _t(G))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert seen and not any(seen)
