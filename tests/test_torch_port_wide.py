"""The port's kernels past their old limits, against the JAX package on the
CPU: ``fused_linear_ey`` past 32 classes, exact TreeSHAP past 64 groups
(the slot layout ``exact_tree_phi`` takes there) and exact interactions at
64 groups.

Inputs are made from a seed with numpy and go through the JAX function and
the port.  The CUDA kernels cannot run here: the wrappers take the plain
PyTorch versions for CPU tensors.  Tolerances: ``ey`` within 1e-5 of the
Pallas kernel in interpret mode (``tests/test_pallas.py:59``); sampled phi
within 1e-4 (``tests/test_torch_port_engine.py``'s bar: f32 sums in other
orders); exact phi and interactions within 2e-5 · max(1, max|·|)
(``tests/test_treeshap.py:780``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from distributedkernelshap_tpu import KernelShap as JaxKernelShap
from distributedkernelshap_tpu.models import as_predictor as jax_as_predictor
from distributedkernelshap_tpu.models.predictors import LinearPredictor as JaxLinear
from distributedkernelshap_tpu.ops import groups_to_matrix
from distributedkernelshap_tpu.ops import treeshap as jts
from distributedkernelshap_tpu.ops.pallas_kernels import fused_linear_ey as pallas_ey
from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
from distributedkernelshap_tpu_torch.convert import linear_predictor_from_numpy
from distributedkernelshap_tpu_torch.models.predictors import as_predictor
from distributedkernelshap_tpu_torch.ops import cuda_kernels as tck
from distributedkernelshap_tpu_torch.ops import treeshap as tts
from distributedkernelshap_tpu_torch.ops.explain import ShapConfig, capture_kernel_paths

EY_ATOL = 1e-5
PHI_ATOL = 1e-4
PHI_REL = 2e-5


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _close_rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= PHI_REL * max(1.0, float(np.abs(ref).max()))


def _ey_inputs(B, S, N, M, K, seed):
    rng = np.random.default_rng(seed)
    D = 2 * M
    X, bg = rng.normal(size=(B, D)), rng.normal(size=(N, D))
    W, b = rng.normal(scale=0.7, size=(D, K)), rng.normal(size=K)
    G = np.zeros((M, D))
    for m in range(M):
        G[m, 2 * m:2 * m + 2] = 1.0
    GW = G[:, :, None] * W[None]
    mask = (rng.random((S, M)) < 0.5).astype(np.float32)
    bgw = rng.random(N) + 0.5
    arrays = (np.einsum("bd,mdk->bmk", X, GW), np.einsum("nd,mdk->nmk", bg, GW),
              bg @ W + b, bgw / bgw.sum(), mask)
    return [np.asarray(a, dtype=np.float32) for a in arrays]


# ---------------------------------------------------------------------------
# fused_linear_ey past 32 classes


@pytest.mark.parametrize("activation", ["softmax", "sigmoid"])
@pytest.mark.parametrize("K", [40, 100])
def test_fused_plain_matches_pallas_past_32_classes(K, activation):
    """The shapes of the CPU tests of the Pallas kernel (B = 8, S = 64, N =
    9, M = 5), at class counts past the register kernel's 32."""

    args = _ey_inputs(8, 64, 9, 5, K, seed=K)
    ref = np.asarray(pallas_ey(*(jnp.asarray(a) for a in args), activation,
                               interpret=True))
    launches = tck.fused_linear_ey.launches
    got = tck.fused_linear_ey(*(_t(a) for a in args), activation).numpy()
    plain = tck.fused_linear_ey_plain(*(_t(a) for a in args), activation, chunk=5).numpy()
    assert got.shape == (8, 64, K)
    np.testing.assert_allclose(got, ref, atol=EY_ATOL)
    np.testing.assert_allclose(plain, ref, atol=EY_ATOL)
    assert tck.fused_linear_ey.launches == launches      # CPU tensors never launch


GROUPS = [[0, 1], [2], [3, 4, 5], [6], [7, 8, 9]]
NAMES = [f"g{i}" for i in range(len(GROUPS))]


@pytest.mark.parametrize("use_kernel", [None, True])
def test_multinomial_explain_past_32_classes_matches_jax(use_kernel):
    """A 40-class multinomial LR explained through the JAX package and
    through the port on the CPU, the port's predictor carried across by
    ``convert.linear_predictor_from_numpy``: the default route (the
    plan-constant path here) and the kernel route (the wrapper's plain
    version on CPU tensors)."""

    K, D, N, B = 40, 10, 12, 6
    rng = np.random.default_rng(40)
    W = rng.normal(scale=0.5, size=(D, K)).astype(np.float32)
    b = rng.normal(scale=0.5, size=K).astype(np.float32)
    bg = rng.normal(size=(N, D)).astype(np.float32)
    X = rng.normal(size=(B, D)).astype(np.float32)
    weights = (rng.random(N) + 0.5).astype(np.float32)
    ref = JaxKernelShap(JaxLinear(W, b, "softmax"), link="logit", seed=3)
    ref.fit(bg, group_names=NAMES, groups=GROUPS, weights=weights)
    ref_phi = np.stack([np.asarray(v) for v in ref.explain(X, silent=True).shap_values], 1)
    port = KernelShap(linear_predictor_from_numpy(W, b, "softmax", device="cpu"),
                      link="logit", seed=3, device="cpu",
                      engine_config=EngineConfig(shap=ShapConfig(use_kernel=use_kernel)))
    port.fit(bg, group_names=NAMES, groups=GROUPS, weights=weights)
    expl = port.explain(X, silent=True)
    phi = np.stack([np.asarray(v) for v in expl.shap_values], 1)
    assert phi.shape == (B, K, len(GROUPS))
    assert port.kernel_path == {"ey": "einsum_cached" if use_kernel is None else "plain"}
    np.testing.assert_allclose(phi, ref_phi, atol=PHI_ATOL)


# ---------------------------------------------------------------------------
# exact TreeSHAP past 64 groups, exact interactions at 64


def _wide_gbt(D, seed, n_estimators=6, max_depth=4):
    """A GradientBoostingRegressor over ``D`` columns, lifted by both
    packages (as ``tests/test_torch_port_treeshap.py``'s fixture)."""

    from sklearn.ensemble import GradientBoostingRegressor

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(200, D))
    y = X[:, :8] @ rng.normal(size=8) + np.where(X[:, 8] > 0, 1.0, -1.0) * X[:, 9]
    model = GradientBoostingRegressor(n_estimators=n_estimators, max_depth=max_depth,
                                      random_state=0).fit(X, y)
    Xf = X.astype(np.float32)
    jp = jax_as_predictor(model.predict, example_dim=D, probe_data=Xf[:16])
    tp = as_predictor(model.predict, example_dim=D, probe_data=Xf[:16], device="cpu")
    assert tts.supports_exact(tp)
    return Xf, jp, tp


def test_exact_phi_past_64_groups_matches_jax():
    """Exact phi of a lifted GBT over 70 ungrouped columns: the port's dense
    route on the CPU against the JAX ``exact_shap_from_reach`` (its einsum
    route), and the kernel's slot layout on the same inputs."""

    D = 70
    X, jp, tp = _wide_gbt(D, seed=70)
    G = groups_to_matrix(None, D)
    bg, x = X[100:140], X[:7]
    bgw = np.random.default_rng(1).random(bg.shape[0]).astype(np.float32) + 0.1
    ref = np.asarray(jts.exact_shap_from_reach(jp, x, jts.background_reach(jp, bg, G),
                                               bgw, G, use_pallas=False))
    reach = tts.background_reach(tp, _t(bg), _t(G))
    with capture_kernel_paths() as kp:
        got = tts.exact_shap_from_reach(tp, _t(x), reach, _t(bgw), _t(G), use_kernel=True)
    assert kp == {"exact_phi": "plain"} and got.shape == (7, 1, D)
    _close_rel(got.numpy(), ref)
    # the slot layout the kernel takes past 64 groups, on the route's inputs
    (xo, xn, zo, zd, lv), dmax = tts._dense_inputs(tp, _t(x), reach, _t(G))
    args = tts._kernel_args(xo, xn, zo, zd, lv, _t(bgw / bgw.sum()))
    dense = tck.exact_tree_phi_plain(*args, dmax=dmax)
    _close_rel(tck.exact_tree_phi_slots_plain(*args, dmax=dmax).numpy(), dense.numpy())


def test_interactions_at_64_groups_match_jax():
    """Exact interactions at the reference's cap, 64 ungrouped columns:
    the port on the CPU against the JAX ``exact_interactions_from_reach``
    (``distributedkernelshap_tpu/ops/treeshap.py:844``); 65 raises in
    both."""

    D = 64
    X, jp, tp = _wide_gbt(D, seed=64, n_estimators=4, max_depth=3)
    G = groups_to_matrix(None, D)
    bg, x = X[100:130], X[:4]
    bgw = np.random.default_rng(2).random(bg.shape[0]).astype(np.float32) + 0.1
    ref = np.asarray(jts.exact_interactions_from_reach(
        jp, x, jts.background_reach(jp, bg, G), bgw, G, use_pallas=False))
    reach = tts.background_reach(tp, _t(bg), _t(G))
    with capture_kernel_paths() as kp:
        phi, got = tts.exact_shap_and_interactions(tp, _t(x), reach, _t(bgw), _t(G),
                                                   use_kernel=True)
    assert kp == {"exact_phi": "plain", "exact_inter": "plain"}
    assert got.shape == (4, 1, D, D)
    _close_rel(got.numpy(), ref)
    np.testing.assert_allclose(got.numpy().sum(-1), phi.numpy(), atol=1e-5)
    G65 = np.concatenate([G, np.zeros((1, D), np.float32)])
    with pytest.raises(ValueError, match="64"):
        jts.exact_interactions_from_reach(jp, x, jts.background_reach(jp, bg, G65),
                                          bgw, G65, use_pallas=False)
    with pytest.raises(ValueError, match="64"):
        tts.exact_shap_and_interactions(tp, _t(x), tts.background_reach(tp, _t(bg),
                                                                         _t(G65)),
                                        _t(bgw), _t(G65))


# ---------------------------------------------------------------------------
# the slot layout exact_tree_phi takes past 64 groups


@pytest.mark.parametrize("kind", ["random", "all live", "none live"])
@pytest.mark.parametrize("dmax", [1, 30, 64])
def test_slot_layout_matches_dense_plain_at_100_groups(dmax, kind):
    """``exact_tree_phi_slots_plain`` (the inputs gathered into each path's
    64 slots, the terms added back at their groups) against the dense plain
    version at M = 100, on tree-path-shaped inputs (each path holds at most
    dmax groups, as ``chip_smoke.py`` phase 52 feeds the kernel)."""

    rng = np.random.default_rng(dmax)
    args = cs.phi_edge_inputs(rng, 6, 40, 70, 100, 2, "cpu", kind, path_groups=dmax)
    assert int(((args[0] + args[1]) > 0.5).any(0).sum(1).max()) <= dmax
    dense = tck.exact_tree_phi_plain(*args, dmax=dmax)
    slots = tck.exact_tree_phi_slots_plain(*args, dmax=dmax)
    _close_rel(slots.numpy(), dense.numpy())
    # the wrapper takes the dense plain version for CPU tensors at any M
    assert torch.equal(tck.exact_tree_phi(*args, dmax=dmax), dense)


def test_path_slots_order_padding_and_limit():
    """Row p of the slot table: the groups any instance has on path p, in
    ascending order, then -1; a path of more than 64 groups raises."""

    xo = torch.zeros(2, 3, 90)
    xn = torch.zeros(2, 3, 90)
    xo[0, 0, [5, 70]] = 1.0
    xn[1, 0, 2] = 1.0
    xo[1, 2, 89] = 1.0
    slots = tck.path_slots(xo, xn)
    assert slots.dtype == torch.int32 and slots.shape == (3, tck.MAX_TREE_M)
    assert slots[0, :4].tolist() == [2, 5, 70, -1]
    assert (slots[1] == -1).all()
    assert slots[2, :2].tolist() == [89, -1]
    xo[0, 1, :65] = 1.0
    with pytest.raises(ValueError, match="65 groups"):
        tck.path_slots(xo, xn)


def test_weight_tables_past_64_groups_share_one_word():
    """Past 64 groups the tables index counts of one word's bits: (65, 65),
    the same for every M at one dmax, and cached once."""

    wide = tck.build_weight_tables("phi", 30, 300)
    assert wide.shape == (2, 65, 65) and tck.table_side(300) == 65
    assert torch.equal(wide, tck.build_weight_tables("phi", 30, 64))
    assert tck.build_weight_tables("inter", 12, 12).shape == (3, 13, 13)
    cpu = torch.device("cpu")
    assert tck.exact_weight_tables("phi", 30, 100, cpu) \
        is tck.exact_weight_tables("phi", 30, 300, cpu)
    assert ("phi", 30, 64, "cpu") in tck._tables


# ---------------------------------------------------------------------------
# what the card's phases and scripts lean on


def test_covertype_lookalike_has_configuration_5s_groups():
    """``chip_smoke.py`` phase 51 copies Covertype's grouping (its loader
    imports the JAX package): 10 numeric singletons, wilderness 4, soil 40,
    under the same names; its rows are one-hot in both blocks."""

    from scripts.process_covertype_data import covertype_groups

    groups, names = covertype_groups()
    assert cs.covertype_groups() == groups and cs.COVERTYPE_NAMES == names
    rows = cs.covertype_rows(np.random.default_rng(0), 50)
    assert rows.shape == (50, 54) and rows.dtype == np.float32
    assert (rows[:, 10:14].sum(1) == 1).all() and (rows[:, 14:].sum(1) == 1).all()


def test_kernel_ab_reads_each_c_interface():
    """``scripts/torch_kernel_ab.py`` reads a base source's C interface:
    this checkout's exact kernels take the slot table and the dead flags;
    the earlier interfaces are told apart by the tables' occupancy query."""

    from scripts import torch_kernel_ab as ab

    got = {name: ab.interface((tck.CSRC_DIR / f"{name}.cu").read_text())
           for name in tck.KERNELS}
    assert got == {"fused_linear_ey": "ey_epilogue", "exact_tree_phi": "slots",
                   "exact_tree_inter": "slots"}
    assert ab.interface("long long exact_tree_phi_smem_bytes(int M) {") == "tables"
    assert ab.interface("int exact_tree_phi_launch(..., void* zbits, float* table") \
        == "binomial"
    assert len(ab._ARGS["slots"]) == len(tck._SYMBOLS["exact_tree_phi"]
                                         ["exact_tree_phi_launch"][0])
