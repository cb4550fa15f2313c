"""Parity of the PyTorch port's exact TreeSHAP main effects with the JAX
package, on the CPU.

Inputs are made from a seed with numpy and go through the JAX function and
its counterpart in ``distributedkernelshap_tpu_torch``.  Host-side arrays
(path tensors, packed plans, reach indicators, which are 0/1 from
integer-valued sums) must be equal; phi agrees within
``2e-5 · max(1, max|phi|)``, the JAX package's own kernel-vs-einsum bar
(``tests/test_treeshap.py:780``) for f32 sums taken in another order.  The
CUDA kernel cannot run here: its wrapper takes the plain PyTorch version for
CPU tensors, which is held against the Pallas kernel in interpret mode.
"""

import itertools
from math import factorial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedkernelshap_tpu import KernelShap as JaxKernelShap
from distributedkernelshap_tpu.models import as_predictor as jax_as_predictor
from distributedkernelshap_tpu.ops import groups_to_matrix
from distributedkernelshap_tpu.ops import treeshap as jts
from distributedkernelshap_tpu.ops.pallas_kernels import exact_tree_phi as pallas_phi
from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
from distributedkernelshap_tpu_torch.convert import tree_ensemble_from_numpy
from distributedkernelshap_tpu_torch.models import trees as ttrees
from distributedkernelshap_tpu_torch.models.predictors import as_predictor
from distributedkernelshap_tpu_torch.ops import cuda_kernels as tck
from distributedkernelshap_tpu_torch.ops import treeshap as tts
from distributedkernelshap_tpu_torch.ops.explain import ShapConfig, capture_kernel_paths

PHI_REL = 2e-5          # x max(1, max|phi|)
PRED_ATOL = 1e-5        # f32 leaf sums against sklearn's f64 predict


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _phi_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    tol = PHI_REL * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol


@pytest.fixture(scope="module")
def gbt():
    """The lifted GradientBoostingRegressor of tests/test_treeshap.py."""

    from sklearn.ensemble import GradientBoostingRegressor

    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 6))
    y = (2.0 * X[:, 0] + np.where(X[:, 1] > 0, 1.5, -0.5) * X[:, 2]
         + 0.1 * rng.normal(size=300))
    model = GradientBoostingRegressor(n_estimators=8, max_depth=3,
                                      random_state=0).fit(X, y)
    Xf = X.astype(np.float32)
    jp = jax_as_predictor(model.predict, example_dim=6, probe_data=Xf[:16])
    tp = as_predictor(model.predict, example_dim=6, probe_data=Xf[:16], device="cpu")
    assert isinstance(tp, ttrees.TreeEnsemblePredictor) and tts.supports_exact(tp)
    return dict(model=model, X=Xf, jax=jp, port=tp)


@pytest.fixture(scope="module")
def hgbt():
    """A HistGradientBoostingRegressor trained with missing values, so its
    splits carry learned NaN directions."""

    from sklearn.ensemble import HistGradientBoostingRegressor

    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 5))
    y = X[:, 0] + np.where(X[:, 1] > 0, 1.0, -1.0) * X[:, 2]
    X[rng.random(X.shape) < 0.1] = np.nan
    model = HistGradientBoostingRegressor(max_iter=10, random_state=0).fit(X, y)
    Xf = X.astype(np.float32)
    probe = np.nan_to_num(Xf[:16])
    jp = jax_as_predictor(model.predict, example_dim=5, probe_data=probe)
    tp = as_predictor(model.predict, example_dim=5, probe_data=probe, device="cpu")
    assert tp.missing_left is not None
    return dict(model=model, X=Xf, jax=jp, port=tp)


# ---------------------------------------------------------------------------
# models/trees.py


@pytest.mark.parametrize("which", ["gbt", "hgbt"])
def test_lift_forward_matches_sklearn_and_jax(which, request):
    s = request.getfixturevalue(which)
    X = s["X"][:64].copy()
    X[0, :3] = [np.nan, np.inf, -np.inf]
    X[1, 1:4] = [-np.inf, np.nan, np.inf]
    with torch.no_grad():
        got = s["port"](torch.as_tensor(X)).numpy()[:, 0]
    ref = np.asarray(s["jax"](jnp.asarray(X)))[:, 0]
    np.testing.assert_allclose(got, ref, atol=PRED_ATOL)
    # GradientBoosting's own predict refuses non-finite rows
    rows = slice(None) if which == "hgbt" else slice(2, None)
    np.testing.assert_allclose(got[rows], s["model"].predict(X[rows]), atol=PRED_ATOL)
    # ensembles without path tensors take the iterative traversal
    s["port"].path_sign, sign = None, s["port"].path_sign
    try:
        with torch.no_grad():
            it = s["port"](torch.as_tensor(X)).numpy()[:, 0]
    finally:
        s["port"].path_sign = sign
    np.testing.assert_allclose(it, got, atol=PRED_ATOL)


@pytest.mark.parametrize("which", ["gbt", "hgbt"])
def test_path_tensors_equal_jax(which, request):
    s = request.getfixturevalue(which)
    tp, jp = s["port"], s["jax"]
    for name in ("path_sign", "path_offset", "path_len", "leaf_value",
                 "feature", "threshold", "left", "right", "value"):
        assert np.array_equal(getattr(tp, name).numpy(),
                              np.asarray(getattr(jp, name))), name
    assert (tp.depth, tp.scale, tp.aggregation, tp.n_leaves) == \
        (jp.depth, jp.scale, jp.aggregation, jp.n_leaves)


def test_tree_ensemble_from_numpy_matches_jax(hgbt):
    jp = hgbt["jax"]
    tp = tree_ensemble_from_numpy(
        np.asarray(jp.feature), np.asarray(jp.threshold), np.asarray(jp.left),
        np.asarray(jp.right), np.asarray(jp.value), jp.depth, jp.aggregation,
        np.asarray(jp.base), jp.scale, jp.out_transform,
        np.asarray(jp.missing_left), jp.vector_out, device="cpu")
    assert np.array_equal(tp.path_sign.numpy(), np.asarray(jp.path_sign))
    X = hgbt["X"][:32]
    with torch.no_grad():
        got = tp(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, np.asarray(jp(jnp.asarray(X))), atol=PRED_ATOL)


def test_sampled_tree_explain_and_interactions_raise(gbt):
    """A sampled explain of a lifted tree runs (its masked_ey) and is
    additive; interactions without nsamples='exact', and the exact path
    under a non-identity link, raise as in the reference."""

    ks = KernelShap(gbt["model"].predict, device="cpu").fit(gbt["X"][:10])
    assert isinstance(ks._explainer.predictor, ttrees.TreeEnsemblePredictor)
    expl = ks.explain(gbt["X"][:3], silent=True)
    assert ks.kernel_path == {"ey": "masked_ey"}
    total = np.asarray(expl.shap_values[0]).sum(1) + expl.expected_value[0]
    np.testing.assert_allclose(total, expl.data["raw"]["raw_prediction"].reshape(-1),
                               atol=1e-4)
    # interactions exist only on the exact path, as in the reference
    with pytest.raises(ValueError, match="nsamples='exact'"):
        ks.explain(gbt["X"][:3], interactions=True)
    with pytest.raises(ValueError, match="identity"):
        KernelShap(gbt["model"].predict, link="logit", device="cpu").fit(
            gbt["X"][:10]).explain(gbt["X"][:3], nsamples="exact")


# ---------------------------------------------------------------------------
# reach tensors and the packed plan: host-side 0/1 arrays, equal


GROUPINGS = {"ungrouped": None, "grouped": [[0, 1], [2], [3, 4]]}


@pytest.mark.parametrize("grouping", list(GROUPINGS))
@pytest.mark.parametrize("chunk", [None, 1 << 12])
def test_background_reach_equals_jax(gbt, grouping, chunk):
    G = groups_to_matrix(GROUPINGS[grouping], 6)
    bg = gbt["X"][40:77]
    ref = jts.background_reach(gbt["jax"], bg, G, target_chunk_elems=chunk)
    got = tts.background_reach(gbt["port"], _t(bg), _t(G), target_chunk_elems=chunk)
    for name in ("z_ok", "z_ung_dead", "onpath_g"):
        assert np.array_equal(got[name].numpy(), np.asarray(ref[name])), name
    xo_r, xn_r = jts._x_reach(gbt["jax"], jnp.asarray(gbt["X"][:9]), jnp.asarray(G),
                              ref["onpath_g"], target_chunk_elems=chunk)
    xo, xn = tts._x_reach(gbt["port"], _t(gbt["X"][:9]), _t(G), got["onpath_g"],
                          target_chunk_elems=chunk)
    assert np.array_equal(xo.numpy(), np.asarray(xo_r))
    assert np.array_equal(xn.numpy(), np.asarray(xn_r))
    assert tts._exact_dmax(gbt["port"], G.shape[0]) == \
        jts._exact_dmax(gbt["jax"], G.shape[0])


@pytest.mark.parametrize("tile,shards", [(None, 1), (32, 1), (16, 2)])
def test_packed_plan_and_pack_reach_equal_jax(gbt, tile, shards):
    G = groups_to_matrix(GROUPINGS["grouped"], 6)
    ref = jts.build_packed_plan(gbt["jax"], G, tile=tile, shards=shards)
    got = tts.build_packed_plan(gbt["port"], G, tile=tile, shards=shards)
    assert np.array_equal(got.perm, ref.perm) and np.array_equal(got.live, ref.live)
    assert got.buckets == ref.buckets and got.gain == ref.gain
    assert (got.n_live, got.dmax_global) == (ref.n_live, ref.dmax_global)
    for pack in (None, True, False):
        assert tts.resolve_pack_paths(pack, got) == jts.resolve_pack_paths(pack, ref)
    bg = gbt["X"][:20]
    rr = jts.background_reach(gbt["jax"], bg, G)
    pr = jts.pack_reach(gbt["jax"], rr, ref)
    pg = tts.pack_reach(gbt["port"], tts.background_reach(gbt["port"], _t(bg), _t(G)), got)
    for name in ("z_ok", "z_dead", "lv", "perm", "live"):
        assert np.array_equal(pg[name].numpy(), np.asarray(pr[name])), name


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel (interpret mode)


def _phi_inputs(B, P, N, M, K, seed):
    rng = np.random.default_rng(seed)
    x_ok = (rng.random((B, P, M)) < 0.6).astype(np.float32)
    onpath = (rng.random((P, M)) < 0.5).astype(np.float32)
    z_ok = (rng.random((N, P, M)) < 0.6).astype(np.float32)
    z_dead = (rng.random((N, P)) < 0.1).astype(np.float32)
    leaf_val = rng.normal(size=(P, K)).astype(np.float32)
    bgw = rng.random(N).astype(np.float32) + 0.1
    bgw /= bgw.sum()
    return (x_ok * onpath, (1.0 - x_ok) * onpath, z_ok, z_dead, leaf_val, bgw)


@pytest.mark.parametrize("B,P,N,M,K", [(13, 77, 77, 6, 1), (5, 40, 19, 5, 3),
                                       (8, 130, 9, 7, 2)])
@pytest.mark.parametrize("dmax", ["1", "3", "M"])
def test_exact_tree_phi_plain_matches_pallas_interpret(B, P, N, M, K, dmax):
    dmax = M if dmax == "M" else int(dmax)
    args = _phi_inputs(B, P, N, M, K, seed=B * P + dmax)
    ref = np.asarray(pallas_phi(*(jnp.asarray(a) for a in args), dmax=dmax,
                                interpret=True))
    launches = tck.exact_tree_phi.launches
    got = tck.exact_tree_phi(*(_t(a) for a in args), dmax=dmax).numpy()
    plain = tck.exact_tree_phi_plain(*(_t(a) for a in args), dmax=dmax, chunk=4).numpy()
    assert tck.exact_tree_phi.launches == launches   # CPU tensors never launch
    _phi_close(got, ref)
    _phi_close(plain, ref)


def beta_weight_inputs(D: int):
    """Inputs whose phi IS the Beta weights: instance ``b`` holds one pair
    ``(u, v)`` with ``u + v <= 2D``, one path, one background row, leaf
    value 1; groups ``0..D-1`` are x-only against the row (z_ok = 0),
    groups ``D..2D-1`` x-not (z_ok = 1).  Then ``phi[b, 0] = wp(u, v)`` when
    ``u > 0`` and ``phi[b, D] = -wm(u, v)`` when ``v > 0``.  Returns the
    kernel's six inputs and the ``(u, v)`` pairs."""

    pairs = [(u, v) for u in range(D + 1) for v in range(D + 1) if u + v > 0]
    M = 2 * D
    xo = np.zeros((len(pairs), 1, M), np.float32)
    xn = np.zeros_like(xo)
    for b, (u, v) in enumerate(pairs):
        xo[b, 0, :u] = 1.0
        xn[b, 0, D:D + v] = 1.0
    z_ok = np.zeros((1, 1, M), np.float32)
    z_ok[0, 0, D:] = 1.0
    args = (xo, xn, z_ok, np.zeros((1, 1), np.float32), np.ones((1, 1), np.float32),
            np.ones(1, np.float32))
    return args, pairs


def test_plain_beta_weights_match_f64_table():
    """The masked-product weights 1/(u·C(u+v,u)), 1/(v·C(u+v,u)) against the
    f64 gammaln tables at rtol 5e-5 (tests/test_treeshap.py:814-834), read
    straight off phi."""

    D = 31
    args, pairs = beta_weight_inputs(D)
    phi = tck.exact_tree_phi(*(_t(a) for a in args), dmax=2 * D).numpy()[:, :, 0]
    wp_t, wm_t = tts._beta_tables(2 * D)
    u, v = np.array(pairs).T
    has_u, has_v = u > 0, v > 0
    np.testing.assert_allclose(phi[has_u, 0], wp_t[u[has_u], v[has_u]], rtol=5e-5)
    np.testing.assert_allclose(-phi[has_v, D], wm_t[u[has_v], v[has_v]], rtol=5e-5)
    assert np.array_equal(tts._beta_tables(12)[0], jts._beta_tables(12)[0])


def test_exact_tree_phi_wrapper_checks_and_never_gives_way_to_plain():
    args = [_t(a) for a in _phi_inputs(4, 10, 5, 3, 1, seed=0)]
    with pytest.raises(TypeError, match="float32"):
        tck.exact_tree_phi(args[0].double(), *args[1:], dmax=3)
    with pytest.raises(ValueError, match="contiguous"):
        tck.exact_tree_phi(args[0].transpose(0, 1), *args[1:], dmax=3)
    with pytest.raises(ValueError, match="shape"):
        tck.exact_tree_phi(*args[:5], torch.ones(4), dmax=3)
    with pytest.raises(ValueError, match="dmax"):
        tck.exact_tree_phi(*args, dmax=0)
    # tensors off the CPU launch the kernel or raise — the meta device
    # stands in for the card: any M reaches the launch (which raises off the
    # card), past one word of groups only with dmax <= 64
    for M in (tck.MAX_TREE_M, 100):
        wide = [_t(a).to("meta") for a in _phi_inputs(2, 3, 2, M, 1, 0)]
        with pytest.raises(ValueError, match="cuda or cpu"):
            tck.exact_tree_phi(*wide, dmax=tck.MAX_TREE_M)
    with pytest.raises(ValueError, match="dmax <= 64"):
        tck.exact_tree_phi(*wide, dmax=tck.MAX_TREE_M + 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tck.exact_tree_phi(*(a.to("meta") for a in args), dmax=3)
    # the dispatch with the kernel asked for reaches the wrapper, too
    with pytest.raises(ValueError, match="ShapConfig"):
        tts._phi_call(*wide, dmax=tck.MAX_TREE_M + 1, use_kernel=True)


def test_kernel_source_is_packaged():
    src = tck.CSRC_DIR / "exact_tree_phi.cu"
    common = tck.CSRC_DIR / "exact_tree_common.cuh"   # the packed-word limit
    text = src.read_text() + common.read_text()
    assert '#include "exact_tree_common.cuh"' in text
    assert "pallas_kernels.py:exact_tree_phi" in text
    assert f"kMaxM = {tck.MAX_TREE_M}" in text
    assert f"kNC = {tck.EXACT_CHUNK_ROWS}" in text
    assert "exact_tree_phi" in tck.KERNELS and "exact_tree_phi" in tck._SYMBOLS
    assert {"exact_tree_phi_smem_bytes", "exact_tree_phi_blocks_per_sm"} \
        <= set(tck._SYMBOLS["exact_tree_phi"])
    assert tck.library_path("exact_tree_phi") != tck.library_path("fused_linear_ey")


@pytest.mark.parametrize("dmax", [1, 4, 12, 31, 63])
def test_beta_weight_tables_match_f64(dmax):
    """The wrapper's division-free tables wp = 1/(u·C(u+v,u)) and wm =
    1/(v·C(u+v,u)) (the masked product in f32, the reciprocal rounded once)
    against the f64 gammaln tables at rtol 5e-5 (tests/test_treeshap.py:
    814-834), at M = dmax where the product is exact."""

    t = tck.build_weight_tables("phi", dmax, dmax).numpy()
    wp, wm = tts._beta_tables(dmax)
    assert t.shape == (2, dmax + 1, dmax + 1) and t.dtype == np.float32
    np.testing.assert_allclose(t[0], wp, rtol=5e-5, atol=0)
    np.testing.assert_allclose(t[1], wm, rtol=5e-5, atol=0)


def test_weight_tables_follow_the_plain_binomial_past_dmax():
    """Past dmax the tables keep the plain version's truncated product (u
    up to M), so a kernel reading them computes what the plain version
    does: wp[u, v] = 1/(u · Π_{i<=min(u,dmax)} (v+i)/i)."""

    M, dmax = 9, 3
    t = tck.build_weight_tables("phi", dmax, M).double().numpy()
    for u in range(1, M + 1):
        for v in range(M + 1):
            C = float(np.prod([(v + i) / i for i in range(1, min(u, dmax) + 1)]))
            assert t[0, u, v] == pytest.approx(1.0 / (u * C), rel=1e-6)
    with pytest.raises(ValueError, match="kind"):
        tck.build_weight_tables("pairs", dmax, M)


def test_weight_table_cache_is_keyed_by_kind_dmax_m_device():
    cpu, meta = torch.device("cpu"), torch.device("meta")
    a = tck.exact_weight_tables("phi", 4, 6, cpu)
    assert tck.exact_weight_tables("phi", 4, 6, cpu) is a
    assert torch.equal(a, tck.build_weight_tables("phi", 4, 6))
    others = [tck.exact_weight_tables("inter", 4, 6, cpu),
              tck.exact_weight_tables("phi", 5, 6, cpu),
              tck.exact_weight_tables("phi", 4, 7, cpu),
              tck.exact_weight_tables("phi", 4, 6, meta)]
    assert all(o is not a for o in others)
    assert others[-1].device.type == "meta"
    # dmax past M builds the same table as dmax = M
    assert tck.exact_weight_tables("phi", 9, 6, cpu) is tck.exact_weight_tables("phi", 6, 6, cpu)
    assert {("phi", 4, 6, "cpu"), ("inter", 4, 6, "cpu"), ("phi", 4, 6, "meta")} \
        <= set(tck._tables)


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117phi_tile_kernelILi16EEEvPKfS2_PKyS2_S2_S2_Pfiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117phi_tile_kernelILi16EEEvPKfS2_PKyS2_S2_S2_Pfiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117phi_tile_kernelILi64EEEvPKfS2_PKyS2_S2_S2_Pfiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117phi_tile_kernelILi64EEEvPKfS2_PKyS2_S2_S2_Pfiiiiiii
    24 bytes stack frame, 20 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 255 registers, 16 bytes smem, 464 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills():
    rep = tck.ptxas_report(_PTXAS_LOG)
    assert [r["registers"] for r in rep] == [40, 255]
    assert "phi_tile_kernelILi16E" in rep[0]["function"]
    assert (rep[0]["spill_stores"], rep[0]["spill_loads"], rep[0]["smem_bytes"]) == (0, 0, 0)
    assert (rep[1]["stack_bytes"], rep[1]["spill_stores"], rep[1]["spill_loads"],
            rep[1]["smem_bytes"]) == (24, 20, 28, 16)
    assert tck.ptxas_report("nvcc: no kernels") == []


# ---------------------------------------------------------------------------
# the dense and packed routes against the JAX package


@pytest.mark.parametrize("grouping", list(GROUPINGS))
@pytest.mark.parametrize("route", ["dense", "packed"])
def test_exact_routes_match_jax(gbt, grouping, route):
    G = groups_to_matrix(GROUPINGS[grouping], 6)
    rng = np.random.default_rng(5)
    X = gbt["X"][:13]
    bg = gbt["X"][50:127]
    bgw = rng.random(77).astype(np.float32) + 0.1
    jr = jts.background_reach(gbt["jax"], bg, G)
    tr = tts.background_reach(gbt["port"], _t(bg), _t(G))
    if route == "dense":
        ref = jts.exact_shap_from_reach(gbt["jax"], X, jr, bgw, G, use_pallas=False)
        with capture_kernel_paths() as kp:
            got = tts.exact_shap_from_reach(gbt["port"], _t(X), tr, _t(bgw), _t(G))
    else:
        jplan = jts.build_packed_plan(gbt["jax"], G, tile=16)
        ref = jts.exact_shap_packed(gbt["jax"], X, jr["onpath_g"],
                                    jts.pack_reach(gbt["jax"], jr, jplan), bgw, G,
                                    jplan.buckets, use_pallas=False)
        plan = tts.build_packed_plan(gbt["port"], G, tile=16)
        assert len(plan.buckets) >= 1
        with capture_kernel_paths() as kp:
            got = tts.exact_shap_packed(gbt["port"], _t(X), tr["onpath_g"],
                                        tts.pack_reach(gbt["port"], tr, plan),
                                        _t(bgw), _t(G), plan.buckets)
    assert kp == {"exact_phi": "plain"}
    _phi_close(got.numpy(), ref)


def _brute_force_phi(pred, x, bg, groups):
    """Shapley values by full enumeration over group coalitions."""

    M = len(groups)

    def f(S):
        rows = bg.copy()
        cols = [c for g in S for c in groups[g]]
        rows[:, cols] = x[cols]
        with torch.no_grad():
            return float(pred(torch.as_tensor(rows))[:, 0].mean())

    phi = np.zeros(M)
    for j in range(M):
        rest = [m for m in range(M) if m != j]
        for r in range(M):
            for S in itertools.combinations(rest, r):
                w = factorial(r) * factorial(M - r - 1) / factorial(M)
                phi[j] += w * (f(set(S) | {j}) - f(set(S)))
    return phi


def test_exact_matches_brute_force(gbt):
    groups = [[0, 1], [2], [3], [4, 5]]
    G = _t(groups_to_matrix(groups, 6))
    bg = gbt["X"][40:60]
    out = tts.exact_tree_shap(gbt["port"], _t(gbt["X"][:2]), _t(bg),
                              torch.ones(20), G)
    phi = out["shap_values"].numpy()
    for b in range(2):
        want = _brute_force_phi(gbt["port"], gbt["X"][b], bg.copy(), groups)
        np.testing.assert_allclose(phi[b, 0], want, atol=1e-5)
    total = phi.sum(-1) + out["expected_value"].numpy()[None]
    np.testing.assert_allclose(total, out["raw_prediction"].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# the slice end to end: KernelShap(...).explain(X, nsamples='exact')


@pytest.fixture(scope="module")
def adult_gbr():
    """benchmarks/configs.py:240-282 at its smoke size (max_iter=10 on 4000
    training rows, 8 test rows, the 100-row background, 12 groups)."""

    import scipy.sparse as sp
    from sklearn.ensemble import HistGradientBoostingRegressor

    from distributedkernelshap_tpu.utils import load_data

    data = load_data()
    Xtr = data["all"]["X"]["processed"]["train"][:4000].toarray()
    ytr = data["all"]["y"]["train"][:4000].astype(np.float64)
    gbr = HistGradientBoostingRegressor(max_iter=10, random_state=0).fit(Xtr, ytr)
    bgd = data["background"]["X"]["preprocessed"]
    return {"gbr": gbr, "gn": data["all"]["group_names"], "groups": data["all"]["groups"],
            "X": data["all"]["X"]["processed"]["test"][:8].toarray().astype(np.float32),
            "bg": bgd.toarray() if sp.issparse(bgd) else np.asarray(bgd)}


@pytest.mark.parametrize("pack_paths,packed", [(None, False), (True, True), (False, False)])
def test_adult_gbt_exact_matches_jax(adult_gbr, pack_paths, packed):
    a = adult_gbr
    ref = JaxKernelShap(a["gbr"].predict, seed=0).fit(
        a["bg"], group_names=a["gn"], groups=a["groups"]).explain(a["X"], nsamples="exact")
    ks = KernelShap(a["gbr"].predict, seed=0, device="cpu", engine_config=EngineConfig(
        shap=ShapConfig(pack_paths=pack_paths)))
    got = ks.fit(a["bg"], group_names=a["gn"], groups=a["groups"]).explain(
        a["X"], nsamples="exact")
    # the smoke ensemble plans a gain of 1.0: auto keeps the dense layout
    assert (ks._explainer._exact_consts()["packed"] is not None) == packed
    assert ks.kernel_path == {"exact_phi": "plain"}
    phi = np.asarray(got.shap_values[0])
    assert phi.shape == (8, 12)
    _phi_close(phi, ref.shap_values[0])
    np.testing.assert_allclose(got.expected_value, ref.expected_value, atol=1e-5)
    raw = np.asarray(got.data["raw"]["raw_prediction"]).reshape(-1)
    np.testing.assert_allclose(raw, a["gbr"].predict(a["X"]), atol=1e-5)
    additivity = np.abs(phi.sum(-1) + np.ravel(got.expected_value)[0] - raw).max()
    assert additivity < 1e-4
