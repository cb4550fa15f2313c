"""Parity of the PyTorch port's exact Shapley interactions with the JAX
package, on the CPU.

Inputs are made from a seed with numpy and go through the JAX function and
its counterpart in ``distributedkernelshap_tpu_torch``.  Tolerances:

* the raw pairwise sum (``exact_tree_inter_plain`` against the Pallas kernel
  in interpret mode): atol = rtol = 3e-5, the JAX package's kernel-vs-einsum
  bar (``tests/test_treeshap.py:903``);
* the finished matrices, port against JAX: ``2e-5 · max(1, max|·|)``, the
  phi bar, for f32 sums taken in another order;
* symmetry and row sums: 1e-5 (``tests/test_treeshap.py:518-519``);
* the weights against the f64 gammaln tables: rtol 5e-5
  (``tests/test_treeshap.py:924-955``).

The CUDA kernel cannot run here: its wrapper takes the plain PyTorch version
for CPU tensors.
"""

import itertools
from math import factorial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedkernelshap_tpu import KernelShap as JaxKernelShap
from distributedkernelshap_tpu import rank_interaction_pairs as jax_rank_pairs
from distributedkernelshap_tpu.models import as_predictor as jax_as_predictor
from distributedkernelshap_tpu.ops import groups_to_matrix
from distributedkernelshap_tpu.ops import treeshap as jts
from distributedkernelshap_tpu.ops.pallas_kernels import exact_tree_inter as pallas_inter
from distributedkernelshap_tpu_torch import (
    EngineConfig,
    KernelShap,
    rank_interaction_pairs,
)
from distributedkernelshap_tpu_torch.models.predictors import as_predictor
from distributedkernelshap_tpu_torch.ops import cuda_kernels as tck
from distributedkernelshap_tpu_torch.ops import treeshap as tts
from distributedkernelshap_tpu_torch.ops.explain import ShapConfig, capture_kernel_paths
from test_torch_port_treeshap import _phi_inputs, beta_weight_inputs

REL = 2e-5              # x max(1, max|.|)
RAW_TOL = 3e-5          # atol and rtol on the raw pairwise sum
CONV = 1e-5             # symmetry, row sums


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    tol = REL * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol


def _conventions(inter, phi):
    """Symmetric matrices whose rows sum to phi."""

    inter, phi = np.asarray(inter), np.asarray(phi)
    np.testing.assert_allclose(inter, np.swapaxes(inter, -1, -2), atol=CONV)
    np.testing.assert_allclose(inter.sum(-1), phi, atol=CONV)


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
    return dict(model=model, X=Xf, jax=jp, port=tp)


# ---------------------------------------------------------------------------
# the kernel's plain version


@pytest.mark.parametrize("B,P,N,M,K", [(13, 77, 77, 6, 1), (5, 48, 20, 6, 2)])
@pytest.mark.parametrize("dmax", ["1", "3", "M"])
def test_exact_tree_inter_plain_matches_pallas_interpret(B, P, N, M, K, dmax):
    dmax = M if dmax == "M" else int(dmax)
    args = _phi_inputs(B, P, N, M, K, seed=B * P + dmax)
    ref = np.asarray(pallas_inter(*(jnp.asarray(a) for a in args), dmax=dmax,
                                  interpret=True))
    launches = tck.exact_tree_inter.launches
    got = tck.exact_tree_inter(*(_t(a) for a in args), dmax=dmax).numpy()
    plain = tck.exact_tree_inter_plain(*(_t(a) for a in args), dmax=dmax,
                                       chunk=4).numpy()
    assert tck.exact_tree_inter.launches == launches   # CPU tensors never launch
    assert got.shape == (B, M, M, K)
    np.testing.assert_allclose(got, ref, atol=RAW_TOL, rtol=RAW_TOL)
    np.testing.assert_allclose(plain, ref, atol=RAW_TOL, rtol=RAW_TOL)


def test_plain_interaction_weights_match_f64_table():
    """The masked-product pairwise weights against the f64 gammaln tables
    at rtol 5e-5 (tests/test_treeshap.py:924-955), read straight off the raw
    sum: on ``beta_weight_inputs`` (groups ``0..D-1`` x-only, ``D..2D-1``
    x-not, one path, one row, leaf value 1) ``inter[b, 0, 1] = W_uu``,
    ``inter[b, 0, D] = W_uv`` and ``inter[b, D, D+1] = W_vv``."""

    D = 31
    args, pairs = beta_weight_inputs(D)
    inter = tck.exact_tree_inter(*(_t(a) for a in args), dmax=2 * D).numpy()[..., 0]
    w_uu, w_vv, w_uv = tts._interaction_tables(2 * D)
    u, v = np.array(pairs).T
    for got, table, sel in ((inter[:, 0, 1], w_uu, u >= 2),
                            (inter[:, 0, D], w_uv, (u >= 1) & (v >= 1)),
                            (inter[:, D, D + 1], w_vv, v >= 2)):
        np.testing.assert_allclose(got[sel], table[u[sel], v[sel]], rtol=5e-5)
    for got, want in zip(tts._interaction_tables(12), jts._interaction_tables(12)):
        assert np.array_equal(got, want)


def test_exact_tree_inter_wrapper_launches_or_raises(monkeypatch):
    """Tensors off the CPU launch the kernel or raise; they never run the
    plain version.  The meta device stands in for the card."""

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for tensors off the CPU")

    monkeypatch.setattr(tck, "exact_tree_inter_plain", no_plain)
    args = [_t(a).to("meta") for a in _phi_inputs(4, 10, 5, 3, 1, seed=0)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tck.exact_tree_inter(*args, dmax=3)
    # 64 groups (the reference's cap) reach the launch, 65 raise
    widest = [_t(a).to("meta") for a in _phi_inputs(2, 3, 2, tck.MAX_TREE_M, 1, 0)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tck.exact_tree_inter(*widest, dmax=3)
    wide = [_t(a).to("meta") for a in _phi_inputs(2, 3, 2, tck.MAX_TREE_M + 1, 1, 0)]
    with pytest.raises(ValueError, match="at most 64"):
        tck.exact_tree_inter(*wide, dmax=3)
    with pytest.raises(ValueError, match="at most 64"):
        tts._inter_call(*wide, dmax=3, use_kernel=True)
    # a card tensor within the limits goes to the launch (which counts; a
    # stand-in that launches nothing leaves the count alone)
    launched = []

    def fake_launch(wrapper, out_shape, kargs, dmax):
        launched.append((wrapper.__name__, out_shape, dmax))
        return torch.zeros(out_shape, device="meta")

    monkeypatch.setattr(tck, "_exact_launch", fake_launch)
    before = tck.exact_tree_inter.launches
    out = tck.exact_tree_inter(*args, dmax=3)
    assert launched == [("exact_tree_inter", (4, 3, 3, 1), 3)]
    assert out.shape == (4, 3, 3, 1)
    assert tck.exact_tree_inter.launches == before
    with pytest.raises(TypeError, match="float32"):
        tck.exact_tree_inter(args[0].double(), *args[1:], dmax=3)


class _FakeLibrary:
    """Stands in for a built exact-kernel library: records each launch call
    and returns ``err`` from it."""

    def __init__(self, name, err=0):
        self.calls, self.err = [], err
        setattr(self, f"{name}_partial_tiles", lambda P: (P + 31) // 32)
        setattr(self, f"{name}_launch", self._launch)

    def _launch(self, *cargs):
        # x_only, x_not, z_ok, z_dead, leaf_val, bgw, tables, slots, zbits,
        # zdead, partial, out, then B, P, N, M, K, dmax and the stream
        assert len(cargs) == 19
        self.calls.append(cargs[-7:-1])     # B, P, N, M, K, dmax
        return self.err


@pytest.mark.parametrize("wrapper", ["exact_tree_phi", "exact_tree_inter"])
def test_exact_launch_counts_only_launches(wrapper):
    """Each exact wrapper counts one where its kernel launched and nowhere
    else: not for a zero-size problem (nothing launches, the output is
    zeros) and not for a failed launch.  The launch gets the kernel's weight
    tables for (M, min(dmax, M)) on the tensors' device.  Meta tensors stand
    in for the card."""

    fn = getattr(tck, wrapper)
    kind, ntab = ("phi", 2) if wrapper == "exact_tree_phi" else ("inter", 3)

    def out_shape(B, M, K):
        return (B, M, K) if wrapper == "exact_tree_phi" else (B, M, M, K)

    for B, P, N in ((0, 10, 5), (4, 10, 0), (4, 0, 5)):
        lib = _FakeLibrary(wrapper)
        args = [_t(a).to("meta") for a in _phi_inputs(B, P, N, 3, 1, seed=0)]
        before = fn.launches
        out = tck._exact_run(fn, lib, 0, out_shape(B, 3, 1), args, dmax=3)
        assert out.shape == out_shape(B, 3, 1)
        assert lib.calls == [] and fn.launches == before
    args = [_t(a).to("meta") for a in _phi_inputs(4, 10, 5, 3, 2, seed=0)]
    lib = _FakeLibrary(wrapper, err=700)
    before = fn.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tck._exact_run(fn, lib, 0, out_shape(4, 3, 2), args, dmax=5)
    assert lib.calls == [(4, 10, 5, 3, 2, 3)] and fn.launches == before
    lib = _FakeLibrary(wrapper)
    out = tck._exact_run(fn, lib, 0, out_shape(4, 3, 2), args, dmax=5)
    assert out.shape == out_shape(4, 3, 2)
    assert lib.calls == [(4, 10, 5, 3, 2, 3)] and fn.launches == before + 1
    tables = tck._tables[(kind, 3, 3, "meta")]      # built for the launch
    assert tables.shape == (ntab, 4, 4) and tables.device.type == "meta"
    fn.launches = before


@pytest.mark.parametrize("dmax", [1, 4, 12, 31, 63])
def test_interaction_weight_tables_match_f64(dmax):
    """The wrapper's division-free tables W_uu, W_uv, W_vv (over the
    masked-product C(u+v-1, v)) against the f64 gammaln tables at rtol 5e-5
    (tests/test_treeshap.py:924-955), at M = dmax where the product is
    exact; the u = 0 case of W_vv included."""

    t = tck.build_weight_tables("inter", dmax, dmax).numpy()
    w_uu, w_vv, w_uv = tts._interaction_tables(dmax)
    assert t.shape == (3, dmax + 1, dmax + 1) and t.dtype == np.float32
    for got, want in zip(t, (w_uu, w_uv, w_vv)):
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=0)
    if dmax >= 2:
        assert t[2, 0, 2] == 1.0     # W_vv at u = 0, v = 2: 1/(v-1)


def test_kernel_source_is_packaged():
    text = (tck.CSRC_DIR / "exact_tree_inter.cu").read_text()
    common = (tck.CSRC_DIR / "exact_tree_common.cuh").read_text()
    assert "pallas_kernels.py:exact_tree_inter" in text
    assert '#include "exact_tree_common.cuh"' in text
    assert f"kMaxM = {tck.MAX_TREE_M}" in common
    assert f"kNC = {tck.EXACT_CHUNK_ROWS}" in common
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in common
    assert "exact_tree_inter" in tck.KERNELS and "exact_tree_inter" in tck._SYMBOLS
    assert {"exact_tree_inter_smem_bytes", "exact_tree_inter_blocks_per_sm"} \
        <= set(tck._SYMBOLS["exact_tree_inter"])
    assert tck._LIMITS["exact_tree_inter"][1] == tck.MAX_TREE_M


# ---------------------------------------------------------------------------
# exact_interactions_from_reach against the JAX package


CASES = {"ungrouped N=77": (None, slice(50, 127)),
         "grouped N=32": ([[0, 1], [2], [3, 4, 5]], slice(40, 72)),
         "ungrouped N=300": (None, slice(0, 300))}


@pytest.mark.parametrize("case", list(CASES))
def test_exact_interactions_from_reach_match_jax(gbt, case):
    groups, rows = CASES[case]
    G = groups_to_matrix(groups, 6)
    bg = gbt["X"][rows]
    bgw = np.random.default_rng(9).random(bg.shape[0]).astype(np.float32) + 0.1
    X = gbt["X"][:5]
    jr = jts.background_reach(gbt["jax"], bg, G)
    ref = np.asarray(jts.exact_interactions_from_reach(gbt["jax"], X, jr, bgw, G,
                                                       use_pallas=False))
    tr = tts.background_reach(gbt["port"], _t(bg), _t(G))
    with capture_kernel_paths() as kp:
        phi, got = tts.exact_shap_and_interactions(gbt["port"], _t(X), tr, _t(bgw), _t(G))
    assert kp == {"exact_phi": "plain", "exact_inter": "plain"}
    assert got.shape == (5, 1, G.shape[0], G.shape[0])
    _close(got.numpy(), ref)
    _conventions(got.numpy(), phi.numpy())
    alone = tts.exact_interactions_from_reach(gbt["port"], _t(X), tr, _t(bgw), _t(G),
                                              use_kernel=False)
    assert torch.equal(alone, got)


def _brute_force_interactions(pred, x, bg, groups):
    """Shapley interaction index by full enumeration over group coalitions
    of the model expectation game."""

    M = len(groups)

    def f(S):
        rows = bg.copy()
        cols = [c for g in S for c in groups[g]]
        rows[:, cols] = x[cols]
        with torch.no_grad():
            return float(pred(torch.as_tensor(rows))[:, 0].mean())

    I = np.zeros((M, M))
    for i, j in itertools.combinations(range(M), 2):
        rest = [m for m in range(M) if m not in (i, j)]
        for r in range(M - 1):
            for S in itertools.combinations(rest, r):
                w = factorial(r) * factorial(M - r - 2) / factorial(M - 1)
                S = set(S)
                I[i, j] += w * (f(S | {i, j}) - f(S | {i}) - f(S | {j}) + f(S))
        I[j, i] = I[i, j]
    return I


def test_interactions_match_brute_force(gbt):
    groups = [[0, 1], [2], [3], [4, 5]]
    G = _t(groups_to_matrix(groups, 6))
    bg = gbt["X"][40:60]
    reach = tts.background_reach(gbt["port"], _t(bg), G)
    inter = tts.exact_interactions_from_reach(gbt["port"], _t(gbt["X"][:2]), reach,
                                              torch.ones(20), G).numpy()
    off = ~np.eye(len(groups), dtype=bool)
    for b in range(2):
        I = _brute_force_interactions(gbt["port"], gbt["X"][b], bg.copy(), groups)
        np.testing.assert_allclose(inter[b, 0][off], (I / 2.0)[off], atol=CONV)


def test_exact_interactions_group_limit(gbt):
    G = torch.eye(65, 6)
    with pytest.raises(ValueError, match="beyond the supported 64"):
        tts.exact_interactions_from_reach(gbt["port"], _t(gbt["X"][:2]), {}, torch.ones(3), G)


# ---------------------------------------------------------------------------
# engine and public API


def test_engine_and_public_api(gbt):
    ks = KernelShap(gbt["model"].predict, seed=0, device="cpu").fit(gbt["X"][:10])
    eng = ks._explainer
    assert eng.last_interaction_values is None
    sv = eng.get_explanation(gbt["X"][:5], nsamples="exact", interactions=True)
    inter = eng.last_interaction_values
    assert isinstance(inter, list) and len(inter) == 1 and inter[0].shape == (5, 6, 6)
    _conventions(inter[0], sv)
    assert eng.kernel_path == {"exact_phi": "plain", "exact_inter": "plain"}
    with pytest.raises(ValueError, match="nsamples='exact'"):
        eng.get_explanation(gbt["X"][:5], nsamples=64, interactions=True)
    # a later explain without interactions drops the stale matrices
    eng.get_explanation(gbt["X"][5:8], nsamples="exact")
    assert eng.last_interaction_values is None

    res = ks.explain(gbt["X"][:5], nsamples="exact", interactions=True)
    got = res.data["raw"]["interaction_values"]
    assert got[0].shape == (5, 6, 6)
    _conventions(got[0], res.shap_values[0])
    assert "interaction_values" not in ks.explain(
        gbt["X"][:5], nsamples="exact").data["raw"]


def test_summarise_result_keeps_row_sums(gbt):
    ks = KernelShap(gbt["model"].predict, seed=0, device="cpu").fit(gbt["X"][:10])
    res = ks.explain(gbt["X"][:3], nsamples="exact", interactions=True,
                     summarise_result=True, cat_vars_start_idx=[0],
                     cat_vars_enc_dim=[2])
    inter = res.data["raw"]["interaction_values"]
    assert inter[0].shape == (3, 5, 5)          # 6 columns -> 5 variables
    assert np.asarray(res.shap_values[0]).shape == (3, 5)
    _conventions(inter[0], res.shap_values[0])
    # without indices the summarisation is dropped for both
    res = ks.explain(gbt["X"][:3], nsamples="exact", interactions=True,
                     summarise_result=True)
    assert res.data["raw"]["interaction_values"][0].shape == (3, 6, 6)
    _conventions(res.data["raw"]["interaction_values"][0], res.shap_values[0])


def test_rank_interaction_pairs_matches_jax(gbt):
    ks = KernelShap(gbt["model"].predict, seed=0, device="cpu").fit(gbt["X"][:10])
    inter = ks.explain(gbt["X"][:6], nsamples="exact",
                       interactions=True).data["raw"]["interaction_values"]
    names = [f"x{i}" for i in range(6)]
    for args in ((inter, names), (inter, names, 5), ([inter[0][0]], names),
                 (inter, names[:3])):
        got, ref = rank_interaction_pairs(*args), jax_rank_pairs(*args)
        assert got.keys() == ref.keys()
        for key in ref:
            assert got[key]["names"] == ref[key]["names"]
            assert np.array_equal(got[key]["ranked_effect"], ref[key]["ranked_effect"])


# ---------------------------------------------------------------------------
# the slice end to end on the Adult GBT


@pytest.fixture(scope="module")
def adult_gbr():
    """benchmarks/configs.py:240-282 at its smoke size (max_iter=10 on 4000
    training rows, 8 test rows, the 100-row background, 12 groups), and the
    JAX package's interaction explain of it."""

    import scipy.sparse as sp
    from sklearn.ensemble import HistGradientBoostingRegressor

    from distributedkernelshap_tpu.utils import load_data

    data = load_data()
    Xtr = data["all"]["X"]["processed"]["train"][:4000].toarray()
    ytr = data["all"]["y"]["train"][:4000].astype(np.float64)
    gbr = HistGradientBoostingRegressor(max_iter=10, random_state=0).fit(Xtr, ytr)
    bgd = data["background"]["X"]["preprocessed"]
    a = {"gbr": gbr, "gn": data["all"]["group_names"], "groups": data["all"]["groups"],
         "X": data["all"]["X"]["processed"]["test"][:8].toarray().astype(np.float32),
         "bg": bgd.toarray() if sp.issparse(bgd) else np.asarray(bgd)}
    a["ref"] = JaxKernelShap(gbr.predict, seed=0).fit(
        a["bg"], group_names=a["gn"], groups=a["groups"]).explain(
            a["X"], nsamples="exact", interactions=True)
    return a


@pytest.mark.parametrize("pack_paths", [None, True])
def test_adult_gbt_interactions_match_jax(adult_gbr, pack_paths):
    a = adult_gbr
    ks = KernelShap(a["gbr"].predict, seed=0, device="cpu", engine_config=EngineConfig(
        shap=ShapConfig(pack_paths=pack_paths)))
    got = ks.fit(a["bg"], group_names=a["gn"], groups=a["groups"]).explain(
        a["X"], nsamples="exact", interactions=True)
    eng = ks._explainer
    # auto keeps the smoke ensemble dense; forced packing drops the dense
    # reach from the phi constants, so the interactions rebuild it once
    packed = eng._exact_consts()["packed"] is not None
    assert packed == bool(pack_paths)
    assert (("exact_reach_full", eng.content_fingerprint())
            in eng._plan_consts_cache) == packed
    assert ks.kernel_path == {"exact_phi": "plain", "exact_inter": "plain"}
    inter = got.data["raw"]["interaction_values"][0]
    assert inter.shape == (8, 12, 12) and np.isfinite(inter).all()
    _close(inter, a["ref"].data["raw"]["interaction_values"][0])
    _close(got.shap_values[0], a["ref"].shap_values[0])
    _conventions(inter, got.shap_values[0])


# ---------------------------------------------------------------------------
# chip_smoke.py's diagnostics of the exact kernels, on the CPU


def test_divergence_counts_match_a_direct_walk():
    """``chip_smoke.divergence`` against a loop over (instance, 32-path
    tile, chunk) on a ragged problem (P and N not multiples of the tile and
    the chunk)."""

    import chip_smoke as cs

    args = cs.phi_edge_inputs(np.random.default_rng(5), 3, 40, 70, 6, 1, "cpu")
    nc = tck.EXACT_CHUNK_ROWS
    for kind in ("phi", "inter"):
        live = cs.live_triples(args, kind).numpy()        # (B, N, P)
        B, N, P = live.shape
        any_rows = max_lane = 0
        for b in range(B):
            for p0 in range(0, P, 32):
                for n0 in range(0, N, nc):
                    block = live[b, n0:n0 + nc, p0:p0 + 32]
                    any_rows += int(block.any(1).sum())
                    max_lane += int(block.sum(0).max())
        d = cs.divergence(args, kind)
        assert (d["rows_any_lane_live"], d["max_lane_live_rows"], d["live_triples"]) \
            == (any_rows, max_lane, int(live.sum()))
        assert d["warp_chunks"] == B * 2 * 2 and d["triples"] == B * N * P


def test_edge_input_kinds_do_what_they_say():
    import chip_smoke as cs

    rng = np.random.default_rng(6)
    alive = {}
    for kind in ("random", "all live", "none live", "all on path"):
        xo, xn, zo, zd, _, bgw = cs.phi_edge_inputs(rng, 4, 40, 30, 12, 1, "cpu", kind)
        assert float((xo * xn).sum()) == 0.0 and abs(float(bgw.sum()) - 1.0) < 1e-6
        dead = torch.einsum("bpm,npm->bnp", xn, 1.0 - zo)
        alive[kind] = (dead < 0.5) & (zd[None] < 0.5)
        if kind == "all on path":
            assert bool(((xo + xn) == 1.0).all()) and bool((xo[0] == 1.0).all())
    assert bool(alive["all live"].all()) and not bool(alive["none live"].any())
    assert 0 < float(alive["random"].float().mean()) < 1


def test_tile_kernel_names_read_from_mangled_symbols():
    import chip_smoke as cs

    assert cs.tile_name("_ZN12_GLOBAL__N_117inter_tile_kernelIjLi3EEEvPKfS2_PKyS2_"
                        "S2_S2_Pfiiiiiii") == "inter_tile_kernel<unsigned, 3>"
    assert cs.tile_name("_ZN12_GLOBAL__N_115phi_tile_kernelIyLi64EEEvPKf") \
        == "phi_tile_kernel<u64, 64>"
    assert cs.tile_name("_ZN12_GLOBAL__N_116sum_tiles_kernelEPKfPfxi") == "sum_tiles_kernel"
