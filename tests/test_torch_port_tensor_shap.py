"""The PyTorch port's exact tensor-train SHAP (``ops/tensor_shap.py``,
``models/tensor_net.py`` and the engine's ``'tn'`` flavour) against the JAX
package and against brute force, on the CPU.

Inputs are made from a seed with numpy.  Tolerances: the size-indexed DP
against a float64 enumeration of all 2^M coalitions within 1e-6 (the f32
DP's own rounding), against the JAX ``tensor_shap_phi`` and the JAX engine
within 2e-5 (f32 sums in another order); the Shapley weight tables, the
node structure, the fingerprint bytes and the host-side ALS fit compare
exactly; chunked explains within 1e-6 of one chunk, staged explains bit for
bit.  The JAX package's sharded TN claims bit identity with its
single-device run, which does not hold here (ROADMAP C.7), so the port is
held to it within 2e-5.
"""

from itertools import combinations
from math import factorial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedkernelshap_tpu.kernel_shap import KernelExplainerEngine as JaxEngine
from distributedkernelshap_tpu.models.tensor_net import TensorTrainPredictor as JaxTT
from distributedkernelshap_tpu.models.tensor_net import fit_tt_surrogate as jax_fit
from distributedkernelshap_tpu.ops import tensor_shap as jtns
from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
from distributedkernelshap_tpu_torch.kernel_shap import KernelExplainerEngine, StagedRows
from distributedkernelshap_tpu_torch.models.predictors import LinearPredictor
from distributedkernelshap_tpu_torch.models.tensor_net import (
    TensorTrainPredictor,
    fit_tt_surrogate,
)
from distributedkernelshap_tpu_torch.ops import tensor_shap as tns

CPU = EngineConfig(device="cpu")
BRUTE_ATOL = 1e-6
JAX_ATOL = 2e-5


def _cores(M, r, seed=0, K=1, b_scale=0.3):
    """Random well-conditioned TT cores (per-site scale r^-1/2), as the JAX
    package's tests make them."""

    rng = np.random.default_rng(seed)
    dims = [1] + [r] * (M - 1) + [K]
    scale = 1.0 / np.sqrt(r)
    return [(rng.normal(scale=scale, size=(dims[i], dims[i + 1])).astype(np.float32),
             rng.normal(scale=b_scale * scale, size=(dims[i], dims[i + 1])).astype(np.float32))
            for i in range(M)]


def _problem(M, r, N, B, seed, K=1, b_scale=0.3):
    rng = np.random.default_rng(seed + 100)
    return (_cores(M, r, seed, K, b_scale), rng.normal(size=(N, M)).astype(np.float32),
            rng.normal(size=(B, M)).astype(np.float32))


def _phi(values):
    """``(B, K, M)`` from an explain's list of K ``(B, M)`` arrays."""

    return np.stack([np.asarray(v) for v in values], 1)


def _brute_force(cores, X, bg):
    """float64 Shapley values ``(B, K, M)`` by enumerating every coalition,
    the value function evaluated through the host cores in float64."""

    M = X.shape[1]
    bg64 = np.asarray(bg, np.float64)

    def f64(rows):
        v = np.ones((rows.shape[0], 1))
        for i, (A, B) in enumerate(cores):
            v = np.einsum("br,brs->bs", v, A[None] + rows[:, i, None, None] * B[None])
        return v

    def value(S, x):
        comp = bg64.copy()
        comp[:, list(S)] = x[list(S)]
        return f64(comp).mean(0)

    K = cores[-1][0].shape[1]
    phi = np.zeros((X.shape[0], K, M))
    for bi, x in enumerate(np.asarray(X, np.float64)):
        for j in range(M):
            others = [i for i in range(M) if i != j]
            for s in range(M):
                w = factorial(s) * factorial(M - 1 - s) / factorial(M)
                for S in combinations(others, s):
                    phi[bi, :, j] += w * (value(set(S) | {j}, x) - value(S, x))
    return phi


# ---------------------------------------------------------------------------
# the DP against brute force and against the JAX contraction


@pytest.mark.parametrize("K", [1, 2])
def test_dp_matches_brute_force_enumeration(K):
    cores, bg, X = _problem(6, 3, 5, 3, seed=0, K=K, b_scale=0.5)
    engine = KernelExplainerEngine(TensorTrainPredictor(cores, device="cpu"), bg,
                                   link="identity", seed=0, config=CPU)
    phi = _phi(engine.get_explanation(X, nsamples="exact"))
    assert engine.kernel_path == {"exact_phi": "tn_dp"}
    np.testing.assert_allclose(phi, _brute_force(cores, X, bg), atol=BRUTE_ATOL)
    # efficiency: phi sums to f(x) - E f(z)
    fx = np.asarray(JaxTT(cores)(X))
    efz = np.asarray(JaxTT(cores)(bg)).mean(0)
    np.testing.assert_allclose(phi.sum(-1), fx - efz[None], atol=1e-5)


@pytest.mark.parametrize("chunk_elems", [None, 1, 4000])
def test_tensor_shap_phi_matches_jax(chunk_elems):
    """The batched DP against the JAX ``tensor_shap_phi`` (``lax.scan``
    over sites, ``vmap`` over instances, ``lax.map`` over rows) at M = 8,
    with the background rows in one chunk, one row a chunk and a few."""

    cores, bg, X = _problem(8, 4, 16, 5, seed=1, K=2)
    port, ref = TensorTrainPredictor(cores, device="cpu"), JaxTT(cores)
    Wt = tns.weight_toeplitz(8)
    bgw = np.full(16, 1 / 16, np.float32)
    s = port.tt_structure()
    got = tns.tensor_shap_phi(s["A"], s["B"], s["head"], torch.tensor(Wt), torch.tensor(X),
                              torch.tensor(bg), torch.tensor(bgw),
                              target_chunk_elems=chunk_elems).numpy()
    r = ref.tt_structure()
    want = np.asarray(jtns.tensor_shap_phi(r["A"], r["B"], r["head"], jnp.asarray(Wt),
                                           jnp.asarray(X), jnp.asarray(bg), jnp.asarray(bgw)))
    assert got.shape == want.shape == (5, 2, 8)
    np.testing.assert_allclose(got, want, atol=JAX_ATOL)
    rows = tns.tn_phi_rows(s["A"], s["B"], s["head"], torch.tensor(Wt), torch.tensor(X),
                           torch.tensor(bg), chunk_elems).numpy()
    rows_ref = np.asarray(jtns.tn_phi_rows(r["A"], r["B"], r["head"], jnp.asarray(Wt),
                                           jnp.asarray(X), jnp.asarray(bg)))
    np.testing.assert_allclose(rows, rows_ref, atol=JAX_ATOL)


@pytest.mark.parametrize("M", [1, 2, 5, 24, 48, 171])
def test_weight_tables_bit_equal_to_jax(M):
    np.testing.assert_array_equal(tns.shapley_size_weights(M), jtns.shapley_size_weights(M))
    np.testing.assert_array_equal(tns.weight_toeplitz(M), jtns.weight_toeplitz(M))


def test_weight_table_needs_a_site():
    with pytest.raises(ValueError, match="at least one site"):
        tns.shapley_size_weights(0)


# ---------------------------------------------------------------------------
# the predictor and its lifts


@pytest.mark.parametrize("M,r,K", [(1, 1, 1), (2, 3, 2), (7, 4, 1)])
def test_tt_predictor_matches_jax(M, r, K):
    cores, bg, X = _problem(M, r, 4, 6, seed=2, K=K)
    port, ref = TensorTrainPredictor(cores, device="cpu"), JaxTT(cores)
    np.testing.assert_allclose(port(torch.tensor(X)).numpy(), np.asarray(ref(X)), atol=1e-6)
    s, rs = port.tt_structure(), ref.tt_structure()
    for name in ("A", "B", "head"):
        np.testing.assert_array_equal(s[name].numpy(), np.asarray(rs[name]))
    assert (s["M"], s["K"], s["rank"], s["ranks"]) == (rs["M"], rs["K"], rs["rank"], rs["ranks"])
    assert port.fingerprint_bytes() == ref.fingerprint_bytes()
    assert (port.n_outputs, port.vector_out, port.out_transform) == (K, True, "identity")


def test_tt_predictor_rejects_bad_cores():
    A = np.ones((1, 2), np.float32)
    with pytest.raises(ValueError, match="at least one core"):
        TensorTrainPredictor([], device="cpu")
    with pytest.raises(ValueError, match="equal-shape"):
        TensorTrainPredictor([(A, np.ones((1, 3), np.float32))], device="cpu")
    with pytest.raises(ValueError, match="does not chain"):
        TensorTrainPredictor([(A, A), (np.ones((3, 1)), np.ones((3, 1)))], device="cpu")


def test_rank1_linear_lift_matches_the_linear_path():
    """A linear model in TT form serves the same phi as the linear path with
    every coalition enumerated, and as the closed form W_j (x_j - E z_j)."""

    rng = np.random.default_rng(11)
    D, K = 7, 2
    W = rng.normal(size=(D, K)).astype(np.float32)
    b = rng.normal(size=K).astype(np.float32)
    bg = rng.normal(size=(9, D)).astype(np.float32)
    X = rng.normal(size=(4, D)).astype(np.float32)
    tt = TensorTrainPredictor.from_linear(W, b, device="cpu")
    np.testing.assert_allclose(tt(torch.tensor(X)).numpy(), X @ W + b, atol=1e-5)
    assert tt.fingerprint_bytes() == JaxTT.from_linear(W, b).fingerprint_bytes()
    closed = np.einsum("dk,bd->bkd", W, X - bg.mean(0, keepdims=True))
    phi_tt = _phi(KernelExplainerEngine(tt, bg, seed=0, config=CPU)
                  .get_explanation(X, nsamples="exact"))
    np.testing.assert_allclose(phi_tt, closed, atol=JAX_ATOL)
    lin = LinearPredictor(W, b, activation="identity", device="cpu")
    phi_lin = _phi(KernelExplainerEngine(lin, bg, seed=0, config=CPU)
                   .get_explanation(X, nsamples=2 ** D - 2, l1_reg=False))
    np.testing.assert_allclose(phi_tt, phi_lin, atol=JAX_ATOL)
    lifted = TensorTrainPredictor.from_linear_predictor(lin)
    assert lifted.fingerprint_bytes() == tt.fingerprint_bytes()
    assert lifted._device().type == "cpu"
    with pytest.raises(ValueError, match="identity-activation"):
        TensorTrainPredictor.from_linear_predictor(
            LinearPredictor(W, b, activation="softmax", device="cpu"))
    one = TensorTrainPredictor.from_linear(W[:1], b, device="cpu")
    np.testing.assert_allclose(one(torch.tensor(X[:, :1])).numpy(), X[:, :1] @ W[:1] + b,
                               atol=1e-6)


@pytest.mark.parametrize("M", [1, 5])
def test_cp_lift_matches_jax(M):
    rng = np.random.default_rng(13)
    a = rng.normal(size=(M, 3)).astype(np.float32)
    bb = rng.normal(scale=0.4, size=(M, 3)).astype(np.float32)
    head = rng.normal(size=(3, 2)).astype(np.float32)
    X = rng.normal(size=(6, M)).astype(np.float32)
    port = TensorTrainPredictor.from_cp(a, bb, head, device="cpu")
    ref = JaxTT.from_cp(a, bb, head)
    assert port.fingerprint_bytes() == ref.fingerprint_bytes()
    np.testing.assert_allclose(port(torch.tensor(X)).numpy(), np.asarray(ref(X)), atol=1e-5)


def test_fit_tt_surrogate_matches_jax():
    """The ALS fit is host float64 in both packages: the same cores, and the
    fit error evaluated through each package's predictor."""

    cores, _, _ = _problem(6, 3, 1, 1, seed=0, b_scale=0.5)
    target = JaxTT(cores)
    rng = np.random.default_rng(17)
    Xfit = rng.normal(size=(200, 6)).astype(np.float32)

    def fn(Z):
        return np.asarray(target(Z))

    port = fit_tt_surrogate(fn, Xfit, rank=3, n_sweeps=3, seed=0, device="cpu")
    ref = jax_fit(fn, Xfit, rank=3, n_sweeps=3, seed=0)
    assert port.fingerprint_bytes() == ref.fingerprint_bytes()
    np.testing.assert_allclose(port.fit_mse_, ref.fit_mse_, rtol=1e-3, atol=1e-9)
    assert port.fit_mse_ < 0.05 * float(np.var(fn(Xfit)))
    assert tns.supports_exact_tn(port)


# ---------------------------------------------------------------------------
# the engine


@pytest.fixture(scope="module")
def mid():
    cores, bg, X = _problem(8, 4, 16, 5, seed=1)
    return dict(cores=cores, bg=bg, X=X, pred=TensorTrainPredictor(cores, device="cpu"))


def test_engine_exact_matches_jax(mid):
    eng = KernelExplainerEngine(mid["pred"], mid["bg"], link="identity", seed=0, config=CPU)
    ref = JaxEngine(JaxTT(mid["cores"]), mid["bg"], link="identity", seed=0)
    assert eng._exact_flavor() == "tn"
    got = _phi(eng.get_explanation(mid["X"], nsamples="exact"))
    want = _phi(ref.get_explanation(mid["X"], nsamples="exact"))
    np.testing.assert_allclose(got, want, atol=JAX_ATOL)
    np.testing.assert_allclose(eng.last_raw_prediction, np.asarray(ref.last_raw_prediction),
                               atol=1e-6)
    np.testing.assert_allclose(np.ravel(eng.expected_value), np.ravel(ref.expected_value),
                               atol=1e-6)
    assert eng.content_fingerprint() == ref.content_fingerprint()


def test_explain_api_and_importance(mid):
    ks = KernelShap(mid["pred"], seed=0, device="cpu").fit(mid["bg"])
    expl = ks.explain(mid["X"], nsamples="exact", silent=True)
    phi = _phi(expl.shap_values)
    total = phi.sum(-1) + np.asarray(expl.expected_value)[None]
    np.testing.assert_allclose(total, expl.data["raw"]["raw_prediction"], atol=1e-5)
    imp = ks._explainer.get_importance(mid["X"], nsamples="exact")
    np.testing.assert_allclose(imp, np.abs(phi).mean(0), atol=1e-7)


def test_engine_chunked_and_staged_explains(mid):
    X = np.concatenate([mid["X"], mid["X"][::-1]])
    sync = KernelExplainerEngine(mid["pred"], mid["bg"], seed=0, config=CPU)
    want = _phi(sync.get_explanation(X, nsamples="exact"))
    chunked = KernelExplainerEngine(mid["pred"], mid["bg"], seed=0,
                                    config=EngineConfig(device="cpu", instance_chunk=3))
    np.testing.assert_allclose(_phi(chunked.get_explanation(X, nsamples="exact")), want,
                               atol=1e-6)
    assert chunked.last_dispatch_window >= 1
    staged = sync.stage_rows(X, nsamples="exact")
    assert isinstance(staged, StagedRows)
    values, info = sync.get_explanation_async(staged, nsamples="exact")()
    np.testing.assert_array_equal(_phi(values), want)
    np.testing.assert_array_equal(info["raw_prediction"], sync.last_raw_prediction)
    values2, _ = sync.get_explanation_async(X, nsamples="exact")()
    np.testing.assert_array_equal(_phi(values2), want)
    # interactions have no TN closed form: staging declines, the sync path raises
    assert sync.stage_rows(X, nsamples="exact", interactions=True) is None
    with pytest.raises(ValueError, match="interactions"):
        sync.get_explanation(X, nsamples="exact", interactions=True)


def test_transfer_dtype_rounds_only_phi(mid):
    eng = KernelExplainerEngine(mid["pred"], mid["bg"], seed=0, config=CPU)
    want = _phi(eng.get_explanation(mid["X"], nsamples="exact"))
    raw = eng.last_raw_prediction
    from dataclasses import replace

    half = KernelExplainerEngine(mid["pred"], mid["bg"], seed=0, config=replace(
        CPU, shap=replace(CPU.shap, transfer_dtype="float16")))
    np.testing.assert_allclose(_phi(half.get_explanation(mid["X"], nsamples="exact")), want,
                               atol=1e-3, rtol=2e-3)
    np.testing.assert_array_equal(half.last_raw_prediction, raw)


def test_against_the_sharded_reference_within_tolerance(mid):
    from distributedkernelshap_tpu.parallel.distributed import DistributedExplainer

    eng = KernelExplainerEngine(mid["pred"], mid["bg"], link="identity", seed=0, config=CPU)
    got = _phi(eng.get_explanation(mid["X"], nsamples="exact"))
    dist = DistributedExplainer({"n_devices": 8, "coalition_parallel": 2,
                                 "algorithm": "kernel_shap"},
                                JaxEngine, (JaxTT(mid["cores"]), mid["bg"]),
                                {"link": "identity", "seed": 0})
    want = _phi(dist.get_explanation(mid["X"], nsamples="exact"))
    np.testing.assert_allclose(got, want, atol=JAX_ATOL)


def test_device_cache_rekey_reset_and_bound(mid):
    engine = KernelExplainerEngine(mid["pred"], mid["bg"], seed=0, config=CPU)
    c1 = engine._exact_tn_consts()
    assert engine._exact_tn_consts() is c1
    key = ("exact_tn_consts", engine.content_fingerprint())
    assert key in engine._plan_consts_cache
    engine.reset_device_state()
    assert key not in engine._plan_consts_cache
    assert engine._exact_tn_consts() is not c1
    for i in range(engine._DEV_CACHE_MAX_ENTRIES + 3):
        engine._plan_consts_cache[("filler", i)] = None
    engine._plan_consts_cache.pop(key, None)
    engine._exact_tn_consts()
    assert len(engine._plan_consts_cache) <= engine._DEV_CACHE_MAX_ENTRIES
    # equal core bytes are the same constants; any byte changed is another key
    clone = TensorTrainPredictor([(A.copy(), B.copy()) for A, B in mid["cores"]],
                                 device="cpu")
    assert KernelExplainerEngine(clone, mid["bg"], config=CPU).content_fingerprint() \
        == engine.content_fingerprint()
    bent = [(A.copy(), B.copy()) for A, B in mid["cores"]]
    bent[0][0][0, 0] += 1.0
    assert KernelExplainerEngine(TensorTrainPredictor(bent, device="cpu"), mid["bg"],
                                 config=CPU).content_fingerprint() \
        != engine.content_fingerprint()
    # plan_constant_cache=False recomputes and stores nothing, with the same phi
    off = KernelExplainerEngine(mid["pred"], mid["bg"], seed=0,
                                config=EngineConfig(device="cpu", plan_constant_cache=False))
    assert off._exact_tn_consts() is not off._exact_tn_consts()
    assert not off._plan_consts_cache
    np.testing.assert_array_equal(_phi(off.get_explanation(mid["X"], nsamples="exact")),
                                  _phi(engine.get_explanation(mid["X"], nsamples="exact")))


# ---------------------------------------------------------------------------
# readiness gates, validation and the fallback counts


def _gate_cases(pred, jpred, M):
    G = np.eye(M, dtype=np.float32)
    grouped = np.zeros((M, M - 1), np.float32)
    grouped[:M - 1] = np.eye(M - 1)
    grouped[-1, -1] = 1.0
    big = _cores(3, tns.TN_MAX_RANK + 1, seed=2)
    return [((pred, "identity", G), (jpred, "identity", G), None),
            ((object(), "identity", G), (object(), "identity", G), None),
            ((pred, "logit", G), (jpred, "logit", G), None),
            ((pred, "identity", grouped), (jpred, "identity", grouped), None),
            ((TensorTrainPredictor(big, device="cpu"), "identity", np.eye(3, dtype=np.float32)),
             (JaxTT(big), "identity", np.eye(3, dtype=np.float32)), None),
            ((pred, "identity", G), (jpred, "identity", G), 256)]


def test_readiness_gates_and_validation_match_jax(mid):
    want_reasons = [None, "structure", "link", "grouping", "rank", "footprint"]
    for (args, jargs, budget), want in zip(_gate_cases(mid["pred"], JaxTT(mid["cores"]), 8),
                                           want_reasons):
        assert tns.tn_exact_ready(*args, target_chunk_elems=budget) == want
        assert jtns.tn_exact_ready(*jargs, target_chunk_elems=budget) == want
        if budget is None and want is not None:
            with pytest.raises(ValueError) as port_err:
                tns.validate_exact_tn(*args)
            with pytest.raises(ValueError) as ref_err:
                jtns.validate_exact_tn(*jargs)
            assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="link='identity'"):
        KernelExplainerEngine(mid["pred"], mid["bg"], link="logit",
                              config=CPU).get_explanation(mid["X"], nsamples="exact")
    before = dict(tns.tn_fallback_counts())
    tns.record_tn_fallback("rank")
    tns.record_tn_fallback("rank", "again")
    assert tns.tn_fallback_counts()[("rank",)] == before.get(("rank",), 0.0) + 2.0


def test_structure_probes(mid):
    class Broken:
        def tt_structure(self):
            raise RuntimeError("broken")

    assert tns.tt_structure(Broken()) is None
    assert not tns.supports_exact_tn(Broken())
    assert tns.supports_exact_tn(mid["pred"])
    eng = KernelExplainerEngine(mid["pred"], mid["bg"], config=CPU)
    assert eng._exact_async_ready() and not eng._exact_async_ready(interactions=True)
