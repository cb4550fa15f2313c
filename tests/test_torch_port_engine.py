"""The PyTorch port's sampled engine against the JAX package, on the CPU:
the packed result copy (``pack_transfer`` / ``unpack_transfer``,
``ShapConfig.transfer_dtype``), the plan-constant cache
(``EngineConfig.plan_constant_cache``), the bounded device caches and the
device-side importance (``get_importance`` / ``rank_features``).

Inputs are made from a seed with numpy.  Tolerances: the packing is a
concatenation and a cast, so its bytes equal the reference's; the cached
and uncached arms of the plan-constant path run one function on equal
constants, so their phi is equal; against the classic function the
products are batched otherwise (1e-6); against the JAX package the two
frameworks sum f32 in other orders (``PHI_ATOL``, as in
``tests/test_torch_port_slice.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedkernelshap_tpu import KernelShap as JaxKernelShap
from distributedkernelshap_tpu.kernel_shap import EngineConfig as JaxEngineConfig
from distributedkernelshap_tpu.models.predictors import LinearPredictor as JaxLinear
from distributedkernelshap_tpu.ops import explain as jexp
from distributedkernelshap_tpu.ops.explain import ShapConfig as JaxShapConfig
from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
from distributedkernelshap_tpu_torch.convert import linear_predictor_from_numpy
from distributedkernelshap_tpu_torch.kernel_shap import KernelExplainerEngine
from distributedkernelshap_tpu_torch.ops import explain as texp
from distributedkernelshap_tpu_torch.ops.explain import ShapConfig

PHI_ATOL = 1e-4       # link-space phi of O(1), port vs JAX
RAW_ATOL = 2e-5       # link-space f(x) and E[f(x)], port vs JAX
OFF_ATOL = 1e-6       # plan-constant path vs the classic function
# phi through a 16-bit transfer (tests/test_pipeline.py:316-339)
F16_ATOL, F16_RTOL = 1e-3, 2e-3


def _problem(K, activation, seed=0, D=10, N=12, B=16):
    rng = np.random.default_rng(seed)
    # logits of O(1): far from the f32 saturation the logit link amplifies
    W = rng.normal(scale=0.5, size=(D, K)).astype(np.float32)
    b = rng.normal(size=K).astype(np.float32)
    bg = rng.normal(size=(N, D)).astype(np.float32)
    X = rng.normal(size=(B, D)).astype(np.float32)
    weights = (rng.random(N) + 0.5).astype(np.float32)
    return W, b, bg, X, weights


GROUPS = [[0, 1], [2], [3, 4, 5], [6], [7, 8, 9]]
NAMES = [f"g{i}" for i in range(len(GROUPS))]


def _port(W, b, activation, bg, weights, link, **cfg):
    shap = {k: cfg.pop(k) for k in ("use_kernel", "transfer_dtype") if k in cfg}
    ks = KernelShap(linear_predictor_from_numpy(W, b, activation, device="cpu"), link=link,
                    seed=3, device="cpu",
                    engine_config=EngineConfig(shap=ShapConfig(**shap), **cfg))
    return ks.fit(bg, group_names=NAMES, groups=GROUPS, weights=weights)


def _jax(W, b, activation, bg, weights, link, transfer_dtype=None):
    ks = JaxKernelShap(JaxLinear(W, b, activation), link=link, seed=3,
                       engine_config=JaxEngineConfig(
                           shap=JaxShapConfig(transfer_dtype=transfer_dtype)))
    return ks.fit(bg, group_names=NAMES, groups=GROUPS, weights=weights)


def _phi(expl):
    return np.stack([np.asarray(v) for v in expl.shap_values], 1)


# ---------------------------------------------------------------------------
# packed transfer


@pytest.mark.parametrize("transfer_dtype", [None, "float16", "bfloat16"])
def test_pack_transfer_bytes_match_jax(transfer_dtype):
    rng = np.random.default_rng(7)
    B, K, M = 5, 3, 7              # odd sizes: the narrow tail is not 4-aligned
    phi = rng.normal(scale=3.0, size=(B, K, M)).astype(np.float32)
    e_val = rng.normal(size=K).astype(np.float32)
    fx = rng.normal(size=(B, K)).astype(np.float32)
    narrow = np.concatenate([e_val, fx.ravel()])
    ref = np.asarray(jexp.pack_transfer(jnp.asarray(phi), jnp.asarray(narrow),
                                        transfer_dtype))
    got = texp.fetch_transfer(texp.pack_transfer(torch.as_tensor(phi),
                                                 torch.as_tensor(narrow), transfer_dtype))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    ref_wide, ref_narrow = jexp.unpack_transfer(ref, phi.size, transfer_dtype)
    wide, tail = texp.unpack_transfer(got, phi.size, transfer_dtype)
    np.testing.assert_array_equal(wide, ref_wide)
    np.testing.assert_array_equal(tail, narrow)          # the narrow tail stays f32
    np.testing.assert_array_equal(tail, ref_narrow)


def test_one_copy_per_explain_bit_identical_to_three(monkeypatch):
    """The engine brings phi, E[f] and f(x) back in one copy, equal bit for
    bit to the explain function's outputs copied one by one."""

    W, b, bg, X, weights = _problem(2, "softmax", B=5)
    for cache in (None, "off"):
        ks = _port(W, b, "softmax", bg, weights, "logit", plan_constant_cache=cache)
        engine = ks._explainer
        engine._dispatch_array(X, engine._plan(None))()   # first call: fingerprints, caches
        copies = []
        cpu = torch.Tensor.cpu
        monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a: copies.append(t.shape) or cpu(t, *a))
        got = engine._dispatch_array(X, engine._plan(None))()
        monkeypatch.undo()
        assert len(copies) == 1
        Xp = torch.as_tensor(engine._pad_to_bucket(X)[0])
        if cache is None:       # the plan-constant path
            chunk = texp._auto_chunk(engine._plan(None).n_rows, 8 * 12 * 2, 1 << 25)
            out = engine._fn_cache[("linear_fast", chunk)](
                Xp, engine._plan_consts(engine._plan(None), chunk))
        else:
            out = engine._fn()(Xp, *engine._device_args(engine._plan(None)))
        np.testing.assert_array_equal(got["shap_values"], out["shap_values"][:5].numpy())
        np.testing.assert_array_equal(got["expected_value"], out["expected_value"].numpy())
        np.testing.assert_array_equal(got["raw_prediction"], out["raw_prediction"][:5].numpy())


@pytest.mark.parametrize("transfer_dtype", ["float16", "bfloat16"])
def test_engine_transfer_dtype_matches_jax(transfer_dtype):
    """Only phi takes the 16-bit dtype: E[f] and f(x) stay bit-identical to
    the float32 explain, phi stays within the 16-bit rounding of it and of
    the JAX engine with the same setting."""

    W, b, bg, X, weights = _problem(2, "softmax", seed=5)
    full = _port(W, b, "softmax", bg, weights, "logit").explain(X, l1_reg=False)
    got = _port(W, b, "softmax", bg, weights, "logit",
                transfer_dtype=transfer_dtype).explain(X, l1_reg=False)
    ref = _jax(W, b, "softmax", bg, weights, "logit", transfer_dtype).explain(X, l1_reg=False)
    np.testing.assert_array_equal(got.expected_value, full.expected_value)
    np.testing.assert_array_equal(got.data["raw"]["raw_prediction"],
                                  full.data["raw"]["raw_prediction"])
    scale = 8 if transfer_dtype == "bfloat16" else 1    # 8 bits of mantissa, not 11
    np.testing.assert_allclose(_phi(got), _phi(full), atol=scale * F16_ATOL,
                               rtol=scale * F16_RTOL)
    np.testing.assert_allclose(_phi(got), _phi(ref), atol=scale * F16_ATOL,
                               rtol=scale * F16_RTOL)
    np.testing.assert_allclose(got.data["raw"]["raw_prediction"],
                               np.asarray(ref.data["raw"]["raw_prediction"]), atol=RAW_ATOL)


# ---------------------------------------------------------------------------
# plan-constant cache


VARIANTS = [(2, "softmax", "logit", "binary"), (3, "softmax", "logit", "general"),
            (3, "sigmoid", "logit", "general"), (2, "identity", "identity", "identity")]


@pytest.mark.parametrize("K,activation,link,variant", VARIANTS,
                         ids=[f"{v[3]}-{v[1]}-K{v[0]}" for v in VARIANTS])
def test_plan_constants_match(K, activation, link, variant):
    """At B = 1, 3 and 16: the cached arm equals the recomputing arm bit
    for bit, the classic function within 1e-6, the JAX package's cached
    path within PHI_ATOL; the second request is served from the cache."""

    W, b, bg, X, weights = _problem(K, activation, seed=K)
    assert texp.plan_constants_variant(activation, K) == variant
    arms = {c: _port(W, b, activation, bg, weights, link, plan_constant_cache=c)
            for c in (None, False, "off")}
    ref = _jax(W, b, activation, bg, weights, link)
    for B in (1, 3, 16):
        phi = {c: _phi(ks.explain(X[:B], l1_reg=False)) for c, ks in arms.items()}
        np.testing.assert_array_equal(phi[None], phi[False])
        np.testing.assert_allclose(phi[None], phi["off"], rtol=0, atol=OFF_ATOL)
        np.testing.assert_allclose(phi[None], _phi(ref.explain(X[:B], l1_reg=False)),
                                   atol=PHI_ATOL)
    assert arms[None].kernel_path == arms[False].kernel_path == {"ey": "einsum_cached"}
    assert arms["off"].kernel_path == {"ey": "einsum" if variant == "identity" else "plain"}
    # one entry per padded-batch chunk policy, none for the control arm
    assert len(arms[None]._explainer._plan_consts_cache) >= 1
    assert len(arms[False]._explainer._plan_consts_cache) == 0


def test_plan_consts_enabled_mirrors_reference():
    W, b, bg, _, weights = _problem(2, "softmax")

    def enabled(activation, **cfg):
        shap = ShapConfig(use_kernel=cfg.pop("use_kernel", None))
        pred = linear_predictor_from_numpy(W, b, activation, device="cpu")
        return KernelExplainerEngine(pred, bg, config=EngineConfig(
            device="cpu", shap=shap, **cfg))._plan_consts_enabled()

    assert enabled("softmax")                             # CPU: no kernel engaged
    assert not enabled("softmax", use_kernel=True)        # the kernel takes raw tensors
    assert not enabled("sigmoid", use_kernel=True)
    assert enabled("identity", use_kernel=True)           # identity never reaches it
    assert not enabled("softmax", plan_constant_cache="off")
    assert enabled("softmax", plan_constant_cache=False)  # the control arm


@pytest.mark.parametrize("change", ["background", "weights", "G", "link", "ridge"])
def test_content_fingerprint_changes(change):
    W, b, bg, _, weights = _problem(2, "softmax")
    pred = linear_predictor_from_numpy(W, b, "softmax", device="cpu")

    def fingerprint(bg=bg, weights=weights, groups=None, link="logit", ridge=1e-6):
        from distributedkernelshap_tpu_torch.data import DenseData

        groups = groups or [[i] for i in range(bg.shape[1])]
        data = DenseData(bg, [f"c{i}" for i in range(len(groups))], groups, weights)
        return KernelExplainerEngine(pred, data, link=link, config=EngineConfig(
            device="cpu", shap=ShapConfig(ridge=ridge))).content_fingerprint()

    base = fingerprint()
    assert fingerprint() == base
    other = {"background": dict(bg=bg + 1.0), "weights": dict(weights=weights[::-1].copy()),
             "G": dict(groups=GROUPS), "link": dict(link="identity"),
             "ridge": dict(ridge=1e-5)}[change]
    assert fingerprint(**other) != base


def test_device_caches_are_bounded_lru_and_reset():
    W, b, bg, X, weights = _problem(2, "softmax", B=2)
    engine = _port(W, b, "softmax", bg, weights, "logit")._explainer
    cap = KernelExplainerEngine._DEV_CACHE_MAX_ENTRIES
    assert cap == 8
    budgets = list(range(8, 8 + cap + 3))                 # more plans than the bound
    for n in budgets:
        engine.get_explanation(X, nsamples=n, l1_reg=False)
    assert len(engine._dev_cache) == cap
    assert len(engine._plan_consts_cache) == cap
    # least recently used out first: the first budgets' plans are gone
    from distributedkernelshap_tpu_torch.ops.coalitions import plan_fingerprint

    first, last = (plan_fingerprint(engine._plan(n)) for n in (budgets[0], budgets[-1]))
    assert first not in engine._dev_cache and last in engine._dev_cache
    assert [k[1] for k in engine._plan_consts_cache][-1] == last
    assert first not in [k[1] for k in engine._plan_consts_cache]
    touched = engine._plan(budgets[3])
    engine._device_args(touched)                          # a hit moves it to the end
    assert next(reversed(engine._dev_cache)) == plan_fingerprint(touched)
    n_plans = len(engine._plan_cache)
    engine.reset_device_state()
    assert not engine._dev_cache and not engine._plan_consts_cache and not engine._fn_cache
    assert len(engine._plan_cache) == n_plans             # host plans survive
    engine.get_explanation(X, l1_reg=False)               # and rebuilds from host state


# ---------------------------------------------------------------------------
# device-side importance


@pytest.mark.parametrize("use_kernel", [None, True])
def test_rank_features_matches_jax_and_explain(use_kernel, monkeypatch):
    """``rank_features`` against the JAX package's and against the port's
    own ranking of a full explain; with the kernel asked for it goes through
    the ``fused_linear_ey`` wrapper (CPU tensors: its plain version)."""

    from distributedkernelshap_tpu_torch.kernel_shap import rank_by_importance

    rng = np.random.default_rng(0)
    D, K, N, B = 8, 3, 16, 24
    W = rng.normal(size=(D, K)).astype(np.float32)
    bg = rng.normal(size=(N, D)).astype(np.float32)
    X = rng.normal(size=(B, D)).astype(np.float32)
    names = [f"f{i}" for i in range(D)]
    calls = []
    wrapper = texp.fused_linear_ey
    monkeypatch.setattr(texp, "fused_linear_ey", lambda *a: calls.append(1) or wrapper(*a))
    ks = KernelShap(linear_predictor_from_numpy(W, np.zeros(K), "softmax", device="cpu"),
                    link="identity", feature_names=names, seed=0, device="cpu",
                    engine_config=EngineConfig(shap=ShapConfig(use_kernel=use_kernel))).fit(bg)
    got = ks.rank_features(X)
    assert len(calls) == (1 if use_kernel else 0)
    ref = JaxKernelShap(JaxLinear(W, np.zeros(K, np.float32), "softmax"), link="identity",
                        feature_names=names, seed=0).fit(bg).rank_features(X)
    own = rank_by_importance(ks.explain(X, silent=True, l1_reg=False).shap_values, names)
    for want in (ref, own):
        assert set(got) == set(want)
        for key in got:
            assert got[key]["names"] == want[key]["names"]
            np.testing.assert_allclose(got[key]["ranked_effect"], want[key]["ranked_effect"],
                                       atol=1e-5)
    with pytest.raises(TypeError, match="unfitted"):
        KernelShap(lambda x: x, device="cpu").rank_features(X)
