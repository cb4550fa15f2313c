"""Faults of the PyTorch port found against the JAX package, each held to
the reference's behaviour on the CPU:

* a Gram matrix that is not positive definite gives NaN phi, as
  ``jax.scipy.linalg.cho_factor`` does, where ``torch.linalg.cholesky``
  raised (and its error check waited for the device);
* the exact tree path's constants live in the shared plan-constant LRU
  under the reference's keys and are recomputed with
  ``plan_constant_cache=False``;
* ``content_fingerprint`` reads a predictor's ``fingerprint_bytes``;
* the package exports the reference's top-level names;
* ``silent`` reaches the host-eval pass of the l1 path;
* composite predictors' members (``nn.ModuleList`` children) are part of
  their content fingerprints (C.14).

Inputs are made from a seed with numpy.  Tolerances: NaN patterns and
cache keys compare exactly; phi of a positive-definite solve within the
f32 tolerance of ``tests/test_torch_port_ops.py`` (1e-4 relative, 1e-5).
"""

import inspect
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributedkernelshap_tpu as jax_package
import distributedkernelshap_tpu_torch as port_package
from distributedkernelshap_tpu.ops import explain as jexp
from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
from distributedkernelshap_tpu_torch import kernel_shap as ks_mod
from distributedkernelshap_tpu_torch.kernel_shap import KernelExplainerEngine
from distributedkernelshap_tpu_torch.models.predictors import (
    BasePredictor,
    CallbackPredictor,
)
from distributedkernelshap_tpu_torch.ops import explain as texp
from distributedkernelshap_tpu_torch.ops.coalitions import coalition_plan

#: reference exports the port does not define yet (none since the
#: one-process half of ROADMAP.md queue A item 10 brought DISTRIBUTED_OPTS,
#: batch and get_filename)
QUEUED_EXPORTS = set()


def _indefinite(M1: int, seed: int, eigs) -> np.ndarray:
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(M1, M1)))
    return ((Q * np.asarray(eigs)) @ Q.T).astype(np.float32)


# ---------------------------------------------------------------------------
# C.1: a Gram matrix that is not positive definite


@pytest.mark.parametrize("eigs", [[2.0, 1.0, 0.5, 0.3, -0.4],      # one negative
                                  [-1.0, -2.0, -0.5, -0.1, -3.0]])  # none positive
def test_non_positive_definite_gram_gives_nan_like_the_reference(eigs):
    A = _indefinite(5, 0, eigs)
    rng = np.random.default_rng(1)
    rhs = rng.normal(size=(3, 2, 5)).astype(np.float32)
    fme = rng.normal(size=(3, 2)).astype(np.float32)
    want = np.asarray(jexp.solve_from_normal(jnp.asarray(A), jnp.asarray(rhs),
                                             jnp.asarray(fme), 0.0))
    got = texp.solve_from_normal(torch.tensor(A), torch.tensor(rhs), torch.tensor(fme),
                                 0.0).numpy()
    assert got.shape == want.shape == (3, 2, 6)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).all()


def test_positive_definite_factor_is_unchanged():
    """On a positive-definite Gram the NaN-safe factor is the Cholesky
    factor itself, bit for bit, and the solve agrees with the reference."""

    A = _indefinite(6, 2, [3.0, 2.0, 1.0, 0.5, 0.2, 0.1])
    np.testing.assert_array_equal(texp.cholesky_or_nan(torch.tensor(A)).numpy(),
                                  torch.linalg.cholesky(torch.tensor(A)).numpy())
    rng = np.random.default_rng(3)
    rhs = rng.normal(size=(2, 1, 6)).astype(np.float32)
    fme = rng.normal(size=(2, 1)).astype(np.float32)
    want = np.asarray(jexp.solve_from_normal(jnp.asarray(A), jnp.asarray(rhs),
                                             jnp.asarray(fme), 1e-6))
    got = texp.solve_from_normal(torch.tensor(A), torch.tensor(rhs), torch.tensor(fme),
                                 1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_singular_plan_constants_give_nan_phi():
    """The plan-constant path factors its Gram once per fit: a plan whose
    Gram is singular (every weight 0) factors to NaN, so its phi are NaN,
    instead of raising."""

    rng = np.random.default_rng(4)
    W = rng.normal(size=(4, 2)).astype(np.float32)
    b = np.zeros(2, np.float32)
    pred = port_package.LinearPredictor(W, b, "identity", device="cpu")
    bg = rng.normal(size=(6, 4)).astype(np.float32)
    plan = coalition_plan(4, nsamples=10, seed=0)
    precompute = texp.build_linear_plan_consts_fn(pred, texp.ShapConfig(ridge=0.0), 16)
    G = torch.eye(4)
    consts = precompute(torch.tensor(bg), torch.ones(6), torch.tensor(plan.mask),
                        torch.zeros(plan.n_rows), G)
    assert torch.isnan(consts["chol"]).all()


# ---------------------------------------------------------------------------
# C.2: the exact constants in the shared LRU


@pytest.fixture(scope="module")
def small_gbt():
    from sklearn.ensemble import GradientBoostingRegressor

    rng = np.random.default_rng(5)
    Xtr = rng.normal(size=(120, 6)).astype(np.float32)
    y = Xtr[:, 0] - 2 * (Xtr[:, 1] > 0) * Xtr[:, 2]
    gbr = GradientBoostingRegressor(n_estimators=6, max_depth=3, random_state=0).fit(Xtr, y)
    return gbr, Xtr[:10], Xtr[100:104]


@pytest.mark.parametrize("cache,builds", [(None, 1), (False, 2)])
def test_exact_consts_honour_plan_constant_cache(small_gbt, monkeypatch, cache, builds):
    gbr, bg, X = small_gbt
    calls = []
    real = ks_mod.background_reach

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ks_mod, "background_reach", counting)
    ks = KernelShap(gbr.predict, seed=0, device="cpu",
                    engine_config=EngineConfig(plan_constant_cache=cache))
    ks.fit(bg)
    first = ks.explain(X, nsamples="exact", silent=True).shap_values[0]
    second = ks.explain(X, nsamples="exact", silent=True).shap_values[0]
    np.testing.assert_array_equal(first, second)
    eng = ks._explainer
    assert len(calls) == builds
    key = ("exact_consts", eng.content_fingerprint(), None)
    assert (key in eng._plan_consts_cache) == (cache is None)
    assert not hasattr(eng, "_exact_cache")


def test_exact_consts_rekey_on_pack_paths_and_stay_bounded(small_gbt):
    from dataclasses import replace

    gbr, bg, X = small_gbt
    eng = KernelExplainerEngine(gbr.predict, bg, seed=0, config=EngineConfig(device="cpu"))
    c1 = eng._exact_consts()
    assert eng._exact_consts() is c1
    eng.config = replace(eng.config, shap=replace(eng.config.shap, pack_paths=True))
    c2 = eng._exact_consts()
    assert c2 is not c1 and c2["packed"] is not None
    assert ("exact_consts", eng.content_fingerprint(), True) in eng._plan_consts_cache
    for i in range(eng._DEV_CACHE_MAX_ENTRIES + 3):
        eng._plan_consts_cache[("filler", i)] = None
    eng._exact_full_reach()
    assert len(eng._plan_consts_cache) <= eng._DEV_CACHE_MAX_ENTRIES
    assert ("exact_reach_full", eng.content_fingerprint()) in eng._plan_consts_cache
    eng.reset_device_state()
    assert not eng._plan_consts_cache


# ---------------------------------------------------------------------------
# the content fingerprint reads fingerprint_bytes


class _ContentPredictor(BasePredictor):
    """A scalar model ``x @ w`` that publishes its weights as content bytes."""

    def __init__(self, w):
        super().__init__()
        self.w_host = np.asarray(w, np.float32)
        self.register_buffer("w", torch.tensor(self.w_host))

    def forward(self, X):
        return (X @ self.w)[:, None]

    def fingerprint_bytes(self) -> bytes:
        return self.w_host.tobytes()


def test_content_fingerprint_reads_fingerprint_bytes():
    rng = np.random.default_rng(6)
    bg = rng.normal(size=(5, 3)).astype(np.float32)
    w = rng.normal(size=3)

    def fp(weights):
        return KernelExplainerEngine(_ContentPredictor(weights), bg,
                                     config=EngineConfig(device="cpu")).content_fingerprint()

    assert fp(w) == fp(w.copy())
    assert fp(w) != fp(w + 1.0)


def test_content_fingerprint_falls_back_to_the_type():
    """A predictor without content bytes (``None``) keys by its type, as
    before: two instances share the fingerprint."""

    class NoContent(_ContentPredictor):
        def fingerprint_bytes(self):
            return None

    rng = np.random.default_rng(7)
    bg = rng.normal(size=(5, 3)).astype(np.float32)
    a = KernelExplainerEngine(NoContent(rng.normal(size=3)), bg,
                              config=EngineConfig(device="cpu"))
    b = KernelExplainerEngine(NoContent(rng.normal(size=3)), bg,
                              config=EngineConfig(device="cpu"))
    assert a.content_fingerprint() == b.content_fingerprint()


# ---------------------------------------------------------------------------
# C.3: the package exports


def _exports(module) -> set:
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


def test_package_exports_the_references_names():
    missing = _exports(jax_package) - _exports(port_package)
    assert missing == QUEUED_EXPORTS
    assert port_package.__version__ == jax_package.__version__
    assert port_package.Data is not None and port_package.NumpyEncoder is not None


# ---------------------------------------------------------------------------
# C.4: silent reaches the l1 path's host-eval pass


@pytest.mark.parametrize("silent,passes", [(False, 2), (True, 0)])
def test_hosteval_l1_logs_both_passes_unless_silent(caplog, silent, passes):
    rng = np.random.default_rng(8)
    D = 16
    W = rng.normal(scale=0.3, size=(D, 1)).astype(np.float32)
    bg = rng.normal(size=(8, D)).astype(np.float32)
    X = rng.normal(size=(2, D)).astype(np.float32)

    def fn(x):
        return np.asarray(x, np.float32) @ W

    eng = KernelExplainerEngine(CallbackPredictor(fn, example_dim=D), bg, seed=0,
                                config=EngineConfig(host_eval=True, device="cpu"))
    with caplog.at_level(logging.INFO, logger=ks_mod.__name__):
        eng.get_explanation(X, nsamples=64, l1_reg="num_features(5)", silent=silent)
    done = [r for r in caplog.records if r.getMessage().startswith("host-eval:")
            and r.getMessage().split()[1].split("/")[0]
            == r.getMessage().split()[1].split("/")[1]]
    assert len(done) == passes


# ---------------------------------------------------------------------------
# C.14: composite predictors keep their members in nn.ModuleList children;
# the content walk reads them, so two composites with different members
# never share a fingerprint, a result-cache key or a shared program


def _lin(seed, port: bool, D: int = 4):
    from distributedkernelshap_tpu.models import LinearPredictor as JaxLinear
    from distributedkernelshap_tpu_torch.models.predictors import LinearPredictor

    rng = np.random.default_rng(seed)
    W = rng.normal(size=(D, 2)).astype(np.float32)
    b = rng.normal(size=(2,)).astype(np.float32)
    if port:
        return LinearPredictor(W, b, activation="softmax", device="cpu")
    return JaxLinear(W, b, activation="softmax")


def _composite(kind: str, member_seeds, port: bool):
    """A voting / AdaBoost / stacking / one-vs-rest composite of linear
    members made from ``member_seeds``, in the port or the JAX package."""

    if port:
        from distributedkernelshap_tpu_torch.models import compose
    else:
        from distributedkernelshap_tpu.models import compose
    members = [_lin(s, port) for s in member_seeds]
    if kind == "voting":
        return compose.MeanEnsemblePredictor(members)
    if kind == "adaboost":
        return compose.AdaBoostPredictor(members, np.array([0.7, 0.3]), n_classes=2)
    if kind == "stacking":
        # the final estimator reads the members' positive columns
        final = _lin(50, port, D=2)
        return compose.StackingPredictor(members, [(1, 2), (1, 2)], final)
    return compose.OneVsRestPredictor(members)


def _served(pred, port: bool):
    bg = np.random.default_rng(99).normal(size=(6, 4)).astype(np.float32)
    if port:
        from distributedkernelshap_tpu_torch.serving.wrappers import BatchKernelShapModel
        return BatchKernelShapModel(pred, bg, {"seed": 0, "device": "cpu"}, {})
    from distributedkernelshap_tpu.serving.wrappers import BatchKernelShapModel as JaxModel
    return JaxModel(pred, bg, {"seed": 0}, {})


def _keys(model, port: bool):
    """``(predictor digest, weak, model fingerprint, shared-program key)``."""

    if port:
        from distributedkernelshap_tpu_torch.scheduling import result_cache as rc
        share = texp.shared_program_key
    else:
        from distributedkernelshap_tpu.scheduling import result_cache as rc
        share = jexp.shared_program_key
    engine = model.explainer._explainer
    digest, weak = rc.predictor_fingerprint(engine.predictor)
    return digest, weak, rc.model_fingerprint(model, count_weak=False), share(model)


@pytest.mark.parametrize("kind", ["voting", "adaboost", "stacking"])
def test_composites_with_different_members_get_different_keys(kind):
    for port in (False, True):
        a = _keys(_served(_composite(kind, (1, 2), port), port), port)
        a_again = _keys(_served(_composite(kind, (1, 2), port), port), port)
        b = _keys(_served(_composite(kind, (1, 3), port), port), port)
        assert not a[1] and not b[1], (kind, port)
        # the reference's inequality, and the port's
        assert a[0] != b[0] and a[2] != b[2], (kind, port)
        assert a[3] is None or a[3] != b[3], (kind, port)
        # content-identical composites still agree (restart-stable keys)
        assert a[0] == a_again[0] and a[2] == a_again[2] and a[3] == a_again[3]
    port_keys = _keys(_served(_composite(kind, (1, 2), True), True), True)
    jax_keys = _keys(_served(_composite(kind, (1, 2), False), False), False)
    assert (port_keys[3] is None) == (jax_keys[3] is None)


def test_one_vs_rest_gets_a_strong_fingerprint_like_the_reference():
    from distributedkernelshap_tpu.scheduling.result_cache import (
        predictor_fingerprint as jax_fp,
    )
    from distributedkernelshap_tpu_torch.resilience.journal import _predictor_content_digest
    from distributedkernelshap_tpu_torch.scheduling.result_cache import predictor_fingerprint

    assert jax_fp(_composite("ovr", (1, 2), port=False))[1] is False
    a, weak = predictor_fingerprint(_composite("ovr", (1, 2), port=True))
    assert weak is False
    assert a == predictor_fingerprint(_composite("ovr", (1, 2), port=True))[0]
    assert a != predictor_fingerprint(_composite("ovr", (1, 3), port=True))[0]
    # the journal's restart-stable digest reads the members too
    assert _predictor_content_digest(_composite("ovr", (1, 2), port=True)) != \
        _predictor_content_digest(_composite("ovr", (1, 3), port=True))


def test_two_voting_tenants_with_different_members_are_not_coalesced():
    from distributedkernelshap_tpu_torch.registry import ModelRegistry

    reg = ModelRegistry()
    reg.register("a", _served(_composite("voting", (1, 2), True), True))
    reg.register("b", _served(_composite("voting", (1, 3), True), True))
    ka, kb = reg.resolve("a").share_key, reg.resolve("b").share_key
    assert ka and kb and ka != kb
    assert reg.share_peers(ka) == 1 and reg.share_peers(kb) == 1
