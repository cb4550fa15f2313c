"""The PyTorch port's anytime refinement (``distributedkernelshap_tpu_torch/
anytime``) against the JAX package, on the CPU.

The schedules, draw blocks and calibration are host numpy copies, so they
must equal the reference's byte for byte.  The round engine runs on torch
tensors: per round, phi, the split-half gap, the reported error, the
cumulative sample count and ``done`` are held against the JAX engine's
``anytime_begin(...).step()`` on the same seeded inputs, for a linear
predictor (``fused_linear_ey``'s plain version on CPU tensors), a tree
ensemble (``masked_ey``) and a numpy black box (the generic route).

Tolerances: phi and the raw gap within ``PHI_REL · max(1, max|φ|)`` with the
identity link (f32 sums in another order), ``LOGIT_REL · max(1, max|φ|)``
with the logit link (which amplifies an f32 rounding of a probability near
0 or 1); the reported error is the gap times the calibration factor (at
most 6), so it takes the gap's bound times that factor.  Without an
enumerated block (a budget too small for one) the first rounds' stratum
solves are set by the ridge, so there only phi is compared.  Within the
port, the accumulated solve equals a single-shot WLS over the concatenated rows
within 2e-4 (``tests/test_anytime.py:110-146``) and a resumed run is bit
for bit the never-suspended one.
"""

import numpy as np
import pytest
import torch

from distributedkernelshap_tpu import KernelShap as JaxKernelShap
from distributedkernelshap_tpu.anytime import calibration as jcal
from distributedkernelshap_tpu.anytime import convergence as jconv
from distributedkernelshap_tpu.anytime import rounds as jrounds
from distributedkernelshap_tpu.kernel_shap import EngineConfig as JaxEngineConfig
from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
from distributedkernelshap_tpu_torch.anytime import calibration as tcal
from distributedkernelshap_tpu_torch.anytime import convergence as tconv
from distributedkernelshap_tpu_torch.anytime import rounds as trounds
from distributedkernelshap_tpu_torch.anytime.engine import STATE_KEYS, AnytimeRun
from distributedkernelshap_tpu_torch.convert import linear_predictor_from_numpy
from distributedkernelshap_tpu_torch.ops import explain as texp

PHI_REL = 1e-4        # x max(1, max|phi|), identity link, port vs JAX
LOGIT_REL = 1e-3      # x max(1, max|phi|), logit link, port vs JAX
SINGLE_SHOT_ATOL = 2e-4
ADDITIVITY = 1e-4
MAX_FACTOR = max(max(tcal.DEFAULT_TABLE.values()), tcal.DEFAULT_FACTOR)

GROUPS = [[0, 1], [2], [3, 4, 5], [6], [7, 8, 9]]
NAMES = [f"g{i}" for i in range(len(GROUPS))]
NSAMPLES = 256        # ungrouped M = 10: a 20-row enumerated block in round 0


# ---------------------------------------------------------------------------
# schedules, draw blocks, calibration: byte-identical copies


SCHEDULES = [(10, 256, 0), (16, 512, 3), (5, 24, 1), (12, None, 0), (48, None, 0),
             (1, None, 0), (4, 64, 0), (16, 512, 3, 1)]


def _assert_schedules_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    for f in ("M", "seed", "weight_left", "draws"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("enum_mask", "enum_weights", "sampled_sizes", "size_probs"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.fingerprint() == b.fingerprint()


@pytest.mark.parametrize("case", SCHEDULES, ids=str)
def test_schedule_and_draw_masks_equal_reference(case):
    M, nsamples, seed = case[:3]
    rounds = case[3] if len(case) > 3 else trounds.DEFAULT_ROUNDS
    got = trounds.build_schedule(M, nsamples=nsamples, seed=seed, rounds=rounds)
    want = jrounds.build_schedule(M, nsamples=nsamples, seed=seed, rounds=rounds)
    _assert_schedules_equal(got, want)
    if got is None:
        return
    for r in range(got.n_rounds):
        a, b = trounds.round_draw_mask(got, r), jrounds.round_draw_mask(want, r)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert got.cumulative_nsamples(r) == want.cumulative_nsamples(r)
    with pytest.raises(IndexError):
        trounds.round_draw_mask(got, got.n_rounds)


def test_calibration_and_convergence_equal_reference():
    rng = np.random.default_rng(0)
    for r in range(6):
        assert tcal.calibration_factor(r) == jcal.calibration_factor(r)
        assert tcal.calibration_factor(r, {r: 1.5}) == jcal.calibration_factor(r, {r: 1.5})
    raw = rng.uniform(0.01, 0.1, size=200)
    pairs = list(zip(raw, raw * rng.uniform(0.2, 3.0, size=200)))
    assert tcal.fit_calibration(pairs, 0.9) == jcal.fit_calibration(pairs, 0.9)
    assert tcal.fit_calibration([]) == jcal.fit_calibration([])
    gap = rng.uniform(0, 1e-5, size=(3, 7)).astype(np.float32)
    for r in (0, 1, 4):
        a, b = tconv.calibrated_err(gap, r), jconv.calibrated_err(gap, r)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    prev = rng.random((3, 7)).astype(np.float32)
    cur = rng.random((3, 7)).astype(np.float32)
    assert np.array_equal(tconv.monotone_min(prev, cur), jconv.monotone_min(prev, cur))
    assert np.array_equal(tconv.monotone_min(None, cur), jconv.monotone_min(None, cur))


# ---------------------------------------------------------------------------
# the round engine against the JAX package


def _data(seed=0, D=10, N=12, B=4):
    rng = np.random.default_rng(seed)
    W = rng.normal(scale=0.5, size=(D, 2)).astype(np.float32)
    b = rng.normal(size=2).astype(np.float32)
    bg = rng.normal(size=(N, D)).astype(np.float32)
    X = rng.normal(size=(B, D)).astype(np.float32)
    return W, b, bg, X


def _numpy_mlp(seed=1, D=10, H=8):
    rng = np.random.default_rng(seed)
    W1 = rng.normal(scale=0.5, size=(D, H))
    W2 = rng.normal(scale=0.5, size=(H, 2))

    def f(x):
        z = np.tanh(np.asarray(x, np.float64) @ W1) @ W2
        e = np.exp(z - z.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    return f


@pytest.fixture(scope="module")
def gbr():
    from sklearn.ensemble import GradientBoostingRegressor

    rng = np.random.default_rng(5)
    X = rng.normal(size=(200, 10))
    y = X[:, 0] + np.where(X[:, 1] > 0, 1.0, -0.5) * X[:, 2]
    return GradientBoostingRegressor(n_estimators=4, max_depth=3, random_state=0).fit(X, y)


# (model kind, link, expected ey route); ungrouped M = 10 at NSAMPLES
ENGINE_CASES = {
    "linear_logit": ("linear", "logit", "plain"),
    "linear_identity": ("linear", "identity", "plain"),
    "tree_masked_ey": ("tree", "identity", "masked_ey"),
    "blackbox_generic": ("blackbox", "logit", "generic"),
}


def _model(kind, W, b, gbr_model):
    if kind == "linear":
        from distributedkernelshap_tpu.models.predictors import LinearPredictor as JaxLinear

        return (linear_predictor_from_numpy(W, b, "softmax", device="cpu"),
                JaxLinear(W, b, "softmax"))
    if kind == "tree":
        return gbr_model.predict, gbr_model.predict
    f = _numpy_mlp()
    return f, f


def _both(case, gbr_model):
    kind, link, _ = ENGINE_CASES[case]
    W, b, bg, X = _data()
    port_model, jax_model = _model(kind, W, b, gbr_model)
    port = KernelShap(port_model, link=link, seed=3, device="cpu").fit(bg)
    ref = JaxKernelShap(jax_model, link=link, seed=3,
                        engine_config=JaxEngineConfig(host_eval=False)).fit(bg)
    return port, ref, X


def _tol(link, phi):
    return (LOGIT_REL if link == "logit" else PHI_REL) * max(1.0, float(np.abs(phi).max()))


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_rounds_match_jax(case, gbr):
    port, ref, X = _both(case, gbr)
    _, link, route = ENGINE_CASES[case]
    run = port._explainer.anytime_begin(X, nsamples=NSAMPLES)
    jrun = ref._explainer.anytime_begin(X, nsamples=NSAMPLES)
    assert run is not None and jrun is not None
    assert run.schedule.fingerprint() == jrun.schedule.fingerprint()
    while not jrun.done:
        got, want = run.step(), jrun.step()
        tol = _tol(link, want.phi)
        assert got.round_index == want.round_index
        assert got.phi.shape == want.phi.shape
        np.testing.assert_allclose(got.phi, np.asarray(want.phi), rtol=0, atol=tol)
        np.testing.assert_allclose(got.raw_gap, np.asarray(want.raw_gap), rtol=0, atol=tol)
        np.testing.assert_allclose(got.est_err, np.asarray(want.est_err), rtol=0,
                                   atol=MAX_FACTOR * tol)
        np.testing.assert_allclose(got.raw_prediction, np.asarray(want.raw_prediction),
                                   rtol=0, atol=tol)
        np.testing.assert_allclose(got.expected_value, np.asarray(want.expected_value),
                                   rtol=0, atol=tol)
        assert got.cumulative_nsamples == want.cumulative_nsamples
        assert got.done == want.done
    assert run.done
    assert port.kernel_path["ey"] == route


def test_rounds_without_enumerated_block_match_jax():
    """A budget too small for round 0 to enumerate a size pair (grouped
    M = 5, nsamples = 24): phi per round against the JAX engine.  The
    split-half gap is not compared here: each stratum of round 0 holds two
    complement pairs, which give one row each up to sign, for four unknowns,
    so its solve is set by the 1e-6 ridge and by rounding in both packages
    (and round 1's, with four pairs, is barely determined)."""

    W, b, bg, X = _data()
    from distributedkernelshap_tpu.models.predictors import LinearPredictor as JaxLinear

    fit = {"group_names": NAMES, "groups": GROUPS}
    port = KernelShap(linear_predictor_from_numpy(W, b, "softmax", device="cpu"),
                      seed=3, device="cpu").fit(bg, **fit)
    ref = JaxKernelShap(JaxLinear(W, b, "softmax"), seed=3).fit(bg, **fit)
    run = port._explainer.anytime_begin(X, nsamples=24)
    jrun = ref._explainer.anytime_begin(X, nsamples=24)
    assert run.schedule.n_enumerated == 0
    while not jrun.done:
        got, want = run.step(), jrun.step()
        np.testing.assert_allclose(got.phi, np.asarray(want.phi), rtol=0,
                                   atol=_tol("identity", want.phi))
        assert np.all(np.isfinite(got.raw_gap)) and np.all(got.raw_gap >= 0)
        assert got.cumulative_nsamples == want.cumulative_nsamples
        assert got.done == want.done
    assert run.done


# ---------------------------------------------------------------------------
# within the port: the estimator, monotone error, resume


@pytest.fixture(scope="module")
def linear_engines():
    W, b, bg, _ = _data(seed=2, D=16, N=24)

    def make():
        pred = linear_predictor_from_numpy(W, b, "softmax", device="cpu")
        return KernelShap(pred, link="logit", seed=3, device="cpu").fit(bg)._explainer

    return make(), make()


def test_accumulated_solve_matches_single_shot(linear_engines):
    """The accumulated round solve is the single-shot WLS over the
    concatenated enumerated and draw rows with count weights."""

    engine = linear_engines[0]
    X = np.random.default_rng(7).normal(size=(3, 16)).astype(np.float32)
    run = engine.anytime_begin(X, nsamples=512)
    results = []
    while not run.done:
        results.append(run.step())
    final = results[-1]
    assert final.done
    s = run.schedule
    draw_rows = np.concatenate([trounds.round_draw_mask(s, r) for r in range(s.n_rounds)], 0)
    mask = np.concatenate([s.enum_mask, draw_rows], 0).astype(np.float32)
    weights = np.concatenate([s.enum_weights,
                              np.full(draw_rows.shape[0], s.weight_left / draw_rows.shape[0],
                                      dtype=np.float32)]).astype(np.float32)
    from dataclasses import replace

    fn = texp.build_explainer_fn(engine.predictor,
                                 replace(engine.config.shap, link=engine.config.link))
    t = torch.as_tensor
    ref = fn(t(X), t(engine.background), t(engine.bg_weights), t(mask), t(weights),
             t(engine.G))
    np.testing.assert_allclose(final.phi, ref["shap_values"].numpy(), rtol=0,
                               atol=SINGLE_SHOT_ATOL)
    np.testing.assert_allclose(final.expected_value, ref["expected_value"].numpy(), atol=1e-5)
    np.testing.assert_allclose(final.raw_prediction, ref["raw_prediction"].numpy(), atol=1e-5)
    assert engine.kernel_path["ey"] == "plain"


def test_reported_error_monotone_and_additive(linear_engines):
    engine = linear_engines[0]
    X = np.random.default_rng(11).normal(size=(2, 16)).astype(np.float32)
    run = engine.anytime_begin(X, nsamples=512)
    prev = None
    while not run.done:
        res = run.step()
        assert res.est_err.shape == (2, 16)
        if prev is not None:
            assert np.all(res.est_err <= prev)
        prev = res.est_err
        np.testing.assert_allclose(res.phi.sum(-1),
                                   res.raw_prediction - res.expected_value[None, :],
                                   atol=ADDITIVITY)
    assert run.last_round_s > 0
    with pytest.raises(RuntimeError, match="exhausted"):
        run.step()


def test_resume_bit_identical_and_state_untouched(linear_engines):
    """A run exported after round 1 and restored into a FRESH engine gives
    rounds 2-3 bit for bit; no round writes into the plan-constant cache
    entry or into an exported snapshot."""

    engine, fresh = linear_engines
    X = np.random.default_rng(13).normal(size=(2, 16)).astype(np.float32)
    straight = engine.anytime_begin(X, nsamples=512)
    straight_results = []
    while not straight.done:
        straight_results.append(straight.step())

    part = engine.anytime_begin(X, nsamples=512)
    part.step()
    part.step()
    snap = part.export_state()
    assert set(snap["state"]) == set(STATE_KEYS)
    frozen = {k: v.copy() for k, v in snap["state"].items()}
    consts = engine._anytime_consts(part.schedule)
    consts_before = {k: v.clone() for k, v in consts.items()}
    part.step()                                   # the original run goes on
    resumed = AnytimeRun.restore(fresh, fresh._anytime_schedule(512), snap)
    resumed_results = []
    while not resumed.done:
        resumed_results.append(resumed.step())
    assert [r.round_index for r in resumed_results] == [2, 3]
    for a, b in zip(straight_results[2:], resumed_results):
        assert a.cumulative_nsamples == b.cumulative_nsamples
        assert np.array_equal(a.phi, b.phi), "resumed phi must be bit-identical"
        assert np.array_equal(a.raw_gap, b.raw_gap)
        assert np.array_equal(a.est_err, b.est_err)
    for k, v in frozen.items():
        assert np.array_equal(snap["state"][k], v), k
    for k, v in consts_before.items():
        assert torch.equal(consts[k], v), k


def test_consts_cached_by_content_and_schedule(linear_engines):
    engine = linear_engines[0]
    schedule = engine._anytime_schedule(512)
    a = engine._anytime_consts(schedule)
    assert engine._anytime_consts(schedule) is a
    key = (engine.content_fingerprint(), "anytime", schedule.fingerprint())
    assert key in engine._plan_consts_cache
    assert len(engine._plan_consts_cache) <= engine._DEV_CACHE_MAX_ENTRIES


def test_begin_ineligible_budgets(linear_engines):
    engine = linear_engines[0]
    x = np.zeros((1, 16), np.float32)
    assert engine.anytime_begin(x, nsamples="exact") is None
    assert engine.anytime_begin(x, nsamples=2 ** 16) is None   # exact enumeration
    assert not engine.anytime_supported("exact")
    assert engine.anytime_supported(512)
    assert engine.anytime_begin(x, nsamples="auto") is not None
    W, b, bg, _ = _data(seed=2, D=16, N=24)
    pred = linear_predictor_from_numpy(W, b, "softmax", device="cpu")
    host = KernelShap(_numpy_mlp(D=16), link="logit", seed=3, device="cpu",
                      engine_config=EngineConfig(host_eval=True)).fit(bg)._explainer
    assert host.anytime_begin(x, nsamples=512) is None
    assert not host.anytime_supported(512)
    chunked = KernelShap(pred, seed=3, device="cpu",
                         engine_config=EngineConfig(instance_chunk=2)).fit(bg)._explainer
    assert chunked.anytime_begin(np.zeros((3, 16), np.float32), nsamples=512) is None
    assert chunked.anytime_begin(np.zeros((2, 16), np.float32), nsamples=512) is not None
