"""The PyTorch port's staging and async explains (``stage_rows``,
``get_explanation_async``, ``_async_sync_fallback``) against the port's own
synchronous explain and the JAX package's contract, on the CPU.

The async routes run the same functions on the same padded rows as the
synchronous explain, so their results are compared bit for bit, with
``finalize`` run on another thread as the serving pipeline runs it.  On the
CPU a :class:`StagedRows` holds a plain tensor; the card's side stream,
event and pinned buffer are held by ``chip_smoke.py`` (phase 18).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distributedkernelshap_tpu import kernel_shap as jks
from distributedkernelshap_tpu.kernel_shap import EngineConfig as JaxEngineConfig
from distributedkernelshap_tpu.kernel_shap import KernelExplainerEngine as JaxEngine
from distributedkernelshap_tpu.models.predictors import LinearPredictor as JaxLinear
from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
from distributedkernelshap_tpu_torch import kernel_shap as tks
from distributedkernelshap_tpu_torch.convert import linear_predictor_from_numpy
from distributedkernelshap_tpu_torch.kernel_shap import KernelExplainerEngine, StagedRows
from distributedkernelshap_tpu_torch.profiling import profiler

GROUPS = [[0, 1], [2], [3, 4, 5], [6], [7, 8, 9]]
NAMES = [f"g{i}" for i in range(len(GROUPS))]


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    W = rng.normal(scale=0.5, size=(10, 2)).astype(np.float32)
    b = rng.normal(size=2).astype(np.float32)
    bg = rng.normal(size=(12, 10)).astype(np.float32)
    X = rng.normal(size=(13, 10)).astype(np.float32)
    return W, b, bg, X


def _engine(W, b, bg, **cfg):
    pred = linear_predictor_from_numpy(W, b, "softmax", device="cpu")
    return KernelShap(pred, link="logit", seed=3, device="cpu",
                      engine_config=EngineConfig(**cfg)).fit(
        bg, group_names=NAMES, groups=GROUPS)._explainer


@pytest.fixture(scope="module")
def gbt():
    from sklearn.ensemble import GradientBoostingRegressor

    rng = np.random.default_rng(3)
    Xtr = rng.normal(size=(200, 10))
    y = Xtr[:, 0] * np.where(Xtr[:, 1] > 0, 1.0, -1.0) + Xtr[:, 2]
    return GradientBoostingRegressor(n_estimators=5, max_depth=3, random_state=0).fit(Xtr, y)


def _in_thread(fn):
    with ThreadPoolExecutor(max_workers=1) as pool:
        return pool.submit(fn).result()


def _assert_values_equal(got, want):
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)


# ---------------------------------------------------------------------------
# gating


def test_stage_rows_gating(problem, gbt):
    W, b, bg, X = problem
    eng = _engine(W, b, bg)
    staged = eng.stage_rows(X[:5], l1_reg=False)
    assert isinstance(staged, StagedRows)
    assert staged.B == 5 and staged.shape == (5, 10)
    assert isinstance(staged.device, torch.Tensor) and staged.device.shape == (8, 10)
    assert staged.ready is None and staged.pinned is None          # CPU: a plain tensor
    assert np.array_equal(staged.device[:5].numpy(), X[:5])
    # active l1 (an explicit selection, and 'auto' below 20% of the space)
    assert eng.stage_rows(X[:5], l1_reg="num_features(2)") is None
    assert eng.stage_rows(X[:2]) is not None                       # M = 5: 'auto' inactive
    rng = np.random.default_rng(1)
    wide = KernelExplainerEngine(
        linear_predictor_from_numpy(rng.normal(size=(16, 2)).astype(np.float32),
                                    np.zeros(2, np.float32), "softmax", device="cpu"),
        rng.normal(size=(8, 16)).astype(np.float32), link="logit", seed=0,
        config=EngineConfig(device="cpu"))
    assert wide.stage_rows(rng.normal(size=(2, 16))) is None      # M = 16: 'auto' active
    assert wide.stage_rows(rng.normal(size=(2, 16)), l1_reg=False) is not None
    # over-chunk batches
    assert _engine(W, b, bg, instance_chunk=4).stage_rows(X, l1_reg=False) is None
    assert _engine(W, b, bg, instance_chunk=4).stage_rows(X[:4], l1_reg=False) is not None
    # host eval
    host = KernelExplainerEngine(lambda x: x[:, :2] ** 2, bg, seed=0,
                                 config=EngineConfig(device="cpu", host_eval=True))
    assert host.stage_rows(X[:3], l1_reg=False) is None
    # exact: tree ensembles with the identity link stage, interactions do not
    tree = KernelShap(gbt.predict, seed=0, device="cpu").fit(bg)._explainer
    assert isinstance(tree.stage_rows(X[:3], nsamples="exact"), StagedRows)
    assert tree.stage_rows(X[:3], nsamples="exact", interactions=True) is None
    tree_logit = KernelShap(gbt.predict, link="logit", seed=0, device="cpu").fit(bg)._explainer
    assert tree_logit.stage_rows(X[:3], nsamples="exact") is None
    assert eng.stage_rows(X[:3], nsamples="exact") is None        # not a tree


def test_exact_async_ready_matches_jax(problem, gbt):
    W, b, bg, _ = problem
    port = {"tree": KernelShap(gbt.predict, seed=0, device="cpu").fit(bg)._explainer,
            "tree_logit": KernelShap(gbt.predict, link="logit", seed=0,
                                     device="cpu").fit(bg)._explainer,
            "linear": _engine(W, b, bg)}
    ref = {"tree": JaxEngine(gbt.predict, bg, seed=0),
           "tree_logit": JaxEngine(gbt.predict, bg, link="logit", seed=0),
           "linear": JaxEngine(JaxLinear(W, b, "softmax"), bg, link="logit", seed=0)}
    for name in port:
        for inter in (False, True):
            assert port[name]._exact_async_ready(inter) == \
                ref[name]._exact_async_ready(inter), (name, inter)


# ---------------------------------------------------------------------------
# async == sync, bit for bit


@pytest.mark.parametrize("staged", [False, True])
def test_sampled_async_equals_sync(problem, staged):
    W, b, bg, X = problem
    eng = _engine(W, b, bg)
    for rows in (X[:1], X[:5], X):
        want = eng.get_explanation(rows, l1_reg=False, silent=True)
        fx_want = eng.last_raw_prediction
        arg = eng.stage_rows(rows, l1_reg=False) if staged else rows
        fin = eng.get_explanation_async(arg, l1_reg=False)
        values, info = _in_thread(fin)
        _assert_values_equal(values, want)
        assert np.array_equal(info["raw_prediction"], fx_want)
        assert info["expected_value"].shape == (2,)
    assert eng.kernel_path["ey"] == "einsum_cached"


def test_sampled_async_batches_in_flight(problem):
    """Several batches dispatched ahead of their finalizes (the serving
    pipeline's shape), finalized on a pool, each equal to its sync result."""

    W, b, bg, X = problem
    eng = _engine(W, b, bg, plan_constant_cache="off")
    batches = [X[i:i + 3] for i in range(0, 12, 3)]
    staged = [eng.stage_rows(batches[0], l1_reg=False)]
    fins = []
    for i in range(len(batches)):
        if i + 1 < len(batches):
            staged.append(eng.stage_rows(batches[i + 1], l1_reg=False))
        fins.append(eng.get_explanation_async(staged[i], l1_reg=False))
    with ThreadPoolExecutor(max_workers=3) as pool:
        results = list(pool.map(lambda f: f(), fins))
    for rows, (values, _) in zip(batches, results):
        _assert_values_equal(values, eng.get_explanation(rows, l1_reg=False, silent=True))
    assert eng.kernel_path["ey"] == "plain"


@pytest.mark.parametrize("staged", [False, True])
def test_exact_async_equals_sync(problem, gbt, staged):
    _, _, bg, X = problem
    eng = KernelShap(gbt.predict, seed=0, device="cpu").fit(
        bg, group_names=NAMES, groups=GROUPS)._explainer
    want = eng.get_explanation(X[:6], nsamples="exact")
    fx_want = eng.last_raw_prediction
    arg = eng.stage_rows(X[:6], nsamples="exact") if staged else X[:6]
    values, info = _in_thread(eng.get_explanation_async(arg, nsamples="exact"))
    _assert_values_equal(values, want)
    assert np.array_equal(info["raw_prediction"], fx_want)
    assert info["expected_value"].shape == (1,)
    assert sorted(info) == ["expected_value", "raw_prediction"]


# ---------------------------------------------------------------------------
# the synchronous fallback


def test_async_fallback_routes_equal_sync(problem, gbt):
    """Host eval, over-chunk batches, active l1, interactions and exact
    when not async-ready compute now and return exactly the sync result."""

    W, b, bg, X = problem

    def host_model(x):
        z = x @ W + b
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    host = KernelExplainerEngine(host_model, bg, link="logit", seed=0,
                                 config=EngineConfig(device="cpu", host_eval=True,
                                                     host_eval_workers=1))
    chunked = _engine(W, b, bg, instance_chunk=4)
    plain = _engine(W, b, bg)
    tree = KernelShap(gbt.predict, seed=0, device="cpu").fit(bg)._explainer
    cases = [(host, {"nsamples": 40, "l1_reg": False}),
             (chunked, {"l1_reg": False}),
             (plain, {"l1_reg": "num_features(3)"}),
             (tree, {"nsamples": "exact", "interactions": True})]
    for eng, kw in cases:
        want = eng.get_explanation(X, silent=True, **kw)
        fx_want = eng.last_raw_prediction
        inter_want = eng.last_interaction_values
        values, info = _in_thread(eng.get_explanation_async(X, **kw))
        _assert_values_equal(values, want)
        assert np.array_equal(info["raw_prediction"], fx_want)
        if kw.get("interactions"):
            assert all(np.array_equal(a, c)
                       for a, c in zip(info["interaction_values"], inter_want))


@pytest.mark.parametrize("interactions", [False, True])
def test_async_sync_fallback_info_keys_equal_reference(problem, interactions):
    W, b, bg, X = problem
    port = _engine(W, b, bg)
    ref = JaxEngine(JaxLinear(W, b, "softmax"), bg, link="logit", seed=3,
                    config=JaxEngineConfig())

    class _Recorder:
        """Stands in for an engine: records the call, returns fixed state."""

        def __init__(self, engine):
            self.engine = engine
            self.last_raw_prediction = np.zeros((2, 2), np.float32)
            self.expected_value = np.zeros(2, np.float32)
            self.last_interaction_values = [np.zeros((2, 5, 5), np.float32)]

        def get_explanation(self, X, **kw):
            self.kw = kw
            return [np.zeros((2, 5), np.float32)]

    rp, rj = _Recorder(port), _Recorder(ref)
    _, info_p = tks._async_sync_fallback(rp, X[:2], 64, False, interactions)()
    _, info_j = jks._async_sync_fallback(rj, X[:2], 64, False, interactions)()
    assert sorted(info_p) == sorted(info_j)
    assert rp.kw == rj.kw
    for k in info_p:
        a, c = info_p[k], info_j[k]
        if isinstance(a, list):
            assert all(np.array_equal(x, y) for x, y in zip(a, c))
        else:
            assert a.dtype == c.dtype and np.array_equal(a, c)


def test_async_phases_land_on_the_finalizing_thread(problem):
    W, b, bg, X = problem
    eng = _engine(W, b, bg)
    prof = profiler()
    prof.enable()
    prof.reset()
    try:
        fin = eng.get_explanation_async(X[:3], l1_reg=False)
        assert "device_explain" not in prof.summary()
        _in_thread(fin)
        s = prof.summary()
        assert s["coalition_plan"]["count"] == 1 and s["device_explain"]["count"] == 1
    finally:
        prof.disable()
        prof.reset()


def test_concurrent_staging_dispatch_and_finalize_stress(problem):
    """More threads than cores stage, one dispatches and several finalize,
    with a short switch interval: every batch comes back equal to its
    synchronous result (a lost or crossed update would break that)."""

    import sys

    W, b, bg, X = problem
    eng = _engine(W, b, bg)
    rng = np.random.default_rng(9)
    batches = [rng.normal(size=(int(rng.integers(1, 6)), 10)).astype(np.float32)
               for _ in range(24)]
    want = [eng.get_explanation(x, l1_reg=False, silent=True) for x in batches]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=8) as stagers, \
                ThreadPoolExecutor(max_workers=8) as finalizers:
            staged = [stagers.submit(eng.stage_rows, x, l1_reg=False) for x in batches]
            fins = [eng.get_explanation_async(f.result(timeout=60), l1_reg=False)
                    for f in staged]
            results = [finalizers.submit(fin) for fin in fins]
            got = [r.result(timeout=60) for r in results]
    finally:
        sys.setswitchinterval(old)
    for (values, _), w in zip(got, want):
        _assert_values_equal(values, w)
