"""The PyTorch port's dispatch pipeline (``distributedkernelshap_tpu_torch/
parallel/pipeline.py``) and the engine's instance chunking, on the CPU.

The ``run_pipeline`` / ``resolve_window`` tests are the port's copies of
``tests/test_pipeline.py``'s (result order in both modes, the in-flight
bound, error propagation, the resolution priority, the multi-process
resolution without a live group).  The chunked
explains hold against the unchunked ones within the port (the same
function per chunk, so the sampled phi differs only by f32 sums over
other batch shapes, ``CHUNK_REL · max(1, max|φ|)``) and against the JAX
package's chunked explain (``PHI_ATOL``, as in
``tests/test_torch_port_engine.py``); the exact ones within
``EXACT_REL · max(1, max|φ|)`` (the JAX package's kernel-vs-einsum bar).
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch

from distributedkernelshap_tpu import KernelShap as JaxKernelShap
from distributedkernelshap_tpu.kernel_shap import EngineConfig as JaxEngineConfig
from distributedkernelshap_tpu.models.predictors import LinearPredictor as JaxLinear
from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
from distributedkernelshap_tpu_torch.convert import linear_predictor_from_numpy
from distributedkernelshap_tpu_torch.parallel import pipeline as pl

PHI_ATOL = 1e-4       # link-space phi of O(1), port vs JAX
CHUNK_REL = 1e-5      # x max(1, max|phi|): chunked vs unchunked in the port
EXACT_REL = 2e-5      # x max(1, max|phi|): tests/test_treeshap.py:780

GROUPS = [[0, 1], [2], [3, 4, 5], [6], [7, 8, 9]]
NAMES = [f"g{i}" for i in range(len(GROUPS))]


# --------------------------------------------------------------------- #
# run_pipeline (copies of tests/test_pipeline.py)


@pytest.mark.parametrize("threaded", [False, True])
@pytest.mark.parametrize("window", [1, 2, 3, 8])
def test_run_pipeline_preserves_order(threaded, window):
    items = list(range(17))
    out = pl.run_pipeline(items, lambda i: i * 10, lambda h: h + 1,
                          window=window, threaded=threaded)
    assert out == [i * 10 + 1 for i in items]


@pytest.mark.parametrize("threaded", [False, True])
def test_run_pipeline_bounds_in_flight(threaded):
    window = 3
    lock = threading.Lock()
    in_flight = {"now": 0, "peak": 0}

    def dispatch(i):
        with lock:
            in_flight["now"] += 1
            in_flight["peak"] = max(in_flight["peak"], in_flight["now"])
        return i

    def fetch(h):
        time.sleep(0.002)  # let dispatch race ahead if unbounded
        with lock:
            in_flight["now"] -= 1
        return h

    out = pl.run_pipeline(list(range(20)), dispatch, fetch,
                          window=window, threaded=threaded)
    assert out == list(range(20))
    assert in_flight["peak"] <= window


@pytest.mark.parametrize("threaded", [False, True])
def test_run_pipeline_propagates_fetch_error(threaded):
    def fetch(h):
        if h == 5:
            raise RuntimeError("boom")
        return h

    with pytest.raises(RuntimeError, match="boom"):
        pl.run_pipeline(list(range(10)), lambda i: i, fetch,
                        window=3, threaded=threaded)


def test_run_pipeline_empty_and_single():
    assert pl.run_pipeline([], lambda i: i, lambda h: h, window=4) == []
    assert pl.run_pipeline([7], lambda i: i, lambda h: h * 2, window=4) == [14]


def test_run_pipeline_threaded_fetches_overlap():
    lock = threading.Lock()
    concurrent = {"now": 0, "peak": 0}

    def fetch(h):
        with lock:
            concurrent["now"] += 1
            concurrent["peak"] = max(concurrent["peak"], concurrent["now"])
        time.sleep(0.02)  # hold the slot long enough for others to enter
        with lock:
            concurrent["now"] -= 1
        return h

    out = pl.run_pipeline(list(range(8)), lambda i: i, fetch,
                          window=8, threaded=True)
    assert out == list(range(8))
    assert concurrent["peak"] > 1  # serial mode would never exceed 1


def test_run_pipeline_threaded_stops_dispatch_after_failure():
    dispatched = []

    def fetch(h):
        if h == 0:
            raise RuntimeError("fatal")
        time.sleep(0.005)
        return h

    with pytest.raises(RuntimeError, match="fatal"):
        pl.run_pipeline(list(range(50)), lambda i: dispatched.append(i) or i,
                        fetch, window=2, threaded=True)
    assert len(dispatched) < 50


def test_run_pipeline_journal_is_not_ported():
    """The journal hook was ported with ``resilience/journal.py``: a
    journal argument no longer raises; journaled items are restored
    without a dispatch and fresh ones are recorded."""

    class Journal:
        def __init__(self):
            self.put_calls = []

        def get(self, i):
            return ("restored", i) if i == 0 else None

        def put(self, i, result):
            self.put_calls.append((i, result))

    journal, dispatched = Journal(), []
    out = pl.run_pipeline([1, 2], lambda i: dispatched.append(i) or i, lambda h: h,
                          window=2, journal=journal)
    assert out == [("restored", 0), 2]
    assert dispatched == [2] and journal.put_calls == [(1, 2)]


# --------------------------------------------------------------------- #
# resolve_window (copies of tests/test_pipeline.py)


def test_resolve_window_explicit_wins(monkeypatch):
    monkeypatch.setenv("DKS_DISPATCH_WINDOW", "7")
    assert pl.resolve_window(5) == 5


def test_resolve_window_env_beats_probe(monkeypatch):
    monkeypatch.setenv("DKS_DISPATCH_WINDOW", "6")
    monkeypatch.setattr(pl, "device_round_trip_s",
                        lambda **kw: pytest.fail("probe must not run"))
    assert pl.resolve_window(None) == 6


def test_resolve_window_clamps_to_items_and_cap(monkeypatch):
    monkeypatch.delenv("DKS_DISPATCH_WINDOW", raising=False)
    assert pl.resolve_window(99, n_items=4) == 4
    assert pl.resolve_window(99) == pl.MAX_WINDOW
    assert pl.resolve_window(0, n_items=1) >= 1  # requested=0 -> derived path


def test_resolve_window_latency_derived(monkeypatch):
    monkeypatch.delenv("DKS_DISPATCH_WINDOW", raising=False)
    monkeypatch.setattr(pl, "device_round_trip_s", lambda **kw: 0.070)
    assert pl.resolve_window(None) == 8   # 1 + ceil(7) = 8
    monkeypatch.setattr(pl, "device_round_trip_s", lambda **kw: 0.001)
    assert pl.resolve_window(None) == 2   # a local card or the CPU


def test_resolve_window_probe_failure_falls_back(monkeypatch):
    monkeypatch.delenv("DKS_DISPATCH_WINDOW", raising=False)

    def broken(**kw):
        raise RuntimeError("backend gone")

    monkeypatch.setattr(pl, "device_round_trip_s", broken)
    assert pl.resolve_window(None) == pl.DETERMINISTIC_WINDOW


def test_resolve_window_multiprocess_is_not_ported(monkeypatch, caplog):
    """Under several processes the window never comes from the probe: each
    process resolves the deterministic window, and rank 0's is broadcast;
    with no live group behind the count (here a spoofed one) the broadcast
    is unavailable and the local value stands, with a warning, as in the
    reference (``pipeline.py:173-180``).  The agreeing broadcast over two
    real processes is ``tests/test_torch_port_multiprocess.py``."""

    monkeypatch.delenv("DKS_DISPATCH_WINDOW", raising=False)
    monkeypatch.setattr(torch.distributed, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a, **k: 4)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a, **k: 1)
    monkeypatch.setattr(pl, "device_round_trip_s",
                        lambda **kw: pytest.fail("probe must not run"))
    with caplog.at_level(logging.WARNING, logger=pl.logger.name):
        assert pl.resolve_window(None) == pl.DETERMINISTIC_WINDOW
        assert pl.resolve_window(None, n_items=2) == 2
        assert pl.resolve_window(5) == 5
    assert any("broadcast unavailable" in r.message for r in caplog.records)
    assert pl._window_cache == {}  # nothing agreed, nothing cached
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a, **k: 1)
    assert pl.resolve_window(3) == 3


def test_resolve_window_non_positive_request_warns_and_degrades(monkeypatch, caplog):
    monkeypatch.setenv("DKS_DISPATCH_WINDOW", "4")
    with caplog.at_level(logging.WARNING, logger=pl.logger.name):
        assert pl.resolve_window(0) == 4
    assert any("non-positive" in r.message for r in caplog.records)


def test_resolve_window_logs_clamp_of_explicit_request(monkeypatch, caplog):
    monkeypatch.delenv("DKS_DISPATCH_WINDOW", raising=False)
    with caplog.at_level(logging.INFO, logger=pl.logger.name):
        assert pl.resolve_window(99) == pl.MAX_WINDOW
    assert any("clamping" in r.message for r in caplog.records)


def test_device_round_trip_is_cached_per_device():
    first = pl.device_round_trip_s(probes=2, refresh=True, device="cpu")
    assert first >= 0.0
    assert pl.device_round_trip_s(device="cpu") == first
    assert pl.device_round_trip_s(device=torch.device("cpu")) == first


# --------------------------------------------------------------------- #
# the engine's instance chunking


def _linear_problem(seed=0, D=10, N=12, B=37):
    rng = np.random.default_rng(seed)
    W = rng.normal(scale=0.5, size=(D, 2)).astype(np.float32)
    b = rng.normal(size=2).astype(np.float32)
    bg = rng.normal(size=(N, D)).astype(np.float32)
    X = rng.normal(size=(B, D)).astype(np.float32)
    return W, b, bg, X


def _port_linear(W, b, bg, **cfg):
    pred = linear_predictor_from_numpy(W, b, "softmax", device="cpu")
    return KernelShap(pred, link="logit", seed=3, device="cpu",
                      engine_config=EngineConfig(**cfg)).fit(
        bg, group_names=NAMES, groups=GROUPS)


def _phi(expl):
    return np.stack([np.asarray(v) for v in expl.shap_values], 1)


def _chunk_tol(ref):
    return CHUNK_REL * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("window", [None, 1, 3])
def test_chunked_explain_matches_unchunked_and_jax(window, monkeypatch):
    monkeypatch.delenv("DKS_DISPATCH_WINDOW", raising=False)
    W, b, bg, X = _linear_problem()
    whole = _port_linear(W, b, bg)
    chunked = _port_linear(W, b, bg, instance_chunk=8, dispatch_window=window)
    want = whole.explain(X, silent=True, l1_reg=False)
    got = chunked.explain(X, silent=True, l1_reg=False)
    assert chunked._explainer.last_dispatch_window == (2 if window is None else window)
    np.testing.assert_allclose(_phi(got), _phi(want), rtol=0, atol=_chunk_tol(_phi(want)))
    np.testing.assert_allclose(got.data["raw"]["raw_prediction"],
                               want.data["raw"]["raw_prediction"], rtol=0,
                               atol=_chunk_tol(want.data["raw"]["raw_prediction"]))
    ref = JaxKernelShap(JaxLinear(W, b, "softmax"), link="logit", seed=3,
                        engine_config=JaxEngineConfig(instance_chunk=8)).fit(
        bg, group_names=NAMES, groups=GROUPS)
    jexpl = ref.explain(X, silent=True, l1_reg=False)
    np.testing.assert_allclose(_phi(got), _phi(jexpl), rtol=0, atol=PHI_ATOL)


def test_chunked_l1_and_hosteval_match_unchunked():
    """Active l1 selects over the whole batch after the chunked first pass;
    host eval loops over the chunks."""

    W, b, bg, X = _linear_problem(B=19)
    want = _port_linear(W, b, bg).explain(X, silent=True, l1_reg="num_features(3)")
    got = _port_linear(W, b, bg, instance_chunk=8).explain(
        X, silent=True, l1_reg="num_features(3)")
    np.testing.assert_allclose(_phi(got), _phi(want), rtol=0, atol=_chunk_tol(_phi(want)))

    def host_model(x):
        z = x @ W + b
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def host(**cfg):
        return KernelShap(host_model, link="logit", seed=3, device="cpu",
                          engine_config=EngineConfig(host_eval=True, host_eval_workers=1,
                                                     **cfg)).fit(bg)

    want = host().explain(X, silent=True, l1_reg=False, nsamples=64)
    got_ex = host(instance_chunk=8)
    got = got_ex.explain(X, silent=True, l1_reg=False, nsamples=64)
    assert got_ex.kernel_path["ey"] == "host"
    np.testing.assert_allclose(_phi(got), _phi(want), rtol=0, atol=_chunk_tol(_phi(want)))


def test_importance_honours_instance_chunk():
    W, b, bg, X = _linear_problem(B=37)
    whole = _port_linear(W, b, bg)
    chunked = _port_linear(W, b, bg, instance_chunk=8)
    calls = []
    fn = chunked._explainer._fn()
    chunked._explainer._fn_cache[False] = lambda Xt, *a: calls.append(Xt.shape[0]) or fn(Xt, *a)
    imp = chunked._explainer.get_importance(X)
    assert calls == [8, 8, 8, 8, 8]             # four full chunks, one of 5 rows padded
    want = whole._explainer.get_importance(X)
    np.testing.assert_allclose(imp, want, rtol=0, atol=_chunk_tol(want))
    phi = _phi(whole.explain(X, silent=True, l1_reg=False))
    np.testing.assert_allclose(imp, np.abs(phi).mean(0), rtol=0, atol=_chunk_tol(want))
    ref = JaxKernelShap(JaxLinear(W, b, "softmax"), link="logit", seed=3,
                        engine_config=JaxEngineConfig(instance_chunk=8)).fit(
        bg, group_names=NAMES, groups=GROUPS)
    np.testing.assert_allclose(imp, np.asarray(ref._explainer.get_importance(X)), rtol=0,
                               atol=PHI_ATOL)


# --------------------------------------------------------------------- #
# chunked exact TreeSHAP and interactions


@pytest.fixture(scope="module")
def gbt():
    from sklearn.ensemble import GradientBoostingRegressor

    rng = np.random.default_rng(3)
    Xtr = rng.normal(size=(200, 10))
    y = Xtr[:, 0] * np.where(Xtr[:, 1] > 0, 1.0, -1.0) + Xtr[:, 2]
    return GradientBoostingRegressor(n_estimators=5, max_depth=3, random_state=0).fit(Xtr, y)


@pytest.mark.parametrize("interactions", [False, True])
def test_chunked_exact_matches_unchunked_and_jax(gbt, interactions):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(21, 10)).astype(np.float32)
    bg = rng.normal(size=(12, 10)).astype(np.float32)

    def port(**cfg):
        return KernelShap(gbt.predict, seed=0, device="cpu",
                          engine_config=EngineConfig(**cfg)).fit(
            bg, group_names=NAMES, groups=GROUPS)

    kw = {"nsamples": "exact", "interactions": interactions, "silent": True}
    want = port().explain(X, **kw)
    chunked = port(instance_chunk=6)
    got = chunked.explain(X, **kw)
    assert chunked._explainer.last_dispatch_window is not None
    tol = EXACT_REL * max(1.0, float(np.abs(_phi(want)).max()))
    np.testing.assert_allclose(_phi(got), _phi(want), rtol=0, atol=tol)
    ref = JaxKernelShap(gbt.predict, seed=0,
                        engine_config=JaxEngineConfig(instance_chunk=6)).fit(
        bg, group_names=NAMES, groups=GROUPS)
    jexpl = ref.explain(X, **kw)
    np.testing.assert_allclose(_phi(got), _phi(jexpl), rtol=0, atol=tol)
    if interactions:
        g = got.data["raw"]["interaction_values"][0]
        w = want.data["raw"]["interaction_values"][0]
        j = np.asarray(jexpl.data["raw"]["interaction_values"][0])
        assert g.shape == (21, 5, 5)
        itol = EXACT_REL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=itol)
        np.testing.assert_allclose(g, j, rtol=0, atol=itol)
        np.testing.assert_allclose(g.sum(-1), _phi(got)[:, 0], atol=1e-5)
