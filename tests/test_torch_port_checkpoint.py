"""The PyTorch port's profiler (``distributedkernelshap_tpu_torch/profiling.py``)
and explainer checkpoints (``KernelShap.save`` / ``load``), on the CPU: the
port's twins of ``tests/test_profiling_checkpoint.py``, plus the engine's
phases against the JAX package's at the same call sites.

A checkpoint pickles the fitted state and rebuilds the engine on load, so
the loaded explainer runs the same functions on the same inputs: its
results are compared bit for bit with the writer's.
"""

import os

import numpy as np
import pytest
import torch

from distributedkernelshap_tpu import KernelShap as JaxKernelShap
from distributedkernelshap_tpu.models import LinearPredictor as JaxLinear
from distributedkernelshap_tpu.profiling import profiler as jax_profiler
from distributedkernelshap_tpu_torch import KernelShap, LinearPredictor
from distributedkernelshap_tpu_torch import profiling as tprof
from distributedkernelshap_tpu_torch.kernel_shap import EngineConfig
from distributedkernelshap_tpu_torch.profiling import Profiler, profiler

D = 7
GROUPS = [[0], [1, 2], [3, 4], [5, 6]]
NAMES = ["a", "b", "c", "d"]


def _weights():
    rng = np.random.default_rng(0)
    W = rng.normal(size=(D, 2)).astype(np.float32)
    bg = rng.normal(size=(10, D)).astype(np.float32)
    X = rng.normal(size=(4, D)).astype(np.float32)
    return W, bg, X


@pytest.fixture()
def fitted(tmp_path):
    W, bg, X = _weights()
    pred = LinearPredictor(W, np.zeros(2, np.float32), activation="softmax", device="cpu")
    ex = KernelShap(pred, link="logit", feature_names=NAMES, seed=0, device="cpu")
    ex.fit(bg, group_names=NAMES, groups=GROUPS, data_provenance="synthetic")
    return ex, X, tmp_path


# ---------------------------------------------------------------------------
# the profiler


def test_profiler_phases():
    p = Profiler(enabled=True)
    with p.phase("solve"):
        pass
    with p.phase("solve"):
        pass
    with p.phase("eval", sync=True):
        pass
    with p.phase("eval_cpu", sync=True, device="cpu"):
        pass
    s = p.summary()
    assert s["solve"]["count"] == 2 and "mean_s" in s["solve"]
    assert "eval" in s and "eval_cpu" in s
    assert set(s["solve"]) == {"count", "total_s", "mean_s", "last_s", "p50_s", "p99_s"}
    assert "solve" in p.report()
    p.reset()
    assert p.summary() == {}


def test_profiler_disabled_is_noop():
    p = Profiler(enabled=False)
    with p.phase("x", sync=True):
        pass
    assert p.summary() == {}


def test_profiler_window_bounds_samples():
    p = Profiler(enabled=True, window=4)
    for _ in range(10):
        with p.phase("x"):
            pass
    s = p.summary()["x"]
    assert s["count"] == 10 and len(p._phases["x"].window) == 4


def test_phase_sync_propagates_device_errors(monkeypatch):
    """Unlike the reference's ``jax.effects_barrier()`` guard, a device
    error at the phase's sync is not swallowed."""

    def failing(device=None):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch.cuda, "synchronize", failing)
    p = Profiler(enabled=True)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        with p.phase("device_explain", sync=True, device="cuda"):
            pass
    with p.phase("host", sync=True, device="cpu"):     # the CPU waits for nothing
        pass
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        with p.phase("device_explain", sync=True):
            pass


def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    p = Profiler()
    with p.trace(str(tmp_path / "explicit")) as logdir:
        torch.ones(8).sum()
    assert logdir == str(tmp_path / "explicit")
    assert p.last_trace_path.startswith(logdir) and os.path.getsize(p.last_trace_path) > 0
    monkeypatch.setenv("DKS_DEVICE_TRACE_DIR", str(tmp_path / "env"))
    with p.trace() as logdir:
        torch.ones(8).sum()
    assert logdir == str(tmp_path / "env") and os.listdir(logdir)


def _phases(prof_fn, run):
    prof = prof_fn()
    prof.enable()
    prof.reset()
    try:
        run()
        return sorted(prof.summary())
    finally:
        prof.disable()
        prof.reset()


def test_default_profiler_collects_engine_phases(fitted):
    ex, X, _ = fitted
    names = _phases(profiler, lambda: ex.explain(X, nsamples=32, silent=True))
    assert {"explain", "device_explain", "coalition_plan"} <= set(names)


def test_engine_phases_match_jax(fitted):
    """The same calls record the same phase names in both packages: the
    explain (with its plan-constant precompute), ``rank_features``, a
    chunked explain, host eval and an anytime run."""

    W, bg, X = _weights()
    b = np.zeros(2, np.float32)

    def host_model(x):
        z = x @ W
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def calls(pkg):
        if pkg == "port":
            lin = KernelShap(LinearPredictor(W, b, "softmax", device="cpu"), link="logit",
                             seed=0, device="cpu")
            host = KernelShap(host_model, link="logit", seed=0, device="cpu",
                              engine_config=EngineConfig(host_eval=True, host_eval_workers=1))
        else:
            from distributedkernelshap_tpu.kernel_shap import EngineConfig as JaxEngineConfig

            lin = JaxKernelShap(JaxLinear(W, b, "softmax"), link="logit", seed=0)
            host = JaxKernelShap(host_model, link="logit", seed=0,
                                 engine_config=JaxEngineConfig(host_eval=True,
                                                               host_eval_workers=1))
        lin.fit(bg, group_names=NAMES, groups=GROUPS)
        host.fit(bg, group_names=NAMES, groups=GROUPS)
        return [lambda: lin.explain(X, nsamples=32, silent=True),
                lambda: lin.rank_features(X, nsamples=32),
                lambda: host.explain(X, nsamples=32, silent=True),
                lambda: lin._explainer.anytime_begin(X[:2], nsamples=12).step()]

    for port_call, jax_call in zip(calls("port"), calls("jax")):
        assert _phases(profiler, port_call) == _phases(jax_profiler, jax_call)


# ---------------------------------------------------------------------------
# save / load


def _phi(expl):
    return np.stack([np.asarray(v) for v in expl.shap_values], 1)


def test_save_load_roundtrip(fitted):
    ex, X, tmp_path = fitted
    before = ex.explain(X, nsamples=32, silent=True)
    path = str(tmp_path / "ckpt" / "explainer.pkl")
    ex.save(path)

    loaded = KernelShap.load(path)
    after = loaded.explain(X, nsamples=32, silent=True)
    assert np.array_equal(_phi(before), _phi(after))
    assert np.array_equal(np.asarray(before.expected_value), np.asarray(loaded.expected_value))
    assert loaded.feature_names == ex.feature_names
    assert loaded.device == torch.device("cpu")
    assert loaded._explainer is not ex._explainer
    # provenance survives the round trip (meta is saved whole)
    assert loaded.meta["data_provenance"] == "synthetic"
    assert after.meta["data_provenance"] == "synthetic"


def test_save_load_preserves_engine_config(fitted, tmp_path):
    ex, X, _ = fitted
    cfg = EngineConfig(host_eval=True, host_eval_workers=3, instance_chunk=2,
                       dispatch_window=2, device="cpu")
    ex2 = KernelShap(ex.predictor, link=ex.link, seed=0, engine_config=cfg)
    ex2.fit(np.asarray(ex.background_data.data))
    path = str(tmp_path / "cfg" / "explainer.pkl")
    ex2.save(path)

    loaded = KernelShap.load(path)
    assert loaded.engine_config == ex2.engine_config
    assert loaded._explainer.config.host_eval is True
    assert loaded._explainer.config.host_eval_workers == 3
    assert loaded._explainer.config.instance_chunk == 2
    assert np.array_equal(_phi(loaded.explain(X, nsamples=32, silent=True)),
                          _phi(ex2.explain(X, nsamples=32, silent=True)))


def test_load_device_argument_beats_the_saved_one(fitted, monkeypatch):
    """``load(path, device=...)`` resolves the device as the constructors
    do: the explicit argument first, then the saved ``engine_config.device``."""

    ex, X, tmp_path = fitted
    path = str(tmp_path / "dev" / "explainer.pkl")
    ex.save(path)
    seen = []
    real = KernelShap.__init__

    def spy(self, *a, **kw):
        seen.append((kw.get("device"), kw.get("engine_config").device))
        real(self, *a, **kw)

    monkeypatch.setattr(KernelShap, "__init__", spy)
    KernelShap.load(path, device="cpu")
    KernelShap.load(path)
    assert seen == [("cpu", torch.device("cpu")), (None, torch.device("cpu"))]


def test_save_unfitted_raises(tmp_path):
    ex = KernelShap(LinearPredictor(np.zeros((3, 2), np.float32), np.zeros(2, np.float32),
                                    device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="unfitted"):
        ex.save(str(tmp_path / "nope.pkl"))


def test_save_load_exact_interactions(tmp_path):
    """A restored explainer runs the exact path with interactions; its
    matrices and shap values equal the writer's, bit for bit."""

    from sklearn.ensemble import GradientBoostingRegressor

    rng = np.random.default_rng(11)
    X = rng.normal(size=(150, 4))
    y = X[:, 0] * np.where(X[:, 1] > 0, 1.0, -1.0)
    gbt = GradientBoostingRegressor(n_estimators=5, max_depth=3,
                                    random_state=0).fit(X, y)
    ex = KernelShap(gbt.predict, seed=0, device="cpu")
    ex.fit(X[:12].astype(np.float32))
    Xq = X[:6].astype(np.float32)
    before = ex.explain(Xq, silent=True, nsamples="exact", interactions=True)

    path = str(tmp_path / "exact" / "explainer.pkl")
    ex.save(path)
    loaded = KernelShap.load(path)
    after = loaded.explain(Xq, silent=True, nsamples="exact", interactions=True)
    assert np.array_equal(before.data["raw"]["interaction_values"][0],
                          after.data["raw"]["interaction_values"][0])
    assert np.array_equal(_phi(before), _phi(after))
    assert loaded.kernel_path == {"exact_phi": "plain", "exact_inter": "plain"}


def test_default_trace_dir_is_the_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("DKS_DEVICE_TRACE_DIR", raising=False)
    monkeypatch.setattr(tprof.tempfile, "gettempdir", lambda: str(tmp_path))
    p = Profiler()
    with p.trace() as logdir:
        pass
    assert logdir == str(tmp_path / "dks_trace") and os.listdir(logdir)
