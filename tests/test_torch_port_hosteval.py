"""The PyTorch port's black-box paths against the JAX package, on the CPU:
the native OpenMP helpers (``runtime/native.py``, ``masked_eval.cc``), the
host-eval engine path (``EngineConfig.host_eval``, ``_hosteval_stats`` with
its thread fan-out, the host-eval branches of l1, importance and predict)
and ``CallbackPredictor`` on the device path.

Inputs are made from a seed with numpy.  Tolerances: the native fill is
one multiply-add per element, so it equals numpy's to 1e-7; the weighted
mean sums in another order (1e-6); link-space phi against the JAX package
or against the device path ``PHI_ATOL``, as in
``tests/test_torch_port_slice.py``; threaded and sequential host-eval write
the same values to disjoint slices, so they are bit-identical.
"""

from dataclasses import replace

import numpy as np
import pytest

from distributedkernelshap_tpu.kernel_shap import EngineConfig as JaxEngineConfig
from distributedkernelshap_tpu.kernel_shap import KernelExplainerEngine as JaxEngine
from distributedkernelshap_tpu.models import CallbackPredictor as JaxCallback
from distributedkernelshap_tpu.runtime import native as jnative
from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
from distributedkernelshap_tpu_torch.kernel_shap import KernelExplainerEngine
from distributedkernelshap_tpu_torch.models.predictors import (
    CallbackPredictor,
    LinearPredictor,
)
from distributedkernelshap_tpu_torch.runtime import native

PHI_ATOL = 1e-4       # link-space phi of O(1)
RAW_ATOL = 2e-5       # link-space E[f(x)] and f(x)


def numpy_masked(X, bg, zc):
    return (X[:, None, None, :] * zc[None, :, None, :]
            + bg[None, None, :, :] * (1 - zc[None, :, None, :])).reshape(-1, X.shape[1])


@pytest.fixture(scope="module")
def shapes():
    rng = np.random.default_rng(0)
    B, S, N, D = 3, 5, 4, 6
    X = rng.normal(size=(B, D)).astype(np.float32)
    bg = rng.normal(size=(N, D)).astype(np.float32)
    zc = (rng.random((S, D)) > 0.5).astype(np.float32)
    return X, bg, zc


def _softmax_model(D, K, seed, bias=True):
    rng = np.random.default_rng(seed)
    W = rng.normal(scale=0.5, size=(D, K)).astype(np.float32)
    b = rng.normal(size=K).astype(np.float32) if bias else np.zeros(K, np.float32)

    def host_model(x):
        z = np.asarray(x, np.float32) @ W + b
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    return W, b, host_model


# ---------------------------------------------------------------------------
# native helpers


def test_native_library_builds_into_build_native():
    assert native.get_lib() is not None
    path = native.library_path()
    assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"
    assert native.fill_route() == "native"
    # named by the source's digest: another source would not load this file
    assert path.name.startswith("libdksruntime-") and len(path.stem.split("-")[1]) == 12


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_masked_fill_matches_numpy_and_jax(shapes, route, monkeypatch):
    X, bg, zc = shapes
    if route == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        assert native.fill_route() == "numpy"
    out = native.masked_fill(X, bg, zc)
    np.testing.assert_allclose(out, numpy_masked(X, bg, zc), atol=1e-7)
    np.testing.assert_allclose(out, jnative.masked_fill(X, bg, zc), atol=1e-7)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_weighted_mean_matches_numpy_and_jax(route, monkeypatch):
    rng = np.random.default_rng(1)
    R, N, K = 7, 4, 3
    pred = rng.normal(size=(R * N, K)).astype(np.float32)
    w = rng.random(N).astype(np.float32)
    w /= w.sum()
    if route == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    out = native.weighted_mean(pred, w, R)
    np.testing.assert_allclose(out, np.einsum("rnk,n->rk", pred.reshape(R, N, K), w), atol=1e-6)
    np.testing.assert_allclose(out, jnative.weighted_mean(pred, w, R), atol=1e-6)
    with pytest.raises(ValueError, match="preserve row count"):
        native.weighted_mean(pred[:-1], w, R)


# ---------------------------------------------------------------------------
# the host-eval engine path


def test_host_eval_none_resolves_to_false_and_runs_on_the_device_path():
    """``host_eval=None`` resolves to False, as the reference resolves it on
    a backend with host callbacks: the CallbackPredictor then runs on the
    generic device route, its rows copied to the host per chunk."""

    rng = np.random.default_rng(5)
    D = 4
    bg = rng.normal(size=(8, D)).astype(np.float32)
    _, _, opaque = _softmax_model(D, 2, seed=5)
    eng = KernelExplainerEngine(CallbackPredictor(opaque, example_dim=D), bg,
                                link="logit", seed=0, config=EngineConfig(device="cpu"))
    assert eng.config.host_eval is False
    ref = JaxEngine(JaxCallback(opaque, example_dim=D), bg, link="logit", seed=0)
    assert ref.config.host_eval is False           # the JAX package on the CPU
    X = rng.normal(size=(3, D)).astype(np.float32)
    phi, want = eng.get_explanation(X), ref.get_explanation(X)
    assert eng.kernel_path == {"ey": "generic"}
    for a, b in zip(phi, want):
        assert a.shape == (3, D)
        np.testing.assert_allclose(a, b, atol=PHI_ATOL)


def test_hosteval_matches_device_path_and_jax():
    """Forced host-eval agrees with the port's device path for the same
    model (a LinearPredictor) and with the JAX package's host-eval."""

    rng = np.random.default_rng(2)
    D, K, N, B = 9, 2, 12, 6
    W, b, host_model = _softmax_model(D, K, seed=2)
    bg = rng.normal(size=(N, D)).astype(np.float32)
    X = rng.normal(size=(B, D)).astype(np.float32)

    host = KernelExplainerEngine(CallbackPredictor(host_model, example_dim=D), bg,
                                 link="logit", seed=0,
                                 config=EngineConfig(host_eval=True, device="cpu"))
    device = KernelExplainerEngine(LinearPredictor(W, b, "softmax", device="cpu"), bg,
                                   link="logit", seed=0, config=EngineConfig(device="cpu"))
    ref = JaxEngine(JaxCallback(host_model, example_dim=D), bg, link="logit", seed=0,
                    config=JaxEngineConfig(host_eval=True))
    sv_host = host.get_explanation(X, nsamples=100)
    assert host.kernel_path == {"ey": "host", "host_fill": "native"}
    for got, dev, want in zip(sv_host, device.get_explanation(X, nsamples=100),
                              ref.get_explanation(X, nsamples=100)):
        np.testing.assert_allclose(got, dev, atol=PHI_ATOL)
        np.testing.assert_allclose(got, want, atol=PHI_ATOL)
    np.testing.assert_allclose(host.expected_value, device.expected_value, atol=RAW_ATOL)
    np.testing.assert_allclose(host.expected_value, ref.expected_value, atol=RAW_ATOL)
    np.testing.assert_allclose(host.predict(X, link=True), ref.predict(X, link=True),
                               atol=RAW_ATOL)
    np.testing.assert_allclose(host.last_raw_prediction, ref.last_raw_prediction,
                               atol=RAW_ATOL)


def test_hosteval_numpy_fill_route_is_recorded(monkeypatch):
    rng = np.random.default_rng(4)
    D = 5
    _, _, host_model = _softmax_model(D, 2, seed=4)
    bg = rng.normal(size=(6, D)).astype(np.float32)
    X = rng.normal(size=(3, D)).astype(np.float32)
    eng = KernelExplainerEngine(CallbackPredictor(host_model, example_dim=D), bg,
                                link="logit", seed=0,
                                config=EngineConfig(host_eval=True, device="cpu"))
    native_phi = eng.get_explanation(X, nsamples=40)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    numpy_phi = eng.get_explanation(X, nsamples=40)
    assert eng.kernel_path["host_fill"] == "numpy"
    for a, b in zip(native_phi, numpy_phi):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_hosteval_threaded_workers_match_sequential():
    """The host-eval chunk fan-out (``host_eval_workers``) is bit-identical
    to the sequential loop: chunks write disjoint slices."""

    rng = np.random.default_rng(7)
    D, K, N, B = 11, 3, 10, 5
    _, _, host_model = _softmax_model(D, K, seed=7, bias=False)
    bg = rng.normal(size=(N, D)).astype(np.float32)
    X = rng.normal(size=(B, D)).astype(np.float32)

    def engine(workers):
        cfg = EngineConfig(host_eval=True, host_eval_workers=workers, device="cpu")
        # a small coalition chunk makes many chunks, so the pool is used
        cfg = replace(cfg, shap=replace(cfg.shap, coalition_chunk=16))
        return KernelExplainerEngine(CallbackPredictor(host_model, example_dim=D), bg,
                                     link="logit", seed=0, config=cfg)

    seq, par = engine(1), engine(4)
    sv_seq = seq.get_explanation(X, nsamples=200)
    sv_par = par.get_explanation(X, nsamples=200)
    assert (seq.last_hosteval_workers, par.last_hosteval_workers) == (1, 4)
    for a, b in zip(sv_seq, sv_par):
        np.testing.assert_array_equal(a, b)

    # the public API reaches the same knob through engine_config
    ks = KernelShap(host_model, link="logit", seed=0, device="cpu",
                    engine_config=EngineConfig(host_eval=True, host_eval_workers=4))
    ks.fit(bg)
    assert ks.hosteval_workers is None
    expl = ks.explain(X, nsamples=200, silent=True)
    assert ks.hosteval_workers >= 1 and ks.kernel_path["ey"] == "host"
    for a, b in zip(sv_seq, expl.shap_values):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("l1_reg", ["num_features(5)", "auto"])
def test_hosteval_l1_matches_jax(l1_reg):
    """The host-eval branch of ``_l1_solve``: the same selection and phi as
    the JAX package's host-eval l1, and additive."""

    rng = np.random.default_rng(3)
    D = 16
    W = rng.normal(scale=0.3, size=(D, 1)).astype(np.float32)
    bg = rng.normal(size=(8, D)).astype(np.float32)
    X = rng.normal(size=(2, D)).astype(np.float32)

    def fn(x):
        return np.asarray(x, np.float32) @ W

    eng = KernelExplainerEngine(CallbackPredictor(fn, example_dim=D), bg, seed=0,
                                config=EngineConfig(host_eval=True, device="cpu"))
    ref = JaxEngine(JaxCallback(fn, example_dim=D), bg, seed=0,
                    config=JaxEngineConfig(host_eval=True))
    sv, = eng.get_explanation(X, nsamples=64, l1_reg=l1_reg)
    want, = ref.get_explanation(X, nsamples=64, l1_reg=l1_reg)
    assert eng.kernel_path["ey"] == "host"
    np.testing.assert_array_equal(np.abs(sv) > 1e-9, np.abs(want) > 1e-9)
    np.testing.assert_allclose(sv, want, atol=PHI_ATOL)
    if l1_reg != "auto":
        assert ((np.abs(sv) > 1e-9).sum(1) <= 6).all()
    np.testing.assert_allclose(sv.sum(1) + eng.expected_value,
                               eng.last_raw_prediction[:, 0], atol=1e-4)


def test_hosteval_importance_takes_the_full_explain():
    rng = np.random.default_rng(9)
    D = 6
    _, _, host_model = _softmax_model(D, 2, seed=9)
    bg = rng.normal(size=(8, D)).astype(np.float32)
    X = rng.normal(size=(5, D)).astype(np.float32)
    ks = KernelShap(host_model, link="logit", seed=0, device="cpu",
                    engine_config=EngineConfig(host_eval=True)).fit(bg)
    phi = np.stack(ks.explain(X, silent=True, l1_reg=False).shap_values)
    imp = ks._explainer.get_importance(X)
    np.testing.assert_allclose(imp, np.abs(phi).mean(1), atol=1e-6)
    assert ks.kernel_path["ey"] == "host"
