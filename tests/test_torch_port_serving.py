"""The PyTorch port's single-process explanation server on the CPU
(``distributedkernelshap_tpu_torch/serving/``), held against the JAX
package's.

Deployments are made from the committed fixture
``tests/fixtures/adult_parity.npz`` (the JAX package's own answers on the
Adult-schema rows: its LR's ``coef`` / ``intercept``, its GBT's tables,
``phi``, ``tree_phi`` and ``tree_interactions``), so no test needs
scikit-learn.  Servers bind port 0 on 127.0.0.1 with ``warmup=False`` and
an explicit ``pipeline_depth`` (one small test runs the warmup ladder),
and every server is stopped in a ``finally``.

Tolerances: served LR phi within 1e-4 of the fixture's JAX phi (as
``tests/test_torch_port_slice.py``); exact GBT phi and interactions within
2e-5 · max(1, max|·|) of the fixture (the exact paths' bar since PR 11);
wire frames byte-equal.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from distributedkernelshap_tpu.registry.classify import classify_path as jax_classify_path
from distributedkernelshap_tpu.serving import client as jax_client
from distributedkernelshap_tpu.serving import wire as jax_wire
from distributedkernelshap_tpu_torch import EngineConfig, KernelShap, TreeEnsemblePredictor
from distributedkernelshap_tpu_torch.models.predictors import (
    LinearPredictor,
    TorchPredictor,
)
from distributedkernelshap_tpu_torch.models.torch_lift import TorchMLPPredictor
from distributedkernelshap_tpu_torch.ops.explain import ShapConfig
from distributedkernelshap_tpu_torch.registry.classify import classify_path
from distributedkernelshap_tpu_torch.scheduling.result_cache import (
    model_fingerprint,
    predictor_fingerprint,
)
from distributedkernelshap_tpu_torch.serving import client, wire
from distributedkernelshap_tpu_torch.serving.server import ExplainerServer
from distributedkernelshap_tpu_torch.serving.wrappers import (
    BatchKernelShapModel,
    EXACT_AUTO_ENV,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "adult_parity.npz")
PHI_ATOL = 1e-4
EXACT_REL = 2e-5
#: fixture GBT rows the exact tests serve (the fixture holds 256)
N_TREE = 12


@pytest.fixture(scope="module")
def fx():
    data = np.load(FIXTURE, allow_pickle=False)
    widths = [int(w) for w in data["group_widths"]]
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
    out = {k: data[k] for k in data.files}
    out["groups"] = [list(range(s, s + w)) for s, w in zip(starts, widths)]
    out["names"] = [f"g{i}" for i in range(len(widths))]
    return out


def _lr_predictor(fx):
    """The fixture's binary LR as the two-class softmax the lift makes."""

    coef = np.asarray(fx["coef"], np.float32).reshape(-1)
    W = np.stack([np.zeros_like(coef), coef], 1)
    b = np.array([0.0, float(fx["intercept"][0])], np.float32)
    return LinearPredictor(W, b, "softmax", device="cpu")


def _lr_explainer(fx, **engine):
    ks = KernelShap(_lr_predictor(fx), link="logit", seed=0, device="cpu",
                    engine_config=EngineConfig(**engine) if engine else None)
    ks.fit(fx["background"], group_names=fx["names"], groups=fx["groups"])
    return ks


def _tree_predictor(fx):
    return TreeEnsemblePredictor(
        fx["tree_feature"], fx["tree_threshold"], fx["tree_left"], fx["tree_right"],
        fx["tree_value"], depth=int(fx["tree_depth"]), aggregation="sum",
        base=fx["tree_base"], scale=float(fx["tree_scale"]),
        missing_left=fx["tree_missing_left"], vector_out=False, device="cpu")


def _tree_explainer(fx):
    ks = KernelShap(_tree_predictor(fx), task="regression", seed=0, device="cpu")
    ks.fit(fx["background"], group_names=fx["names"], groups=fx["groups"])
    return ks


def _serve(model, **kw):
    kw.setdefault("warmup", False)
    kw.setdefault("pipeline_depth", 2)
    kw.setdefault("max_batch_size", 8)
    return ExplainerServer(model, host="127.0.0.1", port=0, **kw).start()


def _url(srv, path="/explain"):
    return f"http://127.0.0.1:{srv.port}{path}"


def _phi_of(payload):
    """``(B, K, M)`` phi of a JSON (str) or binary (dict) payload."""

    if isinstance(payload, (str, bytes)):
        payload = wire.explanation_payload_from_json(payload)
    return np.stack([np.asarray(v) for v in payload["shap_values"]], 1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@pytest.fixture(scope="module")
def lr_server(fx):
    client.reset_negotiation_cache()
    srv = _serve(BatchKernelShapModel.from_explainer(_lr_explainer(fx)))
    try:
        yield srv
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the wire


def _wire_cases():
    rng = np.random.default_rng(0)
    B, K, M = 3, 2, 5
    sv = [rng.normal(size=(B, M)).astype(np.float32) for _ in range(K)]
    ev = rng.normal(size=K).astype(np.float32)
    raw = rng.normal(size=(B, K)).astype(np.float32)
    inter = [rng.normal(size=(B, M, M)).astype(np.float32) for _ in range(K)]
    rows = rng.normal(size=(B, 7))
    return {
        "request": (lambda w: w.encode_request(rows), lambda w, b: w.decode_request(b)),
        "request_model": (lambda w: w.encode_request(rows[:1], model_id="tenant-a"),
                          lambda w, b: w.decode_request_meta(b)),
        "explanation": (lambda w: w.encode_explanation(sv, ev, raw),
                        lambda w, b: w.decode_explanation(b)),
        "interactions": (lambda w: w.encode_explanation(sv, ev, raw, inter),
                         lambda w, b: w.decode_explanation(b)),
        "round_frame": (lambda w: w.encode_round_frame(sv, ev, raw, 2, raw[:, :1]),
                        lambda w, b: w.decode_round_frame(b)[0]),
    }


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("case", sorted(_wire_cases()))
def test_wire_frames_are_byte_equal_and_cross_decode(case):
    encode, decode = _wire_cases()[case]
    ours, theirs = encode(wire), encode(jax_wire)
    assert isinstance(ours, bytes) and ours == theirs
    assert _equal(decode(wire, theirs), decode(jax_wire, ours))


# ---------------------------------------------------------------------------
# the LR deployment end to end


@pytest.mark.parametrize("wire_format", ["json", "binary"])
def test_served_lr_matches_the_jax_fixture(fx, lr_server, wire_format):
    X = fx["X"][:24]
    payloads = client.distribute_requests(
        _url(lr_server), X, batch_mode="default",
        minibatches=np.split(X, 12), max_workers=6, wire_format=wire_format)
    phi = np.concatenate([_phi_of(p) for p in payloads])
    assert phi.shape == (24, 2, 12)
    assert np.abs(phi - fx["phi"][:24]).max() <= PHI_ATOL


@pytest.fixture(scope="module")
def jax_model(fx):
    import chip_smoke

    from distributedkernelshap_tpu.serving.wrappers import (
        BatchKernelShapModel as JaxBatchModel,
    )

    est = chip_smoke.AdultShapedLogisticRegression.fitted(fx["coef"], fx["intercept"])
    return JaxBatchModel(est.predict_proba, fx["background"], {"link": "logit", "seed": 0},
                         {"group_names": fx["names"], "groups": fx["groups"]})


def _keys(doc, prefix=""):
    out = set()
    for k, v in doc.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k in ("data", "meta", "raw"):
            out |= _keys(v, prefix + k + ".")
    return out


def test_response_json_keys_equal_the_jax_models(fx, lr_server, jax_model):
    rows = fx["X"][30:32]
    ours = json.loads(client.explain_request(_url(lr_server), rows))
    theirs = json.loads(jax_model([{"array": rows.tolist()}])[0])
    assert _keys(ours) == _keys(theirs)
    assert np.abs(_phi_of(json.dumps(ours)) - _phi_of(json.dumps(theirs))).max() <= PHI_ATOL


@pytest.mark.parametrize("wire_format", ["json", "binary"])
def test_the_jax_packages_client_gets_the_same_answer(fx, lr_server, wire_format):
    jax_client.reset_negotiation_cache()
    rows = fx["X"][40:43]
    theirs = jax_client.explain_request(_url(lr_server), rows, wire_format=wire_format)
    ours = client.explain_request(_url(lr_server), rows, wire_format=wire_format)
    np.testing.assert_array_equal(_phi_of(theirs), _phi_of(ours))
    assert np.abs(_phi_of(theirs) - fx["phi"][40:43]).max() <= PHI_ATOL


def test_healthz_and_a_result_cache_hit_repeat_no_explain(fx):
    model = BatchKernelShapModel.from_explainer(_lr_explainer(fx))
    calls = []
    inner = model.explain_batch_async

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    model.explain_batch_async = counted
    srv = _serve(model, cache_bytes=1 << 20)
    try:
        with urllib.request.urlopen(_url(srv, "/healthz"), timeout=30) as r:
            assert r.status == 200
        rows = fx["X"][50:52]
        first = client.explain_request(_url(srv), rows)
        n = len(calls)
        second = client.explain_request(_url(srv), rows)
        assert second == first and len(calls) == n == 1
    finally:
        srv.stop()


def test_a_failing_kernel_fails_the_request_and_answers_nothing(fx, monkeypatch):
    """No fallback: a kernel that raises inside a served batch gives that
    batch's requests a 5xx through the server's error path."""

    from distributedkernelshap_tpu_torch.ops import explain as texp

    def broken(*a, **kw):
        raise RuntimeError("fused_linear_ey launch failed: an injected fault")

    ks = _lr_explainer(fx, plan_constant_cache="off",
                       shap=ShapConfig(use_kernel=True))
    monkeypatch.setattr(texp, "fused_linear_ey", broken)
    srv = _serve(BatchKernelShapModel.from_explainer(ks))
    try:
        req = urllib.request.Request(
            _url(srv), data=json.dumps({"array": fx["X"][:1].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code >= 500
        assert "injected fault" in err.value.read().decode()
    finally:
        srv.stop()


def test_the_warmup_ladder_gates_healthz_then_serves(fx):
    srv = _serve(BatchKernelShapModel.from_explainer(_lr_explainer(fx)),
                 warmup=True, max_batch_size=4)
    try:
        deadline = time.monotonic() + 60
        while srv.warmup_status()["state"] in ("pending", "running"):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        st = srv.warmup_status()
        assert st["state"] == "done" and st["completed"] == st["total"] >= 1
        with urllib.request.urlopen(_url(srv, "/healthz"), timeout=30) as r:
            assert r.status == 200
        with urllib.request.urlopen(_url(srv, "/metrics"), timeout=30) as r:
            assert "dks_serve_warming 0" in r.read().decode()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# path choice on the fixture GBT


def test_the_fixture_gbt_auto_routes_to_exact_in_both_packages(fx):
    from distributedkernelshap_tpu import KernelShap as JaxKernelShap
    from distributedkernelshap_tpu.models import TreeEnsemblePredictor as JaxTree

    jtree = JaxTree(fx["tree_feature"], fx["tree_threshold"], fx["tree_left"],
                    fx["tree_right"], fx["tree_value"], depth=int(fx["tree_depth"]),
                    aggregation="sum", base=fx["tree_base"], scale=float(fx["tree_scale"]),
                    missing_left=fx["tree_missing_left"], vector_out=False)
    jks = JaxKernelShap(jtree, task="regression", seed=0)
    jks.fit(fx["background"], group_names=fx["names"], groups=fx["groups"])
    ours, theirs = classify_path(_tree_explainer(fx)), jax_classify_path(jks)
    assert ours == theirs and ours.path == "exact_tree"
    # a bare predictor classifies the same way too
    assert classify_path(_tree_predictor(fx)) == jax_classify_path(jtree)
    assert classify_path(_lr_predictor(fx)).path == "linear"


def test_served_gbt_takes_exact_and_matches_tree_phi(fx):
    model = BatchKernelShapModel.from_explainer(_tree_explainer(fx))
    assert (model.explain_path, model.explain_path_reason) == ("exact", "auto")
    assert model.explain_kwargs == {"nsamples": "exact"}
    srv = _serve(model)
    try:
        X = fx["X"][:N_TREE]
        payloads = client.distribute_requests(
            _url(srv), X, batch_mode="default", minibatches=np.split(X, 4),
            max_workers=4, wire_format="binary")
        phi = np.concatenate([p["shap_values"][0] for p in payloads])
        assert _rel(phi, fx["tree_phi"][:N_TREE]) <= EXACT_REL
        with urllib.request.urlopen(_url(srv, "/metrics"), timeout=30) as r:
            text = r.read().decode()
        assert 'dks_serve_explain_path_total{path="exact"}' in text
    finally:
        srv.stop()


def test_pinned_interactions_deployment_answers(fx):
    model = BatchKernelShapModel.from_explainer(
        _tree_explainer(fx), explain_kwargs={"nsamples": "exact", "interactions": True})
    srv = _serve(model)
    try:
        X = fx["X"][:4]
        body = client.explain_request(_url(srv), X, wire_format="binary")
        assert _rel(body["shap_values"][0], fx["tree_phi"][:4]) <= EXACT_REL
        assert _rel(body["interaction_values"][0], fx["tree_interactions"][:4]) <= EXACT_REL
        doc = json.loads(client.explain_request(_url(srv), X[:1]))
        inter = np.asarray(doc["data"]["raw"]["interaction_values"][0])
        assert _rel(inter, fx["tree_interactions"][:1]) <= EXACT_REL
    finally:
        srv.stop()


def test_exact_auto_opt_out_keeps_the_gbt_sampled(fx, monkeypatch):
    monkeypatch.setenv(EXACT_AUTO_ENV, "0")
    model = BatchKernelShapModel.from_explainer(_tree_explainer(fx))
    assert (model.explain_path, model.explain_path_reason) == ("sampled", "auto_disabled")
    assert "nsamples" not in model.explain_kwargs


# ---------------------------------------------------------------------------
# the metric catalog


class _StubModel:
    def explain_batch(self, instances, split_sizes=None):
        return ["{}"] * len(split_sizes or [1] * len(instances))


def _catalog(server_cls):
    srv = server_cls(_StubModel(), host="127.0.0.1", port=0, warmup=False,
                     pipeline_depth=1)
    return {(d["name"], d["type"], tuple(d["labels"])) for d in srv.metrics.describe()}


def test_the_metric_catalog_matches_the_reference_family_for_family():
    from distributedkernelshap_tpu.serving.server import ExplainerServer as JaxServer

    ours, theirs = _catalog(ExplainerServer), _catalog(JaxServer)
    assert ours == theirs
    assert {n for n, _, _ in ours} >= {"dks_compile_total", "dks_serve_warming",
                                        "dks_device_bytes", "dks_treeshap_fallback_total"}


# ---------------------------------------------------------------------------
# the CLI entry point


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_checkpoint_serves_one_request_and_stops_on_sigterm(fx, tmp_path):
    ckpt = str(tmp_path / "lr.pkl")
    _lr_explainer(fx).save(ckpt)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributedkernelshap_tpu_torch.serving.main",
         "--checkpoint", ckpt, "--host", "127.0.0.1", "--port", str(port),
         "--pipeline_depth", "2", "--max_batch_size", "4"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 90
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                    if r.status == 200:
                        break
            except (urllib.error.URLError, ConnectionError):
                pass
            assert proc.poll() is None, proc.stdout.read().decode()
            assert time.monotonic() < deadline, "the CLI server never became healthy"
            time.sleep(0.2)
        phi = _phi_of(client.explain_request(url + "/explain", fx["X"][:2]))
        assert np.abs(phi - fx["phi"][:2]).max() <= PHI_ATOL
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------------------
# content fingerprints of non-linear predictors


def _mlp(seed):
    rng = np.random.default_rng(seed)
    W1 = rng.normal(size=(4, 3)).astype(np.float32)
    W2 = rng.normal(size=(3, 2)).astype(np.float32)
    return TorchMLPPredictor([("linear", W1, np.zeros(3, np.float32)), ("relu",),
                              ("linear", W2, np.zeros(2, np.float32)), ("softmax",)],
                             n_outputs=2, device="cpu")


def _module(seed):
    torch.manual_seed(seed)
    net = torch.nn.Sequential(torch.nn.Conv1d(1, 2, 2), torch.nn.Flatten(),
                              torch.nn.Linear(6, 2))
    return TorchPredictor(net, n_outputs=2, device="cpu")


@pytest.mark.parametrize("make", [_mlp, _module], ids=["mlp", "torch_module"])
def test_models_differing_only_in_weights_never_share_a_cache_key(make):
    a, a_again, b = make(0), make(0), make(1)
    assert a.fingerprint_bytes() == a_again.fingerprint_bytes()
    assert a.fingerprint_bytes() != b.fingerprint_bytes()
    fa, weak = predictor_fingerprint(a)
    assert not weak and fa == predictor_fingerprint(a_again)[0]
    assert fa != predictor_fingerprint(b)[0]

    class _Model:
        explain_kwargs = {}

        def __init__(self, pred):
            self.explainer = type("E", (), {"_explainer": type(
                "G", (), {"predictor": pred, "background": np.zeros((2, 4), np.float32)})()})()

    assert model_fingerprint(_Model(a)) == model_fingerprint(_Model(a_again))
    assert model_fingerprint(_Model(a)) != model_fingerprint(_Model(b))


def test_a_plain_function_has_no_content_fingerprint():
    pred = TorchPredictor(lambda X: X[:, :2], n_outputs=2, device="cpu")
    assert pred.fingerprint_bytes() is None
    assert predictor_fingerprint(pred)[1]          # weak: in-process identity


def test_anytime_warm_runs_on_a_grouped_deployment(fx, jax_model):
    """The warmup ladder's anytime rungs build their zero rows at the
    predictor's width; the reference builds them at the group count and
    fails on the same grouped deployment (ROADMAP.md C.13)."""

    model = BatchKernelShapModel.from_explainer(_lr_explainer(fx))
    assert model.supports_anytime and jax_model.supports_anytime
    rounds = model.anytime_rounds()
    assert rounds > 0 and model.anytime_warm([2]) == rounds
    with pytest.raises(TypeError):
        jax_model.anytime_warm([2])
