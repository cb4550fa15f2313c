"""The PyTorch port's multi-tenant registry (``distributedkernelshap_tpu_torch/
registry/registry.py``) and the server's registry mode, on the CPU, held
against the JAX package's.

Tenants are small linear deployments made from a seed (a content-identical
pair from one seed, a distinct one from another) or serving stubs where a
test needs to hold a request in flight.  The share keys must agree with the
JAX package's on which tenant pairs may share; a coalesced two-tenant batch
must equal a dedicated dispatch at the same bucket bit for bit and the JAX
package's per-tenant phi within ``PHI_ATOL``.  Routing, hot-swap pinning,
quotas, the drain and the freed device caches run through the port's
server.  Servers bind port 0 on 127.0.0.1 and are stopped in a
``finally``.
"""

import http.client
import json
import threading

import numpy as np
import pytest

import chip_smoke
from distributedkernelshap_tpu.models import LinearPredictor as JaxLinearPredictor
from distributedkernelshap_tpu.ops.explain import shared_program_key as jax_share_key
from distributedkernelshap_tpu.registry import ModelRegistry as JaxRegistry
from distributedkernelshap_tpu.registry import TenantQuota as JaxQuota
from distributedkernelshap_tpu.serving.wrappers import BatchKernelShapModel as JaxModel
from distributedkernelshap_tpu_torch.models.predictors import LinearPredictor
from distributedkernelshap_tpu_torch.ops.explain import shared_program_key
from distributedkernelshap_tpu_torch.registry import ModelRegistry, TenantQuota
from distributedkernelshap_tpu_torch.serving import wire
from distributedkernelshap_tpu_torch.serving.server import ExplainerServer
from distributedkernelshap_tpu_torch.serving.wrappers import BatchKernelShapModel

D = 6
#: port vs JAX phi of the same tenant (f32 sums in other orders)
PHI_ATOL = 1e-5


def _weights(seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(D, 2)).astype(np.float32), rng.normal(size=(2,)).astype(np.float32)


def _bg():
    return np.random.default_rng(99).normal(size=(10, D)).astype(np.float32)


def _linear_model(seed, explain_kwargs=None):
    W, b = _weights(seed)
    return BatchKernelShapModel(LinearPredictor(W, b, activation="softmax", device="cpu"),
                                _bg(), {"link": "logit", "seed": 0, "device": "cpu"}, {},
                                explain_kwargs=explain_kwargs)


def _jax_linear_model(seed, explain_kwargs=None):
    W, b = _weights(seed)
    return JaxModel(JaxLinearPredictor(W, b, activation="softmax"), _bg(),
                    {"link": "logit", "seed": 0}, {}, explain_kwargs=explain_kwargs)


def _opaque(x):
    return np.asarray(x, dtype=np.float32)[:, :1] * 2.0


#: deployments whose share keys are compared: two content-identical
#: tenants, a distinct one, another plan, an active l1 (never shares) and
#: a host callback (never shares)
_TENANTS = [("seed1", 1, None), ("seed1_copy", 1, None), ("seed2", 2, None),
            ("nsamples64", 1, {"nsamples": 64}), ("l1", 1, {"l1_reg": 0.1}),
            ("callback", None, None)]


def test_share_keys_agree_with_the_references_on_which_tenants_may_share():
    ours, theirs = [], []
    for _, seed, kw in _TENANTS:
        if seed is None:
            ours.append(shared_program_key(BatchKernelShapModel(
                _opaque, _bg(), {"seed": 0, "device": "cpu"}, {})))
            theirs.append(jax_share_key(JaxModel(_opaque, _bg(), {"seed": 0}, {})))
        else:
            ours.append(shared_program_key(_linear_model(seed, kw)))
            theirs.append(jax_share_key(_jax_linear_model(seed, kw)))

    def pattern(keys):
        return [[a is not None and a == b for b in keys] for a in keys]

    assert [k is None for k in ours] == [k is None for k in theirs] \
        == [False, False, False, False, True, True]
    assert pattern(ours) == pattern(theirs)
    assert ours[0] == ours[1] != ours[2]


def _post(port, body, headers=None, model=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        if model is not None:
            hdrs["X-DKS-Model"] = model
        conn.request("POST", "/explain", body=body, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        return conn.getresponse().read().decode()
    finally:
        conn.close()


def _body(rows, model=None):
    doc = {"array": np.asarray(rows).tolist()}
    if model is not None:
        doc["model"] = model
    return json.dumps(doc).encode()


def _phi(payload):
    return json.loads(payload)["data"]["shap_values"]


def _batches(port):
    for line in _get(port, "/metrics").splitlines():
        if line.startswith("dks_serve_batches_total "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def test_a_coalesced_two_tenant_batch_matches_a_dedicated_dispatch_and_the_jax_phi():
    reg = ModelRegistry()
    reg.register("t1", _linear_model(1))
    reg.register("t2", _linear_model(1))
    dedicated = _linear_model(1)
    jax_model = _jax_linear_model(1)
    srv = ExplainerServer(registry=reg, host="127.0.0.1", port=0, max_batch_size=2,
                          batch_timeout_s=0.5, pipeline_depth=1, warmup=False).start()
    try:
        rng = np.random.default_rng(5)
        for _ in range(5):
            rows = rng.normal(size=(2, D)).astype(np.float32)
            b0 = _batches(srv.port)
            out = [None, None]

            def fire(i, tenant):
                out[i] = _post(srv.port, _body(rows[i:i + 1]), model=tenant)

            threads = [threading.Thread(target=fire, args=(i, t))
                       for i, t in enumerate(("t1", "t2"))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert all(s == 200 for s, _ in out)
            if _batches(srv.port) - b0 != 1:
                continue  # the two arrivals missed the coalesce window
            ded = dedicated.explain_batch(rows, split_sizes=[1, 1])
            for i in range(2):
                assert _phi(out[i][1]) == _phi(ded[i])
                jax_phi = np.asarray(_phi(jax_model.explain_batch(rows[i:i + 1])[0]))
                assert np.abs(np.asarray(_phi(out[i][1])) - jax_phi).max() <= PHI_ATOL
            break
        else:
            pytest.fail("no attempt coalesced the two tenants")
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def gateway():
    reg = ModelRegistry()
    reg.register("alpha", _linear_model(1))
    reg.register("beta", _linear_model(2))
    srv = ExplainerServer(registry=reg, host="127.0.0.1", port=0, max_batch_size=4,
                          batch_timeout_s=0.003, pipeline_depth=2, warmup=False,
                          cache_bytes=1 << 20).start()
    try:
        yield srv, reg
    finally:
        srv.stop()


def test_routing_by_header_json_field_wire_field_and_default(gateway):
    srv, _ = gateway
    row = np.random.default_rng(5).normal(size=(1, D)).astype(np.float32)
    s1, p1 = _post(srv.port, _body(row), model="alpha")
    s2, p2 = _post(srv.port, _body(row, model="beta"))
    s3, p3 = _post(srv.port, _body(row))
    s4, p4 = _post(srv.port, wire.encode_request(row, model_id="beta"),
                   headers={"Content-Type": wire.CONTENT_TYPE})
    s5, p5 = _post(srv.port, _body(row, model="beta"), model="alpha")
    assert (s1, s2, s3, s4, s5) == (200,) * 5
    assert _phi(p1) != _phi(p2)
    assert _phi(p3) == _phi(p1)          # the default is the first id
    assert _phi(p4) == _phi(p2)          # the wire field routes
    assert _phi(p5) == _phi(p1)          # the header wins over the field
    jax_alpha = _phi(_jax_linear_model(1).explain_batch(row)[0])
    assert np.abs(np.asarray(_phi(p1)) - np.asarray(jax_alpha)).max() <= PHI_ATOL


def test_an_unknown_id_gets_a_404_listing_the_roster(gateway):
    srv, _ = gateway
    s, p = _post(srv.port, _body(np.zeros((1, D), np.float32), model="nope"))
    doc = json.loads(p)
    assert s == 404 and "unknown model" in doc["error"] and doc["models"] == ["alpha", "beta"]


def test_the_result_cache_is_scoped_per_tenant(gateway):
    srv, reg = gateway
    row = np.random.default_rng(7).normal(size=(1, D)).astype(np.float32)
    s1, p1 = _post(srv.port, _body(row, "alpha"))
    s2, p2 = _post(srv.port, _body(row, "beta"))
    mid = srv._cache.stats()
    s3, p3 = _post(srv.port, _body(row, "alpha"))
    assert (s1, s2, s3) == (200, 200, 200) and p1 != p2 and p3 == p1
    assert srv._cache.stats()["hits"] == mid["hits"] + 1
    assert srv._cache_key_for(row, rm=reg.resolve("alpha")).startswith(
        reg.resolve("alpha").fingerprint)


def test_per_tenant_metrics_and_the_statusz_panel(gateway):
    srv, reg = gateway
    _post(srv.port, _body(np.ones((1, D), np.float32), "alpha"))
    page = _get(srv.port, "/metrics")
    assert 'dks_registry_models{model="alpha",version="1",path="linear"} 1' in page
    assert 'dks_registry_requests_total{model="alpha"}' in page
    panel = json.loads(_get(srv.port, "/statusz?format=json"))["detail"]["registry"]
    assert [m["model_id"] for m in panel["models"]] == ["alpha", "beta"]
    assert all(m["path"] == "linear" and m["share_key"] for m in panel["models"])


class _GatedStub:
    """Serving stub whose explain blocks until released."""

    def __init__(self, tag, gate=None):
        self.tag, self.gate = tag, gate

    def explain_batch(self, instances, split_sizes=None):
        if self.gate is not None:
            assert self.gate.wait(timeout=30)
        return [json.dumps({"tag": self.tag}) for _ in (split_sizes or [1] * len(instances))]


def _wait(pred, n=300):
    for _ in range(n):
        if pred():
            return True
        threading.Event().wait(0.01)
    return pred()


def test_a_hot_swap_pins_in_flight_requests_to_the_admitting_version():
    gate = threading.Event()
    reg = ModelRegistry(drain_timeout_s=30.0)
    rm1 = reg.register("m", _GatedStub("v1", gate))
    srv = ExplainerServer(registry=reg, host="127.0.0.1", port=0, max_batch_size=2,
                          pipeline_depth=1, warmup=False).start()
    try:
        results, swapped = [], threading.Event()
        row = _body(np.zeros((1, 3), np.float32), "m")
        t = threading.Thread(target=lambda: results.append(_post(srv.port, row)), daemon=True)
        t.start()
        assert _wait(lambda: rm1.inflight >= 1)

        def swap():
            reg.register("m", _GatedStub("v2"))
            swapped.set()

        threading.Thread(target=swap, daemon=True).start()
        assert _wait(lambda: reg.resolve("m").version == 2)
        assert not swapped.wait(0.2)     # the drain waits for the pinned request
        gate.set()
        t.join(30)
        assert swapped.wait(30)
        assert results[0][0] == 200 and json.loads(results[0][1])["tag"] == "v1"
        assert rm1.state == "retired" and rm1.model is None
        s, p = _post(srv.port, row)
        assert s == 200 and json.loads(p)["tag"] == "v2"
        assert 'dks_registry_swaps_total{model="m"} 2' in _get(srv.port, "/metrics")
    finally:
        gate.set()
        srv.stop()


@pytest.mark.parametrize("quota,reason", [
    (TenantQuota(rate_per_s=0.001, burst=1), "tenant_rate_limited"),
    (TenantQuota(max_inflight=1), "tenant_queue_full"),
], ids=["rate", "inflight"])
def test_a_tenant_over_its_quota_sheds_while_the_others_are_admitted(quota, reason):
    gate = threading.Event()
    reg = ModelRegistry()
    reg.register("open", _GatedStub("open"))
    reg.register("capped", _GatedStub("capped", gate), quota=quota)
    srv = ExplainerServer(registry=reg, host="127.0.0.1", port=0, max_batch_size=2,
                          pipeline_depth=2, warmup=False).start()
    try:
        row = _body(np.zeros((1, 3), np.float32))
        first = []
        t = threading.Thread(target=lambda: first.append(_post(srv.port, row, model="capped")),
                             daemon=True)
        t.start()
        assert _wait(lambda: reg.resolve("capped").inflight >= 1)
        s2, p2 = _post(srv.port, row, model="capped")
        other = []
        t_open = threading.Thread(target=lambda: other.append(_post(srv.port, row,
                                                                    model="open")))
        t_open.start()
        gate.set()  # the capped request holds the dispatcher until released
        t.join(30)
        t_open.join(30)
        s3 = other[0][0]
        assert first[0][0] == 200 and s2 == 429 and s3 == 200
        assert json.loads(p2)["reason"] == reason
        assert (f'dks_registry_sheds_total{{model="capped",reason="{reason}"}} 1'
                in _get(srv.port, "/metrics"))
    finally:
        gate.set()
        srv.stop()


def test_retiring_a_version_drops_its_device_caches_and_ledger_bytes():
    reg = ModelRegistry()
    v1 = reg.register("swap_lr", _linear_model(1))
    keep = reg.register("keep_lr", _linear_model(2))
    srv = ExplainerServer(registry=reg, host="127.0.0.1", port=0, max_batch_size=4,
                          pipeline_depth=1, warmup=False).start()
    try:
        row = _body(np.ones((2, D), np.float32))
        assert _post(srv.port, row, model="swap_lr")[0] == 200
        assert _post(srv.port, row, model="keep_lr")[0] == 200
        engine = v1.model.explainer._explainer
        v1_bytes = chip_smoke._ledger_bytes("swap_lr", 1)
        keep_bytes = chip_smoke._ledger_bytes("keep_lr")
        assert v1_bytes > 0 and keep_bytes > 0
        reg.register("swap_lr", _linear_model(3))
        assert v1.state == "retired"
        assert len(engine._dev_cache) == len(engine._plan_consts_cache) == 0
        assert chip_smoke._ledger_bytes("swap_lr", 1) == 0
        assert _post(srv.port, row, model="swap_lr")[0] == 200
        assert chip_smoke._ledger_bytes("swap_lr", 2) == v1_bytes  # same shapes
        v2 = reg.resolve("swap_lr")
        assert reg.unregister("swap_lr") is True
        assert v2.state == "retired" and chip_smoke._ledger_bytes("swap_lr") == 0
        assert chip_smoke._ledger_bytes("keep_lr") == keep_bytes
        assert 'model="swap_lr"' not in _get(srv.port, "/metrics")
        assert reg.model_ids() == ["keep_lr"] and keep.state == "active"
    finally:
        srv.stop()


class _Stub:
    def __init__(self, tag):
        self.tag = tag

    def explain_batch(self, instances, split_sizes=None):
        return [json.dumps({"tag": self.tag}) for _ in (split_sizes or [1])]


def _lifecycle(registry_cls, quota_cls):
    """One sequence of registry operations; what the registry reports."""

    reg = registry_cls(default_quota=quota_cls(rate_per_s=0.001, burst=2))
    reg.register("a", _Stub("a1"))
    reg.register("b", _Stub("b1"), quota=quota_cls(max_inflight=1))
    reg.register("a", _Stub("a2"))
    rm = reg.resolve("b", pin=True)
    sheds = [reg.admit(rm, exclude_self=True), reg.admit(rm)]
    rm.record_answer(0.5, error=False)
    rm.release()
    a = reg.resolve("a")
    sheds += [reg.admit(a) for _ in range(3)]
    reg.register("c", _Stub("c1"))
    drained = reg.unregister("c")
    panel = reg.statusz_panel()
    for m in panel["models"]:
        m.pop("fingerprint")
    return {"sheds": sheds, "drained": drained, "panel": panel, "ids": reg.model_ids(),
            "models": reg.metric_models(), "requests": reg.metric_requests(),
            "seconds": reg.metric_seconds(), "inflight": reg.metric_inflight(),
            "shed_counts": reg.metric_sheds(), "swaps": reg.metric_swaps()}


def test_the_registry_reports_what_the_reference_reports():
    ours, theirs = _lifecycle(ModelRegistry, TenantQuota), _lifecycle(JaxRegistry, JaxQuota)
    for shed in ours["sheds"] + theirs["sheds"]:
        assert shed[2] >= 0
    assert [s[:2] for s in ours["sheds"]] == [s[:2] for s in theirs["sheds"]]
    ours.pop("sheds"), theirs.pop("sheds")
    assert ours == theirs
