"""The PyTorch port's serving observability on the CPU: the memory ledger
(with its repair), the compile accountant of the port's compiled
artefacts, the scheduler and the packages' exports, each held against the
JAX package's counterpart (``distributedkernelshap_tpu/observability/``,
``runtime/compile_cache.py``, ``scheduling/``).

Inputs are made from a seed or scripted; every comparison is exact
(integers of computed bytes, metric family names, labels and rendered
sample lines, batch membership and order).
"""

import gc
import types

import numpy as np
import pytest

import distributedkernelshap_tpu.analysis as jax_analysis
import distributedkernelshap_tpu.observability as jax_observability
import distributedkernelshap_tpu.registry as jax_registry
import distributedkernelshap_tpu.resilience as jax_resilience
import distributedkernelshap_tpu.scheduling as jax_scheduling
import distributedkernelshap_tpu.serving as jax_serving
import distributedkernelshap_tpu_torch.analysis as port_analysis
import distributedkernelshap_tpu_torch.observability as port_observability
import distributedkernelshap_tpu_torch.registry as port_registry
import distributedkernelshap_tpu_torch.resilience as port_resilience
import distributedkernelshap_tpu_torch.scheduling as port_scheduling
import distributedkernelshap_tpu_torch.serving as port_serving
from distributedkernelshap_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from distributedkernelshap_tpu.runtime.compile_cache import (
    CompileAccounting as JaxCompileAccounting,
)
from distributedkernelshap_tpu_torch import KernelShap, LinearPredictor
from distributedkernelshap_tpu_torch import kernel_shap as ks_mod
from distributedkernelshap_tpu_torch.observability.memledger import (
    MemLedger,
    approx_nbytes,
)
from distributedkernelshap_tpu_torch.observability.metrics import (
    MetricsRegistry,
    validate_exposition,
)
from distributedkernelshap_tpu_torch.runtime import compile_cache, native
from distributedkernelshap_tpu_torch.runtime.compile_cache import CompileAccounting


def _arr(n):
    return np.zeros(n, dtype=np.uint8)


# ---------------------------------------------------------------------------
# the memory ledger: the reference's two seed-failing tests, on the port


def test_tracked_cache_mirrors_all_mutation_paths():
    """The body of ``tests/test_memledger.py::
    test_tracked_cache_mirrors_all_mutation_paths`` on the port's ledger
    (the reference's copy leaks ``pop`` / ``popitem`` charges)."""

    led = MemLedger(enabled=True, budget_bytes=0)
    c = led.tracked_cache("dev_cache")
    c["a"] = _arr(10)
    c["b"] = _arr(20)
    assert led.total_bytes() == 30
    c["a"] = _arr(5)             # replace releases the old charge
    assert led.total_bytes() == 25
    del c["a"]
    assert led.total_bytes() == 20
    c.pop("b")
    assert led.total_bytes() == 0
    c.update({"x": _arr(7), "y": _arr(8)})
    assert led.total_bytes() == 15
    c.popitem(last=False)        # LRU evict, the engine's idiom
    assert led.total_bytes() == 8
    c.clear()
    assert led.total_bytes() == 0
    assert c.ledger_bytes == 0


def test_pressure_evicts_lru_but_never_mru():
    """The body of ``tests/test_memledger.py::
    test_pressure_evicts_lru_but_never_mru`` on the port's ledger."""

    led = MemLedger(enabled=True, budget_bytes=100)
    c = led.tracked_cache("dev_cache")
    for i in range(5):
        c[i] = _arr(40)      # 200 bytes charged, budget 100
    assert led.pressure_events() > 0
    assert led.evicted_bytes() > 0
    assert led.total_bytes() <= 100
    assert 4 in c            # the most-recently-inserted entry survives
    assert len(c) >= 1


def test_pop_default_and_setdefault_keep_the_ledger_exact():
    led = MemLedger(enabled=True, budget_bytes=0)
    c = led.tracked_cache("dev_cache")
    assert c.pop("missing", None) is None
    with pytest.raises(KeyError):
        c.pop("missing")
    v = c.setdefault("k", _arr(9))
    assert c.setdefault("k", _arr(99)) is v
    assert led.total_bytes() == 9 == c.ledger_bytes
    assert c.popitem()[0] == "k" and led.total_bytes() == 0


def test_engine_dev_cache_evictions_return_the_ledger_to_live_bytes(monkeypatch):
    """The port engine's device caches are ledger-tracked: explains over
    more plans than the LRU holds evict, and every eviction releases its
    charge, so the ledger equals the bytes still cached."""

    led = MemLedger(enabled=True, budget_bytes=0)
    monkeypatch.setattr(ks_mod, "memledger", lambda: led)
    rng = np.random.default_rng(0)
    D = 6
    pred = LinearPredictor(rng.normal(size=(D, 2)).astype(np.float32),
                           np.zeros(2, np.float32), "softmax", device="cpu")
    ks = KernelShap(pred, link="logit", seed=0, device="cpu")
    ks.fit(rng.normal(size=(8, D)).astype(np.float32))
    engine = ks._explainer
    X = rng.normal(size=(2, D)).astype(np.float32)
    cap = engine._DEV_CACHE_MAX_ENTRIES
    for nsamples in range(20, 20 + 2 * (cap + 2), 2):
        ks.explain(X, nsamples=nsamples, l1_reg=False, silent=True)
    assert len(engine._dev_cache) == cap
    live = {
        "dev_cache": sum(approx_nbytes(v) for v in engine._dev_cache.values()),
        "plan_consts": sum(approx_nbytes(v) for v in engine._plan_consts_cache.values()),
    }
    assert live["dev_cache"] > 0
    assert led.owner_totals().get("dev_cache", 0) == live["dev_cache"]
    assert led.total_bytes() == live["dev_cache"] + live["plan_consts"]
    engine.reset_device_state()
    assert led.total_bytes() == 0
    del ks, engine
    gc.collect()


def test_plan_consts_owner_routes_like_the_reference():
    from distributedkernelshap_tpu import kernel_shap as jks

    keys = [("exact_consts", "fp", True), ("exact_reach_full", "fp"),
            ("exact_tn_consts", "fp"), ("deepshap_consts", "fp"),
            ("fp", "anytime", "sched"), ("fp", "plan", 4), "other"]
    assert [ks_mod._plan_consts_owner(k) for k in keys] == \
        [jks._plan_consts_owner(k) for k in keys]


def test_reconcile_without_a_cuda_device_is_unsupported():
    import torch

    led = MemLedger(enabled=True, budget_bytes=0)
    led.note_device(torch.device("cpu"))
    led.account("staging").charge("x", 12)
    assert led.reconcile() == {"supported": False, "ledger_bytes": 12}
    assert led.snapshot()["reconcile"]["supported"] is False


# ---------------------------------------------------------------------------
# compile accounting


def _families(registry):
    return [(d["name"], d["type"], tuple(d["labels"])) for d in registry.describe()]


def test_compile_events_render_as_the_references_families():
    acct = CompileAccounting()
    with acct.signature("rows=4,path=sampled"):
        acct.record("fresh", 1.5, "fused_linear_ey")
        acct.record("cache_hit", 0.25, "exact_tree_phi")
    acct.record("cache_hit", 0.5, "libdksruntime")
    reg = MetricsRegistry()
    acct.attach_metrics(reg)
    jreg = JaxRegistry()
    JaxCompileAccounting().attach_metrics(jreg)
    assert _families(reg) == _families(jreg)
    text = reg.render()
    assert validate_exposition(text) == []
    for line in ('dks_compile_total{kind="fresh",signature="rows=4,path=sampled"} 1',
                 'dks_compile_total{kind="cache_hit",signature="rows=4,path=sampled"} 1',
                 'dks_compile_total{kind="cache_hit",signature="_unattributed"} 1',
                 'dks_compile_seconds_total{kind="fresh",signature="rows=4,path=sampled"} 1.5'):
        assert line in text, line
    snap = acct.snapshot()
    assert snap["totals"] == {"fresh": 1, "cache_hit": 2}
    assert acct.artefacts() == {"fused_linear_ey": "fresh", "exact_tree_phi": "cache_hit",
                                "libdksruntime": "cache_hit"}
    assert acct.total_seconds() == 2.25
    with pytest.raises(ValueError):
        acct.record("warm", 1.0)


def test_the_native_library_loads_fresh_then_as_a_cache_hit(tmp_path, monkeypatch):
    """``enable_persistent_cache`` moves both build directories; a load
    that ran ``g++`` counts ``fresh``, a load of the digest-named file
    already there counts ``cache_hit``."""

    from distributedkernelshap_tpu_torch.ops import cuda_kernels

    acct = CompileAccounting()
    monkeypatch.setattr(compile_cache, "_accounting", acct)
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.setattr(cuda_kernels, "BUILD_DIR", cuda_kernels.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv(compile_cache.CACHE_DIR_ENV, raising=False)
    assert compile_cache.enable_persistent_cache() is None
    monkeypatch.setenv(compile_cache.CACHE_DIR_ENV, str(tmp_path))
    assert compile_cache.enable_persistent_cache() == str(tmp_path)
    assert compile_cache.enable_persistent_cache() == str(tmp_path)   # idempotent
    assert cuda_kernels.BUILD_DIR == tmp_path / "kernels"
    assert native.BUILD_DIR == tmp_path / "native"
    with acct.signature("rows=1"):
        assert native.get_lib() is not None
    assert native.library_path().parent == tmp_path / "native"
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.get_lib() is not None
    counts = acct.snapshot()["counts"]
    assert counts == {("fresh", "rows=1"): 1, ("cache_hit", "_unattributed"): 1}


# ---------------------------------------------------------------------------
# the scheduler


class _Item:
    def __init__(self, name, klass, deadline, rows, t_enqueued):
        self.name, self.klass, self.deadline = name, klass, deadline
        self.rows, self.t_enqueued, self.done = rows, t_enqueued, False


def _schedule(pkg):
    """Form batches for one scripted arrival sequence on a fake clock:
    ``(batch names, expired names)`` per ``next_batch``."""

    clock = {"t": 100.0}
    sched = pkg.SLOScheduler(now=lambda: clock["t"])
    rng = np.random.default_rng(7)
    out = []
    n = 0
    for step in range(12):
        for _ in range(int(rng.integers(1, 5))):
            klass = ("interactive", "batch", "best_effort")[int(rng.integers(0, 3))]
            deadline = (None if rng.random() < 0.5
                        else clock["t"] + float(rng.uniform(-0.5, 5.0)))
            sched.put(_Item(f"r{n}", klass, deadline, int(rng.integers(1, 5)),
                            clock["t"] + 0.001 * n))
            n += 1
        clock["t"] += float(rng.uniform(0.05, 0.6))
        batch, expired = sched.next_batch(max_batch_size=4, max_rows=7)
        out.append(([i.name for i in batch or []], [i.name for i in expired]))
    sched.stop()
    while True:
        batch, expired = sched.next_batch(max_batch_size=4, max_rows=7)
        if not batch and not expired:
            break
        out.append(([i.name for i in batch or []], [i.name for i in expired]))
    return out


def test_the_scheduler_forms_the_references_batches_in_order():
    ours, theirs = _schedule(port_scheduling), _schedule(jax_scheduling)
    assert ours == theirs
    assert sum(len(b) for b, _ in ours) > 10 and any(e for _, e in ours)


# ---------------------------------------------------------------------------
# exports


#: reference names whose modules wait for later ROADMAP.md queue A items
#: (none left in these packages since the fleet, the registry, hedging,
#: the journal and supervision were ported)
QUEUED = {}


def _names(pkg):
    return {n for n, v in vars(pkg).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("name,ours,theirs", [
    ("observability", port_observability, jax_observability),
    ("serving", port_serving, jax_serving),
    ("analysis", port_analysis, jax_analysis),
    ("scheduling", port_scheduling, jax_scheduling),
    ("resilience", port_resilience, jax_resilience),
    ("registry", port_registry, jax_registry),
])
def test_packages_export_the_references_names(name, ours, theirs):
    queued = QUEUED.get(name, set())
    assert _names(ours) == _names(theirs) - queued
    assert queued <= _names(theirs)
    if name == "analysis":
        assert ours.lockwitness.make_lock("x") is not None


@pytest.mark.parametrize("attach", ["treeshap", "tensor_shap", "deepshap", "pod", "path"])
def test_each_attached_family_matches_the_reference(attach):
    import importlib

    where = {"treeshap": ("ops.treeshap", "attach_treeshap_metrics"),
             "tensor_shap": ("ops.tensor_shap", "attach_tensor_shap_metrics"),
             "deepshap": ("attribution.deepshap", "attach_deepshap_metrics"),
             "pod": ("serving.multihost", "attach_pod_metrics"),
             "path": ("serving.wrappers", "attach_path_metrics")}[attach]
    ours = getattr(importlib.import_module(f"distributedkernelshap_tpu_torch.{where[0]}"),
                   where[1])
    theirs = getattr(importlib.import_module(f"distributedkernelshap_tpu.{where[0]}"),
                     where[1])
    reg, jreg = MetricsRegistry(), JaxRegistry()
    ours(reg)
    theirs(jreg)
    assert _families(reg) == _families(jreg)
    assert validate_exposition(reg.render()) == []


def test_the_port_never_demotes_an_exact_explain():
    from distributedkernelshap_tpu_torch.ops.treeshap import exact_fallback_counts

    assert exact_fallback_counts() == {}


def test_multihost_entry_points_name_their_roadmap_item():
    """The pod entry points in one process: ``serve_multihost`` leads a pod
    of one (no group: the collective wire, which then broadcasts to
    nobody), serves, records its frames, and drains; the lead and
    follower sides refuse the wrong role.  (Pods of two processes:
    ``tests/test_torch_port_pod_serving.py``.)"""

    import http.client

    import numpy as np

    from distributedkernelshap_tpu_torch.models.predictors import LinearPredictor
    from distributedkernelshap_tpu_torch.observability.flightrec import flightrec
    from distributedkernelshap_tpu_torch.serving import multihost
    from distributedkernelshap_tpu_torch.serving import wire

    rng = np.random.default_rng(5)
    D, K = 5, 2
    pred = LinearPredictor(rng.normal(size=(D, K)).astype(np.float32),
                           np.zeros(K, np.float32), "softmax", device="cpu")
    bg = rng.normal(size=(8, D)).astype(np.float32)
    srv = multihost.serve_multihost(
        pred, bg, {"link": "logit", "seed": 0, "device": "cpu"}, {},
        {"n_devices": 2, "devices": ["cpu"] * 2}, host="127.0.0.1", port=0,
        max_batch_size=2, max_rows=8, explain_kwargs={"nsamples": 32, "l1_reg": False},
        warmup=False)
    try:
        assert isinstance(srv.model, multihost.PipelinedMultihostServingModel)
        assert isinstance(srv.model._transport, multihost.CollectiveTransport)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("POST", "/explain", body=wire.encode_request(bg[:3]),
                     headers={"Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE})
        resp = conn.getresponse()
        assert resp.status == 200
        phi = np.stack(wire.decode_explanation(resp.read())["shap_values"], 1)
        conn.close()
        assert phi.shape == (3, K, D)
        last = flightrec().snapshot("pod_frame")[-1]
        assert (last["role"], last["cmd"], last["rows"], last["frames"]["explain"]) \
            == ("lead", "explain", 3, 1)
        assert last["launches"]["fused_linear_ey"] == 0    # the CPU runs plain versions
        with pytest.raises(RuntimeError, match="lead process"):
            multihost.follower_loop(srv.model.model, transport=srv.model._transport)
    finally:
        assert srv.model.drain_and_shutdown(srv, grace_s=10)
    assert flightrec().snapshot("pod_frame")[-1]["cmd"] == "shutdown"
