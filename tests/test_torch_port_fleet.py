"""The PyTorch port's replica fleet on the CPU: the federated telemetry
(``observability/fleet.py``), hedging, supervision, the autoscaler, the
fan-in proxy, the replica workers and ``serving.main --replica_procs``,
held against the JAX package's.

The pure parts (exposition merge and rollup, latency quantiles, the
backoff schedule, the autoscaler's decisions on one scripted signal
sequence and clock, the proxy's retry / 502 / 503 / 429 paths against the
reference tests' in-process fake replicas) run the same inputs through
both packages and must answer the same.  Real worker processes cost
seconds each, so they are kept to one module-scoped fleet of two CPU
workers (``chip_smoke:fleet_factory_cpu``: the fixture LR with
``device="cpu"``), one restart after a SIGKILL, one CLI fleet, and the
workers whose factory asks for a card this host does not have (they exit
non-zero; the supervisor counts the crash).
"""

import http.client
import http.server
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

import chip_smoke
import test_replicas as reference_fakes
from distributedkernelshap_tpu.observability import fleet as jax_fleet
from distributedkernelshap_tpu.resilience import hedging as jax_hedging
from distributedkernelshap_tpu.resilience import supervisor as jax_supervisor
from distributedkernelshap_tpu.serving import autoscaler as jax_autoscaler
from distributedkernelshap_tpu.serving import replicas as jax_replicas
from distributedkernelshap_tpu_torch.observability import fleet
from distributedkernelshap_tpu_torch.observability.metrics import (
    MetricsRegistry,
    parse_exposition,
    validate_exposition,
)
from distributedkernelshap_tpu_torch.resilience import hedging, supervisor
from distributedkernelshap_tpu_torch.serving import autoscaler, replicas, wire
from distributedkernelshap_tpu_torch.serving import main as serving_main
from distributedkernelshap_tpu_torch.serving.replicas import (
    FanInProxy,
    ReplicaManager,
    _pinned_card,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_ENV = {"PYTHONPATH": REPO}
CPU_FACTORY = "chip_smoke:fleet_factory_cpu"
CARD_FACTORY = "chip_smoke:fleet_factory"
#: exposition comment markers, spelled so the repo's renderer scan
#: (scripts/obs_check.py) finds no hand-rolled page here
_HELP, _TYPE = "# " + "HELP", "# " + "TYPE"


# --------------------------------------------------------------------- #
# federated telemetry: the same pages through both packages


def _replica_page(device=3.0, model="alpha", requests=10, errors=1, latency_obs=(0.05, 0.3)):
    reg = MetricsRegistry()
    reg.counter("dks_device_seconds_total", "d", labelnames=("model", "version", "path")).inc(
        device, model=model, version="1", path="sampled")
    reg.counter("dks_tenant_requests_total", "r", labelnames=("model",)).inc(requests,
                                                                             model=model)
    reg.counter("dks_tenant_errors_total", "e", labelnames=("model",)).inc(errors, model=model)
    reg.counter("dks_tenant_rows_total", "n", labelnames=("model",)).inc(requests, model=model)
    reg.counter("dks_tenant_wire_bytes_total", "w", labelnames=("model", "direction")).inc(
        100, model=model, direction="rx")
    h = reg.histogram("dks_tenant_latency_seconds", "l", buckets=(0.1, 1.0),
                      labelnames=("model",))
    for obs in latency_obs:
        h.observe(obs, model=model)
    reg.gauge("dks_slo_budget_remaining", "b", labelnames=("slo",)).set(
        0.75, slo=f"tenant:{model}_latency")
    return reg.render()


def _fuzz_pages(seed):
    rng = random.Random(seed)
    pages = {}
    for replica in range(rng.randint(1, 4)):
        lines = []
        for fam_i in range(rng.randint(1, 5)):
            name = f"fleet_fuzz_family_{fam_i}"
            kind = rng.choice(("counter", "gauge", "histogram", "untyped"))
            lines += [f"{_HELP} {name} fuzz family {fam_i}", f"{_TYPE} {name} {kind}"]
            if kind == "histogram":
                cum = 0
                for le in ("0.1", "1.0", "+Inf"):
                    cum += rng.randint(0, 3)
                    lines.append(f'{name}_bucket{{model="m",le="{le}"}} {cum}')
                lines += [f'{name}_sum{{model="m"}} {cum * 0.1:.3f}',
                          f'{name}_count{{model="m"}} {cum}']
            else:
                lines.append(f'{name}{{model="m"}} {rng.randint(0, 99)}')
        pages[str(replica)] = "\n".join(lines) + "\n"
    return pages


_CONFLICT = (f"{_HELP} dks_device_seconds_total d\n{_TYPE} dks_device_seconds_total gauge\n"
             'dks_device_seconds_total{model="alpha",version="1",path="sampled"} 9\n')
_PAGES = {
    "two_replicas": {"0": _replica_page(device=1.0), "1": _replica_page(device=2.0)},
    "histograms": {"0": _replica_page(latency_obs=(0.05, 0.05, 5.0)),
                   "1": _replica_page(latency_obs=(0.3,))},
    "type_conflict": {"0": _replica_page(), "1": _CONFLICT},
    "unparseable": {"0": _replica_page(), "1": "}{ not an exposition \x00"},
    "preexisting_label": {"7": f"{_HELP} m x\n{_TYPE} m counter\n" 'm{replica="sneaky"} 1\n'},
    **{f"fuzz{seed}": _fuzz_pages(seed) for seed in range(6)},
}


@pytest.mark.parametrize("case", sorted(_PAGES))
def test_merge_expositions_equals_the_references(case):
    ours = fleet.merge_expositions(_PAGES[case])
    assert ours == jax_fleet.merge_expositions(_PAGES[case])
    assert validate_exposition(ours[0]) == []


def test_fleet_rollup_equals_the_references():
    pages = {"0": _replica_page(device=1.5, requests=4, errors=1, model="cheap"),
             "1": _replica_page(device=2.5, requests=6, errors=0),
             "2": _replica_page(device=9.0, model="costly")}
    parsed = {k: parse_exposition(v) for k, v in pages.items()}
    exemplars = {"2": [{"metric": "dks_tenant_latency_seconds", "labels": {"model": "costly"},
                        "le": "+Inf", "trace_id": "ab" * 16, "value": 3.0, "ts": 1.0}]}
    meta = {k: {"address": f"127.0.0.1:{9000 + int(k)}", "state": "ready", "scraped": True}
            for k in pages}
    ours = fleet.fleet_rollup(parsed, exemplars=exemplars, replica_meta=meta, now=123.0)
    assert ours == jax_fleet.fleet_rollup(parsed, exemplars=exemplars, replica_meta=meta, now=123.0)
    assert ours["tenants"]["alpha"]["device_seconds"] == pytest.approx(2.5)


# --------------------------------------------------------------------- #
# hedging and supervision: the same inputs, the same numbers


def test_latency_quantiles_and_hedge_delays_equal_the_references():
    rng = np.random.default_rng(0)
    ours, theirs = hedging.LatencyQuantiles(window=64), jax_hedging.LatencyQuantiles(window=64)
    for klass, s in zip(rng.choice(["interactive", "batch"], 300), rng.exponential(0.05, 300)):
        ours.observe(str(klass), float(s))
        theirs.observe(str(klass), float(s))
    for klass in ("interactive", "batch", "absent"):
        for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
            assert ours.quantile(klass, q) == theirs.quantile(klass, q)
        assert ours.count(klass) == theirs.count(klass)
    for kw in ({}, {"quantile": 0.5, "min_delay_s": 0.01}, {"min_samples": 0},
               {"min_samples": 1000, "initial_delay_s": 0.3}):
        for klass in ("interactive", "absent"):
            assert hedging.HedgePolicy(**kw).delay_for(ours, klass) == \
                jax_hedging.HedgePolicy(**kw).delay_for(theirs, klass)


@pytest.mark.parametrize("kw", [{"seed": 0}, {"seed": 7, "base_backoff_s": 0.1,
                                              "max_backoff_s": 2.0, "jitter_frac": 0.5}])
def test_the_restart_backoff_schedule_equals_the_references(kw):
    ours, theirs = supervisor.RestartPolicy(**kw), jax_supervisor.RestartPolicy(**kw)
    assert [ours.delay(n) for n in range(1, 12)] == [theirs.delay(n) for n in range(1, 12)]


# --------------------------------------------------------------------- #
# the autoscaler: one scripted signal sequence and clock through both


class _Fleet:
    def __init__(self, proxy):
        self.proxy, self.spawned, self.retired = proxy, [], []

    def spawn_replica(self, standby=False):
        index = self.proxy.add_target("127.0.0.1", 90 + len(self.proxy.replicas),
                                      standby=standby)
        self.spawned.append((index, standby))
        return index

    def retire_replica(self, index):
        self.retired.append(index)
        self.proxy.finish_drain(index)


#: per tick: each replica's /statusz detail (queued interactive requests,
#: rows served so far) and which warming replicas the prober admits
_SCRIPT = ([(0, 100)] * 2 + [(40, 200), (60, 300), (60, 400)] + [(0, 400)] * 3
           + [(0, 400)] * 8)


def _run_scaler(replicas_mod, autoscaler_mod, monkeypatch):
    clock = {"t": 1000.0}
    monkeypatch.setattr(autoscaler_mod, "time", types.SimpleNamespace(
        monotonic=lambda: clock["t"], time=lambda: clock["t"], sleep=time.sleep))
    proxy = replicas_mod.FanInProxy([("127.0.0.1", 1)], probe_interval_s=3600,
                                    health_interval_s=0)
    fleet_ = _Fleet(proxy)
    cfg = autoscaler_mod.AutoscalerConfig(
        min_replicas=1, max_replicas=3, interval_s=0.05, up_ticks=1, down_ticks=3,
        up_cooldown_s=1.0, down_cooldown_s=1.0, drain_settle_polls=2)
    scaler = autoscaler_mod.Autoscaler(fleet_, proxy, config=cfg)
    scaler.estimator.observe(100, 1.0)
    trace = []
    for queued, rows in _SCRIPT:
        detail = {"queue_depths": {"interactive": queued}, "in_flight_batches": 0,
                  "service_rate_rows_per_s": 100.0, "rows_served_total": rows,
                  "projected_wait_s": {"interactive": queued / 100.0}}
        scaler._replica_detail = lambda r, d=detail: dict(d)
        sig = scaler.tick()
        for r in proxy.replicas:  # the prober admits what finished warming
            if r.warming and not r.retired:
                r.warming, r.alive = False, True
        trace.append((dict(scaler._last_decision, t=None),
                      {k: v for k, v in sig.items() if not k.startswith("rate_")},
                      proxy.replica_state_counts(), list(fleet_.spawned), list(fleet_.retired)))
        clock["t"] += 0.5
    return trace


def test_the_autoscalers_decisions_equal_the_references(monkeypatch):
    ours = _run_scaler(replicas, autoscaler, monkeypatch)
    theirs = _run_scaler(jax_replicas, jax_autoscaler, monkeypatch)
    assert ours == theirs
    actions = [d["action"] for d, *_ in ours]
    assert "scale_up" in actions and "scale_down" in actions
    assert ours[-1][4], "the drained replica was never retired"


# --------------------------------------------------------------------- #
# the fan-in's retry, 502, 503 and 429 paths, against the reference
# tests' fake replicas, through both proxies


class _DropReplica:
    """Reads the request, then closes the connection without answering
    (a replica dying mid-request)."""

    def __init__(self):
        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                self.close_connection = True
                self.connection.shutdown(socket.SHUT_RDWR)

            do_GET = do_POST

            def log_message(self, fmt, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _dead_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _req(proxy, headers=None):
    status, payload, hdrs = reference_fakes._request_with_headers(proxy.host, proxy.port,
                                                                   headers or {})
    try:
        doc = json.loads(payload)
    except ValueError:
        doc = None
    return status, doc, "Retry-After" in hdrs


def _scenario(name, proxy_cls):
    """Run one fan-in scenario; what the client and the proxy saw."""

    fakes = {
        "retry": lambda: [None, reference_fakes._FakeReplica("ok")],
        "mid_request_502": lambda: [_DropReplica(), reference_fakes._FakeReplica("ok")],
        "demote_503": lambda: [reference_fakes._FakeReplica("wedged"),
                               reference_fakes._FakeReplica("ok")],
        "all_wedged_503": lambda: [reference_fakes._FakeReplica("wedged")],
        "saturated_429": lambda: [reference_fakes._SchedFakeReplica("saturated"),
                                  reference_fakes._SchedFakeReplica("echo")],
        "rate_limited_429": lambda: [reference_fakes._SchedFakeReplica("rate_limited", "3"),
                                     reference_fakes._SchedFakeReplica("echo")],
        "batch_class_429": lambda: [reference_fakes._SchedFakeReplica("batch_saturated", "30")],
    }[name]()
    ports = [f.port if f is not None else _dead_port() for f in fakes]
    proxy = proxy_cls([("127.0.0.1", p) for p in ports], probe_interval_s=3600).start()
    seen = []
    try:
        if name == "batch_class_429":
            for prio in ("batch", "interactive", "batch"):
                seen.append(_req(proxy, {"X-DKS-Priority": prio}))
        else:
            for _ in range(3):
                seen.append(_req(proxy))
        if name == "saturated_429":
            fakes[1].mode = "saturated"
            seen.append(_req(proxy))
        # replica addresses differ between the two runs
        seen = [(s, json.loads(json.dumps(doc).replace(f"127.0.0.1:{ports[0]}", "<replica 0>"))
                 if doc is not None else None, h) for s, doc, h in seen]
        counters = {m: proxy.metrics.get(m).value() for m in (
            "dks_fanin_forwarded_total", "dks_fanin_replica_errors_total",
            "dks_fanin_retried_connects_total", "dks_fanin_replica_503_demotions_total",
            "dks_fanin_sheds_total")}
        alive = [r.alive for r in proxy.replicas]
        saturated = [r.saturated_any() > time.monotonic() for r in proxy.replicas]
    finally:
        proxy.stop()
        for f in fakes:
            if f is not None:
                f.stop()
    return seen, counters, alive, saturated


@pytest.mark.parametrize("name", ["retry", "mid_request_502", "demote_503", "all_wedged_503",
                                  "saturated_429", "rate_limited_429", "batch_class_429"])
def test_the_fan_in_answers_as_the_references_does(name):
    ours = _scenario(name, FanInProxy)
    assert ours == _scenario(name, jax_replicas.FanInProxy)
    statuses = [s for s, _, _ in ours[0]]
    want = {"retry": 200, "mid_request_502": 502, "demote_503": 200, "all_wedged_503": 503,
            "saturated_429": 429, "rate_limited_429": 429, "batch_class_429": 429}[name]
    assert want in statuses


# --------------------------------------------------------------------- #
# device pinning, pods, the CLI's refusals


@pytest.mark.parametrize("index,visible,n_cards,want", [
    (0, None, 1, "0"), (1, None, 1, "0"), (3, None, 2, "1"), (2, "4,5,6", 8, "6"),
    (4, "4,5,6", 8, "5"), (0, None, 0, None), (1, "", 1, None),
])
def test_replica_k_is_pinned_to_card_k_mod_n(monkeypatch, index, visible, n_cards, want):
    monkeypatch.setattr(replicas, "_visible_card_count", lambda: n_cards)
    assert _pinned_card(index, visible) == want


def test_pod_replica_units_name_the_multi_gpu_item(monkeypatch):
    """A pod unit spawns P ``serving.main --coordinator`` members on a fresh
    coordinator port: the lead on the unit's probed port, each follower on
    its own, member k of pod i on card (i·P + k) mod n.  (Real pods:
    ``tests/test_torch_port_pod_serving.py``.)"""

    spawned = []

    class FakePopen:
        def __init__(self, argv, env):
            spawned.append((argv, env))
            self.pid, self.returncode = 1000 + len(spawned), None

        def poll(self):
            return self.returncode

    monkeypatch.setattr(replicas.subprocess, "Popen", FakePopen)
    monkeypatch.setattr(replicas, "_visible_card_count", lambda: 3)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    mgr = ReplicaManager(2, factory=CPU_FACTORY, pod_processes=2, pipeline_depth=2,
                         env_extra={"X_EXTRA": "1"})
    mgr.ports = mgr._reserve_ports()
    pod = mgr._spawn(1)
    assert isinstance(pod, replicas._PodProcess) and len(pod.members) == 2
    assert pod.pid == pod.members[0].pid
    coords, ports = set(), []
    for k, (argv, env) in enumerate(spawned):
        opt = {argv[i]: argv[i + 1] for i in range(3, len(argv) - 1, 2)}
        assert argv[1:3] == ["-m", "distributedkernelshap_tpu_torch.serving.main"]
        assert opt["--num_processes"] == "2" and opt["--process_id"] == str(k)
        assert opt["--factory"] == CPU_FACTORY and opt["--pipeline_depth"] == "2"
        assert env["CUDA_VISIBLE_DEVICES"] == str((1 * 2 + k) % 3)
        assert env["DKS_REPLICA_INDEX"] == "1" and env["X_EXTRA"] == "1"
        coords.add(opt["--coordinator"])
        ports.append(int(opt["--port"]))
    assert len(coords) == 1 and coords.pop().startswith("127.0.0.1:")
    assert ports[0] == mgr.ports[1] and ports[1] not in mgr.ports
    # one member's death is the pod's: the survivor is killed
    pod.members[1].returncode = 3
    pod.members[0].kill = lambda: setattr(pod.members[0], "returncode", -9)
    assert pod.poll() == 3 and pod.members[0].returncode == -9


@pytest.mark.parametrize("argv,raises", [
    (["--pod_procs", "2", "--replica_procs", "1", "--lockstep"], SystemExit),
    (["--coordinator", "127.0.0.1:1234"], SystemExit),
    (["--replica_procs", "2", "--checkpoint", "x.pkl"], SystemExit),
    (["--replica_procs", "2", "--exact"], SystemExit),
    (["--pod_procs", "2"], SystemExit),
    (["--num_processes", "2"], SystemExit),
    (["--replicate_results", "--lockstep"], SystemExit),
])
def test_the_cli_refuses_what_it_cannot_serve(monkeypatch, argv, raises):
    monkeypatch.setattr(sys, "argv", ["serving.main"] + argv)
    with pytest.raises(raises) as info:
        serving_main.main()
    assert info.value.code == 2


# --------------------------------------------------------------------- #
# real worker processes


def _worker_argv(factory, port):
    return [sys.executable, "-m", "distributedkernelshap_tpu_torch.serving.replica_worker",
            "--factory", factory, "--host", "127.0.0.1", "--port", str(port)]


def test_a_worker_that_asks_for_a_card_fails_and_the_supervisor_counts_it():
    """No fallback at the fleet's level: on a host without a card the
    worker exits non-zero with the port's device error, and the
    supervisor books the exit as a crash (backing off before a
    restart)."""

    env = dict(os.environ, **WORKER_ENV)
    procs = [subprocess.Popen(_worker_argv(CARD_FACTORY, _dead_port()), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    sup = supervisor.ReplicaSupervisor(
        procs, spawn=lambda i: pytest.fail("restarted inside the backoff"),
        policy=supervisor.RestartPolicy(base_backoff_s=60.0, max_backoff_s=60.0, seed=0),
        poll_interval_s=0.05).start()
    try:
        out = procs[0].communicate(timeout=120)[0].decode()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and 0 not in sup._respawn_at:
            time.sleep(0.05)
        assert procs[0].returncode not in (0, None)
        assert "no CUDA device is available" in out
        assert sup._consecutive.get(0) == 1 and 0 in sup._respawn_at
        assert sup.stats()["restarts_total"] == 0
    finally:
        sup.stop()


def _fixture_rows(n):
    return chip_smoke.adult_fixture()["X"][:n]


def _explain(port, rows):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/explain", body=wire.encode_request(rows),
                     headers={"Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _fixture_phi_ok(body, rows):
    fx = chip_smoke.adult_fixture()
    phi = np.stack(wire.decode_explanation(body)["shap_values"], 1)
    return bool(chip_smoke._fixture_ok(phi, fx, rows)[1].all())


@pytest.fixture(scope="module")
def cpu_fleet():
    mgr = ReplicaManager(2, factory=CPU_FACTORY, env_extra=WORKER_ENV, max_batch_size=8,
                         pipeline_depth=2, startup_timeout_s=120.0,
                         restart_policy=supervisor.RestartPolicy(base_backoff_s=0.2, seed=0))
    mgr.start()
    try:
        yield mgr
    finally:
        mgr.stop()
        for p in mgr.procs:
            assert p.poll() is not None


def test_the_fleet_answers_through_the_proxy_from_both_replicas(cpu_fleet):
    X = _fixture_rows(40)
    results = [_explain(cpu_fleet.proxy.port, X[i:i + 4]) for i in range(0, 40, 4)]
    assert all(s == 200 for s, _ in results)
    assert all(_fixture_phi_ok(b, slice(i * 4, i * 4 + 4)) for i, (_, b) in enumerate(results))
    conn = http.client.HTTPConnection("127.0.0.1", cpu_fleet.proxy.port, timeout=60)
    conn.request("GET", "/metrics?federate=1")
    fed = conn.getresponse().read().decode()
    conn.close()
    assert validate_exposition(fed) == []
    served = {}
    for line in fed.splitlines():
        if line.startswith("dks_serve_requests_total{"):
            rep = line.split('replica="', 1)[1].split('"', 1)[0]
            served[rep] = served.get(rep, 0) + float(line.rsplit(" ", 1)[1])
    assert set(served) == {"0", "1"} and min(served.values()) >= 1
    assert not [ln for ln in fed.splitlines()
                if ln.startswith("dks_compile_total{") and 'kind="fresh"' in ln]


def test_a_killed_replica_fails_only_its_in_flight_requests_and_restarts(cpu_fleet):
    port = cpu_fleet.proxy.port
    X = _fixture_rows(160)
    victim = cpu_fleet.procs[0]
    address = cpu_fleet.proxy.replicas[0].address
    done, results = [], [None] * 40

    def one(i):
        results[i] = _explain(port, X[4 * i:4 * i + 4])
        done.append(i)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(40)]
    for i, t in enumerate(threads):
        t.start()
        if i == 16:
            os.kill(victim.pid, signal.SIGKILL)
    for t in threads:
        t.join(120)
    failed = [(s, b) for s, b in results if s != 200]
    assert all(s == 502 and address.encode() in b for s, b in failed)
    assert len(failed) <= 16
    assert all(_fixture_phi_ok(b, slice(4 * i, 4 * i + 4))
               for i, (s, b) in enumerate(results) if s == 200)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and not (
            cpu_fleet.procs[0] is not victim and cpu_fleet.proxy.replicas[0].alive):
        time.sleep(0.1)
    assert cpu_fleet.proxy.replicas[0].alive and cpu_fleet.procs[0] is not victim
    assert cpu_fleet.supervisor.stats()["restarts_total"] == 1
    assert _explain(port, X[:4])[0] == 200


def test_the_cli_serves_a_replica_fleet_and_stops_on_sigterm():
    port = _dead_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributedkernelshap_tpu_torch.serving.main",
         "--replica_procs", "2", "--factory", CPU_FACTORY, "--host", "127.0.0.1",
         "--port", str(port), "--max_batch_size", "4", "--pipeline_depth", "2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    workers = set()
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            workers |= chip_smoke._children(proc.pid)
            assert proc.poll() is None, proc.stdout.read().decode()[-2000:]
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                conn.request("GET", "/healthz")
                if conn.getresponse().status == 200:
                    break
            except OSError:
                pass
            time.sleep(0.1)
        workers |= chip_smoke._children(proc.pid)
        status, body = _explain(port, _fixture_rows(2))
        assert status == 200 and _fixture_phi_ok(body, slice(0, 2))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert len(workers) == 2 and not any(chip_smoke._pid_alive(p) for p in workers)


# --------------------------------------------------------------------- #
# the new modules define the reference modules' public names


@pytest.mark.parametrize("ours", [
    "registry.registry", "resilience.journal", "resilience.hedging", "resilience.supervisor",
    "observability.fleet", "serving.replicas", "serving.replica_worker", "serving.autoscaler",
])
def test_each_new_module_defines_the_references_public_names(ours):
    import importlib

    def public(name):
        mod = importlib.import_module(name)
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and not isinstance(v, types.ModuleType)
                and getattr(v, "__module__", name) == name}

    assert public(f"distributedkernelshap_tpu_torch.{ours}") == \
        public(f"distributedkernelshap_tpu.{ours}")


# --------------------------------------------------------------------- #
# repair: a deployment that asks for "cuda" without an index


def test_an_index_less_cuda_device_resolves_to_one_the_server_can_bind(monkeypatch):
    """A replica factory asks for ``device="cuda"``.  The engine's device
    must carry an index, or every server thread's ``bind_device``
    (``torch.cuda.set_device``) raises and the worker warms forever."""

    import torch
    from torch._utils import _get_device_index

    from distributedkernelshap_tpu_torch.serving.server import bind_device
    from distributedkernelshap_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    bound = []
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: bound.append(_get_device_index(d)))
    device = resolve_device("cuda")
    assert device == torch.device("cuda", 0)
    bind_device(device)
    assert bound == [0]
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")
