"""The port's pod serving fabric (``serving/multihost.py``) over real
processes on the CPU: two processes joined by ``torch.distributed`` (gloo
on 127.0.0.1, the ``TCPStore`` wire), and a replica fleet whose unit is a
two-process pod (``serving/replicas.py``, ``serving/main.py
--coordinator``).

The serving cases are those of ``tests/test_multihost.py:_serve_tiny`` /
``_serve_tiny_pipelined``: a direct sharded explain first on both
processes, then ``serve_multihost``; the lead serves 8 rows over HTTP, the
follower joins each device call; served phi must equal the direct explain
within 1e-5, lock-step (``replicate_results=False``) and pipelined (depth
3, one row a request).  Workers log to files, every wait has a timeout and
every process is killed on the way out.
"""

import http.client
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVED_ATOL = 1e-5
N_DEVICES = 4
WAIT_S = 150
CPU_FACTORY = "chip_smoke:fleet_factory_cpu"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pod(tmp_path, case):
    port = _free_port()
    logs = [tmp_path / f"{case}_{r}.log" for r in range(2)]
    procs = []
    try:
        for r in range(2):
            with open(logs[r], "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), case, str(r), str(port),
                     str(tmp_path)],
                    cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                    stdout=log, stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=WAIT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    texts = [log.read_text(errors="replace") for log in logs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {case} failed:\n{texts[r][-3000:]}"
    return np.load(tmp_path / f"{case}.npz")


def serve_worker(case, out):
    """The tiny serving problem of the reference's two-process test."""

    from distributedkernelshap_tpu_torch import KernelShap
    from distributedkernelshap_tpu_torch.models.predictors import LinearPredictor
    from distributedkernelshap_tpu_torch.serving import client as cl
    from distributedkernelshap_tpu_torch.serving.multihost import (
        MultihostServingModel,
        PipelinedMultihostServingModel,
        serve_multihost,
    )

    rng = np.random.default_rng(0)
    D, K, N = 6, 3, 12
    W = rng.normal(size=(D, K)).astype(np.float32)
    bg = rng.normal(size=(N, D)).astype(np.float32)
    X = rng.normal(size=(8, D)).astype(np.float32)
    pred = LinearPredictor(W, np.zeros(K, np.float32), "softmax", device="cpu")
    pipelined = case == "pipelined"
    opts = {"n_devices": N_DEVICES, "devices": ["cpu"] * 2, "replicate_results": pipelined}
    explain_kwargs = {"nsamples": 64, "l1_reg": False}
    # the direct sharded explain FIRST, on every process at once: after
    # the followers leave, a sharded explain on the lead would be peerless
    ex = KernelShap(pred, link="identity", seed=0, device="cpu", distributed_opts=opts)
    ex.fit(bg)
    direct = np.stack(ex.explain(X, silent=True, **explain_kwargs).shap_values, 1)
    srv = serve_multihost(pred, bg, {"link": "identity", "seed": 0, "device": "cpu"}, {},
                          opts, host="127.0.0.1", port=0,
                          max_batch_size=1 if pipelined else 4, max_rows=16,
                          pipeline_depth=3 if pipelined else None,
                          explain_kwargs=explain_kwargs, warmup=False)
    if srv is None:
        return  # follower: released by the shutdown broadcast
    try:
        want = PipelinedMultihostServingModel if pipelined else MultihostServingModel
        assert type(srv.model) is want, type(srv.model)
        assert srv.pipeline_depth == (3 if pipelined else 1)
        payloads = cl.distribute_requests(f"http://127.0.0.1:{srv.port}/explain", X,
                                          max_workers=8 if pipelined else 4)
        phi = np.stack([np.asarray(json.loads(p)["data"]["shap_values"])[:, 0]
                        for p in payloads])
        status, page = _get(srv.port, "/metrics")
        _, debugz = _get(srv.port, "/debugz")
    finally:
        clean = srv.model.drain_and_shutdown(srv, grace_s=30)
    frames = [e for e in json.loads(debugz)["events"] if e["kind"] == "pod_frame"]
    np.savez(out / f"{case}.npz", served=phi, direct=direct, clean=clean,
             explain_frames=frames[-1]["frames"]["explain"],
             page_has_bytes=b"dks_pod_bcast_bytes_total{" in page)


@pytest.mark.parametrize("case", ["lockstep", "pipelined"])
def test_two_process_serving_matches_the_direct_explain(tmp_path, case):
    got = _run_pod(tmp_path, case)
    np.testing.assert_allclose(got["served"], got["direct"], rtol=0, atol=SERVED_ATOL)
    assert bool(got["clean"]) and int(got["explain_frames"]) >= 1
    assert bool(got["page_has_bytes"])


def _get(port, path, timeout=10):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_a_replica_unit_of_two_processes_serves_and_terminates_cleanly():
    import chip_smoke
    from distributedkernelshap_tpu_torch.serving import wire
    from distributedkernelshap_tpu_torch.serving.replicas import ReplicaManager, _PodProcess

    fx = chip_smoke.adult_fixture()
    mgr = ReplicaManager(1, factory=CPU_FACTORY, pod_processes=2, max_batch_size=4,
                         pipeline_depth=2, startup_timeout_s=120.0, restart=False,
                         env_extra={"PYTHONPATH": REPO})
    mgr.start()
    pod = mgr.procs[0]
    try:
        assert isinstance(pod, _PodProcess) and len(pod.members) == 2
        X = np.asarray(fx["X"][:8], np.float32)
        for i in range(0, 8, 4):
            conn = http.client.HTTPConnection("127.0.0.1", mgr.proxy.port, timeout=120)
            conn.request("POST", "/explain", body=wire.encode_request(X[i:i + 4]),
                         headers={"Content-Type": wire.CONTENT_TYPE,
                                  "Accept": wire.CONTENT_TYPE})
            resp = conn.getresponse()
            status, payload = resp.status, resp.read()
            conn.close()
            assert status == 200, payload[:500]
            phi = np.stack(wire.decode_explanation(payload)["shap_values"], 1)
            assert chip_smoke._fixture_ok(phi, fx, slice(i, i + 4))[1].all()
        assert pod.poll() is None
        # each member's flight recorder (the lead's server, the follower's
        # health listener) counts the same frames
        follower_port = int(pod.members[1].args[pod.members[1].args.index("--port") + 1])
        frames = []
        for port in (mgr.ports[0], follower_port):
            status, body = _get(port, "/debugz")
            assert status == 200
            events = [e for e in json.loads(body)["events"] if e["kind"] == "pod_frame"]
            frames.append(events[-1]["frames"])
        assert frames[0] == frames[1] and frames[0]["explain"] >= 2
    finally:
        t0 = time.monotonic()
        mgr.stop()
        stop_s = time.monotonic() - t0
    assert [m.returncode for m in pod.members] == [0, 0], stop_s
    assert stop_s < 10


if __name__ == "__main__":
    import pathlib

    case, rank, port, out = sys.argv[1:5]
    sys.path.insert(0, REPO)
    from distributedkernelshap_tpu_torch.parallel.mesh import initialize_multihost

    initialize_multihost(f"127.0.0.1:{port}", 2, int(rank), timeout_s=60)
    serve_worker(case, pathlib.Path(out))
