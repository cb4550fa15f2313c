"""The port's mesh across processes (``parallel/mesh.py``,
``coalition_sharding.py``, ``distributed.py``, ``pipeline.py``): two OS
processes joined by ``torch.distributed`` over gloo on 127.0.0.1, each
laying out its own ``['cpu'] * 2``.

Each case spawns this file twice as a worker (``python <this file> <case>
<rank> <port> <dir>``), with logs in files (a full pipe would stall the
peer inside a collective), a timeout and a kill on every wait; the workers
write their answers to ``.npz`` files and the test compares them:

* the sampled headline (the fixture's Adult-width LR, ``link='logit'``) at
  4×1, 2×2 and 1×4: phi ``array_equal`` across the ranks, within 1e-6 of
  the port's one-process ``['cpu'] * 4`` mesh of the same layout (in fact
  bit-equal: every rank adds the same partials in the same order), within
  ``PHI_ATOL`` of the JAX ``DistributedExplainer`` on four virtual CPU
  devices;
* the exact paths (a scikit-learn GBT): dense with interactions at 1×4,
  packed at 2×2, and a tensor train at 2×1 (one CPU device a rank), each
  bit-equal across ranks, within 1e-6 of the one-process mesh and within
  ``EXACT_ATOL`` of the JAX mesh;
* the rest: ``checkpoint_dir`` warned and ignored, ``resolve_window``
  agreeing under a skewed ``DKS_DISPATCH_WINDOW`` on rank 1, the device-side
  importance and the async path, both serving wires carrying rank 0's
  frame, a ``torchrun``-style launch from the environment, and an explicit
  launch to a dead coordinator raising.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHI_ATOL = 1e-4
EXACT_ATOL = 1e-5
SAME_ATOL = 1e-6
B_SAMPLED, NSAMPLES = 24, 256
SAMPLED_LAYOUTS = (("4x1", 4, 1), ("2x2", 4, 2), ("1x4", 4, 4))
#: (label, n_devices, coalition_parallel, devices a rank, what)
EXACT_LAYOUTS = (("dense 1x4", 4, 4, 2, "dense"), ("packed 2x2", 4, 2, 2, "packed"),
                 ("tensor train 2x1", 2, 1, 1, "tn"))
WAIT_S = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, case, world=2, env_for_rank=None, launch="explicit"):
    """Start ``world`` workers of ``case`` and wait for every one (each wait
    bounded, every process killed on the way out); assert each exited 0."""

    port = _free_port()
    logs = [tmp_path / f"{case}_{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            env = dict(os.environ, PYTHONPATH=REPO)
            env.update((env_for_rank or {}).get(r, {}))
            if launch == "env":
                env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                           WORLD_SIZE=str(world))
            with open(logs[r], "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), case, str(r), str(port),
                     str(tmp_path), launch],
                    cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
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
    return texts


def _load(tmp_path, case, world=2):
    return [dict(np.load(tmp_path / f"{case}_{r}.npz")) for r in range(world)]


# ---------------------------------------------------------------------------
# the problems, shared by the workers and the in-test references


def _fixture_lr(device="cpu"):
    import chip_smoke

    fx = chip_smoke.adult_fixture()
    pred, bg, ctor, fit = chip_smoke._fleet_deployment(device)
    return fx, pred, bg, fit


def _sampled_explainer(opts):
    from distributedkernelshap_tpu_torch import KernelShap

    fx, pred, bg, fit = _fixture_lr()
    ks = KernelShap(pred, link="logit", seed=0, device="cpu", distributed_opts=opts)
    ks.fit(bg, **fit)
    return ks, fx["X"][:B_SAMPLED]


def _gbt():
    from sklearn.ensemble import GradientBoostingRegressor

    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 6))
    y = (2.0 * X[:, 0] + np.where(X[:, 1] > 0, 1.5, -0.5) * X[:, 2]
         + 0.1 * rng.normal(size=300))
    model = GradientBoostingRegressor(n_estimators=8, max_depth=3, random_state=0).fit(X, y)
    X = X.astype(np.float32)
    return model.predict, X[:10], X[50:63]


def _tt_problem():
    rng = np.random.default_rng(7)
    M, r = 8, 4
    dims = [1] + [r] * (M - 1) + [1]
    scale = 1.0 / np.sqrt(r)
    crng = np.random.default_rng(1)
    cores = [(crng.normal(scale=scale, size=(dims[i], dims[i + 1])).astype(np.float32),
              crng.normal(scale=0.3 * scale, size=(dims[i], dims[i + 1])).astype(np.float32))
             for i in range(M)]
    bg = rng.normal(size=(16, M)).astype(np.float32)[:13]
    X = rng.normal(size=(5, M)).astype(np.float32)
    return cores, bg, X


def _exact_run(what, opts):
    """``(phi, interactions or None, raw predictions)`` of one exact path on
    the mesh ``opts`` (``devices`` in it are this process's)."""

    from distributedkernelshap_tpu_torch import EngineConfig
    from distributedkernelshap_tpu_torch.kernel_shap import KernelExplainerEngine
    from distributedkernelshap_tpu_torch.ops.explain import ShapConfig
    from distributedkernelshap_tpu_torch.parallel.distributed import DistributedExplainer

    opts = {**opts, "algorithm": "kernel_shap"}
    if what == "tn":
        from distributedkernelshap_tpu_torch.models.tensor_net import TensorTrainPredictor

        cores, bg, X = _tt_problem()
        pred, config = TensorTrainPredictor(cores, device="cpu"), EngineConfig(device="cpu")
    else:
        pred, bg, X = _gbt()
        config = EngineConfig(device="cpu", shap=ShapConfig(pack_paths=(what == "packed")))
    dist = DistributedExplainer(opts, KernelExplainerEngine, (pred, bg),
                                {"link": "identity", "seed": 0, "config": config})
    inter = what == "dense"
    phi = np.asarray(dist.get_explanation(X, nsamples="exact", interactions=inter))
    inters = (np.stack(dist.last_interaction_values, 1) if inter else None)
    return phi, inters, np.asarray(dist.last_raw_prediction), dist


# ---------------------------------------------------------------------------
# workers (run as ``python <this file> <case> <rank> <port> <dir> <launch>``)


def _join(rank, port, launch):
    from distributedkernelshap_tpu_torch.parallel.mesh import (
        collective_backend,
        initialize_multihost,
        process_count,
    )

    if launch == "env":
        initialize_multihost(timeout_s=60)
    else:
        initialize_multihost(f"127.0.0.1:{port}", 2, rank, timeout_s=60)
    assert process_count() == 2 and collective_backend() == "gloo"


def worker_sampled(rank, out):
    res = {}
    for label, n, cp in SAMPLED_LAYOUTS:
        ks, X = _sampled_explainer({"n_devices": n, "coalition_parallel": cp,
                                    "devices": ["cpu"] * 2})
        mesh = ks._explainer.mesh
        assert mesh.shape == {"data": n // cp, "coalition": cp}
        assert sorted(mesh.local_entries()) == sorted(
            (i, j) for i in range(n // cp) for j in range(cp)
            if (i * cp + j) // 2 == rank)
        expl = ks.explain(X, nsamples=NSAMPLES, l1_reg=False, silent=True)
        res[label] = np.stack(expl.shap_values, 1)
        res[label + " raw"] = np.asarray(expl.data["raw"]["raw_prediction"])
    np.savez(out / f"sampled_{rank}.npz", **res)


def worker_exact(rank, out):
    res = {}
    for label, n, cp, per_rank, what in EXACT_LAYOUTS:
        phi, inter, raw, _ = _exact_run(what, {"n_devices": n, "coalition_parallel": cp,
                                               "devices": ["cpu"] * per_rank})
        res[label] = phi
        res[label + " raw"] = raw
        if inter is not None:
            res[label + " inter"] = inter
    np.savez(out / f"exact_{rank}.npz", **res)


def worker_misc(rank, out):
    import logging

    from distributedkernelshap_tpu_torch.parallel import pipeline as pl

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logging.getLogger("distributedkernelshap_tpu_torch").addHandler(Keep())
    opts = {"n_devices": 4, "coalition_parallel": 2, "devices": ["cpu"] * 2,
            "batch_size": 4, "checkpoint_dir": str(out / f"journal_{rank}")}
    ks, X = _sampled_explainer(opts)
    dist = ks._explainer
    window = pl.resolve_window(None, n_items=8)
    phi = np.stack(ks.explain(X, nsamples=NSAMPLES, l1_reg=False, silent=True).shap_values, 1)
    importance = dist.get_importance(X, nsamples=NSAMPLES)
    rep, _ = _sampled_explainer({"n_devices": 4, "devices": ["cpu"] * 2,
                                 "replicate_results": True})
    rdist = rep._explainer
    fast = rdist.takes_async_fast_path(8, nsamples=NSAMPLES, l1_reg=False)
    values, info = rdist.get_explanation_async(X[:8], nsamples=NSAMPLES, l1_reg=False)()
    from distributedkernelshap_tpu_torch.serving.multihost import (
        CollectiveTransport,
        KVStoreTransport,
        _default_transport,
    )

    frame = np.arange(7, dtype=np.float32) + 100 * rank
    wires = [type(_default_transport()).__name__]
    for wire in (CollectiveTransport(), KVStoreTransport()):
        wires.append(wire.broadcast(frame, is_source=(rank == 0)))
    np.savez(out / f"misc_{rank}.npz", phi=phi, importance=importance,
             default_wire=wires[0], collective_frame=wires[1], kv_frame=wires[2],
             async_phi=np.stack(values, 1), window=window, fast=fast,
             journal_none=dist.last_journal_stats is None,
             journal_dir=os.path.exists(out / f"journal_{rank}"),
             warned=any("checkpoint_dir is single-process only" in m for m in records),
             skew=any("differs from rank 0's" in m for m in records))


# ---------------------------------------------------------------------------
# the tests


@pytest.fixture(scope="module")
def sampled(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sampled")
    _run_ranks(tmp, "sampled")
    return _load(tmp, "sampled")


@pytest.mark.parametrize("label,n,cp", SAMPLED_LAYOUTS, ids=[s[0] for s in SAMPLED_LAYOUTS])
def test_sampled_headline_across_two_processes(sampled, label, n, cp):
    from distributedkernelshap_tpu import KernelShap as JaxKernelShap
    from distributedkernelshap_tpu.models import LinearPredictor as JaxLinear

    r0, r1 = sampled
    np.testing.assert_array_equal(r0[label], r1[label])
    np.testing.assert_array_equal(r0[label + " raw"], r1[label + " raw"])
    ks, X = _sampled_explainer({"n_devices": n, "coalition_parallel": cp,
                                "devices": ["cpu"] * 4})
    one = np.stack(ks.explain(X, nsamples=NSAMPLES, l1_reg=False, silent=True).shap_values, 1)
    np.testing.assert_allclose(r0[label], one, rtol=0, atol=SAME_ATOL)
    fx, pred, bg, fit = _fixture_lr()
    W, b, _ = pred.linear_decomposition
    jks = JaxKernelShap(JaxLinear(W.numpy(), b.numpy(), activation="softmax"), link="logit",
                        seed=0, distributed_opts={"n_devices": n, "coalition_parallel": cp})
    jks.fit(bg, **fit)
    want = np.stack(jks.explain(X, nsamples=NSAMPLES, l1_reg=False, silent=True).shap_values, 1)
    np.testing.assert_allclose(r0[label], want, rtol=0, atol=PHI_ATOL)


@pytest.fixture(scope="module")
def exact(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("exact")
    _run_ranks(tmp, "exact")
    return _load(tmp, "exact")


def _jax_exact(what, n, cp):
    from distributedkernelshap_tpu.kernel_shap import KernelExplainerEngine as JaxEngine
    from distributedkernelshap_tpu.parallel.distributed import DistributedExplainer as JaxDist

    opts = {"n_devices": n, "coalition_parallel": cp, "algorithm": "kernel_shap"}
    if what == "tn":
        from distributedkernelshap_tpu.models.tensor_net import TensorTrainPredictor as JaxTT

        cores, bg, X = _tt_problem()
        pred = JaxTT(cores)
    else:
        pred, bg, X = _gbt()
    dist = JaxDist(opts, JaxEngine, (pred, bg), {"link": "identity", "seed": 0})
    inter = what == "dense"
    phi = np.asarray(dist.get_explanation(X, nsamples="exact", interactions=inter))
    return phi, (np.stack([np.asarray(v) for v in dist.last_interaction_values], 1)
                 if inter else None)


@pytest.mark.parametrize("label,n,cp,per_rank,what", EXACT_LAYOUTS,
                         ids=[e[0] for e in EXACT_LAYOUTS])
def test_exact_paths_across_two_processes(exact, label, n, cp, per_rank, what):
    r0, r1 = exact
    for key in [k for k in r0 if k.startswith(label)]:
        np.testing.assert_array_equal(r0[key], r1[key])
    phi, inter, raw, dist = _exact_run(what, {"n_devices": n, "coalition_parallel": cp,
                                              "devices": ["cpu"] * n})
    np.testing.assert_allclose(r0[label], phi, rtol=0, atol=SAME_ATOL)
    np.testing.assert_allclose(r0[label + " raw"], raw, rtol=0, atol=SAME_ATOL)
    jax_phi, jax_inter = _jax_exact(what, n, cp)
    np.testing.assert_allclose(r0[label], jax_phi, rtol=0, atol=EXACT_ATOL)
    if inter is not None:
        np.testing.assert_allclose(r0[label + " inter"], inter, rtol=0, atol=SAME_ATOL)
        np.testing.assert_allclose(r0[label + " inter"], jax_inter, rtol=0, atol=EXACT_ATOL)
        np.testing.assert_allclose(r0[label + " inter"].sum(-1).reshape(r0[label].shape),
                                   r0[label], atol=EXACT_ATOL)
    assert dist.kernel_path["exact_phi"] == ("tn_dp" if what == "tn" else "plain")


@pytest.fixture(scope="module")
def misc(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("misc")
    _run_ranks(tmp, "misc", env_for_rank={0: {"DKS_DISPATCH_WINDOW": "2"},
                                         1: {"DKS_DISPATCH_WINDOW": "5"}}, launch="env")
    return _load(tmp, "misc")


def test_checkpoint_dir_is_warned_and_ignored_across_processes(misc):
    for r in misc:
        assert bool(r["warned"]) and bool(r["journal_none"]) and not bool(r["journal_dir"])
    np.testing.assert_array_equal(misc[0]["phi"], misc[1]["phi"])
    ks, X = _sampled_explainer({"n_devices": 4, "coalition_parallel": 2,
                                "devices": ["cpu"] * 4, "batch_size": 4})
    one = np.stack(ks.explain(X, nsamples=NSAMPLES, l1_reg=False, silent=True).shap_values, 1)
    np.testing.assert_allclose(misc[0]["phi"], one, rtol=0, atol=SAME_ATOL)


def test_resolve_window_takes_rank_0s_under_a_skewed_env(misc):
    assert int(misc[0]["window"]) == int(misc[1]["window"]) == 2
    assert not bool(misc[0]["skew"]) and bool(misc[1]["skew"])


def test_importance_and_async_agree_across_processes(misc):
    np.testing.assert_array_equal(misc[0]["importance"], misc[1]["importance"])
    np.testing.assert_allclose(misc[0]["importance"],
                               np.abs(misc[0]["phi"]).mean(0), rtol=0, atol=EXACT_ATOL)
    for r in misc:
        assert bool(r["fast"])
    np.testing.assert_array_equal(misc[0]["async_phi"], misc[1]["async_phi"])
    np.testing.assert_allclose(misc[0]["async_phi"], misc[0]["phi"][:8], rtol=0, atol=PHI_ATOL)


def test_both_wires_carry_rank_0s_frame(misc):
    want = np.arange(7, dtype=np.float32)
    for r in misc:
        assert str(r["default_wire"]) == "KVStoreTransport"
        np.testing.assert_array_equal(r["collective_frame"], want)
        np.testing.assert_array_equal(r["kv_frame"], want)


def test_an_explicit_launch_to_a_dead_coordinator_raises():
    import torch

    from distributedkernelshap_tpu_torch.parallel.mesh import initialize_multihost

    with pytest.raises(RuntimeError):
        initialize_multihost(f"127.0.0.1:{_free_port()}", 2, 1, timeout_s=1.0)
    assert not torch.distributed.is_initialized()


def test_device_mesh_lays_out_every_rank_process_major():
    from distributedkernelshap_tpu_torch.parallel.mesh import mesh_from_lists

    lists = [["cpu", "cpu"], ["cpu", "cpu"]]
    m = mesh_from_lists(lists, rank=1, n_devices=4, coalition_parallel=4)
    assert m.shape == {"data": 1, "coalition": 4} and m.owners.tolist() == [[0, 0, 1, 1]]
    assert m.local_entries() == [(0, 2), (0, 3)] and not m.leads(0)
    assert m.coalition_spans_processes and m.multiprocess
    m2 = mesh_from_lists(lists, rank=0, n_devices=4, coalition_parallel=2)
    assert m2.owners.tolist() == [[0, 0], [1, 1]] and not m2.coalition_spans_processes
    assert m2.local_entries() == [(0, 0), (0, 1)] and m2.leads(0) and not m2.leads(1)
    m3 = mesh_from_lists([["cuda:0"], ["cuda:0"]], rank=0)
    assert m3.shape == {"data": 2, "coalition": 1} and m3.distinct_devices == [m3.device(0)]


if __name__ == "__main__":
    import pathlib

    case, rank, port, out, launch = sys.argv[1:6]
    sys.path.insert(0, REPO)
    _join(int(rank), int(port), launch)
    {"sampled": worker_sampled, "exact": worker_exact, "misc": worker_misc}[case](
        int(rank), pathlib.Path(out))
