"""The port's one-process mesh (``parallel/mesh.py``,
``parallel/coalition_sharding.py``, ``parallel/distributed.py``) on
``['cpu'] * 8`` against the JAX ``DistributedExplainer`` on the eight
virtual CPU devices of ``tests/conftest.py``.

The cases are those of ``tests/test_distributed.py`` (sequential parity,
slabs, one slab, a ragged batch, coalition parallelism, the
``actor_cpu_fraction`` map, the attribute proxy, ``KernelShap`` end to end,
async vs sync, serving, kernel paths), the sharded exact tree paths (dense,
interactions, packed) and tensor-train path, the journal, the device-cache
bound and the type guard.  Inputs are made from a seed with numpy; the same
inputs and options go to both packages.

Tolerances: sampled phi through the logit link within ``PHI_ATOL`` = 1e-4
of the JAX mesh and of the port's single-device engine (f32 sums in other
orders through the link's amplification; the engine's CPU default takes the
plan-constant route, the mesh the classic one); exact phi and interactions
within ``EXACT_ATOL`` = 1e-5 (the JAX package's own sharded bar); the
reference's bit-identity claims (ROADMAP C.7) are held to ``EXACT_ATOL``
too, never to ``array_equal``, except that a journaled resume restores the
stored arrays bit for bit.
"""

import json
import logging

import numpy as np
import pytest
import torch

from distributedkernelshap_tpu import DenseData as JaxDenseData
from distributedkernelshap_tpu import KernelShap as JaxKernelShap
from distributedkernelshap_tpu.kernel_shap import KernelExplainerEngine as JaxEngine
from distributedkernelshap_tpu.models import LinearPredictor as JaxLinear
from distributedkernelshap_tpu.parallel.distributed import DistributedExplainer as JaxDist
from distributedkernelshap_tpu_torch import DenseData, EngineConfig, KernelShap
from distributedkernelshap_tpu_torch.kernel_shap import KernelExplainerEngine
from distributedkernelshap_tpu_torch.models.predictors import LinearPredictor
from distributedkernelshap_tpu_torch.ops.explain import ShapConfig
from distributedkernelshap_tpu_torch.parallel import mesh as tmesh
from distributedkernelshap_tpu_torch.parallel.distributed import (
    DistributedExplainer,
    invert_permutation,
    kernel_shap_postprocess_fn,
    kernel_shap_target_fn,
)

PHI_ATOL = 1e-4
EXACT_ATOL = 1e-5
CPU = EngineConfig(device="cpu")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    D, K, N, B = 11, 2, 20, 24
    groups = [[0], [1], [2, 3, 4], [5, 6], [7, 8, 9, 10]]
    names = ["a", "b", "c", "d", "e"]
    W = rng.normal(size=(D, K)).astype(np.float32)
    b = rng.normal(size=(K,)).astype(np.float32)
    bg = rng.normal(size=(N, D)).astype(np.float32)
    X = rng.normal(size=(B, D)).astype(np.float32)
    return dict(pred=LinearPredictor(W, b, activation="softmax", device="cpu"),
                jpred=JaxLinear(W, b, activation="softmax"),
                data=DenseData(bg, names, groups), jdata=JaxDenseData(bg, names, groups),
                X=X, groups=groups, names=names, bg=bg)


def _port(s, opts, config=CPU, link="logit"):
    return DistributedExplainer({**opts, "algorithm": "kernel_shap"}, KernelExplainerEngine,
                                (s["pred"], s["data"]),
                                {"link": link, "seed": 0, "config": config})


def _jax(s, opts, link="logit"):
    return JaxDist({**opts, "algorithm": "kernel_shap"}, JaxEngine,
                   (s["jpred"], s["jdata"]), {"link": link, "seed": 0})


def _close(got, want, atol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


# ---------------------------------------------------------------------------
# pure helpers and the mesh


def test_pure_helpers_match_the_reference():
    p = [3, 0, 2, 1]
    np.testing.assert_array_equal(invert_permutation(p), [1, 3, 2, 0])
    out = kernel_shap_postprocess_fn([np.ones((2, 3)), 2 * np.ones((3, 3))])
    assert out.shape == (5, 3) and out[2:].mean() == 2.0
    multi = kernel_shap_postprocess_fn([[np.ones((2, 3)), np.zeros((2, 3))],
                                        [2 * np.ones((1, 3)), np.zeros((1, 3))]])
    assert len(multi) == 2 and multi[0].shape == (3, 3) and multi[0][-1, 0] == 2.0


def test_target_fn_dispatches_an_indexed_work_item(setup):
    engine = KernelExplainerEngine(setup["pred"], setup["data"], link="logit", seed=0,
                                   config=CPU)
    idx, sv = kernel_shap_target_fn(engine, (3, setup["X"][:2]), {"nsamples": 32})
    assert idx == 3 and sv[0].shape == (2, 5)


def test_mesh_shapes_and_multi_process_guard(caplog, monkeypatch):
    cpus = ["cpu"] * 8
    assert tmesh.device_mesh(8, devices=cpus).shape == {"data": 8, "coalition": 1}
    m2 = tmesh.device_mesh(8, coalition_parallel=2, devices=cpus)
    assert m2.shape == {"data": 4, "coalition": 2}
    assert m2.device(3, 1) == torch.device("cpu") and m2.distinct_devices == [torch.device("cpu")]
    with pytest.raises(ValueError):
        tmesh.device_mesh(6, coalition_parallel=4, devices=cpus)
    with caplog.at_level(logging.WARNING, logger=tmesh.__name__):
        assert tmesh.device_mesh(16, devices=cpus).shape["data"] == 8
    assert any("only 8 are attached" in r.message for r in caplog.records)
    assert tmesh.pad_to_multiple(10, 8) == (16, 6)
    assert tmesh.pad_to_multiple(16, 8) == (16, 0)
    # without a coordinator or a torchrun environment: one process, no group
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.initialize_multihost() is None
    assert not torch.distributed.is_initialized()
    assert (tmesh.process_count(), tmesh.process_index(), tmesh.collective_backend()) \
        == (1, 0, None)
    assert m2.owners.tolist() == [[0, 0]] * 4 and not m2.multiprocess
    # an explicit launch needs all three of its arguments and a host:port
    for kw in ({"num_processes": 2},
               {"coordinator_address": "localhost:1234"},
               {"coordinator_address": "localhost", "num_processes": 2, "process_id": 0},
               {"coordinator_address": "localhost:1234", "num_processes": 2,
                "process_id": 2}):
        with pytest.raises(ValueError):
            tmesh.initialize_multihost(**kw)


def test_a_group_of_several_processes_raises_naming_item_10(setup, monkeypatch):
    """A group that already stands is left alone, and the process count and
    rank read from it; the backend rule picks NCCL only for a card a rank."""

    monkeypatch.setattr(torch.distributed, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a, **k: 4)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a, **k: 2)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a, **k: "gloo")
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: pytest.fail("a standing group must be left alone"))
    assert tmesh.initialize_multihost("127.0.0.1:1", 4, 2) is None
    assert (tmesh.process_count(), tmesh.process_index(), tmesh.collective_backend()) \
        == (4, 2, "gloo")
    assert tmesh.choose_backend(["cpu", "cpu"]) == "gloo"
    assert tmesh.choose_backend(["GPU-a", "GPU-a"]) == "gloo"      # one card, two ranks
    assert tmesh.choose_backend(["GPU-a", "cpu"]) == "gloo"
    assert tmesh.choose_backend(["GPU-a", "GPU-b"]) == "nccl"
    assert tmesh.choose_backend(["GPU-a"]) == "nccl"
    # rank 2's view of a 1x8 layout over four ranks of two devices
    m = tmesh.mesh_from_lists([["cpu"] * 2] * 4, rank=2, coalition_parallel=8)
    assert m.local_entries() == [(0, 4), (0, 5)] and not m.leads(0)
    assert m.coalition_spans_processes and m.distinct_devices == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# the sampled path against the JAX mesh

_SAMPLED = {
    "matches_sequential": {"n_devices": 8, "batch_size": None},
    "slabs": {"n_devices": 8, "batch_size": 2},
    "one_slab": {"n_devices": 8, "batch_size": 64},
    "coalition_parallel": {"n_devices": 8, "coalition_parallel": 2},
    "actor_cpu_fraction": {"n_devices": 8, "actor_cpu_fraction": 2.0},
    "gspmd": {"n_devices": 8, "partitioning": "gspmd"},
    "replicate_results": {"n_devices": 4, "replicate_results": True},
}


@pytest.fixture(scope="module")
def sequential(setup):
    seq = KernelExplainerEngine(setup["pred"], setup["data"], link="logit", seed=0,
                                config=CPU)
    return seq.get_explanation(setup["X"], nsamples=64)


@pytest.mark.parametrize("case", sorted(_SAMPLED))
def test_sampled_mesh_matches_the_jax_mesh(setup, sequential, case):
    opts = _SAMPLED[case]
    dist = _port(setup, opts)
    got = dist.get_explanation(setup["X"], nsamples=64)
    want = _jax(setup, opts).get_explanation(setup["X"], nsamples=64)
    assert len(got) == 2 and got[0].shape == (24, 5)
    _close(got, want, PHI_ATOL)
    _close(got, sequential, PHI_ATOL)
    if case in ("coalition_parallel", "actor_cpu_fraction"):
        assert dist.coalition_parallel == 2
        assert dist.mesh.shape == {"data": 4, "coalition": 2}
    # the sampled linear route on CPU tensors: the kernel's plain version
    assert dist.kernel_path == {"ey": "plain"}
    assert dist.last_raw_prediction.shape == (24, 2)


def test_f16_transfer_and_window(setup, sequential):
    dist = _port(setup, {"n_devices": 8, "batch_size": 1, "dispatch_window": 2},
                 config=EngineConfig(device="cpu", shap=ShapConfig(transfer_dtype="float16")))
    assert dist.dispatch_window == 2
    sv = dist.get_explanation(setup["X"], nsamples=64)
    for a, b in zip(sequential, sv):
        assert np.asarray(b).dtype == np.float32
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=2e-3)
    assert dist.last_raw_prediction.dtype == np.float32


def test_ragged_batch_pads_to_the_data_axis(setup):
    got = _port(setup, {"n_devices": 8}).get_explanation(setup["X"][:13], nsamples=64)
    want = _jax(setup, {"n_devices": 8}).get_explanation(setup["X"][:13], nsamples=64)
    assert got[0].shape == (13, 5)
    _close(got, want, PHI_ATOL)


def test_actor_cpu_fraction_warns_degrades_and_yields(setup, caplog):
    logger = "distributedkernelshap_tpu_torch.parallel.distributed"
    with caplog.at_level(logging.WARNING, logger=logger):
        dist = _port(setup, {"n_devices": 8, "actor_cpu_fraction": 0.25})
    assert dist.coalition_parallel == 1
    assert any("actor_cpu_fraction" in r.message for r in caplog.records)
    assert _port(setup, {"n_devices": 8, "actor_cpu_fraction": 3.0}).coalition_parallel == 1
    with pytest.raises(ValueError):
        _port(setup, {"n_devices": 8, "coalition_parallel": 3})
    with pytest.raises(ValueError):
        _port(setup, {"n_devices": 8, "partitioning": "gpsmd"})
    assert _port(setup, {"n_devices": 8, "coalition_parallel": 4,
                         "actor_cpu_fraction": 2.0}).coalition_parallel == 4
    gspmd_cp = _port(setup, {"n_devices": 8, "coalition_parallel": 2,
                             "partitioning": "gspmd"})
    assert gspmd_cp.partitioning == "shard_map"


def test_attribute_proxy_and_staging(setup):
    dist = _port(setup, {"n_devices": 4})
    assert dist.vector_out is True
    assert np.asarray(dist.expected_value).shape == (2,)
    assert dist.return_attribute("M") == 5
    assert dist.stage_rows(setup["X"]) is None


def test_kernel_shap_end_to_end_with_the_references_call(setup):
    # the reference's positional order: (predictor, link, feature_names,
    # categorical_names, task, seed, distributed_opts)
    ex = KernelShap(setup["pred"], "logit", setup["names"], None, "classification", 0,
                    {"n_cpus": 8, "batch_size": None}, device="cpu")
    assert ex.distribute
    ex.fit(setup["bg"], group_names=setup["names"], groups=setup["groups"])
    assert isinstance(ex._explainer, DistributedExplainer)
    explanation = ex.explain(setup["X"], silent=True, nsamples=64)
    sv = explanation.shap_values
    total = np.stack(sv, 1).sum(-1) + np.asarray(explanation.expected_value)[None]
    np.testing.assert_allclose(total, explanation.data["raw"]["raw_prediction"], atol=1e-4)

    jex = JaxKernelShap(setup["jpred"], "logit", setup["names"], None, "classification", 0,
                        {"n_cpus": 8, "batch_size": None})
    jex.fit(setup["bg"], group_names=setup["names"], groups=setup["groups"])
    _close(sv, jex.explain(setup["X"], silent=True, nsamples=64).shap_values, PHI_ATOL)
    # n_devices None in the reference's options: no mesh
    assert not KernelShap(setup["pred"], distributed_opts={"n_devices": None},
                          device="cpu").distribute


def test_distributed_type_guard(setup):
    import pandas as pd

    ex = KernelShap(setup["pred"], distributed_opts={"n_cpus": 2}, device="cpu")
    assert ex.distribute
    ex._fitted = True
    ex._explainer = None
    with pytest.raises(TypeError, match="distributed context"):
        ex.explain(pd.DataFrame(np.zeros((2, 11))))


def test_save_load_keeps_distributed_opts(setup, tmp_path):
    ex = KernelShap(setup["pred"], link="logit", seed=0, device="cpu",
                    distributed_opts={"n_devices": 4, "coalition_parallel": 2,
                                      "batch_size": 3})
    ex.fit(setup["bg"], group_names=setup["names"], groups=setup["groups"])
    want = ex.explain(setup["X"], silent=True, nsamples=64).shap_values
    path = str(tmp_path / "dist.pkl")
    ex.save(path)
    back = KernelShap.load(path, device="cpu")
    assert back.distribute and isinstance(back._explainer, DistributedExplainer)
    assert back.distributed_opts == ex.distributed_opts
    assert back._explainer.mesh.shape == {"data": 2, "coalition": 2}
    _close(back.explain(setup["X"], silent=True, nsamples=64).shap_values, want, 0.0)


def test_async_matches_sync_and_falls_back_on_slabs():
    rng = np.random.default_rng(4)
    D, K, N, B = 7, 2, 12, 16
    W = rng.normal(size=(D, K)).astype(np.float32)
    pred = LinearPredictor(W, np.zeros(K, np.float32), activation="softmax", device="cpu")
    bg = rng.normal(size=(N, D)).astype(np.float32)
    X = rng.normal(size=(B, D)).astype(np.float32)
    for opts, fast in (({"n_devices": 4}, True), ({"n_devices": 4, "batch_size": 2}, False)):
        ex = KernelShap(pred, link="identity", seed=0, distributed_opts=opts, device="cpu")
        ex.fit(bg)
        dist = ex._explainer
        assert dist.takes_async_fast_path(B, nsamples=64, l1_reg=False) is fast
        want = dist.get_explanation(X, nsamples=64, l1_reg=False)
        values, info = dist.get_explanation_async(X, nsamples=64, l1_reg=False)()
        _close(values, want, 1e-6)
        assert info["raw_prediction"].shape == (B, K)
        assert info["expected_value"].shape == (K,)


def test_importance_reduces_on_the_mesh_and_records_the_kernel_path(setup):
    dist = _port(setup, {"n_devices": 8, "batch_size": 2})
    imp = dist.get_importance(setup["X"], nsamples=64)
    want = _jax(setup, {"n_devices": 8, "batch_size": 2}).get_importance(setup["X"],
                                                                       nsamples=64)
    np.testing.assert_allclose(imp, want, atol=PHI_ATOL)
    assert dist.kernel_path == {"ey": "plain"}


def test_device_cache_rekeyed_and_bounded(setup):
    from distributedkernelshap_tpu_torch.ops.coalitions import CoalitionPlan

    def plan(mask):
        mask = np.asarray(mask, np.float32)
        return CoalitionPlan(mask=mask, weights=np.full(mask.shape[0], 1.0 / mask.shape[0],
                                                        np.float32),
                             exact=False, n_enumerated=0)

    dist = _port(setup, {"n_devices": 1})
    dist._device_args(plan(np.eye(5)))
    dist._device_args(plan(np.eye(5)))
    assert len(dist._dev_cache) == 1
    for i in range(dist._DEV_CACHE_MAX_ENTRIES + 4):
        mask = np.eye(5, dtype=np.float32)
        mask[0, 0] = float(i + 2)
        dist._device_args(plan(mask))
    assert len(dist._dev_cache) <= dist._DEV_CACHE_MAX_ENTRIES


def test_journaled_slabs_resume_without_recomputing(setup, tmp_path):
    X = np.tile(setup["X"], (1, 1))          # 24 rows -> 3 slabs at 1 x 8
    opts = {"n_devices": 8, "batch_size": 1, "checkpoint_dir": str(tmp_path)}
    d1 = _port(setup, opts)
    sv1 = d1.get_explanation(X, nsamples=32, l1_reg=False)
    assert d1.last_journal_stats["computed"] == 3 and d1.last_journal_stats["restored"] == 0
    d2 = _port(setup, opts)
    sv2 = d2.get_explanation(X, nsamples=32, l1_reg=False)
    assert d2.last_journal_stats["computed"] == 0 and d2.last_journal_stats["restored"] == 3
    assert all(np.array_equal(a, b) for a, b in zip(sv1, sv2))
    d3 = _port(setup, opts)
    d3.get_explanation(X, nsamples=64, l1_reg=False)
    assert d3.last_journal_stats["restored"] == 0
    _close(sv1, _jax(setup, {"n_devices": 8, "batch_size": 1}).get_explanation(
        X, nsamples=32, l1_reg=False), PHI_ATOL)


# ---------------------------------------------------------------------------
# exact paths: the background over the coalition axis


@pytest.fixture(scope="module")
def gbt():
    from sklearn.ensemble import GradientBoostingRegressor

    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 6))
    y = (2.0 * X[:, 0] + np.where(X[:, 1] > 0, 1.5, -0.5) * X[:, 2]
         + 0.1 * rng.normal(size=300))
    model = GradientBoostingRegressor(n_estimators=8, max_depth=3, random_state=0).fit(X, y)
    return dict(fn=model.predict, X=X.astype(np.float32))


def _exact_pair(g, opts, bg_rows, config=CPU, interactions=False):
    bg = g["X"][:bg_rows]
    Xe = g["X"][50:63]                      # 13 rows: pads to the data axis
    port = DistributedExplainer({**opts, "algorithm": "kernel_shap"}, KernelExplainerEngine,
                                (g["fn"], bg), {"link": "identity", "seed": 0,
                                                "config": config})
    jax = JaxDist({**opts, "algorithm": "kernel_shap"}, JaxEngine, (g["fn"], bg),
                  {"link": "identity", "seed": 0})
    seq = KernelExplainerEngine(g["fn"], bg, link="identity", seed=0, config=config)
    out = []
    for e in (port, jax, seq):
        phi = e.get_explanation(Xe, nsamples="exact", interactions=interactions)
        out.append((phi, e.last_interaction_values))
    return port, out


@pytest.mark.parametrize("opts,bg_rows", [
    ({"n_devices": 8}, 10),
    ({"n_devices": 8, "coalition_parallel": 2}, 10),
    ({"n_devices": 8, "coalition_parallel": 4}, 9),     # pad_background: 9 -> 12
    ({"n_devices": 8, "batch_size": 1}, 10),             # slabs
], ids=["data", "coalition2", "ragged_background", "slabs"])
def test_exact_tree_mesh_matches_the_jax_mesh(gbt, opts, bg_rows):
    port, ((got, _), (jax_phi, _), (seq, _)) = _exact_pair(gbt, opts, bg_rows)
    np.testing.assert_allclose(got, np.asarray(jax_phi), atol=EXACT_ATOL)
    np.testing.assert_allclose(got, seq, atol=EXACT_ATOL)
    assert port.kernel_path["exact_phi"] == "plain"


@pytest.mark.parametrize("opts", [{"n_devices": 8}, {"n_devices": 8, "coalition_parallel": 4},
                                  {"n_devices": 8, "batch_size": 2}],
                         ids=["data", "coalition4", "slabs"])
def test_exact_interactions_mesh_matches_the_jax_mesh(gbt, opts):
    port, ((got, inter), (jax_phi, jax_inter), (seq, seq_inter)) = _exact_pair(
        gbt, opts, 10, interactions=True)
    np.testing.assert_allclose(inter[0], np.asarray(jax_inter[0]), atol=EXACT_ATOL)
    np.testing.assert_allclose(inter[0], seq_inter[0], atol=EXACT_ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_phi), atol=EXACT_ATOL)
    np.testing.assert_allclose(inter[0].sum(-1), got, atol=EXACT_ATOL)
    assert port.kernel_path["exact_inter"] == "plain"


@pytest.mark.parametrize("cp", [2, 4])
def test_packed_exact_mesh_stripes_the_buckets(gbt, cp, monkeypatch):
    from distributedkernelshap_tpu_torch.ops import treeshap as tts

    calls = []
    real = tts._phi_call

    def counting(*args, **kw):
        calls.append(args[0].shape[1])          # the bucket's local path count
        return real(*args, **kw)

    monkeypatch.setattr(tts, "_phi_call", counting)
    cfg = EngineConfig(device="cpu", shap=ShapConfig(pack_paths=True))
    port, ((got, _), (jax_phi, _), (seq, _)) = _exact_pair(
        gbt, {"n_devices": 8, "coalition_parallel": cp}, 16, config=cfg)
    np.testing.assert_allclose(got, seq, atol=EXACT_ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_phi), atol=EXACT_ATOL)
    # one contraction per local bucket and shard (8 shards), each shard
    # holding 1/cp of every bucket's paths; then the engine's own buckets
    plan = tts.build_packed_plan(port.engine.predictor, port.engine.G, shards=cp)
    n_mesh = 8 * len(plan.buckets)
    assert len(calls) > n_mesh
    assert calls[:n_mesh] == [stop - start for start, stop, _ in plan.buckets] * 8
    assert port.stage_rows(gbt["X"][:4], nsamples="exact") is None


def _tt_cores(M, r, seed):
    """Random well-conditioned TT cores (per-site scale r^-1/2), as the JAX
    package's tests make them."""

    rng = np.random.default_rng(seed)
    dims = [1] + [r] * (M - 1) + [1]
    scale = 1.0 / np.sqrt(r)
    return [(rng.normal(scale=scale, size=(dims[i], dims[i + 1])).astype(np.float32),
             rng.normal(scale=0.3 * scale, size=(dims[i], dims[i + 1])).astype(np.float32))
            for i in range(M)]


@pytest.mark.parametrize("cp,bg_rows", [(2, 16), (4, 13)], ids=["even", "ragged"])
def test_tensor_train_mesh_matches_the_jax_mesh(cp, bg_rows):
    from distributedkernelshap_tpu.models.tensor_net import TensorTrainPredictor as JaxTT
    from distributedkernelshap_tpu_torch.models.tensor_net import TensorTrainPredictor

    rng = np.random.default_rng(7)
    M = 8
    cores = _tt_cores(M, 4, seed=1)
    bg = rng.normal(size=(16, M)).astype(np.float32)[:bg_rows]
    X = rng.normal(size=(5, M)).astype(np.float32)
    opts = {"n_devices": 8, "coalition_parallel": cp, "algorithm": "kernel_shap"}
    port = DistributedExplainer(opts, KernelExplainerEngine,
                                (TensorTrainPredictor(cores, device="cpu"), bg),
                                {"link": "identity", "seed": 0, "config": CPU})
    got = port.get_explanation(X, nsamples="exact")
    seq = KernelExplainerEngine(TensorTrainPredictor(cores, device="cpu"), bg,
                                link="identity", seed=0, config=CPU)
    want = JaxDist(opts, JaxEngine, (JaxTT(cores), bg), {"link": "identity", "seed": 0}
                   ).get_explanation(X, nsamples="exact")
    np.testing.assert_allclose(got, seq.get_explanation(X, nsamples="exact"), atol=EXACT_ATOL)
    np.testing.assert_allclose(got, np.asarray(want), atol=EXACT_ATOL)
    np.testing.assert_allclose(port.last_raw_prediction, seq.last_raw_prediction, atol=1e-6)
    assert port.kernel_path["exact_phi"] == "tn_dp"
    with pytest.raises(ValueError, match="interactions"):
        port.get_explanation(X, nsamples="exact", interactions=True)


# ---------------------------------------------------------------------------
# serving a mesh-backed model


def test_mesh_serving_pipelines_and_aligns():
    from distributedkernelshap_tpu_torch.serving import client
    from distributedkernelshap_tpu_torch.serving.server import ExplainerServer
    from distributedkernelshap_tpu_torch.serving.wrappers import BatchKernelShapModel

    rng = np.random.default_rng(6)
    D, K, N = 6, 2, 10
    W = rng.normal(size=(D, K)).astype(np.float32)
    pred = LinearPredictor(W, np.zeros(K, np.float32), activation="softmax", device="cpu")
    bg = rng.normal(size=(N, D)).astype(np.float32)
    X = rng.normal(size=(12, D)).astype(np.float32)
    ctor = {"link": "logit", "seed": 0, "device": "cpu",
            "distributed_opts": {"n_devices": 4}}
    model = BatchKernelShapModel(pred, bg, ctor, {})
    assert isinstance(model.explainer._explainer, DistributedExplainer)

    fetches = {"n": 0}
    real_fetch = DistributedExplainer._fetch_sharded

    def counting_fetch(self, dispatched):
        fetches["n"] += 1
        return real_fetch(self, dispatched)

    DistributedExplainer._fetch_sharded = counting_fetch
    try:
        fin = model.explain_batch_async(X[:1], split_sizes=[1])
        assert fetches["n"] == 0, "async dispatch must not fetch eagerly"
        assert json.loads(fin()[0])["data"]["shap_values"]
        assert fetches["n"] == 1
    finally:
        DistributedExplainer._fetch_sharded = real_fetch

    srv = ExplainerServer(model, host="127.0.0.1", port=0, max_batch_size=1,
                          pipeline_depth=4, warmup=False).start()
    try:
        payloads = client.distribute_requests(f"http://127.0.0.1:{srv.port}/explain", X,
                                              max_workers=8)
    finally:
        srv.stop()
    single = KernelShap(pred, link="logit", seed=0, device="cpu").fit(bg)
    for i, p in enumerate(payloads):
        got = np.asarray(json.loads(p)["data"]["shap_values"])[:, 0, :]
        want = single.explain(X[i:i + 1], silent=True).shap_values
        np.testing.assert_allclose(got, np.stack([v[0] for v in want]), atol=PHI_ATOL)
