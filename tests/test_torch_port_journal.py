"""The PyTorch port's shard journal (``distributedkernelshap_tpu_torch/
resilience/journal.py``) and ``run_pipeline``'s journal hook, on the CPU,
held against the JAX package's.

The record format (JSON lines, a base64 ``.npz`` per chunk) is
framework-free, so a journal one package writes under a ``meta`` reads
back bit for bit in the other.  The port's fingerprint hashes a
predictor by its content (published ``fingerprint_bytes``, else its
parameter tensors read back to the host), never ``id()``: two builds of
one model, and two processes, hash the same; a changed parameter does
not.  The ``pool.shard`` crash runs in a subprocess (``os._exit(42)``),
and the resume recomputes exactly the chunks from the crash on.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributedkernelshap_tpu.resilience import journal as jax_journal
from distributedkernelshap_tpu_torch import KernelShap, TreeEnsemblePredictor
from distributedkernelshap_tpu_torch.models.predictors import LinearPredictor
from distributedkernelshap_tpu_torch.parallel.pipeline import run_pipeline
from distributedkernelshap_tpu_torch.resilience import journal as jr
from distributedkernelshap_tpu_torch.resilience import ShardJournal, journal_fingerprint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "adult_parity.npz")
#: chunks of the journaled explain and the hit the injected crash follows
N_CHUNKS, CHUNK_ROWS, CRASH_AFTER = 5, 8, 3


def load_fixture():
    data = np.load(FIXTURE, allow_pickle=False)
    widths = [int(w) for w in data["group_widths"]]
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
    out = {k: data[k] for k in data.files}
    out["groups"] = [list(range(s, s + w)) for s, w in zip(starts, widths)]
    out["names"] = [f"g{i}" for i in range(len(widths))]
    return out


@pytest.fixture(scope="module")
def fx():
    return load_fixture()


def _lr_explainer(fx, coef_shift=0.0):
    coef = np.asarray(fx["coef"], np.float32).reshape(-1) + np.float32(coef_shift)
    W = np.stack([np.zeros_like(coef), coef], 1)
    b = np.array([0.0, float(fx["intercept"][0])], np.float32)
    ks = KernelShap(LinearPredictor(W, b, "softmax", device="cpu"), link="logit", seed=0,
                    device="cpu")
    ks.fit(fx["background"], group_names=fx["names"], groups=fx["groups"])
    return ks


def _arrays(rng):
    return (rng.normal(size=(3, 4)).astype(np.float32),
            np.asarray([1.5, -2.5], np.float16),
            rng.integers(0, 9, size=(2, 2)).astype(np.int64))


@pytest.mark.parametrize("writer,reader", [(jax_journal, jr), (jr, jax_journal)],
                         ids=["jax_writes_port_reads", "port_writes_jax_reads"])
def test_a_journal_reads_back_bit_for_bit_across_packages(tmp_path, writer, reader):
    meta = {"fingerprint": "fp", "input": "in", "chunks": 3}
    path = str(tmp_path / "run.journal")
    rng = np.random.default_rng(0)
    written = {0: _arrays(rng), 2: _arrays(rng)}
    with writer.ShardJournal(path, meta) as j:
        for i, arrays in written.items():
            j.put(i, arrays)
    j2 = reader.ShardJournal(path, meta)
    assert j2.completed == 2 and j2.get(1) is None
    for i, arrays in written.items():
        got = j2.get(i)
        assert len(got) == len(arrays)
        for a, b in zip(got, arrays):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    j2.close()


def test_the_journal_path_is_the_references(tmp_path):
    assert jr.run_journal_path(str(tmp_path), "fp", "in") == \
        jax_journal.run_journal_path(str(tmp_path), "fp", "in")


def test_a_journal_stores_tensors_as_host_arrays(tmp_path):
    meta = {"fingerprint": "fp"}
    path = str(tmp_path / "t.journal")
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    with ShardJournal(path, meta) as j:
        j.put(0, (t,))
    (got,) = ShardJournal(path, meta).get(0)
    assert got.dtype == np.float32 and np.array_equal(got, t.numpy())


def test_fingerprint_change_and_torn_tail(tmp_path):
    path = str(tmp_path / "run.journal")
    with ShardJournal(path, {"fingerprint": "A"}) as j:
        j.put(0, (np.ones(3),))
        j.put(1, (np.zeros(2),))
    with open(path, "a") as fh:  # a crash mid-append
        fh.write('{"index": 2, "digest": "x", "payload": "AAA')
    j2 = ShardJournal(path, {"fingerprint": "A"})
    assert j2.completed == 2 and j2.get(2) is None
    j2.close()
    assert ShardJournal(path, {"fingerprint": "B"}).completed == 0
    assert ShardJournal(path, {"fingerprint": "A"}).completed == 0


def test_the_fingerprint_is_content_stable_and_content_sensitive(fx):
    a, b = _lr_explainer(fx)._explainer, _lr_explainer(fx)._explainer
    assert a.predictor is not b.predictor
    assert journal_fingerprint(a) == journal_fingerprint(b)
    assert journal_fingerprint(a) != journal_fingerprint(_lr_explainer(fx, 1e-3)._explainer)
    assert journal_fingerprint(a) != journal_fingerprint(a, extra={"nsamples": 64})
    a.fingerprint = "pinned"
    assert journal_fingerprint(a) == "pinned"


def _tree(fx, value_shift=0.0):
    return TreeEnsemblePredictor(
        fx["tree_feature"], fx["tree_threshold"], fx["tree_left"], fx["tree_right"],
        fx["tree_value"] + value_shift, depth=int(fx["tree_depth"]), aggregation="sum",
        base=fx["tree_base"], scale=float(fx["tree_scale"]),
        missing_left=fx["tree_missing_left"], vector_out=False, device="cpu")


def test_a_tree_predictor_hashes_by_its_tensors(fx):
    digest = jr._predictor_content_digest
    assert digest(_tree(fx)) == digest(_tree(fx))
    assert digest(_tree(fx)) != digest(_tree(fx, 1e-3))


_RESTART = """
import sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import test_torch_port_journal as t
print(t.journal_fingerprint(t._lr_explainer(t.load_fixture())._explainer))
"""


def test_the_fingerprint_survives_a_restart(fx):
    code = _RESTART.format(repo=REPO, tests=os.path.join(REPO, "tests"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == journal_fingerprint(_lr_explainer(fx)._explainer)


@pytest.mark.parametrize("threaded", [False, True])
def test_run_pipeline_restores_journaled_items(tmp_path, threaded):
    meta = {"fingerprint": "fp", "chunks": 5}
    path = str(tmp_path / "p.journal")
    with ShardJournal(path, meta) as seed:
        seed.put(1, (np.asarray([10.0]),))
        seed.put(3, (np.asarray([30.0]),))
    dispatched = []

    def dispatch(i):
        dispatched.append(i)
        return i

    journal = ShardJournal(path, meta)
    results = run_pipeline(list(range(5)), dispatch, lambda i: (np.asarray([float(i)]),),
                           window=2, threaded=threaded, journal=journal)
    journal.close()
    assert sorted(dispatched) == [0, 2, 4]
    assert [float(r[0][0]) for r in results] == [0.0, 10.0, 2.0, 30.0, 4.0]
    assert ShardJournal(path, meta).completed == 5


_CRASHING_RUN = """
import numpy as np, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import test_torch_port_journal as t
fx = t.load_fixture()
t.journaled_explain(fx, {path!r})
"""


def journaled_explain(fx, path):
    """The fixture LR's explain of ``N_CHUNKS`` chunks through
    ``run_pipeline`` with a journal at ``path``; ``(results, stats,
    dispatched chunk indices)``."""

    eng = _lr_explainer(fx)._explainer
    X = fx["X"][:N_CHUNKS * CHUNK_ROWS]
    chunks = np.split(X, N_CHUNKS)
    meta = {"fingerprint": journal_fingerprint(eng), "chunks": N_CHUNKS}
    dispatched = []

    def dispatch(i):
        dispatched.append(i)
        return eng.get_explanation_async(chunks[i])

    def fetch(fin):
        values, info = fin()
        return tuple(np.asarray(v) for v in values) + (np.asarray(info["raw_prediction"]),)

    with ShardJournal(path, meta) as j:
        results = run_pipeline(list(range(N_CHUNKS)), dispatch, fetch, window=2,
                               threaded=False, journal=j)
        stats = j.stats()
    return results, stats, dispatched


def test_a_crash_at_pool_shard_resumes_from_the_lost_chunk(tmp_path, fx):
    path = str(tmp_path / "crash.journal")
    env = dict(os.environ, DKS_FAULTS=f"crash:site=pool.shard,after={CRASH_AFTER}")
    code = _CRASHING_RUN.format(repo=REPO, tests=os.path.join(REPO, "tests"), path=path)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode == 42, res.stderr[-2000:]
    with open(path) as fh:
        assert len(fh.read().splitlines()) == 1 + CRASH_AFTER  # header + records
    resumed, stats, dispatched = journaled_explain(fx, path)
    assert dispatched == list(range(CRASH_AFTER, N_CHUNKS))
    assert stats["restored"] == CRASH_AFTER and stats["computed"] == N_CHUNKS - CRASH_AFTER
    fresh, _, _ = journaled_explain(fx, str(tmp_path / "fresh.journal"))
    for a, b in zip(resumed, fresh):
        assert all(np.array_equal(u, v) for u, v in zip(a, b))
    phi = np.concatenate([np.stack(r[:-1], 1) for r in resumed])
    assert np.abs(phi - fx["phi"][:N_CHUNKS * CHUNK_ROWS]).max() <= 1e-4
    assert json.loads(open(path).readline())["chunks"] == N_CHUNKS
