"""The port's boundary spans (``profiling.span``) on the CPU: which spans a
chunked explain, a ranking and an exact interaction explain record, that
they form one trace across the calling and the fetch threads, that each
calling-thread span sits on the clock of the ``torch.profiler`` range it
opens, and that with the tracer off and no profiler nothing is recorded
or opened."""

import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from distributedkernelshap_tpu_torch import EngineConfig, KernelShap, LinearPredictor
from distributedkernelshap_tpu_torch import profiling
from distributedkernelshap_tpu_torch.observability.tracing import tracer

D = 7
GROUPS = [[0], [1, 2], [3, 4], [5, 6]]
ROWS, CHUNK = 7, 3           # chunks of 3, 3 and 1 rows, padded to 4, 4 and 1
N_CHUNKS = 3
#: spans a call records on its calling thread, each in the profiler too
PROFILED = ("kernel_shap.explain", "phase.explain", "phase.dispatch", "phase.assemble",
            "phase.fingerprint", "phase.build_explanation", "phase.pipeline_wait")


@pytest.fixture()
def ring():
    """The process tracer, enabled and empty for the test, restored after."""

    tr = tracer()
    was = tr.enabled
    tr.clear()
    tr.enable()
    try:
        yield tr
    finally:
        tr.enabled = was
        tr.clear()


def _explainer(instance_chunk=CHUNK):
    rng = np.random.default_rng(0)
    W = rng.normal(size=(D, 3)).astype(np.float32)
    bg = rng.normal(size=(10, D)).astype(np.float32)
    pred = LinearPredictor(W, np.zeros(3, np.float32), activation="softmax", device="cpu")
    ex = KernelShap(pred, link="logit", seed=0, device="cpu",
                    engine_config=EngineConfig(instance_chunk=instance_chunk,
                                               dispatch_window=2))
    ex.fit(bg, groups=GROUPS, group_names=list("abcd"))
    X = rng.normal(size=(ROWS, D)).astype(np.float32)
    return ex, X


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_a_chunked_explain_records_each_boundary_span_in_one_trace(ring):
    ex, X = _explainer()
    ex.explain(X, nsamples=32, silent=True)           # warm: plan constants, caches
    ring.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        ex.explain(X, nsamples=32, silent=True)
    spans = ring.spans()
    assert ring.dropped_total == 0
    count = Counter(s.name for s in spans)
    assert count["kernel_shap.explain"] == 1
    for name in ("phase.dispatch", "pool.shard", "phase.fetch_transfer",
                 "phase.unpack_transfer"):
        assert count[name] == N_CHUNKS, name
    assert count["phase.assemble"] == 1 and count["phase.build_explanation"] == 1
    assert count["phase.fingerprint"] == 2            # the explain's X and build_explanation's
    # a window slot for each chunk, then the outstanding fetches
    assert count["phase.pipeline_wait"] == N_CHUNKS + 1

    named = _by_name(spans)
    root = named["kernel_shap.explain"][0]
    assert root.parent_id is None and root.attrs["rows"] == ROWS
    assert {s.trace_id for s in spans} == {root.trace_id}
    ids = {s.span_id for s in spans}
    assert all(s.parent_id in ids for s in spans if s is not root)
    for key in ("phase.dispatch", "pool.shard"):
        got = sorted((s.attrs["index"], s.attrs["rows"], s.attrs["padded_rows"])
                     for s in named[key])
        assert got == [(0, 3, 4), (1, 3, 4), (2, 1, 1)], key
    # the fetches ran on the pool's threads, each under its own chunk's shard
    shards = {s.span_id: s for s in named["pool.shard"]}
    main = threading.get_ident()
    for key in ("phase.fetch_transfer", "phase.unpack_transfer"):
        assert all(s.thread != main and s.parent_id in shards for s in named[key]), key
    assert all(s.attrs["bytes"] > 0 for s in named["phase.fetch_transfer"])
    assert all(s.attrs["elements"] > 0 for s in named["phase.unpack_transfer"])
    assert named["phase.assemble"][0].attrs["bytes"] > 0
    assert all(s.attrs["bytes"] == X.nbytes for s in named["phase.fingerprint"])
    # each shard spans its dispatch and its fetch
    for s in named["pool.shard"]:
        for f in named["phase.fetch_transfer"]:
            if f.parent_id == s.span_id:
                assert s.ts <= f.ts and f.ts + f.duration_s <= s.ts + s.duration_s


def _profiler_ranges(prof):
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in PROFILED:
            start = e.start_ns() * 1e-9
            out.setdefault(e.name(), []).append((start, start + e.duration_ns() * 1e-9))
    return {k: sorted(v) for k, v in out.items()}


def test_calling_thread_spans_contain_their_profiler_ranges(ring):
    ex, X = _explainer()
    ex.explain(X, nsamples=32, silent=True)
    ring.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex.explain(X, nsamples=32, silent=True)
    ranges = _profiler_ranges(prof)
    main = threading.get_ident()
    spans = _by_name([s for s in ring.spans() if s.thread == main and s.name in PROFILED])
    assert set(spans) == set(PROFILED) == set(ranges)
    for name, own in spans.items():
        own = sorted((s.ts, s.ts + s.duration_s) for s in own)
        assert len(own) == len(ranges[name]), name
        for (a, b), (lo, hi) in zip(own, ranges[name]):
            # one clock: the span holds its range, each end within 1 ms
            assert a <= lo + 1e-6 and hi <= b + 1e-6, name
            assert lo - a < 1e-3 and b - hi < 1e-3, (name, lo - a, b - hi)


def _count_ranges(monkeypatch):
    opened = []
    real = profiling._range

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "_range", counting)
    return opened


def test_the_profiler_ranges_are_function_scope_not_user_annotations():
    """A user annotation gets a copy on the device's rows of a CUDA trace,
    over the kernels launched inside it, which readers of the device
    records would count as device work; the spans' ranges are plain
    function-scope events, each on the calling thread."""

    ex, X = _explainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex.explain(X, nsamples=32, silent=True)
    ranges = [e for e in prof.events() if e.name in PROFILED]
    assert {e.name for e in ranges} == set(PROFILED)
    assert not any(e.is_user_annotation for e in ranges)
    assert len({e.thread for e in ranges}) == 1


def test_with_tracing_off_an_explain_opens_no_range_and_records_nothing(monkeypatch):
    ex, X = _explainer()
    tr = tracer()
    monkeypatch.setattr(tr, "enabled", False)
    tr.clear()
    opened = _count_ranges(monkeypatch)
    assert not torch.autograd._profiler_enabled()
    ex.explain(X, nsamples=32, silent=True)
    ex.rank_features(X, nsamples=32)
    assert opened == [] and tr.spans() == [] and tr.recorded_total == 0
    # the count sees the ranges a profiler makes the same calls open
    with profile(activities=[ProfilerActivity.CPU]):
        ex.explain(X, nsamples=32, silent=True)
    assert "kernel_shap.explain" in opened and "phase.assemble" in opened
    assert tr.spans() == []


def test_rank_features_records_its_root_dispatches_and_fetch(ring):
    ex, X = _explainer()
    ex.rank_features(X, nsamples=32)
    count = Counter(s.name for s in ring.spans())
    assert count["kernel_shap.rank_features"] == 1 and count["phase.rank_features"] == 1
    assert count["phase.dispatch"] == N_CHUNKS and count["phase.fetch_transfer"] == 1
    root = _by_name(ring.spans())["kernel_shap.rank_features"][0]
    assert root.attrs["rows"] == ROWS
    assert {s.trace_id for s in ring.spans()} == {root.trace_id}


def test_exact_interactions_record_their_root_assemble_and_fetch(ring):
    from sklearn.ensemble import GradientBoostingRegressor

    rng = np.random.default_rng(11)
    Xf = rng.normal(size=(150, 4))
    y = Xf[:, 0] * np.where(Xf[:, 1] > 0, 1.0, -1.0)
    gbt = GradientBoostingRegressor(n_estimators=5, max_depth=3, random_state=0).fit(Xf, y)
    ex = KernelShap(gbt.predict, seed=0, device="cpu",
                    engine_config=EngineConfig(instance_chunk=4))
    ex.fit(Xf[:12].astype(np.float32))
    ring.clear()
    ex.explain(Xf[:6].astype(np.float32), silent=True, nsamples="exact", interactions=True)
    named = _by_name(ring.spans())
    count = {k: len(v) for k, v in named.items()}
    assert count["kernel_shap.explain"] == 1 and count["phase.assemble"] == 1
    assert count["phase.dispatch"] == 2 and count["pool.shard"] == 2
    assert count["phase.fetch_transfer"] == 2 and count["phase.build_explanation"] == 1
    root = named["kernel_shap.explain"][0]
    assert {s.trace_id for s in ring.spans()} == {root.trace_id}
    # phi, f(x) and the matrices, each chunk's in one span
    assert all(s.attrs["bytes"] > 0 for s in named["phase.fetch_transfer"])


def test_a_root_span_nests_under_an_adopted_request_context(ring):
    from distributedkernelshap_tpu_torch.observability.tracing import use_context

    ex, X = _explainer(instance_chunk=None)
    with ring.span("server.request") as request:
        ex.explain(X, nsamples=32, silent=True)
    root = _by_name(ring.spans())["kernel_shap.explain"][0]
    assert root.parent_id == request.span_id and root.trace_id == request.trace_id
    ring.clear()
    ctx = request.context
    with use_context(ctx):
        ex.rank_features(X, nsamples=32)
    root = _by_name(ring.spans())["kernel_shap.rank_features"][0]
    assert root.parent_id == ctx.span_id


def test_a_span_stamps_the_profilers_clock_and_parents_nested_spans(ring):
    """``span`` reads ``time.time_ns()`` at both ends; a nested span
    parents to it; a phase is a ``phase.<name>`` span whether or not its
    timer runs."""

    import time

    t0 = time.time_ns() * 1e-9
    with profiling.span("outer", rows=3) as outer:
        with profiling.profiler().phase("inner"):
            pass
    t1 = time.time_ns() * 1e-9
    inner = _by_name(ring.spans())["phase.inner"][0]
    assert inner.parent_id == outer.span_id and outer.attrs == {"rows": 3}
    assert t0 <= outer.ts <= inner.ts and inner.ts + inner.duration_s <= t1
    assert outer.ts + outer.duration_s <= t1
    assert torch.autograd._profiler_enabled() is False


def test_a_build_and_a_load_are_compile_backend_spans(ring, tmp_path, monkeypatch):
    from distributedkernelshap_tpu_torch.runtime import compile_cache, native
    from distributedkernelshap_tpu_torch.runtime.compile_cache import CompileAccounting

    monkeypatch.setattr(compile_cache, "_accounting", CompileAccounting())
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    for _ in range(2):
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        with compile_cache.compile_events().signature("rows=1"):
            assert native.get_lib() is not None
    spans = _by_name(ring.spans())["compile.backend"]
    assert [s.attrs for s in spans] == [
        {"kind": kind, "signature": "rows=1", "artefact": "libdksruntime"}
        for kind in ("fresh", "cache_hit")]
    assert spans[0].duration_s > spans[1].duration_s      # g++ ran in the first


def test_resize_keeps_the_newest_spans():
    from distributedkernelshap_tpu_torch.observability.tracing import Tracer

    tr = Tracer(capacity=4, enabled=True)
    for i in range(4):
        tr.end(tr.begin(f"s{i}"))
    tr.resize(2)
    assert [s.name for s in tr.spans()] == ["s2", "s3"] and tr.dropped_total == 2
    tr.resize(8)
    for i in range(4, 8):
        tr.end(tr.begin(f"s{i}"))
    assert len(tr.spans()) == 6 and tr.capacity == 8
