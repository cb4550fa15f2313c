"""The port's pod-fabric protocol (``serving/multihost.py``) over an
in-process fake transport — no process group, no subprocesses: the port of
``tests/test_pod_fabric.py``'s wire contract (header/payload framing under
the broadcast lock, bucket selection, over-slot rejection, shutdown
idempotence and the post-shutdown dispatch ordering, follower
catch-and-continue, the warmup and drain commands, metering), plus the
framing's parity with the JAX module (``_chunk_elems``, ``_payload_chunks``
and ``broadcast_buckets`` give equal values) and the ``KVStoreTransport``
round trip and GC window on an in-process ``TCPStore``.  The two-process
runs are ``tests/test_torch_port_pod_serving.py``."""

import queue
import socket
import threading

import numpy as np
import pytest

from distributedkernelshap_tpu_torch.serving import multihost
from distributedkernelshap_tpu_torch.serving.multihost import (
    _CMD_EXPLAIN,
    _CMD_SHUTDOWN,
    _CMD_WARMUP,
    _HEADER_LEN,
    KVStoreTransport,
    MultihostServingModel,
    PipelinedMultihostServingModel,
    _chunk_elems,
    _payload_chunks,
    broadcast_buckets,
    follower_loop,
    pod_bcast_byte_counts,
    pod_bcast_seconds_total,
)

N_FEATURES = 4
#: the wire's fixed MTU for this feature width — every op on the fake
#: wire must be exactly this shape (shape-uniform ops are the transport
#: correctness contract, see multihost._chunk_elems)
CHUNK = _chunk_elems(N_FEATURES)


# -- fakes -------------------------------------------------------------- #


class _FakeWire:
    """Shared broadcast medium: the lead appends frames, each follower
    pops them in order — the collective's source-to-all semantics
    without any collective."""

    def __init__(self, n_followers: int = 1):
        self.queues = [queue.Queue() for _ in range(n_followers)]
        self.sent = []  # every frame the lead broadcast, in order


class _LeadTransport:
    is_lead = True
    process_index = 0

    def __init__(self, wire: _FakeWire):
        self.wire = wire
        self.process_count = len(wire.queues) + 1

    def broadcast(self, value, is_source):
        assert is_source, "lead must broadcast as source"
        arr = np.array(value, copy=True)
        self.wire.sent.append(arr)
        for q in self.wire.queues:
            q.put(arr)
        return arr


class _FollowerTransport:
    is_lead = False

    def __init__(self, wire: _FakeWire, rank: int = 1):
        self._q = wire.queues[rank - 1]
        self.process_index = rank
        self.process_count = len(wire.queues) + 1

    def broadcast(self, value, is_source):
        assert not is_source, "follower must broadcast as receiver"
        got = self._q.get(timeout=10)
        # the framing contract the whole protocol rests on: the receive
        # buffer the follower allocated from the previous header must
        # match the frame the lead actually sent — any desync in
        # header/payload pairing or bucket sizing fails loudly here
        assert got.shape == np.shape(value), \
            f"framing desync: lead sent {got.shape}, " \
            f"follower expected {np.shape(value)}"
        assert got.dtype == np.asarray(value).dtype
        return got


class _KVLeadTransport(_LeadTransport):
    """A host-side wire fake: frames carried as-is, no MTU chunking."""

    needs_uniform_ops = False


class _KVFollowerTransport(_FollowerTransport):
    needs_uniform_ops = False


class _FakeInner:
    """The DistributedExplainer stand-in behind model.explainer."""

    def __init__(self, replicate=False):
        self.background = np.zeros((8, N_FEATURES), np.float32)
        self.replicate_results = replicate
        self.async_calls = []

    def get_explanation_async(self, X, **kw):
        self.async_calls.append(np.array(X, copy=True))
        return lambda: None


class _FakeExplainer:
    def __init__(self, inner, fail=None):
        self._explainer = inner
        self.calls = []
        self._fail = fail  # callable(X) -> bool, raise on match

    def explain(self, X, silent=True, **kw):
        X = np.asarray(X)
        if self._fail is not None and self._fail(X):
            raise RuntimeError("injected explain failure")
        self.calls.append(np.array(X, copy=True))
        return "explanation"


class _FakeModel:
    """KernelShapModel-shaped serving model the pod wrapper wraps."""

    supports_wire_formats = True

    def __init__(self, replicate=False, fail=None):
        self.explainer = _FakeExplainer(_FakeInner(replicate), fail=fail)
        self.explain_kwargs = {"nsamples": 8}
        self.batch_calls = []

    def explain_batch(self, stacked, split_sizes=None, formats=None):
        self.batch_calls.append((np.array(stacked, copy=True),
                                 split_sizes, formats))
        return ["ok"] * (len(split_sizes) if split_sizes else 1)

    def explain_batch_async(self, stacked, split_sizes=None, formats=None):
        arr = np.array(stacked, copy=True)

        def finalize():
            self.batch_calls.append((arr, split_sizes, formats))
            return ["ok"]

        return finalize


def _lead(model=None, wire=None, max_rows=8, buckets=(1, 2, 4, 8),
          cls=MultihostServingModel):
    wire = wire or _FakeWire()
    model = model or _FakeModel(replicate=cls
                                is PipelinedMultihostServingModel)
    pod = cls(model, max_rows=max_rows, buckets=list(buckets),
              transport=_LeadTransport(wire))
    return pod, model, wire


# -- lead-side framing -------------------------------------------------- #


def test_bucket_selection_smallest_fitting_rung():
    pod, _, _ = _lead()
    assert [pod._bucket_for(r) for r in (1, 2, 3, 4, 5, 8)] \
        == [1, 2, 4, 4, 8, 8]


def test_frame_is_shape_uniform_chunks_padded_to_bucket():
    pod, model, wire = _lead()
    stacked = np.arange(3 * N_FEATURES, dtype=np.float32).reshape(3, -1)
    pod.explain_batch(stacked, split_sizes=[2, 1])
    # every op on the wire is ONE MTU shape: header chunk + payload
    # chunks covering the BUCKET (4), not the slot (8)
    n_chunks = _payload_chunks(4, N_FEATURES)
    assert len(wire.sent) == 1 + n_chunks
    for op in wire.sent:
        assert op.shape == (CHUNK,) and op.dtype == np.float32
    header = wire.sent[0]
    assert list(header[:_HEADER_LEN]) == [_CMD_EXPLAIN, 3, 4]
    np.testing.assert_array_equal(header[_HEADER_LEN:], 0)
    body = np.concatenate(wire.sent[1:])[:4 * N_FEATURES]
    payload = body.reshape(4, N_FEATURES)
    np.testing.assert_array_equal(payload[:3], stacked)
    np.testing.assert_array_equal(payload[3:], 0)
    # the lead's own explain sees the unpadded batch
    (got, split, formats), = model.batch_calls
    np.testing.assert_array_equal(got, stacked)
    assert split == [2, 1] and formats is None


def test_formats_passthrough_and_capability():
    pod, model, _ = _lead()
    assert pod.supports_wire_formats is True
    pod.explain_batch(np.ones((1, N_FEATURES), np.float32),
                      split_sizes=[1], formats=["binary"])
    assert model.batch_calls[-1][2] == ["binary"]


def test_over_slot_batch_rejected_before_any_broadcast():
    pod, _, wire = _lead(max_rows=8)
    with pytest.raises(ValueError, match="broadcast slot"):
        pod.explain_batch(np.zeros((9, N_FEATURES), np.float32))
    assert wire.sent == []  # nothing hit the wire — followers stay paired


def test_buckets_must_end_at_max_rows():
    with pytest.raises(ValueError, match="end at max_rows"):
        _lead(max_rows=8, buckets=(1, 2, 4))


def test_lead_only_construction():
    with pytest.raises(RuntimeError, match="lead process"):
        MultihostServingModel(_FakeModel(), max_rows=8, buckets=[8],
                              transport=_FollowerTransport(_FakeWire()))


def test_pipelined_requires_replicated_results():
    with pytest.raises(ValueError, match="replicate_results"):
        PipelinedMultihostServingModel(
            _FakeModel(replicate=False), max_rows=8, buckets=[8],
            transport=_LeadTransport(_FakeWire()))


# -- shutdown ordering -------------------------------------------------- #


def test_shutdown_idempotent_single_frame():
    pod, _, wire = _lead()
    pod.shutdown_followers()
    pod.shutdown_followers()
    assert len(wire.sent) == 1  # header-only frame: bucket 0 -> no payload
    assert wire.sent[0].shape == (CHUNK,)
    assert list(wire.sent[0][:_HEADER_LEN]) == [_CMD_SHUTDOWN, 0, 0]


def test_post_shutdown_dispatch_errors_never_hangs():
    """The shutdown-vs-in-flight ordering pin: a batch the dispatcher
    popped before stop() but dispatched after the shutdown broadcast
    must fail as a per-request error (the server answers 500) — a
    broadcast into a peerless mesh would hang forever."""

    pod, _, wire = _lead(cls=PipelinedMultihostServingModel)
    pod.shutdown_followers()
    n_frames = len(wire.sent)
    with pytest.raises(RuntimeError, match="shut down"):
        pod.explain_batch(np.zeros((1, N_FEATURES), np.float32))
    with pytest.raises(RuntimeError, match="shut down"):
        pod.explain_batch_async(np.zeros((1, N_FEATURES), np.float32))
    with pytest.raises(RuntimeError, match="shut down"):
        pod.warmup_batch(np.zeros((1, N_FEATURES), np.float32))
    assert len(wire.sent) == n_frames  # nothing broadcast after shutdown


# -- drain -------------------------------------------------------------- #


def test_drain_waits_for_pipelined_finalizes():
    pod, _, _ = _lead(cls=PipelinedMultihostServingModel)
    fin = pod.explain_batch_async(np.zeros((2, N_FEATURES), np.float32),
                                  split_sizes=[2])
    assert pod.drain(timeout_s=0.05) is False  # finalize outstanding
    done = threading.Event()

    def _drainer():
        assert pod.drain(timeout_s=10) is True
        done.set()

    t = threading.Thread(target=_drainer, daemon=True)
    t.start()
    assert fin() == ["ok"]
    t.join(timeout=10)
    assert done.is_set()


def test_drain_and_shutdown_flushes_then_broadcasts():
    pod, _, wire = _lead(cls=PipelinedMultihostServingModel)
    fin = pod.explain_batch_async(np.zeros((1, N_FEATURES), np.float32))
    fin()
    assert pod.drain_and_shutdown(server=None, grace_s=5) is True
    assert list(wire.sent[-1][:_HEADER_LEN]) == [_CMD_SHUTDOWN, 0, 0]
    # grace expiry still broadcasts shutdown (liveness probe is the
    # backstop for a truly wedged collective) but reports unclean
    pod2, _, wire2 = _lead(cls=PipelinedMultihostServingModel)
    pod2.explain_batch_async(np.zeros((1, N_FEATURES), np.float32))
    assert pod2.drain_and_shutdown(server=None, grace_s=0.05) is False
    assert list(wire2.sent[-1][:_HEADER_LEN]) == [_CMD_SHUTDOWN, 0, 0]


# -- follower loop ------------------------------------------------------ #


def _run_follower(model, wire, rank=1, max_rows=8):
    t = threading.Thread(
        target=follower_loop, args=(model,),
        kwargs={"max_rows": max_rows,
                "transport": _FollowerTransport(wire, rank=rank)},
        daemon=True)
    t.start()
    return t


def test_follower_mirrors_lead_end_to_end():
    wire = _FakeWire()
    pod, lead_model, _ = _lead(wire=wire)
    follower_model = _FakeModel()
    t = _run_follower(follower_model, wire)
    pod.warmup_batch(np.zeros((2, N_FEATURES), np.float32))
    b1 = np.full((1, N_FEATURES), 7.0, np.float32)
    b2 = np.full((3, N_FEATURES), 9.0, np.float32)
    pod.explain_batch(b1, split_sizes=[1])
    pod.explain_batch(b2, split_sizes=[3])
    pod.shutdown_followers()
    t.join(timeout=10)
    assert not t.is_alive()
    # the follower entered the identical unpadded batches, in order
    calls = follower_model.explainer.calls
    assert [c.shape[0] for c in calls] == [2, 1, 3]
    np.testing.assert_array_equal(calls[1], b1)
    np.testing.assert_array_equal(calls[2], b2)
    assert len(lead_model.batch_calls) == 3  # warmup + 2 explains


def test_follower_catch_and_continue():
    wire = _FakeWire()
    pod, _, _ = _lead(wire=wire)
    # first batch poisons the follower's explain; the loop must stay up
    # and serve the next broadcast (the lead answered its 500 already)
    follower_model = _FakeModel(fail=lambda X: bool(np.any(X == 13.0)))
    t = _run_follower(follower_model, wire)
    pod.explain_batch(np.full((1, N_FEATURES), 13.0, np.float32))
    good = np.full((2, N_FEATURES), 1.0, np.float32)
    pod.explain_batch(good)
    pod.shutdown_followers()
    t.join(timeout=10)
    assert not t.is_alive()
    calls = follower_model.explainer.calls
    assert len(calls) == 1
    np.testing.assert_array_equal(calls[0], good)


def test_pipelined_follower_async_dispatch_sync_warmup():
    wire = _FakeWire()
    pod, _, _ = _lead(wire=wire, cls=PipelinedMultihostServingModel)
    follower_model = _FakeModel(replicate=True)
    t = _run_follower(follower_model, wire)
    # warmup rungs compile SYNCHRONOUSLY even on the pipelined protocol
    pod.warmup_batch(np.zeros((4, N_FEATURES), np.float32))
    fin = pod.explain_batch_async(np.ones((2, N_FEATURES), np.float32))
    fin()
    pod.shutdown_followers()
    t.join(timeout=10)
    assert not t.is_alive()
    inner = follower_model.explainer._explainer
    assert [c.shape[0] for c in follower_model.explainer.calls] == [4]
    assert [c.shape[0] for c in inner.async_calls] == [2]


def test_follower_refuses_lead_transport():
    with pytest.raises(RuntimeError, match="lead process"):
        follower_loop(_FakeModel(), max_rows=8,
                      transport=_LeadTransport(_FakeWire()))


# -- warmup command framing --------------------------------------------- #


def test_warmup_broadcasts_warmup_command():
    pod, model, wire = _lead()
    pod.warmup_batch(np.zeros((4, N_FEATURES), np.float32),
                     split_sizes=[4])
    header = wire.sent[0]
    assert list(header[:_HEADER_LEN]) == [_CMD_WARMUP, 4, 4]
    assert len(model.batch_calls) == 1  # lead compiles the rung too


# -- ladder + metering --------------------------------------------------- #


def test_broadcast_buckets_pow2_fallback():
    # a model without engine compile buckets gets the pow2 ladder
    assert broadcast_buckets(_FakeModel(), 8) == [1, 2, 4, 8]
    assert broadcast_buckets(_FakeModel(), 6) == [1, 2, 4, 6]


def test_broadcast_buckets_follows_engine_rungs():
    model = _FakeModel()
    inner = model.explainer._explainer
    inner._bucket = lambda n: 1 << max(0, int(n) - 1).bit_length()
    inner.config = type("C", (), {"bucket_batches": True})()
    # engine rungs capped at max_rows, max_rows always present
    assert broadcast_buckets(model, 6) == [1, 2, 4, 6]


def test_pod_bcast_metering_counts_frames():
    bytes_before = pod_bcast_byte_counts()
    seconds_before = pod_bcast_seconds_total()
    pod, _, _ = _lead()
    pod.explain_batch(np.zeros((3, N_FEATURES), np.float32))
    delta = (pod_bcast_byte_counts().get(("4",), 0.0)
             - bytes_before.get(("4",), 0.0))
    # (header chunk + bucket-4 payload chunks) x MTU x 4 bytes
    assert delta == (1 + _payload_chunks(4, N_FEATURES)) * CHUNK * 4
    assert pod_bcast_seconds_total() >= seconds_before


def test_pod_bcast_metering_host_wire_bytes():
    # a non-uniform (host-side) wire meters exact frame bytes: header +
    # bucket-padded payload, no MTU chunk padding
    bytes_before = pod_bcast_byte_counts()
    pod = MultihostServingModel(
        _FakeModel(), max_rows=8, buckets=[1, 2, 4, 8],
        transport=_KVLeadTransport(_FakeWire()))
    pod.explain_batch(np.zeros((3, N_FEATURES), np.float32))
    delta = (pod_bcast_byte_counts().get(("4",), 0.0)
             - bytes_before.get(("4",), 0.0))
    assert delta == (_HEADER_LEN + 4 * N_FEATURES) * 4


def test_attach_pod_metrics_renders_bucket_series():
    from distributedkernelshap_tpu_torch.observability.metrics import (
        MetricsRegistry,
    )

    pod, _, _ = _lead()
    pod.explain_batch(np.zeros((1, N_FEATURES), np.float32))
    reg = MetricsRegistry()
    multihost.attach_pod_metrics(reg)
    text = reg.render()
    assert 'dks_pod_bcast_bytes_total{bucket="1"}' in text
    assert "dks_pod_bcast_seconds_total" in text


# -- host-side (KV) wire ------------------------------------------------- #


def test_host_wire_frames_are_unchunked():
    # transports that don't need shape-uniform ops get exact frames: one
    # [cmd, rows, bucket] header op + one bucket-padded payload op
    wire = _FakeWire()
    pod = MultihostServingModel(
        _FakeModel(), max_rows=8, buckets=[1, 2, 4, 8],
        transport=_KVLeadTransport(wire))
    stacked = np.arange(3 * N_FEATURES, dtype=np.float32).reshape(3, -1)
    pod.explain_batch(stacked)
    assert len(wire.sent) == 2
    header, payload = wire.sent
    assert header.shape == (_HEADER_LEN,)
    assert list(header) == [_CMD_EXPLAIN, 3, 4]
    assert payload.shape == (4, N_FEATURES) and payload.dtype == np.float32
    np.testing.assert_array_equal(payload[:3], stacked)
    np.testing.assert_array_equal(payload[3:], 0)
    pod.shutdown_followers()
    assert wire.sent[-1].shape == (_HEADER_LEN,)
    assert list(wire.sent[-1]) == [_CMD_SHUTDOWN, 0, 0]


def test_host_wire_follower_mirrors_lead():
    wire = _FakeWire()
    pod = MultihostServingModel(
        _FakeModel(), max_rows=8, buckets=[1, 2, 4, 8],
        transport=_KVLeadTransport(wire))
    follower_model = _FakeModel()
    t = threading.Thread(
        target=follower_loop, args=(follower_model,),
        kwargs={"max_rows": 8, "transport": _KVFollowerTransport(wire)},
        daemon=True)
    t.start()
    b = np.full((3, N_FEATURES), 5.0, np.float32)
    pod.explain_batch(b)
    pod.shutdown_followers()
    t.join(timeout=10)
    assert not t.is_alive()
    calls = follower_model.explainer.calls
    assert len(calls) == 1
    np.testing.assert_array_equal(calls[0], b)


def _kv_pair():
    """A lead and a follower transport of one session on one in-process
    ``TCPStore`` (in a pod each process constructs its own; the session
    counter pairs them up)."""

    import datetime

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    store = dist.TCPStore("127.0.0.1", port, 1, True,
                          timeout=datetime.timedelta(seconds=30))
    lead, follower = KVStoreTransport(store), KVStoreTransport(store)
    follower._session = lead._session
    return lead, follower, store


def test_kv_transport_orders_and_round_trips():
    lead, follower, _ = _kv_pair()
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.array([9.0, 8.0, 7.0], np.float32)
    lead.broadcast(a, is_source=True)
    lead.broadcast(b, is_source=True)
    # the follower consumes in sequence order, recovering dtype and
    # shape from its receive template
    got_a = follower.broadcast(np.zeros_like(a), is_source=False)
    got_b = follower.broadcast(np.zeros_like(b), is_source=False)
    np.testing.assert_array_equal(got_a, a)
    np.testing.assert_array_equal(got_b, b)
    assert got_a.dtype == a.dtype and got_a.shape == a.shape


def test_kv_transport_follower_waits_for_a_late_frame(monkeypatch):
    lead, follower, _ = _kv_pair()
    monkeypatch.setattr(multihost, "_KV_WAIT_S", 0.05)  # several bounded waits
    x = np.full((2, 2), 3.0, np.float32)
    t = threading.Timer(0.3, lambda: lead.broadcast(x, is_source=True))
    t.start()
    got = follower.broadcast(np.zeros_like(x), is_source=False)
    t.join(timeout=10)
    np.testing.assert_array_equal(got, x)


def test_kv_transport_gc_window_bounds_store():
    lead, _, store = _kv_pair()
    base = store.num_keys()
    n = KVStoreTransport._GC_WINDOW + 10
    x = np.zeros(1, np.float32)
    for _ in range(n):
        lead.broadcast(x, is_source=True)
    # keys trail the head by at most the GC window; the oldest are gone
    assert store.num_keys() - base == KVStoreTransport._GC_WINDOW
    assert not store.check([f"{lead._session}/0"])
    assert store.check([f"{lead._session}/{n - 1}"])


def test_the_wire_needs_a_store():
    with pytest.raises(RuntimeError, match="not initialized"):
        KVStoreTransport()
    assert isinstance(multihost._default_transport(), multihost.CollectiveTransport)


# -- parity with the JAX module ------------------------------------------ #


@pytest.mark.parametrize("n_features", [1, 4, 11, 48])
def test_framing_matches_the_jax_module(n_features):
    from distributedkernelshap_tpu.serving import multihost as jax_multihost

    assert _chunk_elems(n_features) == jax_multihost._chunk_elems(n_features)
    assert (multihost._CMD_SHUTDOWN, multihost._CMD_EXPLAIN, multihost._CMD_WARMUP,
            _HEADER_LEN) == (jax_multihost._CMD_SHUTDOWN, jax_multihost._CMD_EXPLAIN,
                             jax_multihost._CMD_WARMUP, jax_multihost._HEADER_LEN)
    for bucket in (0, 1, 2, 3, 7, 64, 256):
        assert _payload_chunks(bucket, n_features) \
            == jax_multihost._payload_chunks(bucket, n_features)


@pytest.mark.parametrize("max_rows", [1, 6, 8, 100, 256])
def test_broadcast_buckets_match_the_jax_module(max_rows):
    from distributedkernelshap_tpu.serving import multihost as jax_multihost

    model = _FakeModel()
    assert broadcast_buckets(model, max_rows) == jax_multihost.broadcast_buckets(model, max_rows)
    inner = model.explainer._explainer
    inner._bucket = lambda n: 1 << max(0, int(n) - 1).bit_length()
    inner.config = type("C", (), {"bucket_batches": True})()
    assert broadcast_buckets(model, max_rows) == jax_multihost.broadcast_buckets(model, max_rows)


def test_each_frame_served_lands_in_the_flight_recorder():
    from distributedkernelshap_tpu_torch.observability.flightrec import flightrec

    wire = _FakeWire()
    pod, _, _ = _lead(wire=wire)
    t = _run_follower(_FakeModel(), wire)
    pod.warmup_batch(np.zeros((2, N_FEATURES), np.float32))
    pod.explain_batch(np.zeros((3, N_FEATURES), np.float32))
    pod.shutdown_followers()
    t.join(timeout=10)
    assert not t.is_alive()
    events = flightrec().snapshot("pod_frame")[-6:]
    for role in ("lead", "follower"):
        mine = [e for e in events if e["role"] == role]
        assert [(e["cmd"], e["rows"], e["bucket"]) for e in mine] \
            == [("warmup", 2, 2), ("explain", 3, 4), ("shutdown", 0, 0)]
        assert mine[-1]["frames"] == {"shutdown": 1, "explain": 1, "warmup": 1}
        assert set(mine[-1]["launches"]) == {"fused_linear_ey", "exact_tree_phi",
                                             "exact_tree_inter"}
