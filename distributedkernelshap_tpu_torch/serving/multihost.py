"""SPMD serving over a multi-process mesh: the pod fabric.

Port of ``distributedkernelshap_tpu/serving/multihost.py``.  The
single-process server (``serving/server.py``) owns its whole mesh from one
process.  On a mesh over several processes (``torch.distributed``, joined by
``parallel/mesh.initialize_multihost``) a sharded explain is a *collective*
program: every process must enter the same explain, in the same order, but
HTTP requests arrive only at the lead process (rank 0).

The bridge is a broadcast protocol: the lead runs the normal
:class:`~distributedkernelshap_tpu_torch.serving.server.ExplainerServer`
around a :class:`MultihostServingModel`, which prefixes every device call
with a broadcast frame: a ``[cmd, rows, bucket]`` header plus the batch
padded to the selected *broadcast bucket* (the warmup ladder's rungs), so
the bytes follow the bucket, not the full slot.  The default wire is the
HOST-side :class:`KVStoreTransport` over the group's ``TCPStore``: frames
never wait behind device work.  The collective wire
(:class:`CollectiveTransport`, ``dist.broadcast`` on a gloo group) remains;
on it every op is padded to ONE fixed MTU shape (:func:`_chunk_elems`), so
a frame costs ``1 + ceil(bucket*F/mtu)`` ops.  Followers sit in
:func:`follower_loop`, size the frame from the header's bucket field and
enter the identical explain call, so the mesh's collectives pair up.
Responses are built on the lead only.  Warmup rungs broadcast as
``_CMD_WARMUP`` so every process warms the same shapes before ``/healthz``
flips; shutdown is a drain handshake (the lead stops accepting, flushes
in-flight dispatches, then broadcasts the shutdown header).

Pipelining is the default: ``serve_multihost`` sets
``distributed_opts['replicate_results']=True``, so the cross-process gather
runs at dispatch and the fetch is local;
:class:`PipelinedMultihostServingModel` and the follower's async dispatch
keep several broadcast + explain calls in flight at the server's pipeline
depth (the collective order is the dispatch order on every process by
construction).  The lock-step base protocol (one device call at a time)
remains for explainers whose options cannot take the async path and for
``replicate_results=False``: a sharded fetch then carries a collective
whose order concurrent finalizes would scramble.

Each member records every frame it served in its flight recorder
(``pod_frame`` events: the command, the frames served so far by command and
this process's hand-kernel launches after the frame's dispatch), read at
``/debugz`` on the lead's server and on a follower's health listener.
"""

import datetime
import itertools
import logging
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from distributedkernelshap_tpu_torch.analysis import lockwitness
from distributedkernelshap_tpu_torch.observability.flightrec import flightrec
from distributedkernelshap_tpu_torch.parallel.mesh import (
    collective_backend,
    coordination_store,
    process_count,
    process_index,
)

logger = logging.getLogger(__name__)

_CMD_SHUTDOWN = 0
_CMD_EXPLAIN = 1
_CMD_WARMUP = 2
_CMD_NAMES = {_CMD_SHUTDOWN: "shutdown", _CMD_EXPLAIN: "explain", _CMD_WARMUP: "warmup"}
_KERNELS = ("fused_linear_ey", "exact_tree_phi", "exact_tree_inter")

#: broadcast header fields: ``[cmd, rows, bucket]``.  The bucket field
#: lets followers size the payload without any ladder knowledge of their
#: own — the header IS the framing contract.
_HEADER_LEN = 3


def _chunk_elems(n_features: int) -> int:
    """The wire's fixed MTU, in float32 elements.

    EVERY collective op on the wire is a float32 array of exactly this
    many elements — the header chunk (``[cmd, rows, bucket]`` zero-padded)
    and each payload chunk alike.  Shape-uniform ops are a CORRECTNESS
    requirement: gloo matches in-flight ops per connection pair by slot,
    and back-to-back host collectives of *different* byte sizes can
    cross-match under pipelining and abort the process with a preamble
    length mismatch (``op.preamble.length <= op.nbytes``).  With one MTU
    there is no op-size transition anywhere in the protocol.  Bucketing's
    win becomes op COUNT: a frame carries ``1 + ceil(bucket*n_features/
    mtu)`` chunks, proportional to its bucket instead of the full slot."""

    return _HEADER_LEN + int(n_features)


def _payload_chunks(bucket: int, n_features: int) -> int:
    """Payload chunk count for one frame (header chunk excluded)."""

    chunk = _chunk_elems(n_features)
    return -(-(int(bucket) * int(n_features)) // chunk)


class CollectiveTransport:
    """The collective wire: ``dist.broadcast`` from rank 0 of fixed-MTU
    float32 host tensors on a gloo group (the default group when it is
    gloo, else a gloo group made for the wire), plus the process identity
    the protocol keys on.  Tests drive :class:`MultihostServingModel` and
    :func:`follower_loop` with an in-process fake instead.

    ``needs_uniform_ops`` is True: every op on this wire must be one fixed
    shape (see :func:`_chunk_elems`), so frames are MTU-chunked.  An idle
    follower waits inside a broadcast, which the group's timeout bounds;
    :func:`_default_transport` prefers the host-side KV wire."""

    needs_uniform_ops = True

    def __init__(self):
        self._group = None
        if process_count() > 1 and collective_backend() != "gloo":
            # a collective every rank makes once per serve session, in order
            self._group = torch.distributed.new_group(backend="gloo")

    @property
    def is_lead(self) -> bool:
        return process_index() == 0

    @property
    def process_index(self) -> int:
        return process_index()

    @property
    def process_count(self) -> int:
        return process_count()

    def broadcast(self, value, is_source: bool):
        arr = np.array(value, dtype=np.float32, copy=True)
        if process_count() == 1:
            return arr
        t = torch.from_numpy(arr)
        torch.distributed.broadcast(t, src=0, group=self._group)
        return t.numpy()


#: Process-local count of KV transport constructions, used to derive the
#: session key prefix WITHOUT any wire traffic: the lead constructs its
#: transport once per serve (in the model) and each follower once per
#: serve (at follower_loop entry), so the Nth construction on every
#: process belongs to the same serve session and the prefixes pair up.
_kv_session_counter = itertools.count()

#: seconds one blocking wait on the store lasts before the follower loops
#: (idle gaps between requests are normal)
_KV_WAIT_S = 5.0


class KVStoreTransport:
    """Host-side wire over the group's ``TCPStore`` — the default serving
    wire.

    A collective broadcast on a device would queue behind every explain
    already dispatched there and serialise the very pipeline it feeds;
    frames on the store never touch a device queue, so the lead's dispatch
    stays sub-millisecond whatever the device backlog, and any message size
    is safe — no collective op-shape matching, hence no MTU chunking
    (``needs_uniform_ops`` is False) and frame bytes exactly proportional
    to the broadcast bucket.

    Protocol: the lead ``set``\\ s each op's bytes under a monotonically
    increasing sequence key of this session; followers ``wait`` on the
    next key in order (bounded waits in a loop: idle gaps are normal) and
    ``get`` it.  Keys ``_GC_WINDOW`` ops behind the head are deleted as new
    ones are published — followers trail the lead by at most the pipeline
    depth, so the window bounds the store's memory without racing a
    reader.  ``store`` defaults to :func:`~distributedkernelshap_tpu_torch.
    parallel.mesh.coordination_store`."""

    needs_uniform_ops = False
    _GC_WINDOW = 4096

    def __init__(self, store=None):
        store = store if store is not None else coordination_store()
        if store is None:
            raise RuntimeError(
                "torch.distributed is not initialized; the KV-store wire "
                "needs the group's coordination store")
        self._store = store
        self._session = f"dks/pod/wire/s{next(_kv_session_counter)}"
        self._seq = 0

    @property
    def is_lead(self) -> bool:
        return process_index() == 0

    @property
    def process_index(self) -> int:
        return process_index()

    @property
    def process_count(self) -> int:
        return process_count()

    def broadcast(self, value, is_source: bool):
        template = np.asarray(value)
        key = f"{self._session}/{self._seq}"
        self._seq += 1
        if is_source:
            self._store.set(key, np.ascontiguousarray(template).tobytes())
            stale = self._seq - self._GC_WINDOW - 1
            if stale >= 0:
                self._store.delete_key(f"{self._session}/{stale}")
            return template
        waits = 0
        while True:
            try:
                self._store.wait([key], datetime.timedelta(seconds=_KV_WAIT_S))
                break
            except torch.distributed.DistStoreError:
                # a timed-out wait between requests is the idle-server norm;
                # a store that went away raises DistNetworkError, which
                # propagates and ends the follower
                waits += 1
                if waits % 24 == 0:
                    logger.debug("follower still waiting on %s", key)
        raw = self._store.get(key)
        return np.frombuffer(raw, dtype=template.dtype).reshape(template.shape).copy()


def _default_transport():
    """The serving wire: the host-side KV transport when the group has a
    coordination store (always, under ``initialize_multihost``), else the
    collective wire.  The resolution depends only on process-global state
    that is the same on every process, so every process picks the same
    wire."""

    try:
        return KVStoreTransport()
    except RuntimeError:
        return CollectiveTransport()


# ---------------------------------------------------------------------- #
# Broadcast metering.  Process-global counters with a registry callback
# (the ``attach_treeshap_metrics`` pattern): the pod model is constructed
# before the server's registry exists, and the follower side has no
# registry at all, so the counts live here and the lead's server renders
# them as ``dks_pod_bcast_bytes_total{bucket}`` /
# ``dks_pod_bcast_seconds_total``.

_pod_meter_lock = lockwitness.make_lock("multihost.pod_meter")
_pod_bcast_bytes: dict = {}
_pod_bcast_seconds: float = 0.0


def record_pod_bcast(bucket: int, nbytes: int, seconds: float) -> None:
    """Count one framed broadcast (header + bucket-padded payload)."""

    global _pod_bcast_seconds
    key = str(int(bucket))
    with _pod_meter_lock:
        _pod_bcast_bytes[key] = _pod_bcast_bytes.get(key, 0.0) + float(nbytes)
        _pod_bcast_seconds += float(seconds)


def pod_bcast_byte_counts() -> dict:
    """``{(bucket,): bytes}`` — the registry-callback shape."""

    with _pod_meter_lock:
        return {(b,): n for b, n in _pod_bcast_bytes.items()}


def pod_bcast_seconds_total() -> float:
    with _pod_meter_lock:
        return _pod_bcast_seconds


class _FrameLog:
    """The frames one pod member served, by command, each recorded in the
    flight recorder as a ``pod_frame`` event with the running counts and
    this process's hand-kernel launches (the wrappers' own counts) after
    the frame's dispatch: a member's launches can be held against the
    frames it served from its ``/debugz`` alone."""

    def __init__(self, role: str):
        self.role = role
        self.frames = {name: 0 for name in _CMD_NAMES.values()}

    def record(self, cmd: int, rows: int, bucket: int) -> None:
        from distributedkernelshap_tpu_torch.ops import cuda_kernels

        self.frames[_CMD_NAMES[cmd]] += 1
        flightrec().record("pod_frame", role=self.role, cmd=_CMD_NAMES[cmd], rows=rows,
                           bucket=bucket, frames=dict(self.frames),
                           launches={k: getattr(cuda_kernels, k).launches
                                     for k in _KERNELS})


def attach_pod_metrics(registry) -> None:
    """Register the ``dks_pod_*`` broadcast meters on ``registry`` as
    callback counters over the process-global accounting.  The bucket
    label space is the broadcast ladder — bounded by construction, so no
    cardinality declaration is needed."""

    registry.counter(
        "dks_pod_bcast_bytes_total",
        "Bytes broadcast lead-to-followers on the pod serving fabric "
        "(header + payload padded to the broadcast bucket), by bucket "
        "— proportional-to-bucket by construction, vs the old "
        "protocol's every-batch full slot.",
        labelnames=("bucket",)).set_function(pod_bcast_byte_counts)
    registry.counter(
        "dks_pod_bcast_seconds_total",
        "Seconds the lead's dispatcher spent inside pod broadcast "
        "sends (header + payload, explain and warmup "
        "frames).").set_function(pod_bcast_seconds_total)


def broadcast_buckets(model, max_rows: int) -> List[int]:
    """The broadcast bucket ladder for ``model``: its engine's compile
    buckets over ``1..max_rows`` (the warmup ladder's rungs — shapes the
    mesh warms anyway), capped at and always including ``max_rows``;
    a power-of-two ladder when the engine's batches are not bucketed."""

    from distributedkernelshap_tpu_torch.serving.server import ExplainerServer

    max_rows = int(max_rows)
    bucket = ExplainerServer._bucket_fn(model)
    if bucket is None:
        sizes, b = {max_rows}, 1
        while b < max_rows:
            sizes.add(b)
            b *= 2
        return sorted(sizes)
    sizes = {min(int(bucket(n)), max_rows) for n in range(1, max_rows + 1)}
    sizes.add(max_rows)
    return sorted(sizes)


class MultihostServingModel:
    """Wraps a fitted serving model (``KernelShapModel``-like) so every
    device call is preceded by a header+batch broadcast to the follower
    processes.

    Parameters
    ----------
    model
        A fitted single-process serving model whose explainer was built
        with ``distributed_opts`` spanning the multi-process mesh.
    max_rows
        Broadcast slot bound: the largest batch the protocol carries.
        The server reads this attribute to reject single over-slot
        requests with 413 at enqueue time and to stop coalescing before
        a stacked batch would overflow the slot; the check in
        :meth:`explain_batch` is the backstop.  Batches are padded only
        to the smallest broadcast *bucket* that fits them, not to this
        slot.
    buckets
        Broadcast bucket ladder (sorted rung sizes, last == ``max_rows``).
        Defaults to :func:`broadcast_buckets`.
    transport
        Broadcast transport; defaults to :func:`_default_transport`.  Tests
        inject an in-process fake.
    """

    def __init__(self, model, max_rows: int = 256,
                 buckets: Optional[Sequence[int]] = None,
                 transport=None):
        self.model = model
        self.explainer = model.explainer  # passthrough for introspection
        self.max_rows = int(max_rows)
        self._transport = transport if transport is not None \
            else _default_transport()
        # collective wires need every op shape-uniform (MTU chunking);
        # host-side wires carry frames as-is
        self._uniform_wire = bool(
            getattr(self._transport, "needs_uniform_ops", True))
        self._n_features = int(
            model.explainer._explainer.background.shape[1])
        self.buckets = sorted(int(b) for b in (
            buckets if buckets is not None
            else broadcast_buckets(model, self.max_rows)))
        if not self.buckets or self.buckets[-1] != self.max_rows:
            raise ValueError(
                f"broadcast buckets {self.buckets} must be non-empty and "
                f"end at max_rows={self.max_rows}")
        # one lock serialises EVERY lead-side broadcast: the server's
        # dispatcher thread runs explain_batch while shutdown_followers may
        # be called from the main thread — interleaved broadcasts would
        # desync the followers' header/payload pairing
        self._bcast_lock = lockwitness.make_lock("multihost.bcast")
        self._shut = False
        # drain accounting: dispatches opened (broadcast sent) but not yet
        # completed — the shutdown handshake must flush these before the
        # shutdown broadcast, or followers (and the lead's own finalizers)
        # are stranded in half-finished collectives
        self._drain_cv = lockwitness.make_condition("multihost.drain")
        self._inflight = 0
        self._frames = _FrameLog("lead")
        if not self._transport.is_lead:
            raise RuntimeError(
                "MultihostServingModel must be constructed on the lead "
                "process only; followers run follower_loop()")

    # the server treats the absence of explain_batch_async as "dispatch
    # synchronously" — exactly what the lock-step protocol needs.

    @property
    def supports_wire_formats(self) -> bool:
        # per-slot wire formats only change the LEAD's host-side response
        # encoding — the device program and therefore the followers'
        # collective sequence are format-blind, so the capability passes
        # straight through
        return bool(getattr(self.model, "supports_wire_formats", False))

    def _bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if b >= rows:
                return b
        return self.max_rows

    def _broadcast_batch(self, stacked: np.ndarray,
                         cmd: int = _CMD_EXPLAIN) -> np.ndarray:
        """Validate + frame + broadcast one batch (caller holds
        ``_bcast_lock``); ONE implementation of the wire protocol so the
        sync, pipelined and warmup dispatch paths cannot drift their
        framing."""

        stacked = np.atleast_2d(np.asarray(stacked, dtype=np.float32))
        rows = stacked.shape[0]
        if rows > self.max_rows:
            raise ValueError(
                f"batch of {rows} rows exceeds the multihost broadcast slot "
                f"({self.max_rows}); raise max_rows or lower max_batch_size")
        if self._shut:
            # a batch the dispatcher popped before stop(): fail it as a
            # per-request error instead of broadcasting into a mesh whose
            # followers have already exited (a peerless collective hangs)
            raise RuntimeError("multihost serving mesh already shut down")
        bucket = self._bucket_for(rows)
        t0 = time.monotonic()
        if self._uniform_wire:
            chunk = _chunk_elems(self._n_features)
            n_chunks = _payload_chunks(bucket, self._n_features)
            header = np.zeros(chunk, np.float32)
            header[:_HEADER_LEN] = (cmd, rows, bucket)
            # bucket-padded payload, laid out as shape-uniform MTU chunks
            # (see _chunk_elems for why every wire op must be one shape)
            body = np.zeros(n_chunks * chunk, np.float32)
            body[:rows * self._n_features] = stacked.ravel()
            self._transport.broadcast(header, is_source=True)
            for i in range(n_chunks):
                self._transport.broadcast(body[i * chunk:(i + 1) * chunk],
                                          is_source=True)
            nbytes = (1 + n_chunks) * chunk * 4
        else:
            header = np.array([cmd, rows, bucket], np.float32)
            padded = np.zeros((bucket, self._n_features), np.float32)
            padded[:rows] = stacked
            self._transport.broadcast(header, is_source=True)
            self._transport.broadcast(padded, is_source=True)
            nbytes = header.nbytes + padded.nbytes
        record_pod_bcast(bucket, nbytes, time.monotonic() - t0)
        return stacked

    def _enter(self) -> None:
        with self._drain_cv:
            self._inflight += 1

    def _leave(self) -> None:
        with self._drain_cv:
            self._inflight -= 1
            if self._inflight <= 0:
                self._drain_cv.notify_all()

    def explain_batch(self, stacked: np.ndarray, split_sizes=None,
                      formats=None):
        kwargs = {} if formats is None else {"formats": formats}
        with self._bcast_lock:
            stacked = self._broadcast_batch(stacked)
            self._enter()
            try:
                out = self.model.explain_batch(stacked, split_sizes=split_sizes,
                                               **kwargs)
                self._frames.record(_CMD_EXPLAIN, len(stacked),
                                    self._bucket_for(len(stacked)))
                return out
            finally:
                self._leave()

    def warmup_batch(self, stacked: np.ndarray, split_sizes=None):
        """One collective-safe warmup rung: broadcast the rows under
        ``_CMD_WARMUP`` (followers run the SYNC explain on the same
        ``rows=<b>`` shape in lockstep) and run the lead's own sync explain.
        The server's warmup ladder calls this instead of
        :meth:`explain_batch` when present, so every process finishes its
        rung before ``/healthz`` flips ready."""

        stacked = np.atleast_2d(np.asarray(stacked, dtype=np.float32))
        flightrec().record("pod_warmup", role="lead",
                           rows=int(stacked.shape[0]),
                           bucket=self._bucket_for(int(stacked.shape[0])))
        with self._bcast_lock:
            stacked = self._broadcast_batch(stacked, cmd=_CMD_WARMUP)
            self._enter()
            try:
                out = self.model.explain_batch(stacked, split_sizes=split_sizes)
                self._frames.record(_CMD_WARMUP, len(stacked),
                                    self._bucket_for(len(stacked)))
                return out
            finally:
                self._leave()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait until no broadcast-dispatched device call is still in
        flight (sync calls in progress, pipelined dispatches whose
        finalize has not completed).  Returns ``False`` on timeout."""

        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._drain_cv:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._drain_cv.wait(left)
        return True

    def drain_and_shutdown(self, server=None, grace_s: float = 30.0) -> bool:
        """The rollout-safe shutdown handshake: stop accepting (``server
        .stop()`` fails queued work with retriable 503s and parks the
        dispatcher), flush every in-flight broadcast's device call, THEN
        broadcast shutdown — so followers never exit with a half-finished
        collective pending.  Returns whether the drain completed inside
        ``grace_s`` (shutdown is broadcast either way: at the grace
        boundary a wedged collective cannot be recovered from Python and
        the deployment's liveness probe is the backstop)."""

        if server is not None:
            server.stop()
        clean = self.drain(grace_s)
        flightrec().record("pod_drain", role="lead", clean=clean,
                           grace_s=grace_s)
        if not clean:
            logger.warning(
                "pod drain did not complete within %.1fs; broadcasting "
                "shutdown with work possibly in flight", grace_s)
        self.shutdown_followers()
        return clean

    def shutdown_followers(self):
        """Release the follower loops.  Idempotent: the first call
        broadcasts the shutdown header; later calls are no-ops (a second
        broadcast would block forever — the followers are gone).  Prefer
        :meth:`drain_and_shutdown` on live deployments."""

        with self._bcast_lock:
            if self._shut:
                return
            self._shut = True
            # bucket=0 -> zero payload: shutdown is a header-only frame
            # (on collective wires still padded to the one MTU shape)
            if self._uniform_wire:
                header = np.zeros(_chunk_elems(self._n_features), np.float32)
                header[:_HEADER_LEN] = (_CMD_SHUTDOWN, 0, 0)
            else:
                header = np.array([_CMD_SHUTDOWN, 0, 0], np.float32)
            self._transport.broadcast(header, is_source=True)
            self._frames.record(_CMD_SHUTDOWN, 0, 0)


def follower_loop(model, max_rows: int = 256, transport=None):
    """Run on every non-lead process: enter each broadcast explain call so
    the mesh's collectives pair with the lead's, until shutdown.

    ``model`` must be built from the SAME constructor/fit arguments as the
    lead's (SPMD discipline), with the same ``max_rows``.  Payload receive
    buffers are allocated per broadcast bucket from the header's bucket
    field — followers need no ladder knowledge of their own.
    """

    transport = transport if transport is not None else _default_transport()
    if transport.is_lead:
        raise RuntimeError("follower_loop must not run on the lead process")
    rank = transport.process_index
    inner = model.explainer._explainer
    n_features = int(inner.background.shape[1])
    # pipelined protocol (replicated results): the follower only needs to
    # ENTER each explain in broadcast order — dispatch async and defer the
    # finalize (it fetches nothing the follower uses), so the loop returns
    # to the wire at once and the lead can keep several calls in flight.
    # The LAST finalize is kept: blocking on it at shutdown proves every
    # earlier dispatch completed before this process tears down.
    pipelined = getattr(inner, 'replicate_results', False) \
        and hasattr(inner, 'get_explanation_async')
    last_fin = None
    uniform = bool(getattr(transport, "needs_uniform_ops", True))
    chunk = _chunk_elems(n_features)
    frames = _FrameLog("follower")
    while True:
        header = transport.broadcast(
            np.zeros(chunk if uniform else _HEADER_LEN, np.float32),
            is_source=False)
        cmd = int(round(float(header[0])))
        if cmd == _CMD_SHUTDOWN:
            frames.record(cmd, 0, 0)
            if last_fin is not None:
                try:
                    last_fin()
                except Exception:
                    logger.exception("follower %d: final pipelined fetch "
                                     "failed at shutdown", rank)
            flightrec().record("pod_drain", role="follower", rank=rank)
            logger.info("follower %d: shutdown", rank)
            return
        rows = int(round(float(header[1])))
        bucket = int(round(float(header[2])))
        if uniform:
            n_chunks = _payload_chunks(bucket, n_features)
            body = np.empty(n_chunks * chunk, np.float32)
            for i in range(n_chunks):
                body[i * chunk:(i + 1) * chunk] = transport.broadcast(
                    np.zeros(chunk, np.float32), is_source=False)
            padded = body[:bucket * n_features].reshape(bucket, n_features)
        else:
            padded = transport.broadcast(
                np.zeros((bucket, n_features), np.float32), is_source=False)
        if cmd == _CMD_WARMUP:
            # warmup rungs run the SYNC explain even on the pipelined
            # protocol: the point is this process's warm-up before the
            # lead's /healthz flips, not latency
            flightrec().record("pod_warmup", role="follower", rank=rank,
                               rows=rows, bucket=bucket)
            try:
                model.explainer.explain(padded[:rows], silent=True,
                                        **model.explain_kwargs)
                frames.record(cmd, rows, bucket)
            except Exception:
                logger.exception("follower %d: warmup rung failed; "
                                 "staying in loop", rank)
            continue
        if pipelined:
            try:
                last_fin = inner.get_explanation_async(padded[:rows],
                                                       **model.explain_kwargs)
                frames.record(cmd, rows, bucket)
            except Exception:
                logger.exception(
                    "follower %d: async dispatch failed; staying in loop",
                    rank)
            continue
        # identical DEVICE call as the lead's explain_batch (explain_batch
        # == explainer.explain + host-side response building): same bucket
        # padding, same sharded program, same collective sequence — the
        # response is built on the lead only
        try:
            model.explainer.explain(padded[:rows], silent=True,
                                    **model.explain_kwargs)
            frames.record(cmd, rows, bucket)
        except Exception:
            # mirror the lead's catch-and-continue (the server answers the
            # request with a 500 and keeps serving): a data-dependent
            # explain error must degrade to one failed request, not kill
            # this loop and leave the lead's next broadcast peerless.  An
            # error INSIDE a collective may leave the mesh unrecoverable
            # regardless; the group's timeout then ends the processes and
            # the supervisor restarts the pod
            logger.exception("follower %d: explain failed; staying in loop",
                             rank)


class PipelinedMultihostServingModel(MultihostServingModel):
    """Broadcast-protocol serving model whose device calls PIPELINE.

    Requires the wrapped model's explainer to be a ``DistributedExplainer``
    built with ``distributed_opts['replicate_results']=True``: phi/f(x)
    are then gathered across processes at dispatch, so the lead's fetch is
    a local copy with no collective and may run on any finalizer thread —
    collective order equals dispatch order on every process by
    construction (all broadcasts + dispatches happen on the lead's single
    dispatcher thread, and the follower's loop mirrors them in the same
    order with async dispatches).  ``serve_multihost`` selects this class
    by default; the lock-step base class remains for explainers without
    replicated results."""

    def __init__(self, model, max_rows: int = 256,
                 buckets: Optional[Sequence[int]] = None, transport=None):
        super().__init__(model, max_rows=max_rows, buckets=buckets,
                         transport=transport)
        inner = model.explainer._explainer
        if not getattr(inner, 'replicate_results', False):
            raise ValueError(
                "PipelinedMultihostServingModel needs "
                "distributed_opts['replicate_results']=True (fetches must "
                "be collective-free for pipelined finalizes)")

    def stage_rows(self, instances):
        """Staging hook so the server's batcher runs in front of the pod:
        batches are FORMED and stacked one step ahead of dispatch on the
        batcher thread.  Returns ``None`` deliberately — the upload (and
        the broadcast) must stay on the dispatcher thread under
        ``_bcast_lock``, because a batcher-thread broadcast could interleave
        with a concurrent shutdown broadcast and dispatch a program on the
        followers that the lead never enters."""

        return None

    def explain_batch_async(self, stacked: np.ndarray, split_sizes=None,
                            formats=None):
        kwargs = {} if formats is None else {"formats": formats}
        with self._bcast_lock:
            stacked = self._broadcast_batch(stacked)
            # dispatch INSIDE the lock: broadcast->dispatch must be atomic
            # against a concurrent shutdown broadcast, and the server's
            # single dispatcher thread is the only explain caller anyway
            fin = self.model.explain_batch_async(stacked,
                                                 split_sizes=split_sizes,
                                                 **kwargs)
            self._frames.record(_CMD_EXPLAIN, len(stacked), self._bucket_for(len(stacked)))
            self._enter()

        def finalize():
            try:
                return fin()
            finally:
                self._leave()

        return finalize


def follower_health_server(port: int, host: str = "0.0.0.0"):
    """Minimal listener for follower processes: ``/healthz`` and
    ``/debugz``.

    Followers must NOT serve the explain API (requests go to the lead), but
    a liveness probe against a port nobody listens on would kill a healthy
    follower in a restart loop.  ``/healthz`` answers process liveness only
    — deliberately WITHOUT a device round trip: an idle follower waits on
    the wire, and the wedge detector for the whole group is the LEAD's
    device-probing ``/healthz``.  ``/debugz`` returns this process's
    flight recorder, as the lead's server does (its ``pod_frame`` events
    carry the frames served and the kernel launches).  Returns the started
    ``ThreadingHTTPServer`` (daemon threads)."""

    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.rstrip("/")
            if path == "/debugz":
                body, code = json.dumps(flightrec().to_payload()).encode(), 200
            else:
                body = json.dumps({"status": "alive", "role": "follower"}).encode()
                code = 200 if path == "/healthz" else 404
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            logger.debug("follower health: " + fmt, *args)

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    logger.info("follower health listener on %s:%d", host, httpd.server_address[1])
    return httpd


def serve_multihost(predictor, background_data, constructor_kwargs,
                    fit_kwargs, distributed_opts, host: str = "0.0.0.0",
                    port: int = 8000, max_batch_size: int = 1,
                    max_rows: int = 256,
                    explain_kwargs: Optional[dict] = None,
                    pipeline_depth: Optional[int] = 4,
                    warmup: Optional[bool] = None,
                    staging: Optional[bool] = None):
    """Entry point for every process of a multi-process serve deployment.

    On the lead process: builds the fitted model over the multi-process
    mesh, wraps it for broadcast, starts the HTTP server and returns it
    (the caller stops it with ``model.drain_and_shutdown(server)``).  On a
    follower: starts the health listener on ``port`` (liveness probes must
    not kill members that rightly serve no explain API), builds the
    identical model and blocks in :func:`follower_loop` until shutdown
    (returns ``None``).

    The pipelined protocol is the DEFAULT: ``replicate_results`` defaults
    to True unless the caller pins it False in ``distributed_opts`` (every
    process applies the same default, so the mesh stays SPMD); options
    that cannot take the async path serve lock-step with a warning.
    ``warmup`` defaults to the environment resolution with pods ON (the
    ladder broadcasts as ``_CMD_WARMUP``, so all processes warm in
    lockstep before ``/healthz`` flips); ``staging`` defaults ON for the
    pipelined path and OFF for lock-step.
    """

    from distributedkernelshap_tpu_torch.serving.server import (
        ExplainerServer,
        resolve_warmup_env,
    )
    from distributedkernelshap_tpu_torch.serving.wrappers import (
        BatchKernelShapModel,
        KernelShapModel,
    )

    opts = dict(distributed_opts)
    # pipelined-by-default: the same resolution on every process (the
    # explain programs must agree across the mesh)
    opts.setdefault("replicate_results", True)
    cls = BatchKernelShapModel if max_batch_size > 1 else KernelShapModel
    ctor = dict(constructor_kwargs)
    ctor["distributed_opts"] = opts
    base = cls(predictor, background_data, ctor, fit_kwargs,
               explain_kwargs=explain_kwargs)
    if process_index() != 0:
        health = follower_health_server(port, host=host)
        try:
            follower_loop(base, max_rows=max_rows)
        finally:
            health.shutdown()
            health.server_close()
        return None
    pipelined = bool(opts.get("replicate_results"))
    if pipelined:
        # the deployment's explain options must actually take the async
        # path — otherwise every request lands in the synchronous fallback
        # inside the broadcast lock and the dispatch-time gather is pure
        # cost with no pipelining.  Detect it here and degrade loudly to
        # the lock-step protocol
        inner = base.explainer._explainer
        kw = dict(base.explain_kwargs)
        if not inner.takes_async_fast_path(
                max_rows, nsamples=kw.get("nsamples"),
                l1_reg=kw.get("l1_reg", "auto"),
                interactions=bool(kw.get("interactions"))):
            logger.warning(
                "replicate_results=True but explain options (%r) route "
                "every request through the synchronous fallback (exact / "
                "interactions / active l1 selection / slab-split batches); "
                "serving LOCK-STEP instead — drop those options or set "
                "l1_reg=False to pipeline.", kw)
            pipelined = False
    if warmup is None:
        warmup = resolve_warmup_env(default=True)
    if pipelined:
        # replicated results -> collective-free fetches -> the broadcast
        # protocol pipelines at the server's depth, with the staging
        # batcher forming batches one step ahead
        model = PipelinedMultihostServingModel(base, max_rows=max_rows)
        server = ExplainerServer(model, host=host, port=port,
                                 max_batch_size=max_batch_size,
                                 pipeline_depth=pipeline_depth,
                                 warmup=warmup,
                                 staging=True if staging is None else staging)
    else:
        model = MultihostServingModel(base, max_rows=max_rows)
        server = ExplainerServer(model, host=host, port=port,
                                 max_batch_size=max_batch_size,
                                 pipeline_depth=1, warmup=warmup,
                                 staging=bool(staging))
    # chargeback: the pod's device-seconds span EVERY process's devices —
    # the SPMD program occupies all of them for the lead-measured
    # interval, so the meter bills elapsed x process_count
    server._costmeter.set_device_multiplier(process_count())
    return server.start()
