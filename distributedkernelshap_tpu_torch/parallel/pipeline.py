"""Bounded dispatch/fetch pipelining of a multi-call explain.

Port of ``distributedkernelshap_tpu/parallel/pipeline.py``.  The engine's
instance-chunk loop processes a long batch as a sequence of device calls
and needs two things:

* **dispatch ahead of fetch**: PyTorch launches CUDA work asynchronously,
  so chunk k+1's kernels can be queued while chunk k's device-to-host copy
  is in flight;
* **overlapping fetches**: a copy blocks its calling thread, so fetches
  fan out to a small pool of threads.

The in-flight window is resolved in one place: an explicit request beats
the ``DKS_DISPATCH_WINDOW`` environment knob beats a latency-derived
default measured by one cheap round-trip probe on the engine's device.

Under several processes (a ``torch.distributed`` group) a sharded fetch
carries collectives, so every process must dispatch and fetch in the same
order with the same window: the resolver never probes there, and rank 0's
window is broadcast to all (:func:`resolve_window`); the callers run such
fetches with ``threaded=False``.
A :class:`~distributedkernelshap_tpu_torch.resilience.journal.ShardJournal`
makes a :func:`run_pipeline` loop restartable.
"""

import logging
import math
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import torch

import distributedkernelshap_tpu_torch.observability.tracing as _tracing
from distributedkernelshap_tpu_torch.parallel.mesh import (
    broadcast_int,
    process_count,
    process_index,
)
from distributedkernelshap_tpu_torch.profiling import span

logger = logging.getLogger(__name__)

#: fixed window used whenever a measured one is unavailable (probe failure)
DETERMINISTIC_WINDOW = 3

#: in-flight ceiling: each slot holds one chunk's device-resident
#: inputs+outputs, so the window bounds peak device memory of the loop
MAX_WINDOW = 8

_rtt_cache: Dict[str, float] = {}
_rtt_lock = threading.Lock()

# the agreed window under several processes, per (requested, env, cap): the
# broadcast is a blocking collective and the answer cannot change for the
# process's life.  Every process runs the same driver code, so the cache
# misses (and the broadcasts) stay symmetric across processes
_window_cache: Dict[tuple, int] = {}


def device_round_trip_s(probes: int = 3, refresh: bool = False,
                        device: Optional[Union[str, torch.device]] = None) -> float:
    """Median wall-clock of a tiny device op plus its copy to the host on
    ``device`` (default: the current CUDA device where there is one, else
    the CPU).  The payload is 8 floats, so this is pure launch and copy
    latency: ~10–100 µs on a locally attached card, microseconds on the
    CPU.  Cached per device and process; the probe itself costs ``probes``
    round trips."""

    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    key = str(device)
    with _rtt_lock:
        if key in _rtt_cache and not refresh:
            return _rtt_cache[key]
        x = torch.arange(8, dtype=torch.float32, device=device)
        (x + 0.0).cpu()  # warm: context creation and first launch
        times = []
        for i in range(1, probes + 1):
            t0 = time.perf_counter()
            (x + float(i)).cpu()  # the copy waits for the op
            times.append(time.perf_counter() - t0)
        _rtt_cache[key] = float(sorted(times)[len(times) // 2])
        logger.debug("device round trip on %s: %.3f ms", key, _rtt_cache[key] * 1e3)
        return _rtt_cache[key]


def resolve_window(requested: Optional[int] = None,
                   n_items: Optional[int] = None,
                   device: Optional[Union[str, torch.device]] = None) -> int:
    """Resolve the dispatch window of a multi-call explain loop.

    Priority: ``requested`` (``EngineConfig.dispatch_window``) >
    ``DKS_DISPATCH_WINDOW`` env > latency-derived default
    ``1 + ceil(rtt / 10 ms)`` clamped to ``[2, MAX_WINDOW]``, with ``rtt``
    probed on ``device``: a locally attached card or the CPU resolves to 2.
    The 10 ms divisor is the reference's: the round figure below the
    smallest per-chunk device time it saw at benchmark shapes, so the window
    hides at least one fetch behind in-flight compute.

    Under several processes the window must be the same on every process
    (the fetches carry collectives): the probe is skipped, each process
    resolves explicit / env / :data:`DETERMINISTIC_WINDOW` locally, and
    rank 0's value is broadcast to all, once per ``(requested, env, cap)``
    (the inputs, not the resolved value: under a per-host skew two call
    sites can resolve to one value here and two on a peer, and a key on
    the value would then broadcast a different number of times).  A skew
    is a logged warning, not a wedge.  Without a live group behind the
    count the local value stands."""

    cap = MAX_WINDOW if n_items is None else max(1, min(MAX_WINDOW, n_items))
    multiprocess = process_count() > 1
    resolved: Optional[int] = None
    if requested is not None:
        if int(requested) < 1:
            # warn-and-degrade: an explicit non-positive request is
            # meaningless, so fall through to env/probe resolution
            logger.warning("ignoring non-positive dispatch_window=%r", requested)
        else:
            if int(requested) > cap:
                logger.info("clamping explicit dispatch_window=%d to %d "
                            "(MAX_WINDOW/n_items bound)", int(requested), cap)
            resolved = max(1, min(int(requested), cap))
    if resolved is None and cap < 2:
        resolved = cap  # nothing to pipeline: skip the probe entirely
    if resolved is None:
        env = os.environ.get("DKS_DISPATCH_WINDOW")
        if env:
            try:
                resolved = max(1, min(int(env), cap))
            except ValueError:
                logger.warning("ignoring non-integer DKS_DISPATCH_WINDOW=%r", env)
    if resolved is None and multiprocess:
        resolved = min(DETERMINISTIC_WINDOW, cap)
    if resolved is None:
        try:
            rtt = device_round_trip_s(device=device)
        except Exception:  # a probe failure must not break an explain call
            logger.warning("device RTT probe failed; window=%d",
                           DETERMINISTIC_WINDOW, exc_info=True)
            resolved = min(DETERMINISTIC_WINDOW, cap)
        else:
            resolved = max(2, min(1 + math.ceil(rtt / 0.010), cap))
    if multiprocess:
        key = (requested, os.environ.get("DKS_DISPATCH_WINDOW"), cap)
        if key in _window_cache:
            return _window_cache[key]
        try:
            agreed = broadcast_int(resolved)
        except (RuntimeError, ValueError):
            # no live group behind the count (a spoofed count, a backend
            # without collectives): the local resolution is the only one
            logger.warning("dispatch-window broadcast unavailable; using "
                           "locally resolved %d", resolved, exc_info=True)
            return resolved
        if agreed != resolved:
            logger.warning(
                "dispatch window %d on process %d differs from rank 0's %d; "
                "using rank 0's (per-host env/config skew?)",
                resolved, process_index(), agreed)
        resolved = max(1, min(agreed, cap))
        _window_cache[key] = resolved
    return resolved


def run_pipeline(items: Iterable[Any],
                 dispatch: Callable[[Any], Any],
                 fetch: Callable[[Any], Any],
                 window: int,
                 threaded: bool = True,
                 journal=None,
                 describe: Optional[Callable[[Any], Dict[str, Any]]] = None) -> List[Any]:
    """``[fetch(dispatch(item)) for item in items]`` with bounded overlap.

    ``dispatch`` runs on the calling thread, in order (it may populate the
    engine's caches and keeps the device's launch order deterministic); at
    most ``window`` dispatched-but-unfetched items exist at any moment,
    bounding peak device residency.  With ``threaded=True`` fetches fan out
    to a small pool so their copies overlap; results come back in item
    order regardless.  ``threaded=False`` keeps a serial sliding window.

    ``journal`` (a :class:`~distributedkernelshap_tpu_torch.resilience.
    journal.ShardJournal`) makes the loop restartable: items whose index
    is already journaled are restored from disk without dispatching ANY
    device work, and each fresh fetch is durably recorded before the loop
    moves on — a killed run recomputes only the items in flight when it
    died.  The chaos site ``pool.shard`` fires between fetch and record,
    so an injected ``crash:site=pool.shard,after=K`` loses exactly the
    K-th item's work — the worst case a resume must absorb.  A journaled
    fetch must return a sequence of arrays (the journal's record).

    While tracing is live (``profiling.span``) each item's dispatch is a
    ``phase.dispatch`` span and the calling thread's waits for a window
    slot or for outstanding fetches are ``phase.pipeline_wait`` spans; with
    the tracer on, each item's dispatch→fetch interval is also a
    ``pool.shard`` span (restored items tagged as such), and the fetch
    threads adopt it as their context, so a fetch's own spans parent to
    it.  ``describe(item)`` gives the dispatch and shard spans' counters
    (e.g. rows and padded rows); the item's index is always one.

    A fetch/dispatch exception propagates to the caller after in-flight
    work drains (the executor joins on exit), and a failed fetch stops
    further dispatches.
    """

    items = list(items)
    window = max(1, int(window))
    # the pool.shard chaos site exists ONLY on journaled loops: its
    # contract is "fetch done, journal record not yet written", and firing
    # it from the engine's internal per-chunk pipelines would make an
    # after=K kill count unrelated hits (and let a fleet-wide DKS_FAULTS
    # pool spec crash serving workers through their in-server pipelines)
    injector = None
    if journal is not None:
        from distributedkernelshap_tpu_torch.resilience.faults import env_injector

        injector = env_injector()

    tr = _tracing.tracer()

    def counters(index, item):
        return dict(describe(item) if describe is not None else {}, index=index)

    def start(index, item):
        """Dispatch ``item``: ``(handle, shard span or None)``."""

        attrs = counters(index, item) if tr.enabled else {}
        shard = tr.begin("pool.shard", **attrs) if tr.enabled else None
        with span("phase.dispatch", **attrs):
            handle = dispatch(item)
        return handle, shard

    def finish(index, handle, shard):
        with _tracing.use_context(shard.context if shard is not None else None):
            result = fetch(handle)
        tr.end(shard)
        if injector is not None:
            injector.fire("pool.shard")
        if journal is not None:
            journal.put(index, result)
        return result

    if journal is not None:
        restored = {i: journal.get(i) for i in range(len(items))}
        restored = {i: r for i, r in restored.items() if r is not None}
        if tr.enabled:
            for i in restored:
                tr.end(tr.begin("pool.shard", index=i, restored=True))
    else:
        restored = {}

    if not threaded or window <= 1 or len(items) <= 1:
        pending: deque = deque()
        results: List[Any] = [None] * len(items)
        for i, it in enumerate(items):
            if i in restored:
                results[i] = restored[i]
                continue
            pending.append((i, *start(i, it)))
            if len(pending) >= window:
                j, handle, shard = pending.popleft()
                with span("phase.pipeline_wait"):
                    results[j] = finish(j, handle, shard)
        while pending:
            j, handle, shard = pending.popleft()
            with span("phase.pipeline_wait"):
                results[j] = finish(j, handle, shard)
        return results

    sem = threading.BoundedSemaphore(window)
    failed = threading.Event()  # fail fast: stop dispatching once a fetch dies
    results = [None] * len(items)
    with ThreadPoolExecutor(max_workers=min(window, MAX_WINDOW)) as pool:
        futures = []
        for i, it in enumerate(items):
            if i in restored:
                results[i] = restored[i]
                continue
            with span("phase.pipeline_wait"):
                sem.acquire()  # bounds dispatched-but-unfetched items
            if failed.is_set():
                break  # burn no device work after a fatal fetch error
            handle, shard = start(i, it)

            def _fetch(i=i, handle=handle, shard=shard):
                try:
                    results[i] = finish(i, handle, shard)
                except BaseException:
                    failed.set()
                    raise
                finally:
                    sem.release()

            futures.append(pool.submit(_fetch))
        with span("phase.pipeline_wait"):
            for f in futures:
                f.result()
        return results
