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

Multi-process execution (a ``torch.distributed`` group of more than one
process, whose fetches would have to agree on one order and one window)
is ROADMAP.md queue A item 10 and raises ``NotImplementedError`` here.
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

logger = logging.getLogger(__name__)

#: fixed window used whenever a measured one is unavailable (probe failure)
DETERMINISTIC_WINDOW = 3

#: in-flight ceiling: each slot holds one chunk's device-resident
#: inputs+outputs, so the window bounds peak device memory of the loop
MAX_WINDOW = 8

_rtt_cache: Dict[str, float] = {}
_rtt_lock = threading.Lock()


def _check_single_process() -> None:
    """Raise where ``torch.distributed`` runs more than one process: the
    window and the fetch order would have to agree across processes
    (ROADMAP.md queue A item 10)."""

    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "multi-process dispatch pipelining (torch.distributed world size "
            f"{dist.get_world_size()}) is ROADMAP.md queue A item 10 and not "
            "ported yet")


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
    hides at least one fetch behind in-flight compute.  Raises
    ``NotImplementedError`` under a multi-process ``torch.distributed``
    group (ROADMAP.md queue A item 10)."""

    _check_single_process()
    cap = MAX_WINDOW if n_items is None else max(1, min(MAX_WINDOW, n_items))
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
    if resolved is None:
        try:
            rtt = device_round_trip_s(device=device)
        except Exception:  # a probe failure must not break an explain call
            logger.warning("device RTT probe failed; window=%d",
                           DETERMINISTIC_WINDOW, exc_info=True)
            resolved = min(DETERMINISTIC_WINDOW, cap)
        else:
            resolved = max(2, min(1 + math.ceil(rtt / 0.010), cap))
    return resolved


def run_pipeline(items: Iterable[Any],
                 dispatch: Callable[[Any], Any],
                 fetch: Callable[[Any], Any],
                 window: int,
                 threaded: bool = True,
                 journal=None) -> List[Any]:
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

    # per-item spans: journaled loops are batch runs (each item's
    # dispatch→fetch interval, restored items tagged as such); a loop
    # running under a request's adopted context parents its items to it
    tr = _tracing.tracer()
    trace_parent = _tracing.current_context() if tr.enabled else None
    traced = tr.enabled and (journal is not None or trace_parent is not None)

    def finish(index, handle, t_disp):
        result = fetch(handle)
        if traced:
            tr.record_mono("pool.shard", t_disp, time.monotonic(),
                           parent=trace_parent, index=index)
        if injector is not None:
            injector.fire("pool.shard")
        if journal is not None:
            journal.put(index, result)
        return result

    if journal is not None:
        restored = {i: journal.get(i) for i in range(len(items))}
        restored = {i: r for i, r in restored.items() if r is not None}
        if traced and restored:
            now = time.monotonic()
            for i in restored:
                tr.record_mono("pool.shard", now, now, parent=trace_parent,
                               index=i, restored=True)
    else:
        restored = {}

    if not threaded or window <= 1 or len(items) <= 1:
        pending: deque = deque()
        results: List[Any] = [None] * len(items)
        for i, it in enumerate(items):
            if i in restored:
                results[i] = restored[i]
                continue
            t_disp = time.monotonic()
            pending.append((i, dispatch(it), t_disp))
            if len(pending) >= window:
                j, handle, t_disp = pending.popleft()
                results[j] = finish(j, handle, t_disp)
        while pending:
            j, handle, t_disp = pending.popleft()
            results[j] = finish(j, handle, t_disp)
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
            sem.acquire()  # bounds dispatched-but-unfetched items
            if failed.is_set():
                break  # burn no device work after a fatal fetch error
            t_disp = time.monotonic()
            handle = dispatch(it)

            def _fetch(i=i, handle=handle, t_disp=t_disp):
                try:
                    results[i] = finish(i, handle, t_disp)
                except BaseException:
                    failed.set()
                    raise
                finally:
                    sem.release()

            futures.append(pool.submit(_fetch))
        for f in futures:
            f.result()
        return results
