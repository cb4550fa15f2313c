"""SLO-aware continuous-batching scheduler.

Replaces :class:`ExplainerServer`'s FIFO ``queue.Queue`` + ``_fill_batch``
poll loop (``serving/server.py``, rounds 1-5).  The FIFO had three
production-scale problems the ROADMAP north star ("heavy traffic from
millions of users") runs straight into:

* **No priorities or deadlines** — a 1-row interactive request parks behind
  a 2000-row batch job; under overload every request waits and then the
  whole queue times out together.
* **Idle polling** — the dispatcher woke every 0.1 s to check for work, so
  a lone request paid up to 100 ms of scheduling latency before the device
  ever saw it.
* **A one-slot carry** — a request deferred because it would overflow the
  model's ``max_rows`` broadcast slot lived in a side variable the watchdog
  drain could not see.

This scheduler keeps every queued request in ONE earliest-deadline-first
heap.  Each request carries a priority class (``interactive`` / ``batch`` /
``best_effort``) and an optional absolute deadline; requests without an
explicit deadline are ordered by ``enqueue_time + class budget``, so under
contention interactive traffic sorts ahead of batch traffic *by
construction* rather than via separate queues that need cross-queue
starvation rules.  Batch formation pops in EDF order and packs rows up to
the model's ``max_rows`` budget; an item that would overflow is pushed back
into the heap with its original key, where the advancing clock makes it the
earliest item — it leads the next batch, so deferral can never starve it.
Wakeups are condition-variable driven: ``put`` notifies the dispatcher, so
an idle server dispatches a lone request immediately instead of on the next
poll tick.

The gemma-on-TPU serving comparison and Podracer's centralized batcher
(PAPERS.md) both locate exactly this layer — batch formation by deadline
and cost — as where accelerator serving throughput comes from.
"""

import heapq
import logging
import queue
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from distributedkernelshap_tpu_torch.analysis import lockwitness

logger = logging.getLogger(__name__)

PRIORITY_CLASSES = ("interactive", "batch", "best_effort")

# Ordering budgets (seconds): a request with no explicit deadline is
# scheduled as if it were due ``enqueue + budget[class]``.  These are
# *ordering* knobs only — nothing is shed for missing an implicit budget;
# shedding applies solely to requests that declared a real deadline.
DEFAULT_CLASS_BUDGETS_S: Dict[str, float] = {
    "interactive": 0.5,
    "batch": 30.0,
    "best_effort": 120.0,
}

# queue-wait histogram bounds (seconds): finer than the request-latency
# buckets at the low end — queue wait is the scheduler's own contribution
# to latency and the interactive budget is 0.5 s
QUEUE_WAIT_BUCKETS_S = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                        1.0, 2.5, 5.0, 10.0, 30.0)


class SLOScheduler:
    """EDF request queue with row-budget batch formation.

    Items must expose ``klass`` (one of :data:`PRIORITY_CLASSES`),
    ``deadline`` (absolute ``time.monotonic`` seconds, or ``None``),
    ``t_enqueued`` (monotonic), ``rows`` (int) and ``done`` (bool — set by
    whoever answers the request out-of-band, e.g. the server's wedge path;
    done items are dropped, not dispatched).

    Only one consumer thread may call :meth:`next_batch` (the server runs
    one dispatcher); any number of producers may :meth:`put`.
    """

    def __init__(self, class_budgets: Optional[Dict[str, float]] = None,
                 now=time.monotonic):
        self._budgets = dict(DEFAULT_CLASS_BUDGETS_S)
        if class_budgets:
            self._budgets.update(class_budgets)
        self._now = now
        # named for the runtime lock-order witness (DKS_LOCK_WITNESS)
        self._cond = lockwitness.make_condition("scheduler.cond")
        self._heap: List[Tuple[float, int, object]] = []
        self._seq = 0
        self._depths: Dict[str, int] = {k: 0 for k in PRIORITY_CLASSES}
        self._queued_rows = 0
        self._stopped = False
        # deficit-round-robin state for tenant-aware packing (grouped
        # next_batch only): group key -> row deficit.  A group passed over
        # this cycle keeps its credit and leads a later one, so a
        # high-rate tenant can never starve another tenant's batch past
        # its share.  Bounded (LRU) — keys are tenant/share identities.
        self._drr: "OrderedDict[object, float]" = OrderedDict()
        # observability (attach_metrics): None until the owner attaches a
        # registry — the scheduler is also used standalone in unit tests
        self._m_enqueued = None
        self._m_queue_wait = None
        self._m_expired = None
        self._m_pushbacks = None
        self._m_requeues = None

    def attach_metrics(self, registry) -> None:
        """Register this scheduler's ``dks_sched_*`` series on the
        owner's :class:`~distributedkernelshap_tpu_torch.observability.metrics.
        MetricsRegistry` — the server calls this so queue behaviour
        (wait, expiries, packing pushback) renders on the same ``/metrics``
        page as the serving counters.  Queue DEPTH stays the server-owned
        ``dks_serve_queue_depth`` gauge (pre-existing name, preserved)."""

        self._m_enqueued = registry.counter(
            "dks_sched_enqueued_total",
            "Requests accepted into the scheduler queue.",
            labelnames=("class",)).seed(*[(k,) for k in PRIORITY_CLASSES])
        self._m_queue_wait = registry.histogram(
            "dks_sched_queue_wait_seconds",
            "Time from enqueue to batch claim.",
            buckets=QUEUE_WAIT_BUCKETS_S, labelnames=("class",))
        self._m_expired = registry.counter(
            "dks_sched_expired_total",
            "Requests whose explicit deadline passed while queued.",
            labelnames=("class",)).seed(*[(k,) for k in PRIORITY_CLASSES])
        self._m_pushbacks = registry.counter(
            "dks_sched_row_budget_pushbacks_total",
            "Items deferred to a later batch by packing: the row budget, "
            "or — under tenant-aware grouped formation — bucket-boundary "
            "trims, deficit-round-robin displacement and quota-yield "
            "caps (routine under healthy multi-tenant load, not a "
            "pressure signal there).")
        self._m_requeues = registry.counter(
            "dks_sched_requeues_total",
            "Partially-served requests re-entered into the queue at a "
            "preemption point (anytime refinement round boundaries): each "
            "re-entry competes under EDF again, so an earlier-deadline "
            "arrival preempts further refinement.",
            labelnames=("class",)).seed(*[(k,) for k in PRIORITY_CLASSES])

    # -- ordering hooks (FIFOScheduler overrides) ----------------------- #

    def _effective_deadline(self, item) -> float:
        if getattr(item, "deadline", None) is not None:
            return item.deadline
        budget = self._budgets.get(getattr(item, "klass", "batch"),
                                   self._budgets["batch"])
        return item.t_enqueued + budget

    def _is_expired(self, item, now: float) -> bool:
        deadline = getattr(item, "deadline", None)
        return deadline is not None and now > deadline

    # -- producer side -------------------------------------------------- #

    def put(self, item) -> None:
        with self._cond:
            heapq.heappush(self._heap,
                           (self._effective_deadline(item), self._seq, item))
            self._seq += 1
            klass = getattr(item, "klass", "batch")
            self._depths[klass] = self._depths.get(klass, 0) + 1
            self._queued_rows += item.rows
            self._cond.notify()
        if self._m_enqueued is not None:
            self._m_enqueued.inc(**{"class": klass})

    def requeue(self, item) -> None:
        """Re-enter a partially-served request at a preemption point
        (anytime round boundary).  Ordering is plain EDF — the item's
        deadline has not changed, so it resumes ahead of later-deadline
        work but yields to anything more urgent that arrived while its
        last round ran.  Counted separately from fresh enqueues
        (``dks_sched_requeues_total``) so queue-depth arithmetic against
        ``dks_sched_enqueued_total`` stays honest."""

        with self._cond:
            heapq.heappush(self._heap,
                           (self._effective_deadline(item), self._seq, item))
            self._seq += 1
            klass = getattr(item, "klass", "batch")
            self._depths[klass] = self._depths.get(klass, 0) + 1
            self._queued_rows += item.rows
            self._cond.notify()
        if self._m_requeues is not None:
            self._m_requeues.inc(**{"class": klass})

    # -- introspection (admission control, metrics) --------------------- #

    def depths(self) -> Dict[str, int]:
        with self._cond:
            return dict(self._depths)

    def queued_rows(self) -> int:
        with self._cond:
            return self._queued_rows

    def rows_ahead(self, klass: str, deadline: Optional[float]) -> int:
        """Rows queued that would sort AHEAD of a hypothetical request of
        ``klass`` with ``deadline`` (absolute monotonic, or ``None`` for
        the class budget) — the EDF-aware input to admission's
        projected-wait gate.  Dividing the TOTAL queue by the service rate
        would project as if the request waited behind every queued row,
        i.e. it would shed exactly the interactive traffic this scheduler
        dispatches first.  On :class:`FIFOScheduler` every stored key is
        0.0, so this degrades to the whole queue — correct for FIFO, where
        everything really is ahead."""

        if deadline is None:
            deadline = self._now() + self._budgets.get(
                klass, self._budgets["batch"])
        with self._cond:
            return sum(item.rows for eff, _, item in self._heap
                       if eff <= deadline and not getattr(item, "done",
                                                          False))

    def qsize(self) -> int:
        with self._cond:
            return len(self._heap)

    # -- consumer side --------------------------------------------------- #

    def _account_pop(self, item) -> None:
        klass = getattr(item, "klass", "batch")
        self._depths[klass] = max(0, self._depths.get(klass, 0) - 1)
        self._queued_rows = max(0, self._queued_rows - item.rows)

    def next_batch(self, max_batch_size: int, max_rows: Optional[int] = None,
                   batch_timeout_s: float = 0.0,
                   stop: Optional[threading.Event] = None,
                   idle_wait_s: float = 0.5, grouping=None):
        """Form one batch.  Returns ``(batch, expired)``.

        Blocks (condition-variable wait, bounded by ``idle_wait_s`` per
        sleep so ``stop`` is honoured) until a request arrives, then keeps
        packing in EDF order — waking on new arrivals — until the batch is
        full, the row budget is met, or ``batch_timeout_s`` has passed
        since the first pop.  ``expired`` holds popped items whose explicit
        deadline had already passed: the caller owns failing them (they
        must not cost device work).  Returns ``(None, [])`` when stopped
        while idle.

        ``grouping`` (None = the historical tenant-blind formation) is a
        policy object with ``key(item)`` / ``bucket(key, rows)`` /
        ``limit(key)`` — see :meth:`_fill_grouped` — that turns formation
        tenant-aware: items of one group are packed contiguously up to a
        compile-bucket boundary before another group's items are admitted,
        under deficit-round-robin fairness across groups.
        """

        with self._cond:
            while not self._heap:
                if self._stopped or (stop is not None and stop.is_set()):
                    return None, []
                self._cond.wait(timeout=idle_wait_s)
            if grouping is not None:
                return self._fill_grouped(max_batch_size, max_rows,
                                          batch_timeout_s, stop, grouping)
            batch: List[object] = []
            expired: List[object] = []
            counted_pushback: set = set()
            rows = 0
            fill_deadline = self._now() + (batch_timeout_s
                                           if max_batch_size > 1 else 0.0)
            while True:
                pushback: List[Tuple[float, int, object]] = []
                now = self._now()
                while self._heap and len(batch) < max_batch_size:
                    if max_rows and rows >= max_rows:
                        # budget exactly consumed: nothing can fit, so
                        # don't churn the rest of the heap through the
                        # pushback path (O(n log n) per batch under
                        # backlog, all while holding the lock)
                        break
                    eff, seq, item = heapq.heappop(self._heap)
                    if getattr(item, "done", False):
                        self._account_pop(item)
                        continue
                    if self._is_expired(item, now):
                        self._account_pop(item)
                        expired.append(item)
                        if self._m_expired is not None:
                            self._m_expired.inc(**{
                                "class": getattr(item, "klass", "batch")})
                        continue
                    if batch and max_rows and rows + item.rows > max_rows:
                        # row-budget packing: keep scanning for items that
                        # still fit; the overflow item keeps its original
                        # key, so it leads a subsequent batch (no
                        # starvation, no side-channel carry slot)
                        pushback.append((eff, seq, item))
                        continue
                    self._account_pop(item)
                    if self._m_queue_wait is not None:
                        self._m_queue_wait.observe(
                            max(0.0, now - item.t_enqueued),
                            **{"class": getattr(item, "klass", "batch")})
                    batch.append(item)
                    rows += item.rows
                for entry in pushback:
                    heapq.heappush(self._heap, entry)
                if pushback and self._m_pushbacks is not None:
                    # once per item per next_batch call: the inner loop
                    # rescans the heap on every wakeup before the fill
                    # deadline, and re-counting the same deferred item per
                    # scan would overstate pushback by the wakeup count
                    fresh = [e for e in pushback
                             if id(e[2]) not in counted_pushback]
                    counted_pushback.update(id(e[2]) for e in fresh)
                    if fresh:
                        self._m_pushbacks.inc(len(fresh))
                if len(batch) >= max_batch_size:
                    break
                if max_rows and rows >= max_rows:
                    break
                remaining = fill_deadline - self._now()
                if remaining <= 0:
                    break
                if self._stopped or (stop is not None and stop.is_set()):
                    break
                # woken early by put(): loop re-scans the heap
                self._cond.wait(timeout=remaining)
            return batch, expired

    def _fill_grouped(self, max_batch_size: int, max_rows: Optional[int],
                      batch_timeout_s: float,
                      stop: Optional[threading.Event], grouping):
        """Tenant-aware batch formation (cross-tenant continuous batching).
        Caller holds ``self._cond`` and guarantees a non-empty heap.

        ``grouping`` supplies three hooks:

        * ``key(item)`` — hashable tenant / shared-program identity; items
          with equal keys dispatch as ONE device group.
        * ``bucket(key, rows)`` — the compile-bucket ``rows`` pads to for
          that group's engine.  Formation fills one group's sub-batch to a
          bucket boundary before opening the next, so a cycle of N tiny
          tenant groups no longer pads N buckets.
        * ``limit(key)`` — optional per-cycle item cap (the tenant's
          in-flight quota bound): a capped tenant YIELDS its slots to
          other groups instead of fragmenting the cycle.

        Fairness is deficit round robin over rows: every group with queued
        work earns a per-cycle quantum; groups are served in deficit order
        (ties resolve to the EDF-earliest item) and a group's take spends
        its credit, so a flooding tenant that filled this batch sorts
        behind the tenants it displaced on the next one.  Items not taken
        are pushed back with their ORIGINAL heap keys — the same
        starvation-free deferral contract as row-budget pushback.
        """

        batch: List[object] = []
        expired: List[object] = []
        counted_pushback: set = set()
        rows = 0
        group_rows: Dict[object, int] = {}
        group_items: Dict[object, int] = {}
        fill_deadline = self._now() + (batch_timeout_s
                                       if max_batch_size > 1 else 0.0)
        while True:
            now = self._now()
            # bounded EDF-prefix scan: pop live candidates (expiry and
            # done handling identical to the plain path); anything beyond
            # the scan window stays heap-resident untouched
            scan_limit = max(16, 4 * max_batch_size)
            candidates: List[Tuple[float, int, object]] = []
            while self._heap and len(candidates) < scan_limit:
                eff, seq, item = heapq.heappop(self._heap)
                if getattr(item, "done", False):
                    self._account_pop(item)
                    continue
                if self._is_expired(item, now):
                    self._account_pop(item)
                    expired.append(item)
                    if self._m_expired is not None:
                        self._m_expired.inc(**{
                            "class": getattr(item, "klass", "batch")})
                    continue
                candidates.append((eff, seq, item))
            groups: Dict[object, List[Tuple[float, int, object]]] = {}
            for entry in candidates:
                try:
                    key = grouping.key(entry[2])
                except Exception:
                    key = None
                groups.setdefault(key, []).append(entry)
            # DRR credit: every group with queued work earns a row
            # quantum (capped so an idle-then-bursty group cannot hoard
            # unbounded credit); state is LRU-bounded across tenant churn
            quantum = float(max(1, max_rows or max_batch_size)) \
                / max(1, len(groups))
            for key in groups:
                self._drr[key] = max(
                    min(self._drr.get(key, 0.0) + quantum, 4.0 * quantum),
                    -4.0 * quantum)
                self._drr.move_to_end(key)
            while len(self._drr) > 256:
                self._drr.popitem(last=False)
            serve_order = sorted(
                groups, key=lambda k: (-self._drr.get(k, 0.0),
                                       groups[k][0][:2]))
            pushback: List[Tuple[float, int, object]] = []
            for gi, key in enumerate(serve_order):
                entries = groups[key]
                try:
                    cap = grouping.limit(key)
                except Exception:
                    cap = None
                # EDF-ordered prefix of this group that fits the global
                # capacity, the row budget and the tenant's per-cycle cap
                fit_n, total = 0, rows
                for eff, seq, item in entries:
                    if len(batch) + fit_n >= max_batch_size:
                        break
                    if max_rows and total >= max_rows:
                        break
                    if cap is not None and \
                            group_items.get(key, 0) + fit_n >= cap:
                        break
                    if (batch or fit_n) and max_rows \
                            and total + item.rows > max_rows:
                        break
                    fit_n += 1
                    total += item.rows
                # bucket-boundary trim: while OTHER groups still have
                # work, cut this group at the largest prefix landing
                # exactly on its compile bucket — padding one tenant's
                # sub-batch while another tenant's real rows wait is the
                # waste this packer exists to remove.  No boundary
                # reachable (or last group standing): take the full fit.
                more_elsewhere = bool(pushback) or any(
                    groups[k2] for k2 in serve_order[gi + 1:])
                if fit_n and more_elsewhere:
                    base = group_rows.get(key, 0)
                    cum, best = base, None
                    for i in range(fit_n):
                        cum += entries[i][2].rows
                        try:
                            boundary = grouping.bucket(key, cum) == cum
                        except Exception:
                            boundary = True
                        if boundary:
                            best = i + 1
                    if best is not None:
                        fit_n = best
                for eff, seq, item in entries[:fit_n]:
                    self._account_pop(item)
                    if self._m_queue_wait is not None:
                        self._m_queue_wait.observe(
                            max(0.0, now - item.t_enqueued),
                            **{"class": getattr(item, "klass", "batch")})
                    batch.append(item)
                    rows += item.rows
                    group_rows[key] = group_rows.get(key, 0) + item.rows
                    group_items[key] = group_items.get(key, 0) + 1
                    self._drr[key] = self._drr.get(key, 0.0) - item.rows
                pushback.extend(entries[fit_n:])
            if not batch and pushback:
                # progress guarantee: every group capped out (limit()=0
                # misconfiguration, boundary trims) must never spin the
                # dispatcher on an empty batch — take the EDF-earliest
                # candidate unconditionally, with the SAME per-item
                # accounting as a normal take (queue-wait observation,
                # DRR debit) so the guarantee path cannot skew either
                entry = min(pushback, key=lambda e: e[:2])
                pushback.remove(entry)
                item = entry[2]
                self._account_pop(item)
                if self._m_queue_wait is not None:
                    self._m_queue_wait.observe(
                        max(0.0, now - item.t_enqueued),
                        **{"class": getattr(item, "klass", "batch")})
                batch.append(item)
                rows += item.rows
                try:
                    key = grouping.key(item)
                except Exception:
                    key = None
                group_rows[key] = group_rows.get(key, 0) + item.rows
                group_items[key] = group_items.get(key, 0) + 1
                self._drr[key] = self._drr.get(key, 0.0) - item.rows
            for entry in pushback:
                heapq.heappush(self._heap, entry)
            if pushback and self._m_pushbacks is not None:
                fresh = [e for e in pushback
                         if id(e[2]) not in counted_pushback]
                counted_pushback.update(id(e[2]) for e in fresh)
                if fresh:
                    self._m_pushbacks.inc(len(fresh))
            if len(batch) >= max_batch_size:
                break
            if max_rows and rows >= max_rows:
                break
            remaining = fill_deadline - self._now()
            if remaining <= 0:
                break
            if self._stopped or (stop is not None and stop.is_set()):
                break
            # woken early by put(): loop re-scans the heap
            self._cond.wait(timeout=remaining)
        return batch, expired

    def drain(self) -> List[object]:
        """Remove and return every queued (not-done) item — the server's
        wedge/shutdown path fails them so no handler thread leaks."""

        with self._cond:
            items = [item for _, _, item in self._heap
                     if not getattr(item, "done", False)]
            self._heap.clear()
            self._depths = {k: 0 for k in PRIORITY_CLASSES}
            self._queued_rows = 0
            return items

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()


class StagingBuffer:
    """Bounded handoff for the double-buffered host→device staging pipeline
    (ISSUE 6; Podracer's pipelined host/device split, PAPERS.md arXiv
    2104.06272).

    The server's batcher thread forms scheduler batches and starts their
    host→device upload (``engine.stage_rows`` — ``jax.device_put`` is
    asynchronous), then :meth:`put`\\ s them here; the dispatcher thread
    :meth:`get`\\ s batches whose rows are already device-resident.  With
    ``depth=1`` the steady state is the classic double buffer: one batch
    computing on the device, one staged and ready, one being formed — the
    device never waits on an H2D copy between scheduler batches.

    :meth:`get` also returns how long the staged batch sat ready before
    dispatch — the measured upload/compute overlap the server surfaces as
    ``dks_staging_overlap_seconds_total`` (0 means the dispatcher was
    already waiting, i.e. the host is the bottleneck; sustained positive
    values mean the upload fully hid behind device work).
    """

    def __init__(self, depth: int = 1, mem_account=None,
                 nbytes_fn=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        # optional memory-ledger account: each staged slot pins device
        # buffers between put and get, so slots charge computed nbytes
        # under owner=staging for their (bounded, but real) lifetime
        self._mem = mem_account
        self._mem_nbytes = nbytes_fn

    def _mem_charge(self, item) -> None:
        if self._mem is not None and self._mem_nbytes is not None:
            try:
                self._mem.charge(id(item), int(self._mem_nbytes(item)))
            except Exception:
                logger.exception("staging ledger charge failed")

    def _mem_release(self, item) -> None:
        if self._mem is not None:
            self._mem.release(id(item))

    def put(self, item, stop: Optional[threading.Event] = None,
            poll_s: float = 0.1) -> bool:
        """Block until a staging slot frees (bounded: at most ``depth``
        staged batches hold device buffers at once).  Returns ``False``
        without enqueueing once ``stop`` is set — the caller owns failing
        the batch."""

        entry = (item, time.monotonic())
        self._mem_charge(item)
        while True:
            if stop is not None and stop.is_set():
                self._mem_release(item)
                return False
            try:
                self._q.put(entry, timeout=poll_s)
                return True
            except queue.Full:
                continue

    def get(self, stop: Optional[threading.Event] = None,
            poll_s: float = 0.1):
        """``(item, ready_s)`` for the next staged batch — ``ready_s`` is
        the seconds it sat device-ready before this pop.  ``None`` once
        ``stop`` is set and the buffer is empty (staged leftovers are still
        delivered first so no request silently leaks)."""

        while True:
            try:
                item, t_ready = self._q.get(timeout=poll_s)
            except queue.Empty:
                if stop is not None and stop.is_set():
                    return None
                continue
            self._mem_release(item)
            return item, max(0.0, time.monotonic() - t_ready)

    def drain(self) -> List:
        """Remove and return every still-staged item (shutdown path)."""

        items = []
        while True:
            try:
                item = self._q.get_nowait()[0]
            except queue.Empty:
                return items
            self._mem_release(item)
            items.append(item)


class FIFOScheduler(SLOScheduler):
    """Arrival-order baseline with no deadline semantics.

    Same interface (so the server and the benchmark can swap policies with
    one knob) but orders purely by arrival sequence and never expires
    anything — this is the exact behaviour of the round-4 FIFO queue, kept
    as the control arm for ``benchmarks/scheduling_bench.py``.
    """

    def _effective_deadline(self, item) -> float:
        return 0.0  # heap tie-breaks on seq == arrival order

    def _is_expired(self, item, now: float) -> bool:
        return False


def make_scheduler(policy: str = "slo",
                   class_budgets: Optional[Dict[str, float]] = None,
                   now=time.monotonic) -> SLOScheduler:
    if policy == "slo":
        return SLOScheduler(class_budgets=class_budgets, now=now)
    if policy == "fifo":
        return FIFOScheduler(class_budgets=class_budgets, now=now)
    raise ValueError(f"unknown scheduling policy {policy!r} "
                     f"(expected 'slo' or 'fifo')")
