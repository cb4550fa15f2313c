"""Continuous sampling profiler: always-on, role- and tenant-tagged
folded stacks served on ``/profilez``.

Spans (``observability/tracing.py``) see only what was instrumented;
phase timers (``profiling.py``) see only the engine's named phases.
Everything else a serving host spends wall time on — GIL contention,
JSON encode, scheduler scans, socket writes — is invisible to both,
exactly the host-side plumbing cost Podracer found dominating these
architectures (PAPERS.md, arXiv 2104.06272).  A sampling profiler needs
no instrumentation: a daemon thread walks ``sys._current_frames()`` at
a low default rate (:data:`DEFAULT_HZ` = 19 Hz — prime, so it cannot
alias against the 1 s tick threads) and folds each thread's stack into
a bounded table, both cumulative and a last-60 s ring of per-second
buckets.

Each sample is tagged with the sampled thread's **role** — the serving
loops register themselves at spawn (``dispatcher``/``batcher``/
``finalizer``/``handler``/``tick``; unregistered threads fold under
``other``) — and, where the serving layer published the request context
for the thread, the active **tenant** (part of the fold key) and trace
id (kept as a per-stack exemplar, NOT part of the key — trace ids churn
per request and would unbound the table).  A sampler cannot read
another thread's thread-locals, so the server publishes
(ident -> tenant/trace) into the profiler at request adoption points.

Exports: collapsed-stack text (``frame;frame;frame count`` — the
flamegraph.pl / speedscope wire format, merged across replicas by the
proxy's ``/profilez?federate=1`` over its concurrent scrape pool) and a
Perfetto-compatible chrome-trace JSON whose events round-trip through
:func:`from_perfetto`.

The profiler meters itself (``dks_prof_samples_total``,
``dks_prof_overhead_seconds_total``, ``dks_prof_dropped_stacks_total``)
and **auto-disables** when its own sweep time exceeds a configured
fraction of wall time (:data:`DEFAULT_OVERHEAD_BUDGET`) — an observer
that starts costing real latency turns itself off and says so, rather
than taxing the fleet it watches.  ``DKS_CONTPROF=0|1|<hz>`` (default:
on at 19 Hz).

Stdlib-only, like the rest of the observability package.
"""

import json
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from distributedkernelshap_tpu_torch.analysis.lockwitness import make_lock

logger = logging.getLogger(__name__)

#: default sampling rate — prime, to avoid aliasing with 1 s tickers
DEFAULT_HZ = 19.0

#: bound on distinct (role, tenant, stack) fold keys; overflow counts
#: into dks_prof_dropped_stacks_total instead of growing the table
DEFAULT_MAX_STACKS = 2048

#: auto-disable when sweep time exceeds this fraction of wall time
DEFAULT_OVERHEAD_BUDGET = 0.02

#: frames kept per stack (deepest retained; pathological recursion must
#: not make one sample arbitrarily expensive)
MAX_STACK_DEPTH = 64

#: seconds of per-second ring buckets behind the windowed view
WINDOW_S = 60


def resolve_contprof_env(default_hz: float = DEFAULT_HZ) -> float:
    """``DKS_CONTPROF=0|1|<hz>`` -> sampling rate in Hz (0 = off).
    Unset means on at the low default rate; garbage parses as the
    default, loudly."""

    raw = os.environ.get("DKS_CONTPROF")
    if raw is None or raw.strip() == "":
        return default_hz
    val = raw.strip().lower()
    if val in ("0", "false", "off", "no"):
        return 0.0
    if val in ("1", "true", "on", "yes"):
        return default_hz
    try:
        hz = float(val)
    except ValueError:
        logger.warning("DKS_CONTPROF=%r is not 0|1|<hz>; using %.1f Hz",
                       raw, default_hz)
        return default_hz
    return max(0.0, min(hz, 250.0))


def _fold_frame(frame, max_depth: int = MAX_STACK_DEPTH
                ) -> Tuple[str, ...]:
    """Root-first tuple of ``module:function`` frames."""

    out: List[str] = []
    while frame is not None and len(out) < max_depth:
        code = frame.f_code
        fname = os.path.basename(code.co_filename)
        if fname.endswith(".py"):
            fname = fname[:-3]
        out.append(f"{fname}:{code.co_name}")
        frame = frame.f_back
    out.reverse()
    return tuple(out)


def _stack_line(role: str, tenant: str, stack: Tuple[str, ...]) -> str:
    """One collapsed line's stack part: role (and tenant, when tagged)
    lead as synthetic root frames so flamegraphs split by them."""

    prefix = [f"thread:{role}"]
    if tenant:
        prefix.append(f"tenant:{tenant}")
    return ";".join(prefix + list(stack))


def parse_collapsed(text: str) -> Dict[str, int]:
    """``{stack_line: count}`` from collapsed text (duplicates sum)."""

    out: Dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, count = line.rpartition(" ")
        if not stack:
            continue
        try:
            n = int(count)
        except ValueError:
            continue
        out[stack] = out.get(stack, 0) + n
    return out


def merge_collapsed(pages: Iterable[str]) -> str:
    """Sum-merge collapsed pages (the proxy's federated flamegraph)."""

    merged: Dict[str, int] = {}
    for page in pages:
        for stack, n in parse_collapsed(page).items():
            merged[stack] = merged.get(stack, 0) + n
    return "\n".join(f"{stack} {n}"
                     for stack, n in sorted(merged.items())) \
        + ("\n" if merged else "")


def from_perfetto(doc: Dict) -> Dict[str, int]:
    """Rebuild ``{stack_line: count}`` from :meth:`ContProf.perfetto`
    output — the round-trip contract the export tests pin."""

    out: Dict[str, int] = {}
    for ev in doc.get("traceEvents", []):
        args = ev.get("args") or {}
        stack = args.get("stack")
        if stack is None:
            continue
        line = _stack_line(args.get("role", "other"),
                           args.get("tenant", ""), tuple(stack))
        out[line] = out.get(line, 0) + int(args.get("count", 0))
    return out


class ContProf:
    """The sampling profiler (see module doc).  One instance runs one
    daemon sampler thread; the process-wide instance behind
    :func:`contprof` is refcounted by the serving components
    (:meth:`acquire`/:meth:`release`)."""

    def __init__(self, hz: Optional[float] = None,
                 max_stacks: int = DEFAULT_MAX_STACKS,
                 overhead_budget: float = DEFAULT_OVERHEAD_BUDGET):
        self.hz = resolve_contprof_env() if hz is None else float(hz)
        self.max_stacks = int(max_stacks)
        self.overhead_budget = float(overhead_budget)
        #: master switch: sweeps no-op while False (cheap pause — the
        #: bench's on/off alternation flips this per request)
        self.enabled = self.hz > 0
        self._lock = make_lock("contprof.table")
        self._roles: Dict[int, str] = {}
        self._tags: Dict[int, Dict[str, str]] = {}
        # fold key (role, tenant, stack) -> cumulative count
        self._cum: Dict[Tuple[str, str, Tuple[str, ...]], int] = {}
        # per-stack trace exemplar: last trace id seen on a tagged
        # thread sampled at this key (bounded by the fold-table bound)
        self._trace_exemplars: Dict[Tuple, str] = {}
        # ring of (epoch second, {fold key: count})
        self._ring: "deque[Tuple[int, Dict]]" = deque(maxlen=WINDOW_S)
        self._samples_total = 0
        self._sweeps_total = 0
        self._dropped = 0
        self._overhead_s = 0.0
        self._auto_disabled = False
        self._started_mono: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._refs = 0
        self._ref_lock = make_lock("contprof.refs")

    # -- lifecycle ------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def auto_disabled(self) -> bool:
        with self._lock:
            return self._auto_disabled

    def start(self) -> "ContProf":
        """Start the sampler thread (idempotent; no-op at hz<=0)."""

        if self.hz <= 0 or self.running:
            return self
        self._stop.clear()
        with self._lock:
            self._auto_disabled = False
        self._started_mono = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="dks-contprof", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def acquire(self) -> "ContProf":
        """Refcounted start: each serving component (server, proxy)
        acquires on start and releases on stop; the shared sampler runs
        while anyone holds it."""

        with self._ref_lock:
            self._refs += 1
        self.start()
        return self

    def release(self) -> None:
        with self._ref_lock:
            self._refs = max(0, self._refs - 1)
            last = self._refs == 0
        if last:
            self.stop()

    def pause(self) -> None:
        """Keep the thread, skip the work (per-request overhead arms)."""

        with self._lock:
            self.enabled = False

    def resume(self) -> None:
        with self._lock:
            self.enabled = True

    # -- per-thread registration (cheap: one dict write) ---------------

    def register_current_thread(self, role: str) -> None:
        ident = threading.get_ident()
        if self._roles.get(ident) != role:
            with self._lock:
                self._roles[ident] = role

    def tag_current_thread(self, trace_id: Optional[str] = None,
                           tenant: Optional[str] = None) -> None:
        """Publish the calling thread's request context for the sampler
        (merges non-None fields into the existing tag)."""

        ident = threading.get_ident()
        with self._lock:
            tag = self._tags.setdefault(ident, {})
            if trace_id is not None:
                tag["trace"] = str(trace_id)
            if tenant is not None:
                tag["tenant"] = str(tenant)

    def untag_current_thread(self) -> None:
        ident = threading.get_ident()
        with self._lock:
            self._tags.pop(ident, None)

    # -- the sampler ----------------------------------------------------

    def _run(self) -> None:
        interval = 1.0 / self.hz
        # guarded tick (the prober's DKS-C005 pattern): one bad sweep is
        # logged, the sampler survives — an observer must not die of a
        # transient introspection error
        while not self._stop.wait(interval):
            try:
                self._sweep()
            except Exception:
                logger.exception("contprof sweep failed")

    def _sweep(self) -> None:
        with self._lock:
            if not self.enabled or self._auto_disabled:
                return
        t0 = time.perf_counter()
        own = threading.get_ident()
        frames = sys._current_frames()
        second = int(time.monotonic())
        with self._lock:
            if self._ring and self._ring[-1][0] == second:
                bucket = self._ring[-1][1]
            else:
                bucket = {}
                self._ring.append((second, bucket))
            for ident, frame in frames.items():
                if ident == own:
                    continue
                role = self._roles.get(ident, "other")
                tag = self._tags.get(ident)
                tenant = tag.get("tenant", "") if tag else ""
                stack = _fold_frame(frame)
                key = (role, tenant, stack)
                if key not in self._cum \
                        and len(self._cum) >= self.max_stacks:
                    self._dropped += 1
                    continue
                self._cum[key] = self._cum.get(key, 0) + 1
                bucket[key] = bucket.get(key, 0) + 1
                self._samples_total += 1
                if tag and tag.get("trace"):
                    self._trace_exemplars[key] = tag["trace"]
            # dead threads keep no role/tag entries
            for d in (self._roles, self._tags):
                for ident in [i for i in d if i not in frames]:
                    d.pop(ident, None)
            self._sweeps_total += 1
            self._overhead_s += time.perf_counter() - t0
            overhead = self._overhead_s
        started = self._started_mono
        elapsed = (time.monotonic() - started) if started else 0.0
        if elapsed > 1.0 and overhead / elapsed > self.overhead_budget:
            with self._lock:
                self._auto_disabled = True
            logger.warning(
                "contprof auto-disabled: sweep overhead %.2f%% of wall "
                "time exceeds the %.2f%% budget (%.0f Hz over %d "
                "threads) — lower DKS_CONTPROF or raise the budget",
                100.0 * overhead / elapsed,
                100.0 * self.overhead_budget, self.hz, len(frames))

    # -- views / exports ------------------------------------------------

    def _counts(self, window_s: Optional[float] = None) -> Dict:
        with self._lock:
            if window_s is None:
                return dict(self._cum)
            cutoff = int(time.monotonic()) - int(window_s)
            out: Dict = {}
            for second, bucket in self._ring:
                if second < cutoff:
                    continue
                for key, n in bucket.items():
                    out[key] = out.get(key, 0) + n
            return out

    def collapsed(self, window_s: Optional[float] = None) -> str:
        """Collapsed-stack text, cumulative or windowed."""

        counts = self._counts(window_s)
        lines = [f"{_stack_line(role, tenant, stack)} {n}"
                 for (role, tenant, stack), n in counts.items()]
        return "\n".join(sorted(lines)) + ("\n" if lines else "")

    def perfetto(self, window_s: Optional[float] = None) -> Dict:
        """Chrome-trace JSON (Perfetto-loadable): one ``X`` slice per
        fold key, duration proportional to its sample count, one track
        per role.  ``args`` carry the exact fold key so
        :func:`from_perfetto` round-trips."""

        counts = self._counts(window_s)
        roles = sorted({role for role, _, _ in counts})
        tid = {role: i + 1 for i, role in enumerate(roles)}
        events: List[Dict] = []
        for role in roles:
            events.append({"ph": "M", "pid": 1, "tid": tid[role],
                           "name": "thread_name",
                           "args": {"name": f"role:{role}"}})
        with self._lock:
            exemplars = dict(self._trace_exemplars)
        cursors = {role: 0 for role in roles}
        for (role, tenant, stack), n in sorted(counts.items()):
            args = {"stack": list(stack), "role": role,
                    "tenant": tenant, "count": n}
            trace = exemplars.get((role, tenant, stack))
            if trace:
                args["trace_id"] = trace
            events.append({
                "ph": "X", "pid": 1, "tid": tid[role], "cat": "contprof",
                "name": stack[-1] if stack else "<idle>",
                "ts": cursors[role], "dur": n * 1000, "args": args,
            })
            cursors[role] += n * 1000
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": {"source": "dks-contprof", "hz": self.hz}}

    def stats(self) -> Dict:
        with self._lock:
            window_samples = sum(sum(b.values()) for _, b in self._ring)
            role_counts: Dict[str, int] = {}
            for role in self._roles.values():
                role_counts[role] = role_counts.get(role, 0) + 1
            return {
                "enabled": self.enabled,
                "running": self.running,
                "auto_disabled": self._auto_disabled,
                "hz": self.hz,
                "samples_total": self._samples_total,
                "sweeps_total": self._sweeps_total,
                "dropped_stacks": self._dropped,
                "overhead_seconds": self._overhead_s,
                "distinct_stacks": len(self._cum),
                "window_samples": window_samples,
                "registered_roles": role_counts,
            }

    def status_doc(self, top_n: int = 20) -> Dict:
        counts = self._counts(None)
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:top_n]
        doc = self.stats()
        doc["top_stacks"] = [
            [_stack_line(role, tenant, stack), n]
            for (role, tenant, stack), n in top]
        return doc

    def reset(self) -> None:
        with self._lock:
            self._cum.clear()
            self._ring.clear()
            self._trace_exemplars.clear()
            self._samples_total = 0
            self._sweeps_total = 0
            self._dropped = 0
            self._overhead_s = 0.0
            self._auto_disabled = False
            self._started_mono = time.monotonic()

    def samples_total(self) -> int:
        with self._lock:
            return self._samples_total

    # -- serving --------------------------------------------------------

    def profilez_payload(self, query_params: Dict[str, List[str]]
                         ) -> Tuple[str, bytes]:
        """``(content_type, body)`` for ``GET /profilez`` — shared by
        the server and proxy handlers.  ``format=collapsed|perfetto``
        (default: a JSON status doc with the top stacks);
        ``window=<seconds>`` restricts either export to the ring."""

        fmt = (query_params.get("format") or [""])[-1]
        window = None
        raw_window = (query_params.get("window") or [""])[-1]
        if raw_window:
            try:
                window = max(0.0, float(raw_window))
            except ValueError:
                window = None
        if fmt == "collapsed":
            return ("text/plain; charset=utf-8",
                    self.collapsed(window).encode())
        if fmt == "perfetto":
            return ("application/json",
                    json.dumps(self.perfetto(window)).encode())
        return ("application/json",
                json.dumps(self.status_doc()).encode())

    def attach_metrics(self, registry) -> None:
        """Self-metering families (callback-sourced; both the server's
        and the proxy's registry may read the process profiler)."""

        registry.counter(
            "dks_prof_samples_total",
            "Thread stack samples folded by the continuous sampling "
            "profiler (one per live thread per sweep).").set_function(
                lambda: float(self._samples_total))
        registry.counter(
            "dks_prof_overhead_seconds_total",
            "Wall seconds the profiler spent inside its own sweeps — "
            "the numerator of the auto-disable budget "
            "(overhead/elapsed > budget turns the sampler off)."
        ).set_function(lambda: float(self._overhead_s))
        registry.counter(
            "dks_prof_dropped_stacks_total",
            "Samples dropped because the fold table hit its distinct-"
            "stack bound — the table is bounded by design; a nonzero "
            "value means the profile under-counts rare stacks."
        ).set_function(lambda: float(self._dropped))


_default: Optional[ContProf] = None
_default_lock = make_lock("contprof.singleton")


def contprof() -> ContProf:
    """The process-wide profiler (created on first use, honoring
    ``DKS_CONTPROF``)."""

    global _default
    with _default_lock:
        if _default is None:
            _default = ContProf()
        return _default


def register_thread_role(role: str) -> None:
    """Module-level convenience for thread loops: register the calling
    thread's role with the process profiler."""

    contprof().register_current_thread(role)
