"""Dependency-free distributed tracing with ``X-DKS-Trace`` propagation.

A copy of ``distributedkernelshap_tpu/observability/tracing.py`` (it
imports nothing of either framework), so the port's profiler and pipeline
record into their own tracer without importing the JAX package.

The reference measures wall-clock only around whole ``explain`` calls
(SURVEY §5.1); after the scheduling and resilience PRs there is no way to
answer "where did request X spend its 400 ms" across the client retry /
proxy hedge / replica admission→queue→device→finalize path.  This module
is the substrate: spans are plain records (name, trace id, span id,
parent id, wall-clock start, duration, attributes) collected in a bounded
in-process ring buffer and exported as JSONL.  The engine's own spans
(``profiling.span``) also open ``torch.profiler`` ranges of the same name
whenever a profiler records, so a profiler's Chrome trace carries them
beside the device's records.

**Context propagation** is W3C-traceparent-shaped over one header::

    X-DKS-Trace: 00-<32 hex trace id>-<16 hex span id>-01

The client mints the trace id; the fan-in proxy parents its request span
to the client's, gives every routing pass (primary / hedge) and every
forward attempt its OWN span id, and stamps the forward span's context
onto the header it sends the replica — so a replica's spans parent to the
exact pass (hedged or not, retried or not) that reached it.  Everything
in one trace shares the trace id; JSONL consumers follow a request
end-to-end by filtering on it.

**Time base**: span ``ts`` is epoch seconds (comparable across the
client/proxy/replica processes of one host).  A span timed on its own
thread (:meth:`Tracer.begin` / :meth:`Tracer.end`, :meth:`Tracer.span`)
reads ``time.time_ns()`` at both ends: ``CLOCK_REALTIME``, the clock of
``torch.profiler``'s host and device records, so a span lines up with
them.  An interval measured elsewhere on the monotonic clock
(:meth:`Tracer.record_mono`, the serving path's queue and admission
times) is shifted to epoch seconds by one offset fixed at import.
Cross-host skew is the operator's problem, as with any distributed
tracer.

**Cost when disabled** (the default): one attribute read per guard —
every producer checks ``tracer().enabled`` before building anything.

Enable with ``DKS_TRACE=1`` (or ``tracer().enable()``).  With
``DKS_TRACE_DIR`` set, every finished span is ALSO appended (flushed) to
``<dir>/spans-<pid>.jsonl`` — that is how replica worker processes get
their spans into the chaos bench's merged trace even when they are
SIGKILLed mid-run.
"""

import contextlib
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Union

logger = logging.getLogger(__name__)

TRACE_HEADER = "X-DKS-Trace"

#: epoch <-> monotonic alignment, fixed at import so every span in a
#: process shares one offset (a per-call offset would let spans within
#: one request disagree by scheduler jitter)
_EPOCH_OFFSET = time.time() - time.monotonic()


def mono_to_epoch(t_mono: float) -> float:
    return t_mono + _EPOCH_OFFSET


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


class SpanContext(NamedTuple):
    trace_id: str
    span_id: str


def format_trace_header(ctx: SpanContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_trace_header(value: Optional[str]) -> Optional[SpanContext]:
    """Parse ``X-DKS-Trace``; accepts the full ``00-trace-span-flags``
    form and the bare ``trace-span`` form.  Garbage returns ``None`` —
    an unparseable header must degrade to "start a new trace", never to
    a 400."""

    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) == 4:
        parts = parts[1:3]
    if len(parts) != 2:
        return None
    trace_id, span_id = parts
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    return SpanContext(trace_id.lower(), span_id.lower())


def header_get(headers, name: str = TRACE_HEADER) -> Optional[str]:
    """Case-insensitive header lookup over a plain dict (the proxy hands
    handlers dicts, not Message objects)."""

    if headers is None:
        return None
    target = name.lower()
    for k, v in headers.items():
        if k.lower() == target:
            return v
    return None


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "ts",
                 "duration_s", "attrs", "proc", "thread", "_t0_ns")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], ts: float, duration_s: float,
                 attrs: Optional[Dict] = None, proc: str = "",
                 thread: int = 0):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.ts = ts              # epoch seconds
        self.duration_s = duration_s
        self.attrs = attrs or {}
        self.proc = proc
        self.thread = thread
        self._t0_ns: Optional[int] = None

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def annotate(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> Dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "ts": self.ts, "duration_s": self.duration_s,
                "proc": self.proc, "thread": self.thread,
                "attrs": self.attrs}

    @classmethod
    def from_dict(cls, d: Dict) -> "Span":
        return cls(d["name"], d["trace_id"], d["span_id"],
                   d.get("parent_id"), d["ts"], d["duration_s"],
                   attrs=dict(d.get("attrs") or {}),
                   proc=d.get("proc", ""), thread=int(d.get("thread", 0)))

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id[:8]}…, "
                f"span={self.span_id}, dur={self.duration_s * 1e3:.2f}ms)")


_tls = threading.local()


def current_context() -> Optional[SpanContext]:
    """The innermost span context pushed on THIS thread (``tracer().span``
    blocks and explicit :func:`use_context` handoffs push here).  The
    profiler's phase timers parent their child spans to it."""

    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_context(ctx: Optional[SpanContext]):
    """Adopt ``ctx`` as this thread's current span context (cross-thread
    handoff: the server's dispatcher/finalizer threads adopt a request's
    context around the device call so engine phase timers parent
    correctly).  ``None`` is a no-op."""

    if ctx is None:
        yield
        return
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(ctx)
    try:
        yield
    finally:
        stack.pop()


def _truthy_env(name: str) -> bool:
    return os.environ.get(name, "0").strip().lower() not in (
        "", "0", "false", "no")


class Tracer:
    """Bounded span collector.

    Parameters
    ----------
    capacity
        Ring-buffer bound; the oldest spans fall off (``dropped_total``
        counts them) so an always-on tracer cannot grow a serving
        process without bound.
    enabled
        ``None`` reads ``DKS_TRACE``.
    proc
        Process label stamped on every span (``DKS_TRACE_PROC`` or
        ``pid<N>``); the chaos bench sets it per replica so merged
        traces keep their tracks apart.
    sink_dir
        ``None`` reads ``DKS_TRACE_DIR``.  When set, every finished span
        is appended (flushed) to ``<dir>/spans-<pid>.jsonl`` so a
        SIGKILLed worker loses at most the span in flight.
    sink_max_bytes, sink_max_age_s
        Sink rotation bounds (``DKS_TRACE_MAX_BYTES`` — default 64 MiB —
        and ``DKS_TRACE_MAX_AGE_S`` — default off).  A long-lived
        replica's sink file used to grow without limit; when either
        bound trips, the current file rotates to
        ``spans-<pid>.jsonl.1`` (ONE kept generation — the previous
        ``.1``'s spans are deleted and counted in
        :attr:`sink_dropped_total`) and a fresh file opens.  The
        per-span flush is unchanged, so the SIGKILL-safety contract
        holds across rotations.  ``0`` disables the respective bound.
    """

    def __init__(self, capacity: int = 8192,
                 enabled: Optional[bool] = None,
                 proc: Optional[str] = None,
                 sink_dir: Optional[str] = None,
                 sink_max_bytes: Optional[int] = None,
                 sink_max_age_s: Optional[float] = None):
        if enabled is None:
            enabled = _truthy_env("DKS_TRACE")
        self.enabled = bool(enabled)
        replica = os.environ.get("DKS_REPLICA_INDEX")
        self.proc = (proc or os.environ.get("DKS_TRACE_PROC")
                     or (f"replica{replica}" if replica is not None else None)
                     or f"pid{os.getpid()}")
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.recorded_total = 0
        self._sink_dir = (sink_dir if sink_dir is not None
                          else os.environ.get("DKS_TRACE_DIR") or None)
        self._sink_fh = None
        self._sink_broken = False
        if sink_max_bytes is None:
            sink_max_bytes = int(os.environ.get("DKS_TRACE_MAX_BYTES",
                                                64 << 20) or 0)
        if sink_max_age_s is None:
            sink_max_age_s = float(os.environ.get("DKS_TRACE_MAX_AGE_S",
                                                  0) or 0)
        self.sink_max_bytes = max(0, int(sink_max_bytes))
        self.sink_max_age_s = max(0.0, float(sink_max_age_s))
        self._sink_bytes = 0
        self._sink_spans = 0
        self._sink_opened_mono = 0.0
        # spans living in the kept ``.1`` generation: deleted (and folded
        # into sink_dropped_total) when the NEXT rotation displaces it
        self._rotated_spans = 0
        self.sink_rotations_total = 0
        #: spans this process wrote to the sink and later deleted by
        #: rotation (the ``dks_trace_dropped_total`` source) — in-memory
        #: like ``recorded_total``; other processes' files are untouched
        self.sink_dropped_total = 0

    # ------------------------------------------------------------------ #

    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def _sink_path(self) -> str:
        return os.path.join(self._sink_dir, f"spans-{os.getpid()}.jsonl")

    def _maybe_rotate_sink(self) -> None:
        """Rotate the sink file when a size/age bound trips (caller holds
        the lock and owns an open sink).  ONE generation is kept: the
        current file becomes ``.1``; the displaced ``.1``'s spans are
        deleted and counted as dropped."""

        over_bytes = (self.sink_max_bytes
                      and self._sink_bytes >= self.sink_max_bytes)
        over_age = (self.sink_max_age_s
                    and time.monotonic() - self._sink_opened_mono
                    >= self.sink_max_age_s)
        if not (over_bytes or over_age):
            return
        path = self._sink_path()
        self._sink_fh.close()
        self._sink_fh = None
        # the displaced kept generation is gone for good — its spans are
        # the ones this rotation actually drops (os.replace overwrites)
        if os.path.exists(path + ".1"):
            self.sink_dropped_total += self._rotated_spans
        os.replace(path, path + ".1")
        self._rotated_spans = self._sink_spans
        self._sink_bytes = 0
        self._sink_spans = 0
        self.sink_rotations_total += 1

    def _append(self, span: Span) -> None:
        with self._lock:
            self._buf.append(span)
            self.recorded_total += 1
            if self._sink_dir is not None and not self._sink_broken:
                try:
                    if self._sink_fh is None:
                        os.makedirs(self._sink_dir, exist_ok=True)
                        self._sink_fh = open(self._sink_path(), "a",
                                             encoding="utf-8")
                        self._sink_bytes = self._sink_fh.tell()
                        self._sink_opened_mono = time.monotonic()
                    line = json.dumps(span.to_dict()) + "\n"
                    self._sink_fh.write(line)
                    self._sink_fh.flush()
                    self._sink_bytes += len(line)
                    self._sink_spans += 1
                    self._maybe_rotate_sink()
                except OSError:
                    # a full/unwritable disk must not take serving down
                    self._sink_broken = True
                    logger.exception("span sink failed; disabling it")

    @property
    def dropped_total(self) -> int:
        with self._lock:
            return max(0, self.recorded_total - len(self._buf))

    # ------------------------------------------------------------------ #

    def begin(self, name: str,
              parent: Union[SpanContext, Span, None] = None,
              **attrs) -> Span:
        """Start a span now; finish it with :meth:`end` (possibly from
        another call path or another thread).  ``parent=None`` adopts
        the thread's current context, else mints a new trace."""

        if isinstance(parent, Span):
            parent = parent.context
        if parent is None:
            parent = current_context()
        trace_id = parent.trace_id if parent else new_trace_id()
        span = Span(name, trace_id, new_span_id(),
                    parent.span_id if parent else None, 0.0, 0.0, attrs=attrs,
                    proc=self.proc, thread=threading.get_ident())
        span._t0_ns = time.time_ns()
        span.ts = span._t0_ns * 1e-9
        return span

    def end(self, span: Optional[Span], **attrs) -> None:
        if span is None:
            return
        t0 = span._t0_ns
        span.duration_s = (time.time_ns() - t0) * 1e-9 if t0 is not None else 0.0
        if attrs:
            span.attrs.update(attrs)
        self._append(span)

    @contextlib.contextmanager
    def span(self, name: str,
             parent: Union[SpanContext, Span, None] = None, **attrs):
        """Span as a context manager; pushes its context as the thread's
        current one so nested spans (and profiler phases) parent to it."""

        if not self.enabled:
            yield None
            return
        span = self.begin(name, parent=parent, **attrs)
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(span.context)
        try:
            yield span
        finally:
            stack.pop()
            self.end(span)

    def record_mono(self, name: str, t0_mono: float, t1_mono: float,
                    parent: Union[SpanContext, Span, None] = None,
                    trace_id: Optional[str] = None,
                    **attrs) -> Optional[SpanContext]:
        """Record an already-measured interval (monotonic endpoints) as a
        finished span — the cross-thread path: the dispatcher knows a
        request's enqueue and claim times, neither measured on the
        recording thread."""

        if not self.enabled:
            return None
        if isinstance(parent, Span):
            parent = parent.context
        if trace_id is None:
            trace_id = (parent.trace_id if parent else new_trace_id())
        span = Span(name, trace_id, new_span_id(),
                    parent.span_id if parent else None,
                    mono_to_epoch(t0_mono), max(0.0, t1_mono - t0_mono),
                    attrs=attrs, proc=self.proc,
                    thread=threading.get_ident())
        self._append(span)
        return span.context

    # ------------------------------------------------------------------ #

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.recorded_total = 0

    def resize(self, capacity: int) -> None:
        """Bound the ring at ``capacity`` spans from now on, keeping the
        newest of those it holds."""

        with self._lock:
            self.capacity = int(capacity)
            self._buf = deque(self._buf, maxlen=self.capacity)

    def export_jsonl(self, path: str) -> int:
        """Write the ring's spans as JSON lines; returns the count."""

        spans = self.spans()
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            for span in spans:
                fh.write(json.dumps(span.to_dict()) + "\n")
        return len(spans)


def read_jsonl(path: str) -> List[Span]:
    spans = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                spans.append(Span.from_dict(json.loads(line)))
    return spans


_default = Tracer()


def tracer() -> Tracer:
    """The process-wide default tracer (every producer in the serving /
    pool stack records here)."""

    return _default
