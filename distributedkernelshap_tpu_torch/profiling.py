"""Per-phase timers, boundary spans and a device trace hook of the PyTorch
port.

Port of ``distributedkernelshap_tpu/profiling.py``: named per-phase timers
(coalition plan, device explain, host eval, solve, plan constants, ...)
that the engine wraps around its stages, and a ``torch.profiler`` trace
hook that writes a Chrome trace of host and device activity.

Enable the timers with ``DKS_PROFILE=1`` (or ``profiler().enable()``).
Memory is bounded: per-phase ``count`` and ``total_s`` are exact
accumulators, while the raw samples live in a rolling window of the most
recent :data:`DEFAULT_WINDOW` durations, enough for the windowed p50/p99
of ``summary()``.

:func:`span` is the port's one boundary primitive.  It is live while the
process tracer is enabled (``DKS_TRACE=1`` or ``tracer().enable()``) or a
``torch.profiler`` records on the calling thread; a live span stamps its
ends on ``time.time_ns()`` (the profiler's clock), appends a span to the
tracer's ring (parented to the thread's current context, which it becomes
for its body) and, while a profiler records, opens a profiler range of
the same name, so a profiler's trace names the host's time between device
records.  The range is a function-scope one (``_RecordFunctionFast``),
not ``record_function``'s user annotation: the profiler copies a user
annotation onto the device's rows over the kernels launched inside it,
where a reader of device records takes it for device work, and it costs
~15 times as much to open.  Off, a span costs the ``with`` statement, an
attribute read and one flag check.  Each :meth:`Profiler.phase` is also
a ``phase.<name>`` span.

PyTorch launches CUDA work asynchronously: a span or phase ends when the
host leaves it, and device work it queued lands in whichever later span
first waits for the device (a copy to the host, a synchronize).  The
profiler's device records, on the same clock, say when the device ran it.
"""

import contextlib
import logging
import math
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, Optional

import torch
from torch._C._profiler import _RecordFunctionFast as _range
from torch.autograd import _profiler_enabled

import distributedkernelshap_tpu_torch.observability.tracing as _tracing

logger = logging.getLogger(__name__)

#: rolling-window bound on retained per-phase samples; count/total stay
#: exact beyond it, percentiles become window-local
DEFAULT_WINDOW = 512


class _PhaseStats:
    __slots__ = ("count", "total_s", "window")

    def __init__(self, window: int):
        self.count = 0
        self.total_s = 0.0
        self.window: deque = deque(maxlen=window)


def _percentile(ordered, q: float) -> float:
    """Nearest-rank percentile of a pre-sorted non-empty sequence."""

    rank = max(1, int(math.ceil(q * len(ordered))))
    return ordered[rank - 1]


@contextlib.contextmanager
def span(name: str, **attrs):
    """A boundary span named ``name`` around the block (see the module's
    docstring); yields the ring's :class:`~distributedkernelshap_tpu_torch.
    observability.tracing.Span` (annotate it with counters known only at
    the end) or ``None`` while the tracer is off."""

    tracer = _tracing.tracer()
    ring, recording = tracer.enabled, _profiler_enabled()
    if not (ring or recording):
        yield None
        return
    sp = tracer.begin(name, **attrs) if ring else None
    rf = _range(name) if recording else None
    if rf is not None:
        rf.__enter__()
    try:
        with _tracing.use_context(sp.context if sp is not None else None):
            yield sp
    finally:
        if rf is not None:
            rf.__exit__(None, None, None)
        tracer.end(sp)


class Profiler:
    """Per-phase wall-clock accumulator + device trace hook."""

    def __init__(self, enabled: Optional[bool] = None,
                 window: int = DEFAULT_WINDOW):
        if enabled is None:
            enabled = os.environ.get("DKS_PROFILE", "0") not in ("", "0", "false")
        self.enabled = enabled
        self.window = max(1, int(window))
        self._phases: Dict[str, _PhaseStats] = {}
        self._lock = threading.Lock()
        self._n_traces = 0
        #: the Chrome trace the last :meth:`trace` block wrote
        self.last_trace_path: Optional[str] = None

    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a named phase while the profiler is enabled, and open a
        ``phase.<name>`` :func:`span` around it (live or not, independently
        of the profiler)."""

        t0 = time.perf_counter() if self.enabled else None
        try:
            with span("phase." + name):
                yield
        finally:
            if t0 is not None:
                dt = time.perf_counter() - t0
                with self._lock:
                    st = self._phases.get(name)
                    if st is None:
                        st = self._phases[name] = _PhaseStats(self.window)
                    st.count += 1
                    st.total_s += dt
                    st.window.append(dt)

    @contextlib.contextmanager
    def trace(self, logdir: Optional[str] = None):
        """Capture a ``torch.profiler`` trace of the block (host activity,
        and device activity where CUDA is available) and write it as a
        Chrome trace, ``<logdir>/trace-<pid>-<n>.json``; yields ``logdir``.

        ``logdir`` defaults to ``DKS_DEVICE_TRACE_DIR`` when that is set,
        else ``dks_trace`` in the temporary directory (``/tmp/dks_trace``
        unless ``TMPDIR`` says otherwise).  The written file's path is
        :attr:`last_trace_path` afterwards."""

        if logdir is None:
            logdir = os.environ.get("DKS_DEVICE_TRACE_DIR") \
                or os.path.join(tempfile.gettempdir(), "dks_trace")
        os.makedirs(logdir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        try:
            with prof:
                yield logdir
        finally:
            with self._lock:
                self._n_traces += 1
                n = self._n_traces
            path = os.path.join(logdir, f"trace-{os.getpid()}-{n}.json")
            prof.export_chrome_trace(path)
            self.last_trace_path = path
            logger.info("device trace written to %s", path)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-phase ``{count, total_s, mean_s, last_s, p50_s, p99_s}``.

        ``count``/``total_s``/``mean_s`` are exact over the phase's whole
        history; ``last_s`` and the percentiles come from the rolling
        window of the most recent :attr:`window` samples."""

        with self._lock:
            out = {}
            for name, st in self._phases.items():
                if not st.count:
                    continue
                ordered = sorted(st.window)
                out[name] = {
                    "count": st.count,
                    "total_s": st.total_s,
                    "mean_s": st.total_s / st.count,
                    "last_s": st.window[-1],
                    "p50_s": _percentile(ordered, 0.50),
                    "p99_s": _percentile(ordered, 0.99),
                }
            return out

    def reset(self):
        with self._lock:
            self._phases.clear()

    def report(self) -> str:
        lines = [f"{'phase':<24}{'count':>7}{'total_s':>10}{'mean_s':>10}"
                 f"{'p50_s':>10}{'p99_s':>10}"]
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{name:<24}{s['count']:>7}{s['total_s']:>10.3f}"
                         f"{s['mean_s']:>10.4f}{s['p50_s']:>10.4f}"
                         f"{s['p99_s']:>10.4f}")
        return "\n".join(lines)


_default = Profiler()


def profiler() -> Profiler:
    """The process-wide default profiler."""

    return _default
