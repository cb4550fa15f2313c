"""Per-phase timers and a device trace hook of the PyTorch port.

Port of ``distributedkernelshap_tpu/profiling.py``: named per-phase timers
(coalition plan, device explain, host eval, solve, plan constants, ...)
that the engine wraps around its stages, and a ``torch.profiler`` trace
hook that writes a Chrome trace of host and device activity.

Enable with ``DKS_PROFILE=1`` (or ``profiler().enable()``).  Memory is
bounded: per-phase ``count`` and ``total_s`` are exact accumulators, while
the raw samples live in a rolling window of the most recent
:data:`DEFAULT_WINDOW` durations, enough for the windowed p50/p99 of
``summary()``.

When request tracing is active (``DKS_TRACE=1``) and the current thread
carries a span context, each phase is also recorded as a ``phase.<name>``
child span of that context (``observability/tracing.py``).

PyTorch launches CUDA work asynchronously, so without a sync a phase's time
lands in whichever later phase first waits for the device.
``phase(sync=True)`` waits for the device at the phase's end
(``torch.cuda.synchronize``) where the work is on CUDA; a device error that
surfaces there propagates.
"""

import contextlib
import logging
import math
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, Optional, Union

import torch

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


def _sync(device: Optional[Union[str, torch.device]]) -> None:
    """Wait for outstanding work on ``device``.  ``None`` means the current
    CUDA device when CUDA has been initialised in this process (no work can
    be on a card before that); a CPU device has nothing to wait for.  Errors
    propagate."""

    if device is None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    def phase(self, name: str, sync: bool = False,
              device: Optional[Union[str, torch.device]] = None):
        """Time a named phase.  ``sync=True`` waits for outstanding device
        work on ``device`` (default: the current CUDA device, where CUDA is
        initialised) before reading the clock; on the CPU it waits for
        nothing.

        When the process tracer is enabled and this thread carries a span
        context, the phase is also recorded as a ``phase.<name>`` child
        span, even with the profiler itself disabled."""

        tracer = _tracing.tracer()
        trace_parent = (_tracing.current_context() if tracer.enabled
                        else None)
        if not self.enabled and trace_parent is None:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                _sync(device)
            dt = time.perf_counter() - t0
            if self.enabled:
                with self._lock:
                    st = self._phases.get(name)
                    if st is None:
                        st = self._phases[name] = _PhaseStats(self.window)
                    st.count += 1
                    st.total_s += dt
                    st.window.append(dt)
            if trace_parent is not None:
                t1_mono = time.monotonic()
                tracer.record_mono(f"phase.{name}", t1_mono - dt, t1_mono,
                                   parent=trace_parent)

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
