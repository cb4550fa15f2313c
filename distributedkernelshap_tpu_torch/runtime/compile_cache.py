"""Compiled-artefact cache + compile-event accounting of the PyTorch port.

Port of ``distributedkernelshap_tpu/runtime/compile_cache.py``.  The JAX
package caches and counts XLA executables; the port compiles nothing at
trace time.  Its compiled artefacts are the hand-written CUDA kernels
(``ops/cuda_kernels.py``: one ``nvcc`` run per ``csrc/<name>.cu`` into
``build/kernels/``) and the native host library (``runtime/native.py``:
``g++`` into ``build/native/``), each named by a digest of its source and
flags, so a library on disk is its own persistent cache entry.

* :func:`enable_persistent_cache` points both build directories at one
  directory, from an explicit argument or ``DKS_COMPILE_CACHE_DIR``, so
  replicas or restarts that share it load what another process built.
  Unset, the directories stay where they are (``<repo>/build/kernels``,
  ``<repo>/build/native``).  Idempotent.
* :func:`compile_events` is the process-wide **compile accountant**.  The
  build and load sites report each artefact once per process: ``fresh``
  when this process ran ``nvcc`` / ``g++`` for it (the seconds are the
  compiler's), ``cache_hit`` when the digest-named file was already in the
  build directory (the seconds are the load's).  Each event is attributed
  to the caller-declared *shape signature* that is ambient on the loading
  thread (``with compile_events().signature("rows=64"): ...``), exposed
  as ``dks_compile_total`` / ``dks_compile_seconds_total`` and recorded
  as a ``compile.backend`` trace span, with the reference's families,
  labels and span name.
"""

import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

logger = logging.getLogger(__name__)

#: env knobs (the reference's names).  The reference's write threshold,
#: ``DKS_COMPILE_CACHE_MIN_S``, has nothing to act on here: every artefact
#: is one digest-named file, always kept
CACHE_DIR_ENV = "DKS_COMPILE_CACHE_DIR"
MIN_COMPILE_S_ENV = "DKS_COMPILE_CACHE_MIN_S"

_state_lock = threading.Lock()
_enabled_dir: Optional[str] = None


def shape_signature(rows: int, path: Optional[str] = None,
                    model: Optional[str] = None) -> str:
    """The ONE spelling of a declared compile-shape signature
    (``[model=<id>,]rows=<bucket>[,path=<explain path>]``).  Today only
    the warmup ladder declares signatures (live request compiles fold
    into ``_unattributed``); ``path`` distinguishes the exact-TreeSHAP
    entry from the sampled pipeline at the same bucket — they are
    distinct executables, so a ladder that warmed only one of them shows
    up as such in ``dks_compile_total`` instead of hiding behind a shared
    label.  ``model`` is the multi-tenant registry's namespace prefix:
    each registered ``(model_id, version)`` warms its OWN executables, so
    its rungs must be attributable per tenant.  Any future live-dispatch
    attribution must spell its signatures through this helper so the
    labels collide with the matching rung's."""

    sig = f"rows={int(rows)}"
    if path:
        sig = f"{sig},path={path}"
    return sig if not model else f"model={model},{sig}"


def enable_persistent_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Point the kernel and native-library build directories at
    ``cache_dir`` (``<cache_dir>/kernels``, ``<cache_dir>/native``).

    Resolution order: explicit argument > ``DKS_COMPILE_CACHE_DIR``.
    ``None``/empty leaves both directories as they are and returns
    ``None``.  Libraries already loaded stay loaded;
    later builds and loads use the new directory.  Idempotent: the same
    directory again does nothing.  Returns the directory in use.
    """

    global _enabled_dir
    cache_dir = cache_dir or os.environ.get(CACHE_DIR_ENV) or None
    if not cache_dir:
        return None
    cache_dir = os.path.abspath(cache_dir)
    with _state_lock:
        if _enabled_dir == cache_dir:
            return cache_dir
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError as e:
            # an unwritable directory leaves the builds where they were:
            # cold starts then simply stay cold — never break the caller
            logger.warning("compile cache directory unavailable (%s); "
                           "continuing without it", e)
            return None
        from distributedkernelshap_tpu_torch.ops import cuda_kernels
        from distributedkernelshap_tpu_torch.runtime import native

        cuda_kernels.set_build_dir(os.path.join(cache_dir, "kernels"))
        native.set_build_dir(os.path.join(cache_dir, "native"))
        _enabled_dir = cache_dir
    logger.info("compiled-artefact cache at %s", cache_dir)
    return cache_dir


def persistent_cache_dir() -> Optional[str]:
    """The directory :func:`enable_persistent_cache` last applied, if any."""

    with _state_lock:
        return _enabled_dir


class CompileAccounting:
    """Process-wide compile-event counts, by ``(kind, signature)``.

    ``kind`` is ``'fresh'`` (the compiler ran) or ``'cache_hit'`` (the
    digest-named artefact was on disk; the recorded seconds are then its
    load time).  ``signature`` is whatever shape label the caller declared
    via :meth:`signature` around the work that may build — the warmup
    ladder uses ``rows=<bucket>`` — and ``_unattributed`` otherwise.

    Thread-safe.  The build and load sites call :meth:`record`; compile
    truth is process-global, and per-component registries read it through
    render-time callbacks (:meth:`metric_counts`).
    """

    def __init__(self):
        self._lock = threading.Lock()
        # {(kind, signature): count}, {(kind, signature): seconds}
        self._counts: Dict[tuple, int] = {}
        self._seconds: Dict[tuple, float] = {}
        # running scalar twin of sum(self._seconds.values()): the cost
        # meter reads it twice per device dispatch, so it must not cost
        # a dict scan
        self._total_s = 0.0
        self._local = threading.local()
        #: {artefact name: kind} of every event recorded, for reports
        self._artefacts: Dict[str, str] = {}

    # -------------------------------------------------------------- #

    def record(self, kind: str, seconds: float, artefact: str = "") -> None:
        """Count one compile event of ``kind`` (``'fresh'`` or
        ``'cache_hit'``) that took ``seconds``, attributed to the ambient
        signature of the calling thread."""

        if kind not in ("fresh", "cache_hit"):
            raise ValueError(f"kind must be 'fresh' or 'cache_hit', got {kind!r}")
        sig = getattr(self._local, "signature", None) or "_unattributed"
        key = (kind, sig)
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1
            self._seconds[key] = self._seconds.get(key, 0.0) + float(seconds)
            self._total_s += float(seconds)
            if artefact:
                self._artefacts[artefact] = kind
        self._record_span(kind, sig, seconds, artefact)

    def _record_span(self, kind: str, sig: str, duration: float,
                     artefact: str) -> None:
        """A ``compile.backend`` trace span for the event, parented to the
        ambient request/warmup context (builds and loads run synchronously
        on the calling thread, so the contextvar is the right parent)."""

        try:
            from distributedkernelshap_tpu_torch.observability import tracing

            tr = tracing.tracer()
            if not tr.enabled:
                return
            end = time.monotonic()
            tr.record_mono("compile.backend", end - duration, end,
                           parent=tracing.current_context(),
                           kind=kind, signature=sig, artefact=artefact)
        except Exception:  # tracing must never break a build
            logger.debug("compile span recording failed", exc_info=True)

    def artefacts(self) -> Dict[str, str]:
        """``{artefact: kind}`` of every artefact this process recorded."""

        with self._lock:
            return dict(self._artefacts)

    # -------------------------------------------------------------- #

    @contextmanager
    def signature(self, sig: str):
        """Attribute compile events fired on THIS thread inside the block
        to shape signature ``sig`` (nesting restores the outer value)."""

        prev = getattr(self._local, "signature", None)
        self._local.signature = str(sig)
        try:
            yield self
        finally:
            self._local.signature = prev

    def total_seconds(self) -> float:
        """Cumulative compile seconds across every kind and signature —
        the cost meter's cheap per-dispatch read."""

        with self._lock:
            return self._total_s

    def snapshot(self) -> Dict[str, Dict]:
        """Structured copy of the counts: ``{"counts": {(kind, sig): n},
        "seconds": {(kind, sig): s}}`` plus per-kind totals."""

        with self._lock:
            counts = dict(self._counts)
            seconds = dict(self._seconds)
        totals = {"fresh": 0, "cache_hit": 0}
        sec_totals = {"fresh": 0.0, "cache_hit": 0.0}
        for (kind, _), n in counts.items():
            totals[kind] = totals.get(kind, 0) + n
        for (kind, _), s in seconds.items():
            sec_totals[kind] = sec_totals.get(kind, 0.0) + s
        return {"counts": counts, "seconds": seconds,
                "totals": totals, "seconds_totals": sec_totals}

    @staticmethod
    def delta(before: Dict, after: Dict) -> Dict[str, Dict]:
        """``after - before`` for two :meth:`snapshot` results (new
        signatures appear, untouched ones drop out)."""

        out = {"counts": {}, "seconds": {}}
        for field in ("counts", "seconds"):
            b = before[field]
            for key, val in after[field].items():
                d = val - b.get(key, 0)
                if d:
                    out[field][key] = d
        out["totals"] = {
            k: after["totals"].get(k, 0) - before["totals"].get(k, 0)
            for k in set(after["totals"]) | set(before["totals"])}
        out["seconds_totals"] = {
            k: (after["seconds_totals"].get(k, 0.0)
                - before["seconds_totals"].get(k, 0.0))
            for k in set(after["seconds_totals"])
            | set(before["seconds_totals"])}
        return out

    def fresh_for_signature(self, snapshot_delta: Dict, sig: str) -> int:
        """Fresh-compile count one signature contributed to a delta."""

        return sum(n for (kind, s), n in snapshot_delta["counts"].items()
                   if kind == "fresh" and s == sig)

    # ----------------------- registry callbacks ------------------- #

    def metric_counts(self) -> Dict[tuple, float]:
        with self._lock:
            return {k: float(v) for k, v in self._counts.items()}

    def metric_seconds(self) -> Dict[tuple, float]:
        with self._lock:
            return dict(self._seconds)

    def attach_metrics(self, registry) -> None:
        """Register ``dks_compile_total{kind,signature}`` and
        ``dks_compile_seconds_total{kind,signature}`` on ``registry`` as
        callback counters reading this (process-global) accountant.
        Signature cardinality is bounded: only warmup-ladder rungs and
        serving buckets declare signatures; everything else folds into
        ``_unattributed``."""

        registry.counter(
            "dks_compile_total",
            "Compiled-artefact events by kind (fresh = nvcc/g++ ran, "
            "cache_hit = the digest-named library was already built) "
            "and declared shape signature.",
            labelnames=("kind", "signature")).set_function(self.metric_counts)
        registry.counter(
            "dks_compile_seconds_total",
            "Seconds spent in compile events (cache_hit rows count load "
            "time) by kind and shape signature.",
            labelnames=("kind", "signature")).set_function(
            self.metric_seconds)


_accounting: Optional[CompileAccounting] = None
_accounting_lock = threading.Lock()


def compile_events() -> CompileAccounting:
    """The process-wide compile accountant (created on first use)."""

    global _accounting
    with _accounting_lock:
        if _accounting is None:
            _accounting = CompileAccounting()
        return _accounting
