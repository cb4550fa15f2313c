"""Flight recorder: the last N structured events, queryable at ``/debugz``
and dumped to disk on an injected crash.

Chaos-bench failures used to be log archaeology: a shed here, a hedge
there, a supervisor restart in a third process's stderr, with no shared
ordering.  The flight recorder is one bounded, thread-safe ring of the
*interesting* events — sheds, hedges, replica deaths/recoveries,
restarts, wedges, journal invalidations, deadline expiries, fault
injections — that

* the server and fan-in proxy expose at ``/debugz`` (JSON; bounded, so a
  scrape can never OOM a serving process), and
* the fault harness dumps to ``$DKS_FLIGHTREC_DIR/flightrec-crash-<pid>.json``
  just before an injected ``crash`` fault ``os._exit``\\ s, turning a
  chaos failure into one artifact instead of scattered logs.

Events are plain dicts ``{"ts": epoch_s, "seq": n, "kind": str, ...}``.
The recorder is process-wide (one per process, like the tracer): every
subsystem records into the same ordered ring, which is exactly what makes
the timeline useful.
"""

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

DEFAULT_CAPACITY = 512


def _jsonable(value):
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    return repr(value)


class FlightRecorder:
    """Bounded ring of structured events (see module doc)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.recorded_total = 0

    def record(self, kind: str, **fields) -> Dict:
        """Append one event; cheap and never raises (fields that are not
        JSON-serialisable are repr'd)."""

        event = {"ts": time.time(), "kind": str(kind)}
        for k, v in fields.items():
            event[k] = _jsonable(v)
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._events.append(event)
            self.recorded_total += 1
        return event

    def snapshot(self, kind: Optional[str] = None) -> List[Dict]:
        with self._lock:
            events = list(self._events)
        if kind is not None:
            events = [e for e in events if e["kind"] == kind]
        return events

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.recorded_total = 0
            self._seq = 0

    def to_payload(self) -> Dict:
        """The ``/debugz`` response body: the ring plus its own
        accounting, so a consumer can tell "quiet" from "wrapped"."""

        with self._lock:
            events = list(self._events)
            recorded = self.recorded_total
        return {"capacity": self.capacity,
                "recorded_total": recorded,
                "dropped_total": max(0, recorded - len(events)),
                "events": events}

    def dump(self, path: str) -> str:
        """Write the ring to ``path`` as JSON; returns the path."""

        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        payload = self.to_payload()
        payload["dumped_at"] = time.time()
        payload["pid"] = os.getpid()
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)
            fh.flush()
            os.fsync(fh.fileno())
        return path

    def dump_crash(self, reason: str = "") -> Optional[str]:
        """Best-effort dump for the fault harness's ``crash`` path: writes
        to ``$DKS_FLIGHTREC_DIR`` (no-op when unset) and NEVER raises —
        this runs microseconds before ``os._exit`` and must not turn an
        injected crash into a different failure."""

        directory = os.environ.get("DKS_FLIGHTREC_DIR", "").strip()
        if not directory:
            return None
        try:
            self.record("crash_dump", reason=reason)
            return self.dump(os.path.join(
                directory, f"flightrec-crash-{os.getpid()}.json"))
        except Exception:
            logger.exception("flight-recorder crash dump failed")
            return None


_default = FlightRecorder()


def flightrec() -> FlightRecorder:
    """The process-wide flight recorder."""

    return _default
