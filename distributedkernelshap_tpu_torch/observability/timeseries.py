"""Bounded in-process time-series store + registry sampler.

The PR-3 registry answers "what is the value NOW"; nothing in the process
could answer "what was the error rate over the last minute" or "what was
interactive p99 in the last 30 s" — the inputs every SLO burn-rate
condition (``observability/slo.py``) and alert rule
(``observability/alerts.py``) needs.  This module closes that gap with a
deliberately small design:

* :class:`TimeSeriesStore` — one bounded ring (``deque(maxlen=...)``) per
  series.  A series is ``(metric name, label set)``; samples are
  ``(t, value)`` for counters/gauges and
  ``(t, cumulative bucket counts, sum, count)`` for histograms.  With the
  sampler's fixed interval, the ring is a fixed-width sliding window
  (default 600 samples x 1 s = 10 min of history) whose memory is bounded
  no matter how long the process lives.
* :class:`RegistrySampler` — a background thread that snapshots one or
  more live :class:`~distributedkernelshap_tpu_torch.observability.metrics.
  MetricsRegistry` instances into the store every ``interval_s`` via
  ``registry.collect()`` (cheap: one dict copy per metric under its own
  lock — nothing on the request path).
* **query API** — :meth:`TimeSeriesStore.rate` (counter deltas/s, reset
  aware), :meth:`~TimeSeriesStore.avg_over` (gauge mean),
  :meth:`~TimeSeriesStore.quantile` (windowed histogram quantile with
  the standard Prometheus linear interpolation inside the bucket),
  :meth:`~TimeSeriesStore.delta` / :meth:`~TimeSeriesStore.histogram_window`
  (the windowed increments SLO math consumes), and
  :meth:`~TimeSeriesStore.points` for the ``/statusz`` sparklines.
* **JSONL export/replay** — :meth:`~TimeSeriesStore.export_jsonl` /
  :func:`load_jsonl`, so an incident's history can be pulled off a live
  process and replayed offline through the alert engine
  (``scripts/health_check.py`` replays a committed fixture as the CI
  golden test).

Stdlib-only like the rest of the package (the fan-in proxy imports this
before jax/numpy come up).  Timestamps are epoch seconds; every query
takes an explicit ``now`` so tests and replays are deterministic.
"""

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from distributedkernelshap_tpu_torch.analysis import lockwitness

logger = logging.getLogger(__name__)

#: default samples kept per series — with the sampler's default 1 s
#: interval, ten minutes of history
DEFAULT_CAPACITY = 600

SPARK_CHARS = "▁▂▃▄▅▆▇█"


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def sparkline(values: Sequence[float]) -> str:
    """Unicode sparkline of ``values`` (empty string for no data)."""

    vals = [float(v) for v in values]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return SPARK_CHARS[0] * len(vals)
    span = hi - lo
    return "".join(
        SPARK_CHARS[min(len(SPARK_CHARS) - 1,
                        int((v - lo) / span * len(SPARK_CHARS)))]
        for v in vals)


class _Series:
    """One ring: scalar samples ``(t, value)`` or histogram samples
    ``(t, counts, sum, count)`` (cumulative, +Inf slot included)."""

    __slots__ = ("name", "labels", "kind", "buckets", "samples")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 kind: str, capacity: int,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.labels = labels
        self.kind = kind
        self.buckets = buckets
        self.samples: deque = deque(maxlen=capacity)


class TimeSeriesStore:
    """Bounded per-series rings + the windowed query API (see module doc).

    Thread-safe: the sampler thread writes while ``/statusz`` handlers and
    the alert evaluator read.  All mutation happens under one lock; reads
    copy the (bounded) sample lists they need.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(2, int(capacity))
        self._series: Dict[tuple, _Series] = {}
        self._lock = lockwitness.make_lock("timeseries.store")
        self.samples_total = 0

    # -- write path ---------------------------------------------------- #

    def add(self, name: str, t: float, value: float,
            labels: Optional[Dict[str, str]] = None,
            kind: str = "gauge") -> None:
        """Append one scalar sample (``kind`` is ``counter`` or ``gauge``;
        it selects which queries make sense, not the storage)."""

        key = (name, _label_key(labels))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _Series(
                    name, key[1], kind, self.capacity)
            series.samples.append((float(t), float(value)))
            self.samples_total += 1

    def add_histogram(self, name: str, t: float,
                      buckets: Sequence[float], counts: Sequence[int],
                      sum_value: float, count: int,
                      labels: Optional[Dict[str, str]] = None) -> None:
        """Append one cumulative histogram snapshot.  ``counts`` are the
        per-bucket counts INCLUDING the +Inf slot (i.e.
        ``len(counts) == len(buckets) + 1``), exactly what
        ``Histogram.collect()`` emits."""

        key = (name, _label_key(labels))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _Series(
                    name, key[1], "histogram", self.capacity,
                    buckets=tuple(float(b) for b in buckets))
            series.samples.append((float(t), tuple(int(c) for c in counts),
                                   float(sum_value), int(count)))
            self.samples_total += 1

    # -- lookup -------------------------------------------------------- #

    def _get(self, name: str,
             labels: Optional[Dict[str, str]]) -> Optional[_Series]:
        with self._lock:
            return self._series.get((name, _label_key(labels)))

    def _snapshot(self, name: str, labels: Optional[Dict[str, str]]
                  ) -> Tuple[Optional[_Series], List[tuple]]:
        """Series + a consistent copy of its samples.  Every read path
        copies UNDER the lock: the sampler thread appends concurrently
        with /statusz handlers and scrape-time gauge callbacks, and
        iterating a deque mid-append raises."""

        with self._lock:
            series = self._series.get((name, _label_key(labels)))
            if series is None:
                return None, []
            return series, list(series.samples)

    @staticmethod
    def _in_window(samples: List[tuple], window_s: float,
                   now: float) -> List[tuple]:
        cutoff = now - window_s
        return [s for s in samples if cutoff <= s[0] <= now]

    def series_keys(self) -> List[Tuple[str, Dict[str, str]]]:
        with self._lock:
            return [(s.name, dict(s.labels)) for s in self._series.values()]

    def kind(self, name: str,
             labels: Optional[Dict[str, str]] = None) -> Optional[str]:
        series = self._get(name, labels)
        return series.kind if series is not None else None

    def labelsets(self, name: str) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(s.labels) for s in self._series.values()
                    if s.name == name]

    def latest(self, name: str,
               labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        """Most recent scalar value (None for missing/histogram series)."""

        series, samples = self._snapshot(name, labels)
        if series is None or series.kind == "histogram" or not samples:
            return None
        return samples[-1][1]

    def points(self, name: str, labels: Optional[Dict[str, str]] = None,
               window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Raw ``(t, value)`` scalar points (sparkline feed)."""

        series, samples = self._snapshot(name, labels)
        if series is None or series.kind == "histogram":
            return []
        if window_s is not None:
            now = time.time() if now is None else now
            samples = self._in_window(samples, window_s, now)
        return [(t, v) for t, v in samples]

    def rate_points(self, name: str,
                    labels: Optional[Dict[str, str]] = None,
                    window_s: Optional[float] = None,
                    now: Optional[float] = None
                    ) -> List[Tuple[float, float]]:
        """Per-second increase between consecutive counter samples (reset
        clamps to 0) — the sparkline view of a cumulative counter."""

        pts = self.points(name, labels, window_s=window_s, now=now)
        out = []
        for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
            dt = t1 - t0
            if dt > 0:
                out.append((t1, max(0.0, v1 - v0) / dt))
        return out

    # -- windowed queries (the SLO inputs) ----------------------------- #

    def delta(self, name: str, window_s: float,
              labels: Optional[Dict[str, str]] = None,
              now: Optional[float] = None) -> Optional[float]:
        """Total increase of a cumulative counter over the window (sum of
        positive steps, so a process-restart reset loses the pre-reset
        increment instead of going negative).  None = not enough samples
        in the window to say anything."""

        series, samples = self._snapshot(name, labels)
        if series is None or series.kind == "histogram":
            return None
        now = time.time() if now is None else now
        samples = self._in_window(samples, window_s, now)
        if len(samples) < 2:
            return None
        total = 0.0
        for (_, v0), (_, v1) in zip(samples, samples[1:]):
            if v1 > v0:
                total += v1 - v0
        return total

    def rate(self, name: str, window_s: float,
             labels: Optional[Dict[str, str]] = None,
             now: Optional[float] = None) -> Optional[float]:
        """Per-second rate of a counter over the window."""

        series, samples = self._snapshot(name, labels)
        if series is None or series.kind == "histogram":
            return None
        now = time.time() if now is None else now
        samples = self._in_window(samples, window_s, now)
        if len(samples) < 2:
            return None
        dt = samples[-1][0] - samples[0][0]
        if dt <= 0:
            return None
        # positive-step sum from the SAME snapshot (a second delta()
        # call would re-lock and could see a different sample set)
        increase = sum(v1 - v0 for (_, v0), (_, v1)
                       in zip(samples, samples[1:]) if v1 > v0)
        return increase / dt

    def avg_over(self, name: str, window_s: float,
                 labels: Optional[Dict[str, str]] = None,
                 now: Optional[float] = None) -> Optional[float]:
        """Mean of a gauge's samples over the window."""

        series, samples = self._snapshot(name, labels)
        if series is None or series.kind == "histogram":
            return None
        now = time.time() if now is None else now
        samples = self._in_window(samples, window_s, now)
        if not samples:
            return None
        return sum(v for _, v in samples) / len(samples)

    def frac_over(self, name: str, window_s: float, threshold: float,
                  labels: Optional[Dict[str, str]] = None,
                  now: Optional[float] = None) -> Optional[float]:
        """Fraction of the window's gauge samples strictly above
        ``threshold`` — the staleness-SLO primitive."""

        series, samples = self._snapshot(name, labels)
        if series is None or series.kind == "histogram":
            return None
        now = time.time() if now is None else now
        samples = self._in_window(samples, window_s, now)
        if not samples:
            return None
        return sum(1 for _, v in samples if v > threshold) / len(samples)

    def histogram_window(self, name: str, window_s: float,
                         labels: Optional[Dict[str, str]] = None,
                         now: Optional[float] = None):
        """Windowed histogram increments: ``(bucket bounds, per-bucket
        count deltas incl. +Inf, sum delta, count delta)`` between the
        oldest and newest snapshot inside the window.  None without at
        least two snapshots (or on a reset, where deltas go negative)."""

        series, samples = self._snapshot(name, labels)
        if series is None or series.kind != "histogram":
            return None
        now = time.time() if now is None else now
        samples = self._in_window(samples, window_s, now)
        if len(samples) < 2:
            return None
        _, c0, s0, n0 = samples[0]
        _, c1, s1, n1 = samples[-1]
        if n1 < n0 or len(c0) != len(c1):
            return None  # reset mid-window: no honest delta exists
        counts = tuple(b - a for a, b in zip(c0, c1))
        if any(c < 0 for c in counts):
            return None
        return series.buckets, counts, s1 - s0, n1 - n0

    def quantile(self, name: str, q: float, window_s: float,
                 labels: Optional[Dict[str, str]] = None,
                 now: Optional[float] = None) -> Optional[float]:
        """Windowed ``q``-quantile (0..1) of a histogram, Prometheus
        ``histogram_quantile`` style: find the bucket the target rank
        lands in and interpolate linearly inside it.  None = no
        observations in the window."""

        win = self.histogram_window(name, window_s, labels, now=now)
        if win is None:
            return None
        bounds, counts, _, total = win
        if total <= 0:
            return None
        target = max(0.0, min(1.0, q)) * total
        cumulative = 0
        lower = 0.0
        for bound, c in zip(bounds, counts[:-1]):
            if cumulative + c >= target and c > 0:
                return lower + (bound - lower) * (target - cumulative) / c
            cumulative += c
            lower = bound
        # target lands in the +Inf bucket: the highest finite bound is the
        # most honest answer available
        return bounds[-1] if bounds else None

    def frac_le(self, name: str, threshold: float, window_s: float,
                labels: Optional[Dict[str, str]] = None,
                now: Optional[float] = None) -> Optional[float]:
        """Fraction of the window's histogram observations ``<=
        threshold``, interpolating when the threshold falls between
        bucket bounds — the latency-SLO primitive."""

        win = self.histogram_window(name, window_s, labels, now=now)
        if win is None:
            return None
        bounds, counts, _, total = win
        if total <= 0:
            return None
        cumulative = 0.0
        lower = 0.0
        for bound, c in zip(bounds, counts[:-1]):
            if threshold < bound:
                if c > 0 and bound > lower and threshold > lower:
                    cumulative += c * (threshold - lower) / (bound - lower)
                return max(0.0, min(1.0, cumulative / total))
            cumulative += c
            lower = bound
        return max(0.0, min(1.0, cumulative / total))

    # -- export / replay ----------------------------------------------- #

    def export_jsonl(self, path: str) -> int:
        """Append-free snapshot dump: every sample of every series as one
        JSON line, globally sorted by timestamp (so a replay evaluates in
        arrival order).  Returns the number of lines written."""

        with self._lock:
            series = list(self._series.values())
            rows = []
            for s in series:
                for sample in s.samples:
                    rows.append((sample[0], s, sample))
        rows.sort(key=lambda r: r[0])
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        n = 0
        with open(path, "w", encoding="utf-8") as fh:
            for t, s, sample in rows:
                doc = {"t": t, "name": s.name, "labels": dict(s.labels),
                       "kind": s.kind}
                if s.kind == "histogram":
                    _, counts, sum_value, count = sample
                    doc.update(buckets=list(s.buckets),
                               counts=list(counts),
                               sum=sum_value, count=count)
                else:
                    doc["value"] = sample[1]
                fh.write(json.dumps(doc) + "\n")
                n += 1
        return n

    def load_line(self, doc: Dict) -> None:
        """Ingest one exported line (see :meth:`export_jsonl`)."""

        if doc.get("kind") == "histogram":
            self.add_histogram(doc["name"], doc["t"], doc["buckets"],
                               doc["counts"], doc["sum"], doc["count"],
                               labels=doc.get("labels"))
        else:
            self.add(doc["name"], doc["t"], doc["value"],
                     labels=doc.get("labels"),
                     kind=doc.get("kind", "gauge"))


def load_jsonl(path: str,
               capacity: int = DEFAULT_CAPACITY * 10) -> TimeSeriesStore:
    """Replay an exported JSONL file into a fresh store (torn trailing
    lines — a dump cut off mid-write — are skipped with a warning, like
    the shard journal's torn-tail rule)."""

    store = TimeSeriesStore(capacity=capacity)
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                store.load_line(json.loads(line))
            except (ValueError, KeyError):
                logger.warning("%s:%d: skipping unparseable sample line",
                               path, lineno)
    return store


def iter_jsonl_times(store: TimeSeriesStore) -> List[float]:
    """Sorted unique sample timestamps — the evaluation points a replay
    steps through."""

    with store._lock:
        times = {s[0] for series in store._series.values()
                 for s in series.samples}
    return sorted(times)


class RegistrySampler:
    """Snapshot live registries into a :class:`TimeSeriesStore` on a fixed
    interval (see module doc).  ``sample_once`` is also public so tests
    and replays can drive deterministic ticks without a thread."""

    def __init__(self, store: TimeSeriesStore, registries: Iterable,
                 interval_s: float = 1.0):
        self.store = store
        self.registries = list(registries)
        self.interval_s = float(interval_s)
        self.samples_taken = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        for registry in self.registries:
            try:
                collected = registry.collect()
            except Exception:
                logger.exception("registry collect failed")
                continue
            for metric in collected:
                names = metric["labelnames"]
                if metric["type"] == "histogram":
                    for key, (counts, sum_value, count) in \
                            metric["series"].items():
                        self.store.add_histogram(
                            metric["name"], now, metric["buckets"], counts,
                            sum_value, count,
                            labels=dict(zip(names, key)))
                else:
                    kind = ("counter" if metric["type"] == "counter"
                            else "gauge")
                    for key, value in metric["series"].items():
                        self.store.add(metric["name"], now, value,
                                       labels=dict(zip(names, key)),
                                       kind=kind)
        self.samples_taken += 1

    # -- background loop ----------------------------------------------- #

    def _loop(self, on_tick) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
                if on_tick is not None:
                    on_tick()
            except Exception:
                logger.exception("sampler tick failed")

    def start(self, on_tick=None) -> "RegistrySampler":
        """Start the background thread (``interval_s <= 0`` disables it —
        the store then only ever sees explicit ``sample_once`` calls).
        ``on_tick`` runs after each sample — the health engine hangs the
        alert evaluation off it so one thread drives both."""

        if self.interval_s <= 0 or self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, args=(on_tick,),
                                        name="dks-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
