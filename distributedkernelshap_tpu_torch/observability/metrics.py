"""Central metrics registry: typed Counter/Gauge/Histogram with labels and
ONE Prometheus text renderer.

Before this module, three subsystems each hand-rolled their own metrics
dicts and exposition-format rendering — ``serving/server.py`` (a counters
dict, a shed-reason dict and a hand-unrolled latency histogram inside
``_render_metrics``), ``serving/replicas.py`` (the ``dks_fanin_*`` block)
and ``scheduling/scheduler.py`` (depths rendered by the server).  None of
the renderers was ever format-checked, the fan-in proxy's per-replica
error counters were bare ``int +=`` from hedge threads, and a new metric
meant hand-writing HELP/TYPE lines in the right spot of a 90-line
f-string block.  This registry is the single place a ``dks_*`` series can
come from:

* **registration** — ``registry.counter(name, help, labelnames)`` (and
  ``gauge``/``histogram``) declares the metric once, with its type and
  label schema; re-registering a name with a different shape raises.
* **atomic updates** — every metric guards its series map with its own
  lock, so ``inc()`` from hedge/handler/finalizer threads never loses an
  update (the regression the fan-in's bare ints had).
* **callbacks** — gauges (and counters whose truth lives elsewhere, e.g.
  the profiler's phase totals) may be backed by a ``set_function``
  callable sampled at render time, so scrape-time state (queue depths,
  replica liveness, cache occupancy) needs no write-path bookkeeping.
* **one renderer** — ``registry.render()`` emits the whole exposition
  page: HELP/TYPE per family, escaped label values, cumulative histogram
  buckets with ``+Inf``/``_sum``/``_count``.  ``validate_exposition``
  checks any page against the format rules (used by the compliance test
  and ``scripts/obs_check.py``).
* **self-description** — ``registry.describe()`` returns the catalog
  (name/type/labels/help) that ``make obs-check`` diffs against
  ``docs/OBSERVABILITY.md`` so metrics cannot drift undocumented.

Stdlib-only, like the serving stack it instruments.
"""

import logging
import math
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from distributedkernelshap_tpu_torch.analysis import lockwitness

logger = logging.getLogger(__name__)

#: default last-K exemplars kept per histogram bucket (bounded: the
#: exemplar store can never grow a serving process — K recent trace ids
#: per bucket per series, nothing more)
DEFAULT_EXEMPLAR_SLOTS = 4

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def format_value(value) -> str:
    """Render a sample value: integral values print without a decimal
    point (``dks_serve_requests_total 6``, matching the pre-registry
    renderers and the string assertions in the test suite), everything
    else as the float's shortest repr."""

    f = float(value)
    if math.isfinite(f) and f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labelnames: Sequence[str], labelvalues: Sequence[str],
               extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [(n, v) for n, v in zip(labelnames, labelvalues)]
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{n}="{_escape_label_value(str(v))}"'
                     for n, v in pairs)
    return "{" + inner + "}"


class _Metric:
    """Shared machinery: a name, a label schema, a lock, a series map."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_NAME_RE.match(ln) or ln == "le":
                raise ValueError(f"invalid label name {ln!r} for {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lockwitness.make_lock("metrics.metric")
        self._values: Dict[Tuple[str, ...], float] = {}
        self._fn: Optional[Callable] = None
        # cardinality declaration (the obs-check label-cardinality lint):
        # metrics carrying tenant-shaped labels (``model``) must either
        # declare a hard series cap (``bound_cardinality``) or a retire
        # hook (``MetricsRegistry.declare_retirement``) so deleted
        # tenants cannot grow the label space forever.  ``None`` = no
        # declaration (fails the lint for model-labeled metrics).
        self.cardinality: Optional[str] = None
        if not self.labelnames:
            # an unlabeled metric renders from birth (``..._total 0``) —
            # scrapers and the string assertions in the test suite expect
            # a series to exist before its first increment
            self._values[()] = 0.0

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {tuple(labels)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def set_function(self, fn: Callable) -> "_Metric":
        """Back this metric with a render-time callback.  For unlabeled
        metrics ``fn()`` returns a number; for labeled ones a dict mapping
        label-value tuples (ordered like ``labelnames``) to numbers.
        Callback metrics are read-only through the registry."""

        self._fn = fn
        return self

    def _sampled(self) -> Dict[Tuple[str, ...], float]:
        if self._fn is None:
            with self._lock:
                return dict(self._values)
        try:
            out = self._fn()
        except Exception:
            logger.exception("metric callback for %s failed", self.name)
            return {}
        if isinstance(out, dict):
            return {((k,) if isinstance(k, str) else tuple(str(x) for x in k)):
                    float(v) for k, v in out.items()}
        return {(): float(out)}

    def value(self, **labels) -> float:
        """Current value of one series (0.0 if never touched)."""

        return self._sampled().get(self._key(labels), 0.0)

    def bound_cardinality(self, bound: int) -> "_Metric":
        """Declare a hard cap on this metric's distinct label values (the
        writer enforces it, typically with an ``_overflow`` bucket); the
        obs-check lint accepts either this or a retire hook for
        model-labeled metrics."""

        self.cardinality = f"capped({int(bound)})"
        return self

    def _match_positions(self, match: Dict[str, str]):
        """``[(index, value), ...]`` for label names present in this
        metric's schema, or ``None`` when any match key is unknown."""

        positions = []
        for ln, lv in match.items():
            if ln not in self.labelnames:
                return None
            positions.append((self.labelnames.index(ln), str(lv)))
        return positions

    def retire_labels(self, match: Dict[str, str]) -> int:
        """Drop every series whose label values match ``match`` (a subset
        of the label schema — ``{"model": "m1"}`` retires all of m1's
        series whatever the other labels).  Returns the count removed.
        Callback-backed metrics are a no-op (their truth lives elsewhere;
        the owner retires it at the source)."""

        if self._fn is not None or not match:
            return 0
        positions = self._match_positions(match)
        if positions is None:
            return 0
        with self._lock:
            doomed = [k for k in self._values
                      if all(k[i] == v for i, v in positions)]
            for k in doomed:
                del self._values[k]
        return len(doomed)

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, val in self._sampled().items():
            lines.append(f"{self.name}{_label_str(self.labelnames, key)} "
                         f"{format_value(val)}")
        return lines

    def describe(self) -> Dict[str, object]:
        return {"name": self.name, "type": self.kind,
                "labels": list(self.labelnames), "help": self.help,
                "cardinality": self.cardinality}

    def collect(self) -> Dict[str, object]:
        """Structured snapshot for programmatic consumers (the time-series
        sampler): ``{"name", "type", "labelnames", "series"}`` where
        ``series`` maps label-value tuples to the current value."""

        return {"name": self.name, "type": self.kind,
                "labelnames": self.labelnames, "series": self._sampled()}


class Counter(_Metric):
    """Monotone counter.  ``inc`` is atomic under the metric lock, so
    concurrent handler/hedge/finalizer threads can never lose an update
    (the regression the fan-in proxy's bare ``int +=`` replica counters
    had)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def seed(self, *labelvalue_tuples) -> "Counter":
        """Pre-create series at 0 so known label values render before
        their first increment (the pre-registry renderers listed every
        shed reason from the start)."""

        with self._lock:
            for values in labelvalue_tuples:
                if isinstance(values, str):
                    values = (values,)
                key = tuple(str(v) for v in values)
                if len(key) != len(self.labelnames):
                    raise ValueError(f"seed {values!r} does not match "
                                     f"labels {self.labelnames}")
                self._values.setdefault(key, 0.0)
        return self


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class Histogram(_Metric):
    """Cumulative histogram with fixed bounded buckets.  Renders
    ``<name>_bucket{le=...}`` (cumulative), ``+Inf``, ``_sum`` and
    ``_count`` — exactly the shape the server's hand-unrolled latency
    histogram produced, now format-checked."""

    kind = "histogram"

    def __init__(self, name: str, help: str, buckets: Sequence[float],
                 labelnames: Sequence[str] = (), exemplar_slots: int = 0):
        super().__init__(name, help, labelnames)
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError("histogram buckets must be sorted and non-empty")
        self.buckets = tuple(float(b) for b in buckets)
        # per-series state: ([per-bucket counts + +Inf slot], sum, count)
        self._series: Dict[Tuple[str, ...], List] = {}
        # trace exemplars: last-K per (series, bucket) — an SLO breach on
        # this histogram links straight to the trace ids that landed in
        # its slow buckets.  0 disables (no storage, no overhead beyond
        # one int compare per observe).  Not rendered into the text
        # exposition (format 0.0.4 has no exemplar syntax); exposed via
        # :meth:`exemplars` → ``/debugz`` and ``/fleetz``.
        self.exemplar_slots = int(exemplar_slots)
        self._exemplars: Dict[Tuple[Tuple[str, ...], int], deque] = {}
        if not self.labelnames:
            # like the scalar metrics: an unlabeled histogram renders its
            # (all-zero) buckets from birth
            self._series[()] = [[0] * (len(self.buckets) + 1), 0.0, 0]

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels) -> None:
        """Record one observation; ``exemplar`` (a trace id) is kept in
        the observation's bucket when exemplar slots are enabled."""

        key = self._key(labels)
        with self._lock:
            state = self._series.get(key)
            if state is None:
                state = self._series[key] = [[0] * (len(self.buckets) + 1),
                                             0.0, 0]
            counts, _, _ = state
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    slot = i
                    break
            else:
                counts[-1] += 1
                slot = len(self.buckets)
            state[1] += value
            state[2] += 1
            if exemplar and self.exemplar_slots:
                ring = self._exemplars.get((key, slot))
                if ring is None:
                    ring = self._exemplars[(key, slot)] = deque(
                        maxlen=self.exemplar_slots)
                ring.append((str(exemplar), float(value), time.time()))

    def exemplars(self) -> List[Dict[str, object]]:
        """Bounded exemplar snapshot: one entry per stored exemplar —
        ``{"metric", "labels", "le", "trace_id", "value", "ts"}`` with
        ``le`` the observation's bucket upper bound (``"+Inf"`` for the
        overflow slot)."""

        with self._lock:
            snap = {k: list(v) for k, v in self._exemplars.items()}
        out = []
        for (key, slot), entries in snap.items():
            le = ("+Inf" if slot >= len(self.buckets)
                  else str(self.buckets[slot]))
            labels = dict(zip(self.labelnames, key))
            for trace_id, value, ts in entries:
                out.append({"metric": self.name, "labels": labels,
                            "le": le, "trace_id": trace_id,
                            "value": value, "ts": ts})
        return out

    def retire_labels(self, match: Dict[str, str]) -> int:
        if self._fn is not None or not match:
            return 0
        positions = self._match_positions(match)
        if positions is None:
            return 0
        with self._lock:
            doomed = [k for k in self._series
                      if all(k[i] == v for i, v in positions)]
            for k in doomed:
                del self._series[k]
            for ex_key in [ek for ek in self._exemplars
                           if ek[0] in set(doomed)]:
                del self._exemplars[ex_key]
        return len(doomed)

    def value(self, **labels):
        key = self._key(labels)
        with self._lock:
            state = self._series.get(key)
            if state is None:
                return {"count": 0, "sum": 0.0}
            return {"count": state[2], "sum": state[1]}

    def collect(self) -> Dict[str, object]:
        """Histogram snapshot for the time-series sampler: each series is
        ``(per-bucket counts incl. the +Inf slot, sum, count)`` plus the
        shared bucket bounds."""

        with self._lock:
            series = {k: (tuple(v[0]), v[1], v[2])
                      for k, v in self._series.items()}
        return {"name": self.name, "type": self.kind,
                "labelnames": self.labelnames, "buckets": self.buckets,
                "series": series}

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            series = {k: ([list(v[0])], v[1], v[2])
                      for k, v in self._series.items()}
        for key, (counts_box, total, count) in series.items():
            counts = counts_box[0]
            cumulative = 0
            for bound, c in zip(self.buckets, counts):
                cumulative += c
                lines.append(
                    f"{self.name}_bucket"
                    f"{_label_str(self.labelnames, key, ('le', str(bound)))} "
                    f"{cumulative}")
            cumulative += counts[-1]
            lines.append(
                f"{self.name}_bucket"
                f"{_label_str(self.labelnames, key, ('le', '+Inf'))} "
                f"{cumulative}")
            lines.append(f"{self.name}_sum"
                         f"{_label_str(self.labelnames, key)} "
                         f"{format_value(total)}")
            lines.append(f"{self.name}_count"
                         f"{_label_str(self.labelnames, key)} {count}")
        return lines


class MetricsRegistry:
    """One component's metric namespace (the server and the proxy each own
    one — tests run several servers per process, so a global registry
    would collide).  Thread-safe; renders in registration order."""

    def __init__(self):
        self._lock = lockwitness.make_lock("metrics.registry")
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if (type(existing) is not type(metric)
                        or existing.labelnames != metric.labelnames):
                    raise ValueError(
                        f"metric {metric.name} already registered with a "
                        f"different type or label set")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter(name, help, labelnames))

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(name, help, labelnames))

    def histogram(self, name: str, help: str, buckets: Sequence[float],
                  labelnames: Sequence[str] = (),
                  exemplar_slots: int = 0) -> Histogram:
        return self._register(Histogram(name, help, buckets, labelnames,
                                        exemplar_slots=exemplar_slots))

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def declare_retirement(self, name: str) -> None:
        """Declare that some owner retires this metric's stale label
        values (``retire_labels`` on writes, or source-side removal for
        callback metrics) — the obs-check cardinality lint's alternative
        to a hard cap."""

        metric = self.get(name)
        if metric is None:
            raise ValueError(f"declare_retirement: unknown metric {name}")
        metric.cardinality = "retire-hook"

    def retire_labels(self, name: str, match: Dict[str, str]) -> int:
        """Drop every series of ``name`` whose labels match ``match``
        (subset match); returns the count removed, 0 for unknown metrics
        or label names — retiring is cleanup, never an error path."""

        metric = self.get(name)
        if metric is None:
            return 0
        return metric.retire_labels(match)

    def exemplars(self) -> List[Dict[str, object]]:
        """Every histogram's stored trace exemplars (bounded: last-K per
        bucket per series) — the ``/debugz`` exemplar payload."""

        with self._lock:
            metrics = list(self._metrics.values())
        out: List[Dict[str, object]] = []
        for m in metrics:
            if isinstance(m, Histogram):
                out.extend(m.exemplars())
        return out

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def describe(self) -> List[Dict[str, object]]:
        with self._lock:
            return [m.describe() for m in self._metrics.values()]

    def collect(self) -> List[Dict[str, object]]:
        """Snapshot every metric's current series (see
        :meth:`_Metric.collect`) — the time-series sampler's read path."""

        with self._lock:
            metrics = list(self._metrics.values())
        return [m.collect() for m in metrics]


# --------------------------------------------------------------------- #
# exposition-format parsing + validation (compliance test, obs-check)
# --------------------------------------------------------------------- #

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)\s*$")
_LABEL_PAIR_RE = re.compile(
    r'\s*(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\.)*)"\s*'
    r"(?:,|$)")


def _unescape_label_value(value: str) -> str:
    return (value.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def parse_exposition(text: str):
    """Parse a Prometheus text-format page into
    ``{family: {"type", "help", "samples": [(name, labels, value)]}}``.
    Raises ``ValueError`` on lines that do not parse at all; semantic
    problems are :func:`validate_exposition`'s job."""

    families: Dict[str, Dict] = {}

    def family_for(sample_name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if sample_name.endswith(suffix):
                base = sample_name[:-len(suffix)]
                if families.get(base, {}).get("type") == "histogram":
                    return base
        return sample_name

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            families.setdefault(name, {"type": None, "help": None,
                                       "samples": []})["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            families.setdefault(name, {"type": None, "help": None,
                                       "samples": []})["type"] = kind.strip()
            continue
        if line.startswith("#"):
            continue  # free-form comment
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparseable sample {line!r}")
        labels: Dict[str, str] = {}
        raw = m.group("labels")
        if raw:
            pos = 0
            while pos < len(raw):
                lm = _LABEL_PAIR_RE.match(raw, pos)
                if lm is None:
                    raise ValueError(
                        f"line {lineno}: bad label syntax in {line!r}")
                labels[lm.group("name")] = _unescape_label_value(
                    lm.group("value"))
                pos = lm.end()
        try:
            value = float(m.group("value").replace("+Inf", "inf"))
        except ValueError:
            raise ValueError(f"line {lineno}: bad value in {line!r}")
        fam = family_for(m.group("name"))
        families.setdefault(fam, {"type": None, "help": None,
                                  "samples": []})
        families[fam]["samples"].append((m.group("name"), labels, value))
    return families


def validate_exposition(text: str) -> List[str]:
    """Check a metrics page against the exposition-format rules the
    hand-rolled renderers were never tested for.  Returns a list of
    problems (empty = compliant)."""

    problems: List[str] = []
    if text and not text.endswith("\n"):
        problems.append("page does not end with a newline")
    try:
        families = parse_exposition(text)
    except ValueError as e:
        return problems + [str(e)]
    seen_samples = set()
    for fam, info in families.items():
        if not info["samples"]:
            continue
        if info["type"] is None:
            problems.append(f"{fam}: samples without a # TYPE line")
        if info["help"] is None:
            problems.append(f"{fam}: samples without a # HELP line")
        for name, labels, _ in info["samples"]:
            key = (name, tuple(sorted(labels.items())))
            if key in seen_samples:
                problems.append(f"{name}{labels}: duplicate sample")
            seen_samples.add(key)
            for ln in labels:
                if not _LABEL_NAME_RE.match(ln):
                    problems.append(f"{name}: invalid label name {ln!r}")
        if info["type"] == "histogram":
            problems.extend(_validate_histogram(fam, info["samples"]))
        if info["type"] == "counter":
            for name, labels, value in info["samples"]:
                if value < 0:
                    problems.append(f"{name}{labels}: negative counter")
    return problems


def _validate_histogram(fam: str, samples) -> List[str]:
    problems: List[str] = []
    # group by base labels (minus le)
    series: Dict[Tuple, Dict] = {}
    for name, labels, value in samples:
        base = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
        st = series.setdefault(base, {"buckets": [], "sum": None,
                                      "count": None})
        if name == fam + "_bucket":
            if "le" not in labels:
                problems.append(f"{fam}_bucket missing le label")
                continue
            le = labels["le"]
            st["buckets"].append((math.inf if le == "+Inf" else float(le),
                                  value))
        elif name == fam + "_sum":
            st["sum"] = value
        elif name == fam + "_count":
            st["count"] = value
    for base, st in series.items():
        buckets = sorted(st["buckets"])
        if not buckets:
            # a histogram series may legitimately have no observations yet
            continue
        if buckets[-1][0] != math.inf:
            problems.append(f"{fam}{dict(base)}: no +Inf bucket")
        last = -1.0
        for bound, cum in buckets:
            if cum < last:
                problems.append(
                    f"{fam}{dict(base)}: bucket counts not monotone at "
                    f"le={bound}")
            last = cum
        if st["count"] is None:
            problems.append(f"{fam}{dict(base)}: missing _count")
        elif buckets[-1][0] == math.inf and st["count"] != buckets[-1][1]:
            problems.append(
                f"{fam}{dict(base)}: _count != +Inf bucket "
                f"({st['count']} vs {buckets[-1][1]})")
        if st["sum"] is None:
            problems.append(f"{fam}{dict(base)}: missing _sum")
    return problems
