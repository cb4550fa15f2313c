"""The health engine behind ``/statusz``: one object bundling the
time-series sampler, the SLO set and the alert manager for a serving
component.

``ExplainerServer`` and ``FanInProxy`` each own a
:class:`HealthEngine` next to their ``MetricsRegistry``.  The engine

* samples the registry into a bounded :class:`~distributedkernelshap_tpu_torch.
  observability.timeseries.TimeSeriesStore` on a fixed interval (one
  daemon thread per component; ``interval_s=0`` disables sampling but
  keeps the page serving — a cold ``/statusz`` must render);
* evaluates the component's SLOs and alert rules on the same tick, so
  alert latency is exactly one sampling interval;
* registers the health series back into the registry —
  ``dks_slo_budget_remaining{slo=}``, ``dks_slo_burn_rate{slo=,window=}``
  and (via the alert manager) ``dks_alerts_firing{rule=}`` — so ordinary
  scrapers see SLO state without speaking a second protocol;
* assembles the ``/statusz`` payload: SLO status, alert states, recent
  flight-recorder timeline, sparkline series, component-specific detail
  (queue depths / replica liveness) — one human page
  (:func:`render_statusz_html`) and one machine schema
  (``?format=json``, stable keys asserted by ``tests/test_statusz.py``).

Stdlib-only, like everything under ``observability/``.
"""

import html
import json
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

from distributedkernelshap_tpu_torch.observability.alerts import (
    AlertManager,
    FlightRecorderSink,
    LogSink,
    WebhookSink,
    slo_burn_rule,
)
from distributedkernelshap_tpu_torch.analysis import lockwitness
from distributedkernelshap_tpu_torch.observability.timeseries import (
    RegistrySampler,
    TimeSeriesStore,
    sparkline,
)

logger = logging.getLogger(__name__)

#: flight-recorder tail length on the page
_FLIGHTREC_TAIL = 20

#: sparkline points rendered per series
_SPARK_POINTS = 60


class HealthEngine:
    """Sampler + SLOs + alerts for one component (see module doc).

    Parameters
    ----------
    registry
        The component's :class:`MetricsRegistry` — sampled into the store
        and extended with the ``dks_slo_*`` / ``dks_alerts_firing``
        series.
    component
        ``"server"`` or ``"proxy"`` (labels log lines, flight-recorder
        events and the page header).
    slos
        The SLO set to evaluate (e.g. ``slo.default_server_slos()``).
    rules
        Alert rules.  ``None`` derives one burn-rate rule per SLO via
        :func:`~distributedkernelshap_tpu_torch.observability.alerts.
        slo_burn_rule`; pass an explicit list (possibly empty) to
        override.
    sinks
        Alert sinks.  ``None`` means log + flight recorder (+ webhook
        when ``webhook_url`` is set).
    interval_s
        Sampling/evaluation period; ``0`` disables the background thread
        (the store then only moves on explicit :meth:`tick` calls).
    spark_names
        Metric names surfaced as sparklines on the page (counters render
        as per-interval rates, gauges as levels).
    """

    def __init__(self, registry, component: str, slos: Sequence = (),
                 rules: Optional[Sequence] = None,
                 sinks: Optional[Sequence] = None,
                 flight=None, interval_s: float = 1.0,
                 store: Optional[TimeSeriesStore] = None,
                 capacity: int = 600,
                 webhook_url: Optional[str] = None,
                 spark_names: Sequence[str] = ()):
        if flight is None:
            from distributedkernelshap_tpu_torch.observability.flightrec import (
                flightrec,
            )

            flight = flightrec()
        self.component = component
        self.flight = flight
        self.registry = registry
        self.slos = list(slos)
        self.store = store if store is not None else TimeSeriesStore(capacity)
        self.interval_s = float(interval_s)
        self.sampler = RegistrySampler(self.store, [registry],
                                       interval_s=self.interval_s)
        # whether the rule set is DERIVED from the SLOs (one burn rule
        # each): only then may set_slos rebuild it — an explicit rules
        # override is the caller's contract and stays put
        self._rules_derived = rules is None
        if rules is None:
            rules = [slo_burn_rule(slo) for slo in self.slos]
        if sinks is None:
            sinks = [LogSink(), FlightRecorderSink(flight)]
            if webhook_url:
                sinks.append(WebhookSink(webhook_url))
        self.alerts = AlertManager(self.store, rules, sinks=sinks,
                                   component=component)
        self.spark_names = tuple(spark_names)
        self.started_at = time.time()
        # SLO-status memo: the two dks_slo_* gauge callbacks fire on
        # every scrape AND every sampler tick (collect() samples them
        # too), and each evaluation is an O(window) ring scan per SLO —
        # a short TTL collapses the per-tick repeats into one pass.
        # Half the sampling interval (capped) so a cached status never
        # spans two ticks even at sub-second intervals.
        self._status_ttl_s = (min(0.5, self.interval_s / 2)
                              if self.interval_s > 0 else 0.5)
        self._status_cache: tuple = (0.0, None)
        self._status_lock = lockwitness.make_lock("statusz.status")
        # logical evaluation time for deterministic tick(now=...): the
        # registry's dks_slo_* gauge callbacks take no arguments, so a
        # replayed tick routes its timestamp here — without it the
        # callbacks would evaluate at wall time over logically-stamped
        # samples and record full-budget gauges during a replayed burn
        self._eval_now: Optional[float] = None
        self._register_metrics(registry)

    # -- registry back-channel ------------------------------------------ #

    def _register_metrics(self, registry) -> None:
        self.alerts.attach_metrics(registry)
        registry.gauge(
            "dks_slo_budget_remaining",
            "Error-budget fraction left over the SLO's longest window "
            "(1 = untouched, <0 = overspent).",
            labelnames=("slo",)).set_function(self._budget_series)
        registry.gauge(
            "dks_slo_burn_rate",
            "Error-budget burn rate by SLO and window (1 = spending "
            "exactly on budget).",
            labelnames=("slo", "window")).set_function(self._burn_series)

    def _statuses(self, now: Optional[float] = None) -> List[Dict]:
        if now is None:
            now = (self._eval_now if self._eval_now is not None
                   else time.time())
        with self._status_lock:
            cached_at, cached = self._status_cache
            if cached is not None and 0 <= now - cached_at < \
                    self._status_ttl_s:
                return cached
        statuses = [slo.evaluate(self.store, now=now) for slo in self.slos]
        with self._status_lock:
            self._status_cache = (now, statuses)
        return statuses

    def slo_statuses(self, now: Optional[float] = None) -> List[Dict]:
        """Public view of the current SLO evaluations (memoised per tick
        like the gauge callbacks) — the autoscaler reads its burn-rate
        and budget-remaining signals from here instead of re-deriving
        them from the store."""

        return self._statuses(now)

    def set_slos(self, slos: Sequence) -> None:
        """Replace the evaluated SLO set at runtime (the server's
        per-tenant SLO refresh on registry hot-swap/removal).  When the
        alert rules were derived from the SLOs, they are rebuilt to
        match — rules whose name survives keep their alert state (see
        ``AlertManager.set_rules``); an explicit ``rules`` override is
        left untouched.  The status memo is invalidated so the next
        scrape/tick evaluates the new set."""

        self.slos = list(slos)
        if self._rules_derived:
            self.alerts.set_rules([slo_burn_rule(slo) for slo in self.slos])
        with self._status_lock:
            self._status_cache = (0.0, None)

    def _budget_series(self) -> Dict[tuple, float]:
        out = {}
        for status in self._statuses():
            remaining = status["budget_remaining"]
            # an idle window (no data) reports a full budget: silence is
            # not an outage
            out[(status["name"],)] = 1.0 if remaining is None else remaining
        return out

    def _burn_series(self) -> Dict[tuple, float]:
        out = {}
        for status in self._statuses():
            for window, burn in status["burn_rates"].items():
                out[(status["name"], window)] = 0.0 if burn is None else burn
        return out

    # -- lifecycle ------------------------------------------------------- #

    def tick(self, now: Optional[float] = None) -> List[Dict]:
        """One deterministic sample+evaluate step (tests, replays);
        returns the alert transitions it caused.  ``now`` also becomes
        the gauge callbacks' evaluation time for the duration of the
        tick, so replayed dks_slo_* samples reflect the logical clock."""

        self._eval_now = now
        try:
            self.sampler.sample_once(now=now)
            return self.alerts.evaluate(now=now)
        finally:
            self._eval_now = None

    def start(self) -> "HealthEngine":
        self.started_at = time.time()
        self.sampler.start(on_tick=self.alerts.evaluate)
        return self

    def stop(self) -> None:
        self.sampler.stop()

    # -- /statusz -------------------------------------------------------- #

    def _series_payload(self, now: float) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        for name, labels in self.store.series_keys():
            if name not in self.spark_names:
                continue
            kind = self.store.kind(name, labels)
            if kind == "histogram":
                continue
            if kind == "counter":
                pts = self.store.rate_points(name, labels)[-_SPARK_POINTS:]
            else:
                pts = self.store.points(name, labels)[-_SPARK_POINTS:]
            label_str = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            key = f"{name}{{{label_str}}}" if label_str else name
            values = [v for _, v in pts]
            out[key] = {
                "kind": "rate" if kind == "counter" else "level",
                "latest": round(values[-1], 6) if values else None,
                "points": [[round(t, 3), round(v, 6)] for t, v in pts],
                "sparkline": sparkline(values),
            }
        return out

    def statusz_payload(self, detail: Optional[Dict] = None) -> Dict:
        """The stable ``/statusz?format=json`` document."""

        now = time.time()
        alerts = self.alerts.payload(now=now)
        slos = self._statuses(now)
        firing = [a for a in alerts["alerts"] if a["state"] == "firing"]
        return {
            "component": self.component,
            "generated_at": now,
            "uptime_s": round(now - self.started_at, 1),
            "healthy": not any(a["severity"] == "page" for a in firing),
            "sampler": {
                "interval_s": self.interval_s,
                "enabled": self.interval_s > 0,
                "samples_taken": self.sampler.samples_taken,
                "series": len(self.store.series_keys()),
                "store_capacity": self.store.capacity,
            },
            "slos": slos,
            "alerts": alerts["alerts"],
            "silences": alerts["silences"],
            "series": self._series_payload(now),
            "flightrec": self.flight.snapshot()[-_FLIGHTREC_TAIL:],
            "detail": dict(detail or {}),
        }


# --------------------------------------------------------------------- #
# human rendering
# --------------------------------------------------------------------- #

_STATE_COLORS = {"firing": "#c0392b", "pending": "#e67e22",
                 "inactive": "#27ae60"}

_CSS = """
body { font-family: monospace; margin: 1.5em; color: #222; }
h1 { font-size: 1.3em; } h2 { font-size: 1.05em; margin-top: 1.4em; }
table { border-collapse: collapse; }
td, th { border: 1px solid #ccc; padding: 2px 8px; text-align: left; }
th { background: #f0f0f0; }
.spark { font-size: 1.1em; letter-spacing: 1px; }
.muted { color: #888; }
"""


def _fmt(value, digits=3) -> str:
    if value is None:
        return "–"
    if isinstance(value, bool):
        return "yes" if value else "no"
    if isinstance(value, float):
        return f"{value:.{digits}f}"
    return str(value)


def render_statusz_html(payload: Dict) -> str:
    """One human-readable page from the JSON payload — everything the
    JSON carries, nothing it does not (the page can never show state the
    machine schema omits)."""

    e = html.escape
    p = payload
    rows: List[str] = []
    rows.append(f"<!doctype html><html><head><title>/statusz — "
                f"{e(p['component'])}</title><style>{_CSS}</style></head>"
                f"<body>")
    health = "HEALTHY" if p["healthy"] else "UNHEALTHY"
    color = "#27ae60" if p["healthy"] else "#c0392b"
    rows.append(f"<h1>{e(p['component'])} /statusz — "
                f"<span style='color:{color}'>{health}</span></h1>")
    sampler = p["sampler"]
    rows.append(
        f"<p class='muted'>uptime {p['uptime_s']:.0f}s · sampler "
        f"{'on' if sampler['enabled'] else 'OFF'} "
        f"(interval {sampler['interval_s']:g}s, "
        f"{sampler['samples_taken']} samples, {sampler['series']} series) · "
        f"generated {time.strftime('%Y-%m-%d %H:%M:%S', time.gmtime(p['generated_at']))}Z"
        f" · <a href='/statusz?format=json'>json</a> · "
        f"<a href='/metrics'>metrics</a> · <a href='/debugz'>debugz</a></p>")

    rows.append("<h2>SLOs</h2>")
    if p["slos"]:
        rows.append("<table><tr><th>slo</th><th>kind</th><th>target</th>"
                    "<th>budget remaining</th><th>burn rates</th>"
                    "<th>breached</th></tr>")
        for s in p["slos"]:
            burns = " ".join(
                f"{w}:{_fmt(b, 2)}" for w, b in sorted(s["burn_rates"].items()))
            style = " style='color:#c0392b'" if s["breached"] else ""
            rows.append(
                f"<tr{style}><td>{e(s['name'])}</td><td>{e(s['kind'])}</td>"
                f"<td>{s['target']:g}</td>"
                f"<td>{_fmt(s['budget_remaining'], 3)}</td>"
                f"<td>{e(burns)}</td><td>{_fmt(s['breached'])}</td></tr>")
        rows.append("</table>")
    else:
        rows.append("<p class='muted'>no SLOs configured</p>")

    rows.append("<h2>Alerts</h2>")
    if p["alerts"]:
        rows.append("<table><tr><th>rule</th><th>state</th>"
                    "<th>severity</th><th>since</th><th>info</th></tr>")
        for a in p["alerts"]:
            color = _STATE_COLORS.get(a["state"], "#222")
            since = f"{a['since_s']:.0f}s" if a["since_s"] is not None else "–"
            rows.append(
                f"<tr><td>{e(a['rule'])}</td>"
                f"<td style='color:{color}'>{e(a['state'])}</td>"
                f"<td>{e(a['severity'])}</td><td>{since}</td>"
                f"<td class='muted'>{e(json.dumps(a['info'], default=repr)[:200])}"
                f"</td></tr>")
        rows.append("</table>")
    else:
        rows.append("<p class='muted'>no alert rules configured</p>")
    if p["silences"]:
        rows.append("<p>silences: " + ", ".join(
            f"{e(s['pattern'])} ({s['expires_in_s']:.0f}s left)"
            for s in p["silences"]) + "</p>")

    if p["detail"]:
        rows.append("<h2>Component detail</h2><table>")
        for key, value in sorted(p["detail"].items()):
            rows.append(f"<tr><th>{e(str(key))}</th><td>"
                        f"{e(json.dumps(value, default=repr)[:500])}"
                        f"</td></tr>")
        rows.append("</table>")

    rows.append("<h2>Recent series</h2>")
    if p["series"]:
        rows.append("<table><tr><th>series</th><th>view</th>"
                    "<th>latest</th><th>recent</th></tr>")
        for name, s in sorted(p["series"].items()):
            rows.append(
                f"<tr><td>{e(name)}</td><td>{e(s['kind'])}</td>"
                f"<td>{_fmt(s['latest'])}</td>"
                f"<td class='spark'>{e(s['sparkline'])}</td></tr>")
        rows.append("</table>")
    else:
        rows.append("<p class='muted'>no samples yet (cold start or "
                    "sampler disabled)</p>")

    rows.append("<h2>Recent events (flight recorder)</h2>")
    if p["flightrec"]:
        rows.append("<table><tr><th>seq</th><th>age</th><th>kind</th>"
                    "<th>fields</th></tr>")
        for ev in reversed(p["flightrec"]):
            extra = {k: v for k, v in ev.items()
                     if k not in ("ts", "seq", "kind")}
            age = p["generated_at"] - ev["ts"]
            rows.append(
                f"<tr><td>{ev['seq']}</td><td>{age:.1f}s</td>"
                f"<td>{e(ev['kind'])}</td><td class='muted'>"
                f"{e(json.dumps(extra, default=repr)[:200])}</td></tr>")
        rows.append("</table>")
    else:
        rows.append("<p class='muted'>no events recorded</p>")
    rows.append("</body></html>")
    return "\n".join(rows)


def statusz_response(engine: HealthEngine, query: str,
                     detail: Optional[Dict] = None):
    """Shared handler body for both components' ``/statusz`` routes:
    returns ``(content_type, body_str)`` honouring ``?format=json``."""

    payload = engine.statusz_payload(detail=detail)
    wants_json = "format=json" in (query or "")
    if wants_json:
        return ("application/json",
                json.dumps(payload, default=repr))
    return "text/html; charset=utf-8", render_statusz_html(payload)
