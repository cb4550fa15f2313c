"""Alert rules engine: pending → firing → resolved over the time-series
store, with pluggable sinks.

The SLO layer (``observability/slo.py``) says *whether* a condition
holds at an instant; this module adds the temporal discipline that makes
that an alert instead of noise:

* **for duration** — a condition must hold continuously for ``for_s``
  before the alert fires (a ``pending`` state in between, like
  Prometheus's ``for:``), so one bad scrape cannot page;
* **keep-firing duration** — once firing, the alert stays firing until
  the condition has been false for ``keep_firing_s``, so a flapping
  condition produces one alert, not a storm;
* **dedup** — one alert instance per rule; a rule that keeps evaluating
  true while firing notifies once (on the transition), not per tick;
* **silences** — ``silence(pattern, duration)`` suppresses sink
  notifications for matching rules (evaluation continues, so state is
  correct the moment the silence lapses).

Transitions are delivered to **sinks**: :class:`LogSink` (stderr via
logging), :class:`FlightRecorderSink` (the ``/debugz`` timeline — an
alert firing lands in the same ordered ring as the sheds/wedges that
caused it), :class:`WebhookSink` (JSON POST, fire-and-forget), and a
``dks_alerts_firing{rule=...}`` gauge the manager registers back into
the component's metrics registry so scrapers see alert state without a
second protocol.  Sinks must never raise into the evaluator; failures
are logged and dropped.

Stdlib-only; evaluation takes an explicit ``now`` so replays
(``scripts/health_check.py``) and tests are deterministic.
"""

import fnmatch
import json
import logging
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

INACTIVE = "inactive"
PENDING = "pending"
FIRING = "firing"
RESOLVED = "resolved"  # transition event only; steady state is inactive


class AlertRule:
    """One named condition with its temporal thresholds.

    ``condition(store, now)`` returns truthiness, or a ``(bool, info)``
    pair whose ``info`` dict rides along on every transition event (the
    SLO rules put burn rates there).
    """

    def __init__(self, name: str, condition: Callable,
                 for_s: float = 0.0, keep_firing_s: float = 0.0,
                 severity: str = "page",
                 annotations: Optional[Dict[str, str]] = None):
        self.name = name
        self.condition = condition
        self.for_s = max(0.0, float(for_s))
        self.keep_firing_s = max(0.0, float(keep_firing_s))
        self.severity = severity
        self.annotations = dict(annotations or {})


def slo_burn_rule(slo, for_s: float = 30.0, keep_firing_s: float = 60.0,
                  severity: str = "page") -> AlertRule:
    """The standard rule over one SLO: condition = the SLO's own
    multi-window multi-burn-rate breach, info = its full status dict."""

    def condition(store, now):
        status = slo.evaluate(store, now=now)
        return status["breached"], {
            "slo": slo.name, "kind": slo.kind, "target": slo.target,
            "burn_rates": status["burn_rates"],
            "budget_remaining": status["budget_remaining"]}

    return AlertRule(f"slo_burn:{slo.name}", condition, for_s=for_s,
                     keep_firing_s=keep_firing_s, severity=severity,
                     annotations={"slo": slo.name,
                                  "description": slo.description})


class _AlertInstance:
    __slots__ = ("rule", "state", "pending_since", "firing_since",
                 "last_true", "last_info", "transitions_total",
                 "last_pending_notified")

    def __init__(self, rule: AlertRule):
        self.rule = rule
        self.state = INACTIVE
        self.pending_since: Optional[float] = None
        self.firing_since: Optional[float] = None
        self.last_true: Optional[float] = None
        self.last_info: Dict = {}
        self.transitions_total = 0
        # last time a pending notification went out: a condition
        # flapping just under for_s must not spam sinks (and flood the
        # bounded flight-recorder ring) with one pending per blink
        self.last_pending_notified: Optional[float] = None


class Silence:
    __slots__ = ("pattern", "until")

    def __init__(self, pattern: str, until: float):
        self.pattern = pattern
        self.until = float(until)

    def matches(self, rule_name: str, now: float) -> bool:
        return now < self.until and fnmatch.fnmatch(rule_name, self.pattern)


# --------------------------------------------------------------------- #
# sinks
# --------------------------------------------------------------------- #


class LogSink:
    """Transitions to the process log (stderr under the default config)."""

    _LEVELS = {PENDING: logging.WARNING, FIRING: logging.ERROR,
               RESOLVED: logging.WARNING}

    def notify(self, event: Dict) -> None:
        logger.log(self._LEVELS.get(event["state"], logging.INFO),
                   "alert %s: %s (severity=%s) %s", event["state"],
                   event["rule"], event["severity"],
                   json.dumps(event.get("info", {}), default=repr))


class FlightRecorderSink:
    """Transitions onto the ``/debugz`` timeline, interleaved with the
    sheds/hedges/wedges that explain them."""

    def __init__(self, flight=None):
        if flight is None:
            from distributedkernelshap_tpu_torch.observability.flightrec import (
                flightrec,
            )

            flight = flightrec()
        self.flight = flight

    def notify(self, event: Dict) -> None:
        self.flight.record("alert", rule=event["rule"],
                           state=event["state"],
                           severity=event["severity"],
                           component=event.get("component", ""),
                           info=event.get("info", {}))


class WebhookSink:
    """Fire-and-forget JSON POST per transition.  The POST runs on a
    short-lived daemon thread: the evaluator shares its thread with the
    registry sampler, and a slow/unreachable receiver blocking it for
    ``timeout_s`` would punch sample gaps into every windowed query
    exactly when an incident is producing transitions.  Failures are
    logged and dropped; ``wait()`` drains in-flight posts (tests)."""

    def __init__(self, url: str, timeout_s: float = 5.0):
        self.url = url
        self.timeout_s = float(timeout_s)
        self._inflight: List[threading.Thread] = []

    def _post(self, event: Dict) -> None:
        body = json.dumps(event, default=repr).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=self.timeout_s).close()
        except Exception as e:
            logger.warning("alert webhook %s failed: %s", self.url, e)

    def notify(self, event: Dict) -> None:
        t = threading.Thread(target=self._post, args=(event,),
                             daemon=True, name="dks-alert-webhook")
        self._inflight = [x for x in self._inflight if x.is_alive()]
        self._inflight.append(t)
        t.start()

    def wait(self, timeout_s: Optional[float] = None) -> None:
        for t in list(self._inflight):
            t.join(timeout=timeout_s if timeout_s is not None
                   else self.timeout_s + 1.0)


class CollectSink:
    """Append transitions to a list — replays and tests read it back."""

    def __init__(self):
        self.events: List[Dict] = []

    def notify(self, event: Dict) -> None:
        self.events.append(event)


# --------------------------------------------------------------------- #


class AlertManager:
    """Evaluate rules against the store, run the state machine, notify
    sinks on transitions (see module doc)."""

    def __init__(self, store, rules: Sequence[AlertRule],
                 sinks: Sequence = (), component: str = "",
                 pending_renotify_s: float = 60.0):
        self.store = store
        self.component = component
        self.sinks = list(sinks)
        #: minimum gap between two *pending* notifications of one rule
        #: (firing/resolved always notify — they are per-episode already)
        self.pending_renotify_s = float(pending_renotify_s)
        self._lock = threading.Lock()
        self._alerts: Dict[str, _AlertInstance] = {}
        self._silences: List[Silence] = []
        for rule in rules:
            self.add_rule(rule)

    def add_rule(self, rule: AlertRule) -> None:
        with self._lock:
            if rule.name in self._alerts:
                raise ValueError(f"duplicate alert rule {rule.name!r}")
            self._alerts[rule.name] = _AlertInstance(rule)

    def set_rules(self, rules: Sequence[AlertRule]) -> None:
        """Replace the rule set wholesale (the health engine's dynamic
        SLO refresh: tenant SLOs come and go with registry hot-swaps).
        Rules whose NAME survives keep their alert-instance state — a
        firing alert must not silently reset to inactive because an
        unrelated tenant registered; removed rules drop with their
        state."""

        rules = list(rules)
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            # validated BEFORE any mutation: a bad rule list must leave
            # the current set (and its alert state) fully untouched
            dup = next(n for n in names if names.count(n) > 1)
            raise ValueError(f"duplicate alert rule {dup!r}")
        with self._lock:
            replacement: Dict[str, _AlertInstance] = {}
            for rule in rules:
                inst = self._alerts.get(rule.name)
                if inst is not None:
                    inst.rule = rule
                    replacement[rule.name] = inst
                else:
                    replacement[rule.name] = _AlertInstance(rule)
            self._alerts = replacement

    def silence(self, pattern: str, duration_s: float,
                now: Optional[float] = None) -> Silence:
        """Suppress sink notifications for rules matching ``pattern``
        (fnmatch glob) for ``duration_s``.  Evaluation continues."""

        now = time.time() if now is None else now
        s = Silence(pattern, now + duration_s)
        with self._lock:
            self._silences.append(s)
        return s

    def _silenced(self, rule_name: str, now: float) -> bool:
        with self._lock:
            self._silences = [s for s in self._silences if now < s.until]
            return any(s.matches(rule_name, now) for s in self._silences)

    # -- evaluation ------------------------------------------------------ #

    def _make_event(self, alert: _AlertInstance, state: str,
                    now: float) -> Dict:
        """Build one notification event.  Caller holds ``self._lock`` so
        the event is consistent with the state it announces
        (``transitions_total`` moves with every STATE change, including
        dampened pending episodes that never notify)."""

        return {"ts": now, "rule": alert.rule.name, "state": state,
                "severity": alert.rule.severity,
                "component": self.component,
                "annotations": alert.rule.annotations,
                "info": alert.last_info}

    def _dispatch(self, event: Dict) -> None:
        if self._silenced(event["rule"], event["ts"]):
            event["silenced"] = True
            return
        for sink in self.sinks:
            try:
                sink.notify(event)
            except Exception:
                logger.exception("alert sink %r failed",
                                 type(sink).__name__)

    def evaluate(self, now: Optional[float] = None) -> List[Dict]:
        """One evaluation tick; returns the transition events it caused
        (empty on a steady-state tick).

        Conditions run OUTSIDE the lock (they scan the store and may be
        slow); each alert's state transition is applied UNDER the lock
        so concurrent ``payload()``/``firing_series()`` readers never
        observe a half-applied transition (e.g. ``firing`` with no
        ``firing_since``); sink notification happens after release (a
        sink may itself read manager state)."""

        now = time.time() if now is None else now
        with self._lock:
            alerts = list(self._alerts.values())
        events: List[Dict] = []
        for alert in alerts:
            rule = alert.rule
            try:
                verdict = rule.condition(self.store, now)
            except Exception:
                logger.exception("alert condition %s failed", rule.name)
                continue
            if isinstance(verdict, tuple):
                active, info = bool(verdict[0]), dict(verdict[1] or {})
            else:
                active, info = bool(verdict), {}
            event: Optional[Dict] = None
            with self._lock:
                if info:
                    alert.last_info = info
                if active:
                    alert.last_true = now
                    if alert.state == INACTIVE:
                        alert.pending_since = now
                        if rule.for_s > 0:
                            alert.state = PENDING
                            alert.transitions_total += 1
                            # dampen flapping: a fresh pending EPISODE
                            # only notifies if the last pending
                            # notification is old enough (the state
                            # machine always moves)
                            if (alert.last_pending_notified is None
                                    or now - alert.last_pending_notified
                                    >= self.pending_renotify_s):
                                alert.last_pending_notified = now
                                event = self._make_event(alert, PENDING,
                                                         now)
                        else:
                            alert.state = FIRING
                            alert.firing_since = now
                            alert.transitions_total += 1
                            event = self._make_event(alert, FIRING, now)
                    elif alert.state == PENDING \
                            and now - alert.pending_since >= rule.for_s:
                        alert.state = FIRING
                        alert.firing_since = now
                        alert.transitions_total += 1
                        event = self._make_event(alert, FIRING, now)
                else:
                    if alert.state == PENDING:
                        # the condition blinked before for_s: back to
                        # quiet, no resolved event (nothing ever fired)
                        alert.state = INACTIVE
                        alert.pending_since = None
                        alert.transitions_total += 1
                    elif alert.state == FIRING and (
                            alert.last_true is None
                            or now - alert.last_true
                            >= rule.keep_firing_s):
                        alert.state = INACTIVE
                        alert.firing_since = None
                        alert.pending_since = None
                        alert.transitions_total += 1
                        event = self._make_event(alert, RESOLVED, now)
            if event is not None:
                self._dispatch(event)
                events.append(event)
        return events

    # -- views ----------------------------------------------------------- #

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {name: a.state for name, a in self._alerts.items()}

    def firing(self) -> List[str]:
        with self._lock:
            return sorted(name for name, a in self._alerts.items()
                          if a.state == FIRING)

    def firing_series(self) -> Dict[tuple, float]:
        """The ``dks_alerts_firing{rule=}`` gauge callback: 1 for firing
        rules, 0 otherwise — every rule renders from birth."""

        with self._lock:
            return {(name,): (1.0 if a.state == FIRING else 0.0)
                    for name, a in self._alerts.items()}

    def attach_metrics(self, registry) -> None:
        registry.gauge(
            "dks_alerts_firing",
            "Whether the named alert rule is currently firing.",
            labelnames=("rule",)).set_function(self.firing_series)

    def payload(self, now: Optional[float] = None) -> Dict:
        """Alert state for ``/statusz``: ``{"alerts": [one entry per
        rule], "silences": [active silences]}``."""

        now = time.time() if now is None else now
        with self._lock:
            alerts = list(self._alerts.values())
            silences = [{"pattern": s.pattern,
                         "expires_in_s": round(s.until - now, 1)}
                        for s in self._silences if now < s.until]
        out = []
        for a in alerts:
            since = a.firing_since if a.state == FIRING else a.pending_since
            out.append({
                "rule": a.rule.name, "state": a.state,
                "severity": a.rule.severity,
                "since_s": (round(now - since, 1)
                            if since is not None else None),
                "transitions_total": a.transitions_total,
                "info": a.last_info,
            })
        return {"alerts": sorted(out, key=lambda d: d["rule"]),
                "silences": silences}
