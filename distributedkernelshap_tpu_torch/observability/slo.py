"""Declarative SLOs evaluated as multi-window multi-burn-rate conditions
over the time-series store.

The paper's whole claim is a latency/throughput number, and the serving
stack's scheduler already *admits* by declared SLO (priority class +
deadline, ``scheduling/``) — but nothing could say "the interactive SLO
is burning" after the fact.  This module is the interpretation layer:
an :class:`SLO` names a target ("99% of requests succeed", "90% of
interactive requests finish under 500 ms", "work in flight never stalls
longer than 30 s") and evaluates it the way Google SRE burn-rate alerts
do (SRE Workbook ch. 5): the **burn rate** over a window is

    bad_fraction(window) / (1 - target)

i.e. how many times faster than "exactly on budget" the error budget is
being spent.  A condition holds when the burn rate exceeds a factor in a
long window AND in a short window (:class:`BurnRateWindow`): the long
window proves the problem is sustained, the short window makes the alert
resolve promptly once the problem stops.  Multiple window pairs express
the page/ticket split; any breached pair marks the SLO breached.

Three SLO kinds, matching what the serving stack can measure:

* :class:`AvailabilitySLO` — two counters (total, bad); bad fraction is
  ``delta(bad)/delta(total)`` over the window.
* :class:`LatencySLO` — a histogram + threshold; bad fraction is
  ``1 - frac_le(threshold)`` over the window's bucket increments.  The
  per-priority-class server SLOs are this over
  ``dks_serve_class_latency_seconds{class=...}``.
* :class:`StalenessSLO` — a gauge + bound; bad fraction is the fraction
  of window samples above the bound (e.g. seconds since in-flight work
  last progressed).

``evaluate`` returns ``None`` burn rates when the window holds no data —
an idle server is not in breach, and an alert must not fire on silence.

Stdlib-only, no imports from the serving stack: targets reference metric
*names*, resolved against whatever store the health engine samples into.
"""

import logging
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

#: the scheduler's priority classes, restated here (importing
#: ``scheduling`` would drag numpy into the stdlib-only observability
#: package); ``tests/test_slo_alerts.py`` asserts the two stay in sync
PRIORITY_CLASSES = ("interactive", "batch", "best_effort")


class BurnRateWindow(NamedTuple):
    """One multi-window condition: burn >= ``factor`` over BOTH windows."""

    long_s: float
    short_s: float
    factor: float


#: default page condition: a 5-minute window burning 6x budget, confirmed
#: by the last 30 s (resolves within ~30 s of the problem stopping)
DEFAULT_WINDOWS = (BurnRateWindow(long_s=300.0, short_s=30.0, factor=6.0),)


class SLO:
    """Base: a named target plus its burn-rate windows.  Subclasses
    implement :meth:`bad_fraction` over the store."""

    kind = "slo"

    def __init__(self, name: str, target: float,
                 windows: Sequence[BurnRateWindow] = DEFAULT_WINDOWS,
                 description: str = ""):
        if not 0.0 < target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1), got {target}")
        self.name = name
        self.target = float(target)
        self.windows = tuple(BurnRateWindow(*w) for w in windows)
        if not self.windows:
            raise ValueError("an SLO needs at least one burn-rate window")
        self.description = description

    # -- subclass hook -------------------------------------------------- #

    def bad_fraction(self, store, window_s: float,
                     now: Optional[float] = None) -> Optional[float]:
        raise NotImplementedError

    # -- evaluation ------------------------------------------------------ #

    def burn_rate(self, store, window_s: float,
                  now: Optional[float] = None) -> Optional[float]:
        bad = self.bad_fraction(store, window_s, now=now)
        if bad is None:
            return None
        return bad / max(1e-9, 1.0 - self.target)

    def evaluate(self, store, now: Optional[float] = None) -> Dict:
        """One status dict: per-window burn rates, breached flag, budget
        remaining over the longest window (1.0 = untouched, 0.0 = spent
        exactly, negative = overspent)."""

        burn_rates: Dict[str, Optional[float]] = {}
        breached = False
        for w in self.windows:
            b_long = self.burn_rate(store, w.long_s, now=now)
            b_short = self.burn_rate(store, w.short_s, now=now)
            burn_rates[f"{w.long_s:g}s"] = b_long
            burn_rates[f"{w.short_s:g}s"] = b_short
            if (b_long is not None and b_short is not None
                    and b_long >= w.factor and b_short >= w.factor):
                breached = True
        longest = max(w.long_s for w in self.windows)
        bad = self.bad_fraction(store, longest, now=now)
        budget_remaining = (None if bad is None
                            else 1.0 - bad / max(1e-9, 1.0 - self.target))
        return {"name": self.name, "kind": self.kind,
                "target": self.target,
                "description": self.description,
                "windows": [list(w) for w in self.windows],
                "burn_rates": burn_rates,
                "budget_remaining": budget_remaining,
                "breached": breached}


class AvailabilitySLO(SLO):
    """``target`` fraction of requests answered without error, from two
    cumulative counters (optionally labelled)."""

    kind = "availability"

    def __init__(self, name: str, total: str, bad: str, target: float,
                 total_labels: Optional[Dict[str, str]] = None,
                 bad_labels: Optional[Dict[str, str]] = None, **kwargs):
        super().__init__(name, target, **kwargs)
        self.total = total
        self.bad = bad
        self.total_labels = total_labels
        self.bad_labels = bad_labels

    def bad_fraction(self, store, window_s, now=None):
        total = store.delta(self.total, window_s, self.total_labels, now=now)
        if total is None or total <= 0:
            return None  # no traffic in the window: nothing burned
        bad = store.delta(self.bad, window_s, self.bad_labels, now=now) or 0.0
        return max(0.0, min(1.0, bad / total))


class LatencySLO(SLO):
    """``target`` fraction of observations at or under ``threshold_s``,
    from a histogram's windowed bucket increments."""

    kind = "latency"

    def __init__(self, name: str, histogram: str, threshold_s: float,
                 target: float, labels: Optional[Dict[str, str]] = None,
                 **kwargs):
        super().__init__(name, target, **kwargs)
        self.histogram = histogram
        self.threshold_s = float(threshold_s)
        self.labels = labels

    def bad_fraction(self, store, window_s, now=None):
        good = store.frac_le(self.histogram, self.threshold_s, window_s,
                             self.labels, now=now)
        if good is None:
            return None
        return max(0.0, min(1.0, 1.0 - good))


class ErrorBudgetSLO(LatencySLO):
    """``target`` fraction of anytime answers whose *reported* final
    error bound is at or under ``max_err`` — the accuracy analogue of a
    latency SLO, burned over the ``dks_anytime_final_err`` histogram.
    Mechanically identical to :class:`LatencySLO` (a histogram and a
    threshold); the separate kind keeps /slo output honest about what is
    being promised: answer *quality* under deadline pressure, not answer
    time."""

    kind = "error_budget"

    def __init__(self, name: str, histogram: str, max_err: float,
                 target: float, labels: Optional[Dict[str, str]] = None,
                 **kwargs):
        super().__init__(name, histogram=histogram, threshold_s=max_err,
                         target=target, labels=labels, **kwargs)

    @property
    def max_err(self) -> float:
        return self.threshold_s


class StalenessSLO(SLO):
    """``target`` fraction of window samples where a gauge stays at or
    under ``max_staleness_s`` (e.g. seconds since in-flight work last
    progressed — the watchdog's view, made continuous)."""

    kind = "staleness"

    def __init__(self, name: str, gauge: str, max_staleness_s: float,
                 target: float, labels: Optional[Dict[str, str]] = None,
                 **kwargs):
        super().__init__(name, target, **kwargs)
        self.gauge = gauge
        self.max_staleness_s = float(max_staleness_s)
        self.labels = labels

    def bad_fraction(self, store, window_s, now=None):
        return store.frac_over(self.gauge, window_s, self.max_staleness_s,
                               self.labels, now=now)


class QualitySLO(SLO):
    """``target`` fraction of audited answers passing the in-band
    invariant screen (``observability/quality.py``): burned from the
    windowed increments of ``dks_quality_violations_total`` (summed
    across its ``{model, path, check}`` labelsets — the store's delta is
    an exact-labelset lookup, so the fleet total is folded here) over
    the unlabeled ``dks_quality_audited_total``.  Burns only when
    audited traffic flows; with the auditor off this SLO is inert."""

    kind = "quality"

    def __init__(self, name: str,
                 violations: str = "dks_quality_violations_total",
                 audited: str = "dks_quality_audited_total",
                 target: float = 0.999, **kwargs):
        super().__init__(name, target, **kwargs)
        self.violations = violations
        self.audited = audited

    def bad_fraction(self, store, window_s, now=None):
        total = store.delta(self.audited, window_s, now=now)
        if total is None or total <= 0:
            return None  # nothing audited in the window: nothing burned
        bad = 0.0
        for labels in store.labelsets(self.violations):
            bad += store.delta(self.violations, window_s, labels,
                               now=now) or 0.0
        return max(0.0, min(1.0, bad / total))


# --------------------------------------------------------------------- #
# default SLO sets for the two serving components
# --------------------------------------------------------------------- #

#: per-class latency thresholds/targets for the scheduler's priority
#: classes — interactive is the paper's human-in-the-loop case, batch
#: tracks the pool benchmark envelope, best_effort only promises
#: eventual completion.  Every threshold MUST be at or below the latency
#: histogram's largest finite bucket (serving LATENCY_BUCKETS_S tops out
#: at 60 s): observations land in buckets, so a threshold beyond the
#: last bound would count every +Inf observation as a violation even
#: when it actually met the SLO.
CLASS_LATENCY_TARGETS: Dict[str, Tuple[float, float]] = {
    "interactive": (0.5, 0.90),
    "batch": (30.0, 0.90),
    "best_effort": (60.0, 0.50),
}

#: default anytime error-budget objective: 90% of anytime answers must
#: report a final error bound at or under 0.03 — aligned with a finite
#: ``dks_anytime_final_err`` bucket bound (3e-2) for the same reason the
#: latency thresholds align with LATENCY_BUCKETS_S: observations land in
#: buckets, and a threshold between bounds would miscount the straddling
#: bucket.  Burns only when anytime traffic flows (idle = None = no
#: breach), so non-anytime deployments carry this SLO inert.
ANYTIME_ERR_TARGET: Tuple[float, float] = (0.03, 0.90)

#: default answer-quality objective: 99.9% of audited answers must pass
#: the invariant screen.  The screen's tolerances are path-calibrated
#: (``quality.PATH_TOLERANCES``), so a healthy fleet sits at zero
#: violations — any sustained burn here is a real correctness incident
#: (device fault, engine regression, bad swap), not estimator variance.
QUALITY_TARGET: float = 0.999

#: default per-tenant objectives (the templated SLOs of
#: :func:`tenant_slos`): latency over ``dks_tenant_latency_seconds`` —
#: threshold must stay at or below that histogram's largest finite
#: bucket, same contract as CLASS_LATENCY_TARGETS — and availability
#: over the tenant request/error counter pair
TENANT_LATENCY_TARGET: Tuple[float, float] = (0.5, 0.90)
TENANT_AVAILABILITY_TARGET: float = 0.99

#: bounded-cardinality guard on SLO templating: each tenant adds two
#: SLOs (and two derived burn-rate rules + four dks_slo_* gauge series),
#: all re-evaluated per health tick — a tenant flood must not turn the
#: sampler tick into an O(tenants x windows) ring scan storm.  Tenants
#: past the cap get no per-tenant SLO (logged once per refresh); the
#: fleet-level class SLOs still cover their traffic.
MAX_TENANT_SLOS = 32


def tenant_slos(tenants: Sequence,
                windows: Sequence[BurnRateWindow] = DEFAULT_WINDOWS,
                latency_target: Tuple[float, float] = TENANT_LATENCY_TARGET,
                availability_target: float = TENANT_AVAILABILITY_TARGET,
                max_tenants: int = MAX_TENANT_SLOS) -> List[SLO]:
    """Template per-tenant latency + availability objectives over the
    cost meter's tenant families.  ``tenants`` holds model ids (or
    ``(model_id, version)`` pairs — the version only names the SLO; the
    underlying series are per-model, so a hot-swap keeps burning against
    one history).  Bounded by ``max_tenants`` (see MAX_TENANT_SLOS)."""

    slos: List[SLO] = []
    seen = set()
    for entry in tenants:
        if isinstance(entry, (tuple, list)):
            model_id, version = entry[0], entry[1]
            label = f"{model_id}@v{version}"
        else:
            model_id, label = str(entry), str(entry)
        if model_id in seen:
            continue
        seen.add(model_id)
        if len(slos) // 2 >= max_tenants:
            logger.warning(
                "tenant SLO cap (%d) reached; %r (and later tenants) get "
                "no per-tenant SLO — fleet-level class SLOs still apply",
                max_tenants, model_id)
            break
        threshold_s, target = latency_target
        slos.append(LatencySLO(
            f"tenant:{model_id}_latency",
            histogram="dks_tenant_latency_seconds",
            labels={"model": model_id}, threshold_s=threshold_s,
            target=target, windows=windows,
            description=f"tenant {label} requests finishing within "
                        f"{threshold_s:g}s"))
        slos.append(AvailabilitySLO(
            f"tenant:{model_id}_availability",
            total="dks_tenant_requests_total",
            bad="dks_tenant_errors_total",
            total_labels={"model": model_id},
            bad_labels={"model": model_id},
            target=availability_target, windows=windows,
            description=f"tenant {label} answered requests that are "
                        f"not errors"))
    return slos


def default_server_slos(
        windows: Sequence[BurnRateWindow] = DEFAULT_WINDOWS,
        tenants: Sequence = ()) -> List[SLO]:
    """The server's standard SLO set: availability, one latency SLO per
    priority class (over ``dks_serve_class_latency_seconds``), an
    in-flight staleness SLO feeding off the watchdog's progress gauge,
    and — multi-tenant gateways — per-tenant latency/availability
    objectives templated for every id in ``tenants`` (bounded; see
    :func:`tenant_slos`).  The server refreshes the tenant portion on
    registry hot-swap/removal so stale tenants stop being evaluated."""

    slos: List[SLO] = [
        AvailabilitySLO(
            "availability", total="dks_serve_requests_total",
            bad="dks_serve_errors_total", target=0.99, windows=windows,
            description="answered requests that are not errors"),
    ]
    for klass in PRIORITY_CLASSES:
        threshold_s, target = CLASS_LATENCY_TARGETS[klass]
        slos.append(LatencySLO(
            f"{klass}_latency",
            histogram="dks_serve_class_latency_seconds",
            labels={"class": klass}, threshold_s=threshold_s, target=target,
            windows=windows,
            description=f"{klass} requests finishing within "
                        f"{threshold_s:g}s"))
    slos.append(StalenessSLO(
        "inflight_progress", gauge="dks_serve_last_progress_age_seconds",
        max_staleness_s=30.0, target=0.90, windows=windows,
        description="dispatched work progressing within 30s"))
    max_err, target = ANYTIME_ERR_TARGET
    slos.append(ErrorBudgetSLO(
        "anytime_error", histogram="dks_anytime_final_err",
        max_err=max_err, target=target, windows=windows,
        description=f"anytime answers with a final reported error bound "
                    f"at or under {max_err:g}"))
    slos.append(QualitySLO(
        "answer_quality", target=QUALITY_TARGET, windows=windows,
        description="audited answers passing the invariant screen "
                    "(additivity, finiteness, error-bound sanity)"))
    if tenants:
        slos.extend(tenant_slos(tenants, windows=windows))
    return slos


def default_proxy_slos(
        windows: Sequence[BurnRateWindow] = DEFAULT_WINDOWS) -> List[SLO]:
    """The fan-in proxy's standard SLO set: forwarded-request
    availability (replica mid-request failures are the bad events)."""

    return [
        AvailabilitySLO(
            "proxy_availability", total="dks_fanin_forwarded_total",
            bad="dks_fanin_replica_errors_total", target=0.99,
            windows=windows,
            description="forwarded requests not lost to replica failures"),
    ]
