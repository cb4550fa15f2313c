"""Elastic SLO-driven fleet autoscaling: burn-rate + queue-signal scaler
with predictive pre-warm and drain-based scale-down.

PRs 5-7 made one replica fast; the fleet itself was still a fixed-size
``ReplicaManager`` — under diurnal traffic a static fleet either
overprovisions replica-seconds all day or blows the interactive p99 SLO
at peak.  This module closes ROADMAP open item 1: a control loop that
sizes the replica fleet from the live signals the stack already
computes, the way Podracer scales actors and learners independently
(PAPERS.md, arXiv 2104.06272):

* **SLO burn rate** — the fan-in proxy's :class:`~distributedkernelshap_
  tpu.observability.statusz.HealthEngine` evaluates multi-window
  burn-rate conditions every tick (``observability/slo.py``); any
  breached SLO is the strongest scale-up signal (the budget is actively
  burning — capacity is late, not early).
* **Queue pressure** — each ready replica's ``/statusz?format=json``
  reports its per-class queue depths and its admission estimator's
  EDF-aware projected wait (``scheduling/admission.py`` /
  ``SLOScheduler.rows_ahead``); the scaler aggregates a fleet-level
  projected wait from total queued rows over a fleet-capacity EWMA
  (:class:`~distributedkernelshap_tpu_torch.scheduling.admission.
  ServiceRateEstimator` with :meth:`capacity_hint` rescaling it the
  moment fleet size changes, so the projection neither lags a scale-up
  nor a drain).
* **Rate trend (predictive pre-warm)** — the proxy health engine's
  time-series store answers ``rate(dks_fanin_forwarded_total)`` over a
  short and a long window; traffic ramping (short ≫ long) triggers a
  scale-up BEFORE queues build, so the new replica's warmup ladder
  (PR 5, ``DKS_WARMUP``) finishes as the load arrives instead of after.

**Scale-up is routable in seconds**: a spawned worker pre-warms through
the existing warmup ladder in the ``warming`` state (non-routable — the
proxy's prober admits it the moment ``/healthz`` flips 200; and
non-restartable — the supervisor keys restarts on process exit, and a
warming process is alive).  A configurable **warm-standby pool** keeps
fully-warmed spares out of rotation; activating one
(:meth:`~distributedkernelshap_tpu_torch.serving.replicas.FanInProxy.
activate_standby`) is instant, and the pool is replenished in the
background.

**Scale-down drains**: the victim is marked unroutable at the proxy
(``start_drain`` — in-flight and queued work keeps answering through
the replica's own scheduler), the scaler polls its ``/statusz`` until
queues and in-flight batches are empty for consecutive polls, then
retires it through the supervisor (``ReplicaSupervisor.retire`` — the
exit is on purpose, never restarted).  Stragglers hitting the final
``server.stop()`` get the wedge/claim path's retriable pre-dispatch 503
and fail over — zero lost, zero duplicated answers (asserted by
``benchmarks/autoscale_bench.py --check``).

The scaler never flaps: scale-up needs ``up_ticks`` consecutive signal
ticks and respects ``up_cooldown_s``; scale-down needs ``down_ticks``
and ``down_cooldown_s`` and is held while anything is warming or
draining; both respect ``min_replicas``/``max_replicas``.  A wedged or
killed scaler (chaos site ``scaler.tick``) degrades to the CURRENT
fleet size — the loop only ever acts, never holds the fleet hostage.

``autoscale=off`` is the default: a ``ReplicaManager`` without an
:class:`AutoscalerConfig` serves its fixed ``n_replicas`` exactly as
before.
"""

import concurrent.futures
import http.client
import json
import logging
import threading
import time
from typing import Dict, List, Optional

from distributedkernelshap_tpu_torch.analysis import lockwitness
from distributedkernelshap_tpu_torch.observability.flightrec import flightrec
from distributedkernelshap_tpu_torch.scheduling.admission import (
    ServiceRateEstimator,
)

logger = logging.getLogger(__name__)


class _ScalerCrashed(Exception):
    """Injected thread-scoped crash (chaos site ``scaler.tick``)."""


class AutoscalerConfig:
    """Knobs for one :class:`Autoscaler` (defaults are production-shaped;
    the benchmark tightens the timing knobs to fit a replay).

    Parameters
    ----------
    min_replicas, max_replicas
        Hard bounds on serving-intent replicas (ready + warming;
        standbys are extra).  The scaler never drains below ``min`` and
        never spawns above ``max`` — a crashed replica awaiting its
        supervisor respawn ("down") counts against ``max`` too, so the
        scaler can't spawn a replacement the restart then overshoots.
    warm_standby
        Fully-warmed spares held out of rotation.  Scale-up activates a
        standby instantly (no spawn+warm on the critical path) and
        replenishes the pool in the background.
    interval_s
        Control-loop tick period.
    up_ticks, down_ticks
        Hysteresis: consecutive signal ticks required before acting.
        Down is deliberately much slower than up — adding late burns the
        SLO, removing late only burns replica-seconds.
    up_cooldown_s, down_cooldown_s
        Minimum spacing between same-direction scale actions.
    queue_wait_up_s
        Fleet projected wait (total queued rows / fleet-capacity EWMA)
        above which capacity is late; should sit comfortably under the
        interactive latency SLO threshold.
    replica_wait_up_s
        Per-replica EDF-aware projected interactive wait (replica
        ``/statusz`` ``projected_wait_s``) above which that replica is
        drowning even if the fleet average looks fine.
    trend_factor, trend_window_short_s, trend_window_long_s
        Predictive pre-warm: scale up when the short-window forwarded
        REQUEST rate exceeds ``trend_factor`` x the long-window rate
        (the ratio is unitless, so request counts are fine there) AND
        the served-rows demand is at least ``trend_min_utilization`` of
        fleet rows/s capacity (a ramp from nothing to nearly-nothing
        must not spawn).  Utilization is rows over rows — demand comes
        from differentiating the replicas' ``rows_served_total``, never
        from the request rate, because requests carry arbitrary row
        counts.
    down_utilization
        Scale down when observed rows/s demand could be served by one
        FEWER replica at or below this utilization (and no queue
        pressure, no
        breach) for ``down_ticks`` ticks.
    drain_timeout_s
        Upper bound on a drain; past it the victim is retired anyway
        (its own ``server.stop()`` answers stragglers with retriable
        503s — the proxy fails them over).
    drain_settle_polls
        Consecutive empty (no queued, no in-flight) ``/statusz`` polls
        required before a draining victim is retired — absorbs the
        pick-to-enqueue race on requests routed just before the drain
        flag flipped.
    statusz_timeout_s
        Per-replica ``/statusz`` poll budget; an unreachable replica
        simply contributes no signal that tick.
    """

    def __init__(self,
                 min_replicas: int = 1,
                 max_replicas: int = 4,
                 warm_standby: int = 0,
                 interval_s: float = 1.0,
                 up_ticks: int = 2,
                 down_ticks: int = 10,
                 up_cooldown_s: float = 5.0,
                 down_cooldown_s: float = 30.0,
                 queue_wait_up_s: float = 0.35,
                 replica_wait_up_s: float = 0.35,
                 trend_factor: float = 1.5,
                 trend_window_short_s: float = 5.0,
                 trend_window_long_s: float = 30.0,
                 trend_min_utilization: float = 0.5,
                 down_utilization: float = 0.6,
                 drain_timeout_s: float = 60.0,
                 drain_settle_polls: int = 2,
                 statusz_timeout_s: float = 2.0):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if warm_standby < 0:
            raise ValueError("warm_standby must be >= 0")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.warm_standby = int(warm_standby)
        self.interval_s = float(interval_s)
        self.up_ticks = max(1, int(up_ticks))
        self.down_ticks = max(1, int(down_ticks))
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.queue_wait_up_s = float(queue_wait_up_s)
        self.replica_wait_up_s = float(replica_wait_up_s)
        self.trend_factor = float(trend_factor)
        self.trend_window_short_s = float(trend_window_short_s)
        self.trend_window_long_s = float(trend_window_long_s)
        self.trend_min_utilization = float(trend_min_utilization)
        self.down_utilization = float(down_utilization)
        self.drain_timeout_s = float(drain_timeout_s)
        self.drain_settle_polls = max(1, int(drain_settle_polls))
        self.statusz_timeout_s = float(statusz_timeout_s)

    def to_dict(self) -> Dict:
        return dict(vars(self))


class Autoscaler:
    """The control loop (see module doc).

    Parameters
    ----------
    fleet
        Anything exposing the elastic hooks ``spawn_replica(standby=...)
        -> Optional[int]`` and ``retire_replica(index)`` —
        :class:`~distributedkernelshap_tpu_torch.serving.replicas.
        ReplicaManager` for a subprocess fleet, or the benchmark's
        in-process fleet.  May be ``None`` for metrics-only registration
        (``scripts/obs_check.py``).
    proxy
        The :class:`~distributedkernelshap_tpu_torch.serving.replicas.
        FanInProxy` whose rotation is being sized.  Supplies replica
        states, the health engine (SLO statuses + time-series store) and
        the metrics registry the ``dks_autoscale_*`` series register on.
    config
        :class:`AutoscalerConfig`; ``None`` uses defaults.
    fault_injector
        Chaos hook, consulted at site ``scaler.tick`` with THREAD-scoped
        crash semantics (``resilience/faults.py``) — a crashed or wedged
        scaler kills only this loop; the fleet keeps serving at its
        current size.
    """

    def __init__(self, fleet, proxy, config: Optional[AutoscalerConfig] = None,
                 fault_injector=None):
        self.fleet = fleet
        self.proxy = proxy
        self.config = config or AutoscalerConfig()
        # pod-as-replica: with a pod fleet (ReplicaManager
        # pod_processes > 1) every scale event spawns/retires a WHOLE pod
        # and every provisioned second costs P process-seconds — the
        # replica-seconds meter scales by this so chargeback matches what
        # the cluster actually runs
        self.unit_processes = max(1, int(getattr(fleet, "pod_processes",
                                                 1) or 1))
        self._faults = fault_injector
        self._flight = flightrec()
        # fleet-capacity EWMA in rows/s, capacity-hinted on every scale
        # event so projections track the NEW size immediately
        self.estimator = ServiceRateEstimator(alpha=0.3)
        self._hinted_ready: Optional[int] = None
        # hysteresis counters + cooldown stamps
        self._up_streak = 0
        self._down_streak = 0
        self._last_up_t: Optional[float] = None
        self._last_down_t: Optional[float] = None
        # draining victims: index -> bookkeeping (mutated by the scaler
        # thread under self._lock — statusz_panel iterates it from proxy
        # handler threads)
        self._draining: Dict[int, Dict] = {}
        # served-rows demand: previous per-replica rows_served_total
        # snapshot, differentiated each tick into rows/s
        self._rows_prev: Optional[Dict[int, float]] = None
        self._rows_prev_t: float = 0.0
        # replica-seconds accrue over real elapsed time (a tick blocked
        # on statusz timeouts must still integrate correctly)
        self._accrual_t: Optional[float] = None
        #: spawn timestamps by replica index (monotonic) — the bench's
        #: spawn-to-first-answer criterion reads these
        self.spawn_times: Dict[int, float] = {}
        self._last_decision: Dict = {"action": "none", "reason": "startup",
                                     "t": time.monotonic()}
        self._last_signals: Dict = {}
        self.ticks_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = lockwitness.make_lock("autoscaler.state")
        # replica /statusz polls run concurrently: a tick must not stall
        # statusz_timeout_s x N sequentially exactly when the fleet is
        # overloaded and the scale-up is most urgent
        self._poll_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="dks-autoscale-poll")
        self._attach_metrics(proxy.metrics)
        proxy.attach_autoscaler(self)

    # -- observability -------------------------------------------------- #

    def _attach_metrics(self, registry) -> None:
        self._m_replicas = registry.gauge(
            "dks_autoscale_replicas",
            "Fleet composition by replica lifecycle state.",
            labelnames=("state",))
        self._m_replicas.set_function(
            lambda: {(state,): count for state, count
                     in self.proxy.replica_state_counts().items()})
        registry.gauge(
            "dks_autoscale_target_replicas",
            "Serving-intent replicas (ready + warming) the scaler is "
            "currently steering toward.").set_function(
            lambda: self._serving_intent())
        self._m_decisions = registry.counter(
            "dks_autoscale_decisions_total",
            "Scaler decisions by action and reason (hold rows count "
            "signals suppressed by cooldowns or bounds, not idle ticks).",
            labelnames=("action", "reason")).seed(
            ("scale_up", "burn_rate"), ("scale_up", "queue_wait"),
            ("scale_up", "rate_trend"), ("scale_up", "standby_replenish"),
            ("scale_down", "idle"),
            ("hold", "cooldown"), ("hold", "max_replicas"),
            ("hold", "min_replicas"))
        self._m_ticks = registry.counter(
            "dks_autoscale_ticks_total", "Scaler evaluation ticks.")
        self._m_replica_seconds = registry.counter(
            "dks_autoscale_replica_seconds_total",
            "Replica-seconds accumulated by lifecycle state (the "
            "provisioning cost the autoscaler exists to minimise); pod "
            "fleets accrue in PROCESS units — each pod-second costs its "
            "process count.",
            labelnames=("state",)).seed(
            ("ready",), ("warming",), ("draining",), ("standby",))

    def statusz_panel(self) -> Dict:
        """The ``/statusz`` autoscaler block (rendered by the proxy's
        component-detail table)."""

        now = time.monotonic()
        cfg = self.config
        # every scaler-thread-mutated signal (streaks, cooldown stamps,
        # tick count, draining book) reads under the SAME lock the tick
        # path writes under (DKS-C001/DKS-C002) — the panel must never
        # render a torn decision state
        with self._lock:
            last = dict(self._last_decision)
            signals = dict(self._last_signals)
            draining = {i: round(now - d["since"], 1)
                        for i, d in self._draining.items()}
            up_streak, down_streak = self._up_streak, self._down_streak
            last_up_t, last_down_t = self._last_up_t, self._last_down_t
            ticks_total = self.ticks_total
        up_cd = (max(0.0, cfg.up_cooldown_s - (now - last_up_t))
                 if last_up_t is not None else 0.0)
        down_cd = (max(0.0, cfg.down_cooldown_s - (now - last_down_t))
                   if last_down_t is not None else 0.0)
        return {
            "bounds": [cfg.min_replicas, cfg.max_replicas],
            "warm_standby": cfg.warm_standby,
            "states": self.proxy.replica_state_counts(),
            "serving_intent": self._serving_intent(),
            "last_decision": {"action": last["action"],
                              "reason": last["reason"],
                              "age_s": round(now - last["t"], 1)},
            "signals": signals,
            "up_streak": up_streak,
            "down_streak": down_streak,
            "cooldown_up_remaining_s": round(up_cd, 1),
            "cooldown_down_remaining_s": round(down_cd, 1),
            "draining_age_s": draining,
            "ticks_total": ticks_total,
            "alive": self._thread is not None and self._thread.is_alive(),
        }

    # -- signal gathering ----------------------------------------------- #

    def _serving_intent(self) -> int:
        counts = self.proxy.replica_state_counts()
        return counts.get("ready", 0) + counts.get("warming", 0)

    def _replica_detail(self, replica) -> Optional[Dict]:
        """One replica's ``/statusz?format=json`` ``detail`` block (queue
        depths, projected waits, in-flight) — ``None`` when unreachable
        or unparsable (no signal beats a wrong signal)."""

        conn = http.client.HTTPConnection(
            replica.host, replica.port,
            timeout=self.config.statusz_timeout_s)
        try:
            conn.request("GET", "/statusz?format=json")
            body = conn.getresponse().read()
            return json.loads(body).get("detail")
        except (OSError, http.client.HTTPException, ValueError):
            return None
        finally:
            conn.close()

    def capacity_hint(self, units: float) -> None:
        """Rescale the fleet-capacity EWMA for a known capacity change
        (``ReplicaManager`` calls this with the starting fleet size; the
        scaler itself calls it on every completed scale event)."""

        self.estimator.capacity_hint(units)
        self._hinted_ready = int(units)

    def _gather(self) -> Dict:
        """One tick's signal snapshot."""

        cfg = self.config
        store = self.proxy.health.store
        now_wall = time.time()
        rate_short = store.rate("dks_fanin_forwarded_total",
                                cfg.trend_window_short_s, now=now_wall)
        rate_long = store.rate("dks_fanin_forwarded_total",
                               cfg.trend_window_long_s, now=now_wall)
        breached = [s["name"] for s in self.proxy.health.slo_statuses()
                    if s["breached"]]
        ready = [r for r in self.proxy.replicas if r.state() == "ready"]
        queued_rows = 0
        per_replica_rates: List[float] = []
        max_replica_wait = 0.0
        rows_seen: Dict[int, float] = {}
        details = (list(self._poll_pool.map(self._replica_detail, ready))
                   if ready else [])
        for r, detail in zip(ready, details):
            if detail is None:
                continue
            queued_rows += sum((detail.get("queue_depths") or {}).values())
            rate = detail.get("service_rate_rows_per_s")
            if rate:
                per_replica_rates.append(float(rate))
            rows_total = detail.get("rows_served_total")
            if rows_total is not None:
                rows_seen[r.index] = float(rows_total)
            waits = detail.get("projected_wait_s") or {}
            wait = waits.get("interactive")
            if wait is not None:
                max_replica_wait = max(max_replica_wait, float(wait))
        # fleet-capacity EWMA: mean per-replica device rate x ready count,
        # folded in as one observation per tick.  The hint reconciliation
        # runs FIRST — rescaling after the observe would re-multiply a
        # sample that was already taken at the new fleet size
        n_ready = len(ready)
        if per_replica_rates and n_ready:
            if self._hinted_ready is None or n_ready != self._hinted_ready:
                # ready count moved — a warmed scale-up turned routable,
                # a drain landed, or something outside the scaler (a
                # crash, a supervisor restart): rescale the projection
                # the moment real capacity changed
                self.capacity_hint(n_ready)
            cap = (sum(per_replica_rates) / len(per_replica_rates)) * n_ready
            self.estimator.observe(max(1, int(cap)), 1.0)
        # served-rows DEMAND (rows/s): differentiate the replicas'
        # cumulative rows_served_total between ticks, summed over the
        # replicas present in both snapshots (membership-safe across
        # scale events).  Unit-compatible with the rows/s capacity EWMA —
        # the forwarded REQUEST rate is not, requests carry arbitrary
        # row counts
        now_mono = time.monotonic()
        demand = None
        if self._rows_prev is not None:
            dt = now_mono - self._rows_prev_t
            common = [i for i in rows_seen if i in self._rows_prev]
            if dt > 0 and common:
                delta = sum(max(0.0, rows_seen[i] - self._rows_prev[i])
                            for i in common)
                demand = delta / dt
        self._rows_prev, self._rows_prev_t = rows_seen, now_mono
        fleet_rate = self.estimator.rows_per_s()
        fleet_wait = (queued_rows / fleet_rate
                      if fleet_rate and queued_rows else 0.0)
        utilization = (demand / fleet_rate
                       if fleet_rate and demand is not None else None)
        return {
            "ready": n_ready,
            "breached_slos": breached,
            "queued_rows": int(queued_rows),
            "fleet_rate_rows_per_s": (round(fleet_rate, 2)
                                      if fleet_rate else None),
            "fleet_projected_wait_s": round(fleet_wait, 3),
            "max_replica_interactive_wait_s": round(max_replica_wait, 3),
            "demand_rows_per_s": (round(demand, 2)
                                  if demand is not None else None),
            "rate_short_rps": (round(rate_short, 2)
                               if rate_short is not None else None),
            "rate_long_rps": (round(rate_long, 2)
                              if rate_long is not None else None),
            "utilization": (round(utilization, 3)
                            if utilization is not None else None),
        }

    # -- decisions ------------------------------------------------------ #

    def _up_reason(self, sig: Dict) -> Optional[str]:
        cfg = self.config
        if sig["breached_slos"]:
            return "burn_rate"
        if (sig["fleet_projected_wait_s"] > cfg.queue_wait_up_s
                or sig["max_replica_interactive_wait_s"]
                > cfg.replica_wait_up_s):
            return "queue_wait"
        short, long_ = sig["rate_short_rps"], sig["rate_long_rps"]
        util = sig["utilization"]
        if (short is not None and long_ is not None and long_ > 0
                and util is not None
                and short >= cfg.trend_factor * long_
                and util >= cfg.trend_min_utilization):
            return "rate_trend"
        return None

    def _down_ok(self, sig: Dict) -> bool:
        cfg = self.config
        if sig["breached_slos"] or sig["queued_rows"] > 0:
            return False
        if sig["ready"] <= cfg.min_replicas:
            return False
        demand, fleet = sig["demand_rows_per_s"], sig["fleet_rate_rows_per_s"]
        if demand is None or not fleet or sig["ready"] < 1:
            return False
        # would one fewer replica serve the current rows/s demand at or
        # under the target utilization?  (fleet rate is for the CURRENT
        # size; demand is served rows, same units)
        reduced_capacity = fleet * (sig["ready"] - 1) / sig["ready"]
        return reduced_capacity > 0 and \
            demand <= cfg.down_utilization * reduced_capacity

    def _scale_up(self, reason: str, now: float) -> None:
        cfg = self.config
        counts = self.proxy.replica_state_counts()
        # the bound counts "down" too: a crashed replica is about to be
        # respawned by the supervisor, so spawning a replacement on top
        # would overshoot max_replicas the moment the prober readmits it
        committed = (counts.get("ready", 0) + counts.get("warming", 0)
                     + counts.get("down", 0))
        if committed >= cfg.max_replicas:
            self._m_decisions.inc(action="hold", reason="max_replicas")
            return
        # a warm standby is the fast path: activation is instant, and a
        # replacement standby warms in the background
        standby_idx = next(
            (r.index for r in self.proxy.replicas
             if r.standby and r.warm_ready and not r.retired), None)
        if standby_idx is not None:
            routable = self.proxy.activate_standby(standby_idx)
            logger.info("autoscale: activated standby replica %d (%s)%s",
                        standby_idx, reason,
                        "" if routable else " — prober will admit")
            self._flight.record("scale_up", reason=reason,
                                replica=standby_idx, standby_activated=True)
            self._m_decisions.inc(action="scale_up", reason=reason)
            self._replenish_standby()
        else:
            index = self.fleet.spawn_replica(standby=False)
            if index is None:
                return
            self.spawn_times[index] = time.monotonic()
            logger.info("autoscale: spawned replica %d (%s); pre-warming "
                        "through the DKS_WARMUP ladder", index, reason)
            self._flight.record("scale_up", reason=reason, replica=index,
                                standby_activated=False)
            self._m_decisions.inc(action="scale_up", reason=reason)
        with self._lock:
            self._last_up_t = now
            self._up_streak = 0
            self._last_decision = {"action": "scale_up", "reason": reason,
                                   "t": now}
        if standby_idx is not None:
            # an activated standby serves NOW — rescale the projection.
            # A spawned worker is only warming: it earns its hint when
            # the ready count actually moves (_gather reconciles), never
            # before it can serve a row
            counts = self.proxy.replica_state_counts()
            self.capacity_hint(max(1, counts.get("ready", 0)))

    def _replenish_standby(self) -> None:
        cfg = self.config
        counts = self.proxy.replica_state_counts()
        standbys = counts.get("standby", 0)
        total_live = (self._serving_intent() + standbys
                      + counts.get("down", 0))
        if standbys >= cfg.warm_standby or \
                total_live >= cfg.max_replicas + cfg.warm_standby:
            return
        index = self.fleet.spawn_replica(standby=True)
        if index is not None:
            self.spawn_times[index] = time.monotonic()
            self._m_decisions.inc(action="scale_up",
                                  reason="standby_replenish")
            self._flight.record("scale_up", reason="standby_replenish",
                                replica=index, standby_activated=False)

    def _scale_down(self, now: float) -> None:
        cfg = self.config
        ready = [r for r in self.proxy.replicas if r.state() == "ready"]
        if len(ready) <= cfg.min_replicas:
            self._m_decisions.inc(action="hold", reason="min_replicas")
            return
        # LIFO victim: the most recently added replica drains first, so
        # long-lived replicas keep their warm caches
        victim = max(ready, key=lambda r: r.index)
        self.proxy.start_drain(victim.index)
        with self._lock:
            self._draining[victim.index] = {"since": now, "idle_polls": 0}
        logger.info("autoscale: draining replica %d (idle scale-down)",
                    victim.index)
        self._flight.record("scale_down", reason="idle",
                            replica=victim.index)
        self._m_decisions.inc(action="scale_down", reason="idle")
        with self._lock:
            self._last_down_t = now
            self._down_streak = 0
            self._last_decision = {"action": "scale_down", "reason": "idle",
                                   "t": now}
        # the victim stopped taking NEW work the moment start_drain
        # flipped it to "draining" — the ready count already excludes it
        counts = self.proxy.replica_state_counts()
        self.capacity_hint(max(1, counts.get("ready", 0)))

    def _poll_draining(self, now: float) -> None:
        """Advance every in-progress drain: retire a victim once its
        queues AND in-flight batches have been empty for
        ``drain_settle_polls`` consecutive polls (or the drain timed
        out — its own ``server.stop()`` then answers stragglers with the
        retriable pre-dispatch 503)."""

        cfg = self.config
        # snapshot under the lock: statusz handlers iterate _draining
        # concurrently (DKS-C002); book dicts stay scaler-thread-private
        with self._lock:
            pending = list(self._draining.items())
        for index, book in pending:
            replica = self.proxy.replicas[index]
            forced = now - book["since"] > cfg.drain_timeout_s
            if not forced:
                detail = self._replica_detail(replica)
                if detail is None:
                    # unreachable THIS poll: one transient statusz
                    # timeout on a busy victim must not cut its queued
                    # work short — only a replica that stays dark for
                    # consecutive polls (crashed mid-drain) is forced;
                    # drain_timeout_s backstops everything else
                    book["misses"] = book.get("misses", 0) + 1
                    book["idle_polls"] = 0
                    if book["misses"] < 3:
                        continue
                    forced = True
                else:
                    book["misses"] = 0
                    queued = sum((detail.get("queue_depths") or {}).values())
                    inflight = detail.get("in_flight_batches", 0)
                    book["idle_polls"] = (book["idle_polls"] + 1
                                          if queued == 0 and inflight == 0
                                          else 0)
                    if book["idle_polls"] < cfg.drain_settle_polls:
                        continue
            drain_s = now - book["since"]
            with self._lock:
                del self._draining[index]
            try:
                self.fleet.retire_replica(index)
            except Exception:
                logger.exception("autoscale: retiring replica %d failed",
                                 index)
                self.proxy.finish_drain(index)
            logger.info("autoscale: replica %d drained and retired in "
                        "%.1fs%s", index, drain_s,
                        " (forced by timeout)" if forced else "")
            self._flight.record("drain_complete", replica=index,
                                drain_s=round(drain_s, 2),
                                forced=bool(forced))

    # -- the loop ------------------------------------------------------- #

    def tick(self) -> Dict:
        """One deterministic control step (the thread calls this every
        ``interval_s``; tests call it directly).  Returns the signal
        snapshot it acted on."""

        if self._faults is not None:
            action = self._faults.fire("scaler.tick", crash_scope="thread")
            if action == "crash":
                # thread-scoped: the scaler dies, the fleet serves on at
                # its current size (the chaos invariant)
                raise _ScalerCrashed("injected crash at scaler.tick")
        now = time.monotonic()
        cfg = self.config
        with self._lock:
            self.ticks_total += 1
        self._m_ticks.inc()
        # replica-seconds accrue by state every tick, over the REAL time
        # since the last accrual — a tick stalled on statusz timeouts
        # still integrates the full elapsed provisioning cost
        accrue_s = (now - self._accrual_t if self._accrual_t is not None
                    else cfg.interval_s)
        self._accrual_t = now
        for state, count in self.proxy.replica_state_counts().items():
            if count and state in ("ready", "warming", "draining",
                                   "standby"):
                self._m_replica_seconds.inc(
                    count * accrue_s * self.unit_processes, state=state)
        self._poll_draining(now)
        sig = self._gather()
        with self._lock:
            self._last_signals = sig
        up_reason = self._up_reason(sig)
        if up_reason is not None:
            # streaks and cooldown stamps are panel-visible: mutate and
            # read under the lock (DKS-C001), act after release —
            # _scale_up re-acquires it for its own decision write
            with self._lock:
                self._up_streak += 1
                self._down_streak = 0
                fire = self._up_streak >= cfg.up_ticks
                cooling = (self._last_up_t is not None
                           and now - self._last_up_t < cfg.up_cooldown_s)
            if fire:
                if cooling:
                    self._m_decisions.inc(action="hold", reason="cooldown")
                else:
                    self._scale_up(up_reason, now)
            return sig
        with self._lock:
            self._up_streak = 0
        # down only from a fully settled fleet: anything warming or
        # draining means the last action has not landed yet
        counts = self.proxy.replica_state_counts()
        settled = not counts.get("warming") and not self._draining
        if settled and self._down_ok(sig):
            with self._lock:
                self._down_streak += 1
                fire = self._down_streak >= cfg.down_ticks
                cooling = (self._last_down_t is not None and
                           now - self._last_down_t < cfg.down_cooldown_s)
            if fire:
                if cooling:
                    self._m_decisions.inc(action="hold", reason="cooldown")
                else:
                    self._scale_down(now)
        else:
            with self._lock:
                self._down_streak = 0
        # keep the standby pool full even in steady state (covers the
        # initial fill when start() raced replica startup)
        if counts.get("standby", 0) < cfg.warm_standby and settled:
            self._replenish_standby()
        return sig

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except _ScalerCrashed:
                logger.error("autoscaler crashed (injected); fleet stays "
                             "at its current size")
                return
            except Exception:
                # one bad tick (a torn statusz, a race on a dying
                # replica) must not kill elasticity for the process
                logger.exception("autoscaler tick failed")

    def start(self) -> "Autoscaler":
        # fill the warm-standby pool up front so the first peak activates
        # instead of spawning
        for _ in range(self.config.warm_standby):
            self._replenish_standby()
        self._thread = threading.Thread(target=self._loop,
                                        name="dks-autoscaler", daemon=True)
        self._thread.start()
        logger.info("autoscaler started: bounds [%d, %d], %d warm standby",
                    self.config.min_replicas, self.config.max_replicas,
                    self.config.warm_standby)
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._poll_pool.shutdown(wait=False)
