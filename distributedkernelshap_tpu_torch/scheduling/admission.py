"""Admission control and backpressure for the explanation server.

Under overload the round-4 server accepted everything: every request
queued, every request eventually timed out, and clients learned about the
overload only after burning their full timeout budget.  Production
accelerator-serving stacks shed load *early* instead — a rejected request
costs microseconds and carries a ``Retry-After`` hint, so well-behaved
clients back off and the work that IS admitted finishes inside its SLO.

Three independent gates, all cheap and all host-side (never a device op):

1. **Bounded per-class queues** — each priority class has a depth bound;
   a full class rejects without touching the others (a runaway batch
   client cannot wedge interactive traffic).
2. **Per-client token buckets** — rate limiting keyed by the client key
   (``X-DKS-Client`` header, else peer address), refilled continuously.
3. **Projected-wait shedding** — an EWMA of the device's observed
   rows/second projects how long the queue ahead will take; a request
   whose *own* declared deadline would already be missed while queued is
   rejected now (HTTP 429 + ``Retry-After``) rather than dispatched late
   or timed out.  Requests without an explicit deadline are never shed by
   this gate.

Everything is injectable-clock testable and lock-protected; the server
calls :meth:`AdmissionController.admit` from HTTP handler threads.
"""

import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from distributedkernelshap_tpu_torch.analysis import lockwitness


class TokenBucket:
    """Continuous-refill token bucket (``rate`` tokens/s, ``burst`` cap)."""

    def __init__(self, rate: float, burst: float, now=time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self._now = now
        self._tokens = float(burst)
        self._t_last = now()
        self._lock = lockwitness.make_lock("admission.bucket")

    def try_acquire(self, n: float = 1.0) -> Tuple[bool, float]:
        """Take ``n`` tokens if available.  Returns ``(acquired,
        retry_after_s)`` — on failure ``retry_after_s`` is how long until
        the bucket will have refilled enough."""

        with self._lock:
            t = self._now()
            self._tokens = min(self.burst,
                               self._tokens + (t - self._t_last) * self.rate)
            self._t_last = t
            if self._tokens >= n:
                self._tokens -= n
                return True, 0.0
            return False, (n - self._tokens) / self.rate

    @property
    def tokens(self) -> float:
        with self._lock:
            t = self._now()
            return min(self.burst,
                       self._tokens + (t - self._t_last) * self.rate)


class ServiceRateEstimator:
    """EWMA of observed device throughput in rows/second.

    The server feeds it one observation per completed device batch; the
    admission controller divides queued rows by it to project queue wait.
    Before any observation it reports ``None`` — the projected-wait gate
    then admits (no evidence of overload yet).

    The EWMA assumes the downstream capacity producing the observations
    is static.  When it is not — the autoscaler resized the replica
    fleet behind a fan-in, or a fleet-level estimator watches N workers —
    :meth:`capacity_hint` rescales the believed rate proportionally at
    the moment capacity changes, so projected-wait shedding neither
    over-sheds right after a scale-up (the EWMA still believing the old,
    smaller fleet) nor under-sheds after a drain (still believing the
    bigger one).  The hint moves the ESTIMATE once; subsequent
    observations keep correcting it as usual.
    """

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self._rate: Optional[float] = None
        self._capacity_units: Optional[float] = None
        self._rows_total = 0
        self._lock = lockwitness.make_lock("admission.estimator")

    def observe(self, rows: int, seconds: float) -> None:
        if seconds <= 0 or rows <= 0:
            return
        sample = rows / seconds
        with self._lock:
            self._rows_total += int(rows)
            self._rate = (sample if self._rate is None
                          else self.alpha * sample
                          + (1.0 - self.alpha) * self._rate)

    def capacity_hint(self, units: float) -> None:
        """Declare the downstream capacity in arbitrary ``units``
        (typically ready replicas).  The first call only records the
        baseline; later calls rescale the current EWMA by the units
        ratio.  Called by the autoscaler on every completed scale event
        and by ``ReplicaManager`` with the starting fleet size."""

        units = float(units)
        if units <= 0:
            raise ValueError("capacity_hint units must be positive")
        with self._lock:
            if self._capacity_units and self._rate is not None:
                self._rate *= units / self._capacity_units
            self._capacity_units = units

    def rows_observed_total(self) -> int:
        """Cumulative rows fed through :meth:`observe` — a monotonic
        served-rows counter.  A fleet-level consumer (the autoscaler)
        differentiates it across polls to get a rows/s DEMAND that is
        unit-compatible with :meth:`rows_per_s` capacity, which a
        request-count rate is not (requests carry arbitrary row counts)."""

        with self._lock:
            return self._rows_total

    def rows_per_s(self) -> Optional[float]:
        with self._lock:
            return self._rate


class AdmissionDecision:
    __slots__ = ("admitted", "reason", "retry_after_s")

    def __init__(self, admitted: bool, reason: str = "",
                 retry_after_s: float = 0.0):
        self.admitted = admitted
        self.reason = reason  # "queue_full" | "rate_limited" | "projected_wait"
        self.retry_after_s = retry_after_s

    def __bool__(self) -> bool:
        return self.admitted


class AdmissionController:
    """Combines the three gates; see module docstring.

    Parameters
    ----------
    max_queued_per_class
        Depth bound applied per priority class (int for a uniform bound,
        or a ``{class: bound}`` dict — classes missing from the dict keep
        the default bound of 1024; an explicit 0 entry disables the gate
        for that class).  ``None``/0 disables the gate everywhere.
    rate_limit_per_client
        ``(rate_per_s, burst)`` for the per-client token buckets, counted
        in requests.  ``None`` disables rate limiting.
    estimator
        Shared :class:`ServiceRateEstimator` (the server owns it and feeds
        completions); ``None`` disables projected-wait shedding.
    max_client_buckets
        Bound on tracked client keys so an adversarial key-space cannot
        grow memory without bound; least-recently-seen keys are evicted
        (their next request simply starts a fresh, full bucket).
    """

    def __init__(self,
                 max_queued_per_class=1024,
                 rate_limit_per_client: Optional[Tuple[float, float]] = None,
                 estimator: Optional[ServiceRateEstimator] = None,
                 max_client_buckets: int = 10_000,
                 now=time.monotonic):
        if isinstance(max_queued_per_class, dict):
            self._bounds = dict(max_queued_per_class)
            # unlisted classes keep a real bound: a {class: N} override
            # must not silently unbound every OTHER class's queue
            self._default_bound = 1024
        else:
            self._bounds = {}
            self._default_bound = int(max_queued_per_class or 0)
        self.rate_limit_per_client = rate_limit_per_client
        self.estimator = estimator
        self.max_client_buckets = int(max_client_buckets)
        self._now = now
        self._buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()
        self._buckets_lock = lockwitness.make_lock("admission.clients")

    def _bound_for(self, klass: str) -> int:
        return int(self._bounds.get(klass, self._default_bound) or 0)

    def capacity_hint(self, units: float) -> None:
        """Forward a downstream-capacity change to the estimator (no-op
        without one) — see :meth:`ServiceRateEstimator.capacity_hint`."""

        if self.estimator is not None:
            self.estimator.capacity_hint(units)

    def _bucket_for(self, client_key: str) -> TokenBucket:
        rate, burst = self.rate_limit_per_client
        with self._buckets_lock:
            bucket = self._buckets.get(client_key)
            if bucket is None:
                bucket = TokenBucket(rate, burst, now=self._now)
                self._buckets[client_key] = bucket
                while len(self._buckets) > self.max_client_buckets:
                    self._buckets.popitem(last=False)
            else:
                self._buckets.move_to_end(client_key)
            return bucket

    def admit(self, klass: str, rows: int, client_key: str,
              deadline: Optional[float] = None,
              queue_depth: int = 0,
              queued_rows: int = 0) -> AdmissionDecision:
        """Decide one request.  ``deadline`` is absolute monotonic seconds
        (or ``None``); ``queue_depth`` is the request's class depth and
        ``queued_rows`` the total rows queued ahead of it (both read from
        the scheduler by the caller)."""

        bound = self._bound_for(klass)
        if bound and queue_depth >= bound:
            rps = self.estimator.rows_per_s() if self.estimator else None
            retry = (queued_rows / rps) if (rps and queued_rows) else 1.0
            return AdmissionDecision(False, "queue_full",
                                     max(0.1, min(retry, 60.0)))
        if deadline is not None and self.estimator is not None:
            rps = self.estimator.rows_per_s()
            if rps:
                projected_wait = (queued_rows + rows) / rps
                if self._now() + projected_wait > deadline:
                    return AdmissionDecision(False, "projected_wait",
                                             max(0.1, min(projected_wait,
                                                          60.0)))
        # token consumption LAST: the side-effect-free gates above must not
        # charge a client's bucket for a request that is then rejected
        # anyway (retries after a projected_wait 429 would find the bucket
        # drained by the rejected attempts themselves)
        if self.rate_limit_per_client is not None:
            ok, retry = self._bucket_for(client_key).try_acquire(1.0)
            if not ok:
                return AdmissionDecision(False, "rate_limited",
                                         max(0.05, retry))
        return AdmissionDecision(True)
