"""Per-tenant device-time metering: who consumed the fleet's
device-seconds, and how much of everything else.

Since cross-tenant continuous batching (PR 11) one padded device program
can carry rows from several tenants, and five evaluation paths share the
same dispatcher — so no pre-existing metric could answer "which
tenant/path consumed the device-seconds this hour".  The Gemma-on-TPU
continuous-batching analysis (PAPERS.md, arXiv 2605.25645) identifies
exactly this per-workload device-time accounting as what makes
shared-batch serving operable: without it, chargeback, capacity planning
and noisy-neighbour triage all read one aggregate number.

The :class:`CostMeter` brackets every dispatched device call at the
server's dispatch→fetch boundary (the donated ``jit_batch_entry``
dispatch through the blocking D2H fetch — fetch completion IS
block-until-ready), on the monotonic clock, with backend **compile time
excluded** via the process-global compile accountant
(``runtime/compile_cache.compile_events()``): a fresh bucket shape's
40 s trace+compile must not bill a tenant 40 s of device work.

**Proration rule** (shared cross-tenant batches): one device call's
seconds are split across the member tenants proportionally to their row
counts in the padded program — tenant *i* is charged
``rows_i / sum(rows)`` of the measured interval.  Bucket-padding rows
are charged pro-rata (the padding exists to serve the whole group;
per-tenant padding waste is separately visible as
``dks_serve_padded_rows_total``).  Shares sum to exactly 1, so summing
``dks_device_seconds_total`` over tenants recovers the directly
measured dispatch total — the invariant
``benchmarks/cost_attribution_bench.py --check`` enforces to 5 %.

**Bounded label cardinality**: tenant label values pass through a hard
cap (default 64 distinct ``model`` ids); the first request of tenant
65 is attributed to the explicit ``_overflow`` bucket instead of
minting a new label — a tenant flood can never blow up the registry.
Retired tenants release their slot (and their series) through
:meth:`retire_tenant`, called by ``ModelRegistry`` on hot-swap (old
version's series) and tenant removal (everything).

Stdlib-only at module scope, like the rest of ``observability/``; the
compile accountant is imported lazily on first use.
"""

import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from distributedkernelshap_tpu_torch.observability.metrics import (
    DEFAULT_EXEMPLAR_SLOTS,
)

logger = logging.getLogger(__name__)

#: the explicit overflow tenant label (cap exceeded — see module doc)
OVERFLOW_LABEL = "_overflow"

#: default cap on distinct tenant (``model``) label values per meter
DEFAULT_MAX_TENANTS = 64

#: per-tenant latency histogram bounds — the per-tenant latency SLOs
#: (``slo.tenant_slos``) burn against these, so every tenant SLO
#: threshold must stay at or below the largest finite bucket (the same
#: contract as the server's LATENCY_BUCKETS_S)
TENANT_LATENCY_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                            1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

#: every model-labeled family the meter owns — the retire hook drops a
#: removed tenant's series from each of these
TENANT_METRICS = (
    "dks_device_seconds_total",
    "dks_tenant_rows_total",
    "dks_tenant_wire_bytes_total",
    "dks_tenant_requests_total",
    "dks_tenant_errors_total",
    "dks_tenant_cache_hits_total",
    "dks_tenant_sheds_total",
    "dks_tenant_latency_seconds",
)


class CostMeter:
    """One serving component's tenant cost-attribution plane (the server
    owns one next to its ``MetricsRegistry``; see module doc).

    ``enabled=False`` keeps every record method a cheap early return —
    the metric families still register (the catalog is mode-independent)
    but nothing on the request path pays for bookkeeping.
    """

    def __init__(self, enabled: bool = True,
                 max_tenants: int = DEFAULT_MAX_TENANTS):
        self.enabled = bool(enabled)
        self.max_tenants = int(max_tenants)
        #: device-seconds scale factor: 1.0 on single-process servers; a
        #: multi-host pod lead sets it to the process count
        #: (serving/multihost.serve_multihost) because one SPMD dispatch
        #: occupies EVERY process's devices for the lead-measured
        #: interval — billing only the lead's share under-charges an
        #: N-host pod N-fold
        self.device_multiplier = 1.0
        self._lock = threading.Lock()
        self._tenants: set = set()
        self._overflowed_total = 0
        self._registry = None
        self._compile = None  # lazy: runtime/compile_cache.compile_events

    # -- registration --------------------------------------------------- #

    def attach_metrics(self, registry) -> None:
        """Register the ``dks_device_*`` / ``dks_tenant_*`` families on
        ``registry``.  All tenant-labeled families declare the hard cap
        (obs-check cardinality lint); single-model servers attribute to
        ``model="default"``."""

        self._registry = registry
        cap = self.max_tenants
        self._m_device_seconds = registry.counter(
            "dks_device_seconds_total",
            "Device-seconds consumed per (model, version, evaluation "
            "path), measured at the dispatch-to-fetch boundary on the "
            "monotonic clock with backend compile time excluded; shared "
            "cross-tenant batches are prorated by padded-row share, and "
            "multi-host pod leads scale by the pod's process count "
            "(docs/OBSERVABILITY.md, cost attribution).",
            labelnames=("model", "version", "path")).bound_cardinality(cap)
        self._m_rows = registry.counter(
            "dks_tenant_rows_total",
            "Instance rows answered per tenant (cache hits included — "
            "the served-rows twin of dks_serve_rows_total, by model).",
            labelnames=("model",)).bound_cardinality(cap)
        self._m_wire_bytes = registry.counter(
            "dks_tenant_wire_bytes_total",
            "Payload bytes on /explain per tenant and direction (rx = "
            "request bodies after routing, tx = success responses).",
            labelnames=("model", "direction")).bound_cardinality(cap)
        self._m_requests = registry.counter(
            "dks_tenant_requests_total",
            "Requests answered per tenant (the per-tenant availability "
            "SLO's total counter; errors included).",
            labelnames=("model",)).bound_cardinality(cap)
        self._m_errors = registry.counter(
            "dks_tenant_errors_total",
            "Requests answered with an error per tenant (the per-tenant "
            "availability SLO's bad counter).",
            labelnames=("model",)).bound_cardinality(cap)
        self._m_cache_hits = registry.counter(
            "dks_tenant_cache_hits_total",
            "Requests answered from the result cache per tenant (incl. "
            "in-batch dedup) — answered rows that cost no device time.",
            labelnames=("model",)).bound_cardinality(cap)
        self._m_sheds = registry.counter(
            "dks_tenant_sheds_total",
            "Requests shed before dispatch per tenant, by reason (every "
            "dks_serve_sheds_total reason, attributed to the routed "
            "tenant; single-model servers attribute to model=default).",
            labelnames=("model", "reason")).bound_cardinality(cap)
        self._m_latency = registry.histogram(
            "dks_tenant_latency_seconds",
            "Queue+explain latency of answered requests per tenant — "
            "the histogram per-tenant latency SLOs burn against; "
            "observations carry trace exemplars (/debugz).",
            buckets=TENANT_LATENCY_BUCKETS_S, labelnames=("model",),
            exemplar_slots=DEFAULT_EXEMPLAR_SLOTS).bound_cardinality(cap)
        registry.counter(
            "dks_tenant_label_overflow_total",
            "Attribution events folded into the _overflow tenant because "
            "the distinct-model label cap was reached (a tenant flood "
            "cannot grow the metric registry).").set_function(
            lambda: float(self._overflowed_total))

    # -- tenant label guard --------------------------------------------- #

    def label(self, model_id: Optional[str]) -> str:
        """The bounded metric label for one tenant id: known ids pass
        through, new ids claim a slot while the cap allows, everything
        past the cap lands in the explicit ``_overflow`` bucket."""

        mid = "default" if not model_id else str(model_id)
        with self._lock:
            if mid in self._tenants:
                return mid
            if len(self._tenants) < self.max_tenants:
                self._tenants.add(mid)
                return mid
            self._overflowed_total += 1
        return OVERFLOW_LABEL

    def retire_tenant(self, model_id: str,
                      version: Optional[int] = None) -> int:
        """Retire one tenant's stale label values.  With ``version``
        given (a hot-swap), only the version-labeled device-seconds
        series of that version are dropped — the tenant keeps its slot
        and its version-free tallies.  Without it (tenant removal),
        every family sheds the tenant's series and its cap slot frees.
        Returns the series count removed."""

        if self._registry is None:
            return 0
        removed = 0
        if version is not None:
            return self._registry.retire_labels(
                "dks_device_seconds_total",
                {"model": str(model_id), "version": str(version)})
        for name in TENANT_METRICS:
            removed += self._registry.retire_labels(
                name, {"model": str(model_id)})
        with self._lock:
            self._tenants.discard(str(model_id))
        return removed

    # -- device-time metering ------------------------------------------- #

    def set_device_multiplier(self, n_processes) -> None:
        """Scale every settled dispatch bracket by ``n_processes`` (see
        ``device_multiplier``); clamped to >= 1."""

        self.device_multiplier = max(1.0, float(n_processes))

    def _compile_seconds(self) -> float:
        if self._compile is None:
            from distributedkernelshap_tpu_torch.runtime.compile_cache import (
                compile_events,
            )

            self._compile = compile_events()
        return self._compile.total_seconds()

    def begin(self) -> Optional[Tuple[float, float]]:
        """Open one dispatch bracket: ``(t_mono, compile_seconds)``
        snapshots, taken on the dispatcher thread just before the device
        call.  ``None`` when metering is off (settle then no-ops)."""

        if not self.enabled:
            return None
        return (time.monotonic(), self._compile_seconds())

    def settle(self, tx: Optional[Tuple[float, float]],
               shares: Sequence[Tuple[Optional[str], object, Optional[str],
                                      int]],
               t_end: Optional[float] = None,
               compile_end: Optional[float] = None) -> float:
        """Close a dispatch bracket and attribute its device-seconds.

        ``shares`` is ``[(model_id, version, path, rows), ...]`` — one
        entry per tenant in the dispatched group (``model_id=None`` for
        single-model servers).  The measured interval, minus the compile
        seconds that accrued inside it, is split by row share (see the
        module-doc proration rule).  ``t_end``/``compile_end`` default
        to "now" (tests pass explicit values for determinism).  Returns
        the device-seconds attributed."""

        if tx is None or not self.enabled or not shares:
            return 0.0
        t0, c0 = tx
        if t_end is None:
            t_end = time.monotonic()
        if compile_end is None:
            compile_end = self._compile_seconds()
        elapsed = max(0.0, (t_end - t0) - max(0.0, compile_end - c0)) \
            * self.device_multiplier
        total_rows = sum(max(0, int(r)) for _, _, _, r in shares)
        if total_rows <= 0:
            return 0.0
        for model_id, version, path, rows in shares:
            rows = max(0, int(rows))
            if not rows:
                continue
            self._m_device_seconds.inc(
                elapsed * (rows / total_rows),
                model=self.label(model_id),
                version=str(version if version is not None else 0),
                path=str(path) if path else "unknown")
        return elapsed

    # -- per-request accounting ----------------------------------------- #

    def record_answer(self, model_id: Optional[str], rows: int,
                      elapsed_s: float, error: bool, cache_hit: bool,
                      exemplar: Optional[str] = None) -> None:
        """One answered request's tenant accounting (requests, errors,
        rows, cache hits, latency + trace exemplar)."""

        if not self.enabled:
            return
        mid = self.label(model_id)
        self._m_requests.inc(model=mid)
        self._m_rows.inc(max(0, int(rows)), model=mid)
        if error:
            self._m_errors.inc(model=mid)
        elif cache_hit:
            self._m_cache_hits.inc(model=mid)
        self._m_latency.observe(float(elapsed_s), exemplar=exemplar,
                                model=mid)

    def record_shed(self, model_id: Optional[str], reason: str) -> None:
        if not self.enabled:
            return
        self._m_sheds.inc(model=self.label(model_id), reason=str(reason))

    def record_wire(self, model_id: Optional[str], direction: str,
                    nbytes: int) -> None:
        if not self.enabled or nbytes <= 0:
            return
        self._m_wire_bytes.inc(int(nbytes), model=self.label(model_id),
                               direction=str(direction))


def dispatch_shares(leaders, default_path: Optional[str] = None
                    ) -> List[Tuple[Optional[str], object,
                                    Optional[str], int]]:
    """Fold one dispatch group's live leaders into per-tenant
    ``(model_id, version, path, rows)`` shares (the ``split_sizes`` view
    of the batch, aggregated by pinned tenant version).  Leaders without
    a pinned registry model fold into the ``(None, 0, default_path)``
    default tenant (single-model servers)."""

    agg: "Dict[Tuple[Optional[str], object, Optional[str]], int]" = {}
    order: List[Tuple[Optional[str], object, Optional[str]]] = []
    for p in leaders:
        rm = getattr(p, "model", None)
        if rm is not None:
            model = rm.model
            key = (rm.model_id, rm.version,
                   getattr(model, "explain_path", None) if model is not None
                   else None)
        else:
            key = (None, 0, default_path)
        if key not in agg:
            agg[key] = 0
            order.append(key)
        agg[key] += int(getattr(p, "rows", 0))
    return [(mid, ver, path, agg[(mid, ver, path)])
            for mid, ver, path in order]
