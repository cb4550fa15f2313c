"""End-to-end observability for the serving stack of the PyTorch port
(port of ``distributedkernelshap_tpu/observability/``).

All stdlib-only at module scope (nothing here may import torch/numpy at
import time — the server imports this before the heavyweight stack comes
up):

* :mod:`~distributedkernelshap_tpu_torch.observability.metrics` — the central
  thread-safe metrics registry (Counter/Gauge/Histogram with labels) and
  the ONE Prometheus text renderer every ``/metrics`` endpoint uses,
  plus the exposition-format parser/validator behind the compliance test
  and ``make obs-check``;
* :mod:`~distributedkernelshap_tpu_torch.observability.tracing` — spans with
  W3C-style context propagation over ``X-DKS-Trace``, a bounded ring
  buffer, JSONL export and a Chrome/Perfetto ``trace_event`` converter;
* :mod:`~distributedkernelshap_tpu_torch.observability.flightrec` — a flight
  recorder: the last N structured events (sheds, hedges, restarts,
  journal invalidations, wedges, fault injections), queryable at
  ``/debugz`` and dumped to disk on an injected crash;
* :mod:`~distributedkernelshap_tpu_torch.observability.timeseries` — a bounded
  in-process time-series store (fixed-interval ring per series) fed by a
  background sampler over the live registries, with windowed ``rate`` /
  ``quantile`` / ``avg_over`` queries and JSONL export/replay;
* :mod:`~distributedkernelshap_tpu_torch.observability.slo` — declarative SLOs
  (availability, latency-threshold, staleness) evaluated as multi-window
  multi-burn-rate conditions over the store, with per-priority-class
  latency targets;
* :mod:`~distributedkernelshap_tpu_torch.observability.alerts` — the alert
  rules engine (pending → firing → resolved, for/keep-firing durations,
  dedup, silences) with pluggable sinks (log, flight recorder, webhook,
  ``dks_alerts_firing`` gauge);
* :mod:`~distributedkernelshap_tpu_torch.observability.statusz` — the
  :class:`HealthEngine` bundling sampler + SLOs + alerts behind the
  ``/statusz`` endpoint both serving components expose;
* :mod:`~distributedkernelshap_tpu_torch.observability.contprof` — the
  always-on sampling wall-clock profiler (``sys._current_frames`` at a
  prime default rate) behind ``/profilez``, with role/tenant-tagged
  collapsed stacks, Perfetto export and federated merging;
* :mod:`~distributedkernelshap_tpu_torch.observability.memledger` — the
  process-wide device-memory ledger: per-owner/per-tenant computed
  byte accounting over every device-resident cache, with a soft budget
  and pressure-driven LRU eviction;
* :mod:`~distributedkernelshap_tpu_torch.observability.quality` — continuous
  correctness: the in-band invariant auditor (additivity/NaN/error-bound
  screen on every served answer, ``/qualityz`` repro ring), the budgeted
  shadow-oracle sampler (billed to the ``_quality`` tenant under
  ``DKS_QUALITY_BUDGET_S``) and the hot-swap canary drift sentinel.
  Stdlib-only at module scope like its siblings — numpy and the wire
  codec load lazily inside the screening calls.

The metric catalog, trace header format, SLO/alert semantics and the
``/statusz`` and ``/debugz`` schemas are the reference's
(``docs/OBSERVABILITY.md``).
"""

# NOTE: the ``flightrec()`` accessor function is deliberately NOT
# re-exported here — it shares its name with its submodule, and binding it
# on the package would shadow ``observability.flightrec`` for module-path
# imports.  Import it from the submodule:
# ``from distributedkernelshap_tpu_torch.observability.flightrec import flightrec``.
from distributedkernelshap_tpu_torch.observability.alerts import (  # noqa: F401
    AlertManager,
    AlertRule,
    CollectSink,
    FlightRecorderSink,
    LogSink,
    Silence,
    WebhookSink,
    slo_burn_rule,
)
from distributedkernelshap_tpu_torch.observability.flightrec import (  # noqa: F401
    FlightRecorder,
)
from distributedkernelshap_tpu_torch.observability.costmeter import (  # noqa: F401
    CostMeter,
)
from distributedkernelshap_tpu_torch.observability.contprof import (  # noqa: F401
    ContProf,
    merge_collapsed,
    parse_collapsed,
)
from distributedkernelshap_tpu_torch.observability.memledger import (  # noqa: F401
    MemLedger,
    TrackedCache,
    approx_nbytes,
)
from distributedkernelshap_tpu_torch.observability.fleet import (  # noqa: F401
    fleet_rollup,
    merge_expositions,
)
from distributedkernelshap_tpu_torch.observability.slo import (  # noqa: F401
    AvailabilitySLO,
    BurnRateWindow,
    LatencySLO,
    QualitySLO,
    SLO,
    StalenessSLO,
    default_proxy_slos,
    default_server_slos,
    tenant_slos,
)
from distributedkernelshap_tpu_torch.observability.quality import (  # noqa: F401
    QualityAuditor,
    QualityMonitor,
    ShadowSampler,
    CanarySentinel,
    merge_quality_pages,
    screen_arrays,
    screen_payload,
)
from distributedkernelshap_tpu_torch.observability.statusz import (  # noqa: F401
    HealthEngine,
    render_statusz_html,
    statusz_response,
)
from distributedkernelshap_tpu_torch.observability.timeseries import (  # noqa: F401
    RegistrySampler,
    TimeSeriesStore,
    load_jsonl,
    sparkline,
)
from distributedkernelshap_tpu_torch.observability.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    parse_exposition,
    validate_exposition,
)
from distributedkernelshap_tpu_torch.observability.tracing import (  # noqa: F401
    TRACE_HEADER,
    Span,
    SpanContext,
    Tracer,
    current_context,
    format_trace_header,
    parse_trace_header,
    tracer,
    use_context,
)
