"""Multi-tenant model registry: many models, one fleet, hot-swappable.

Every server in the tree used to bind exactly ONE predictor at build time
(``serve_explainer``), so a real multi-user service needed a fleet per
model.  The registry turns the single-model server into a gateway
(ROADMAP item 4, grounded in ONNXExplainer's format-generic framework):

* **Ingest & classify** — :meth:`ModelRegistry.register` accepts any
  fitted serving model (built from the existing lifts — sklearn / xgb /
  lgbm / torch / TT / linear — or the new ONNX ingester,
  ``registry/onnx_lift.py``) and classifies it onto its engine path with
  the ONE shared :func:`~distributedkernelshap_tpu_torch.registry.classify.
  classify_path`.
* **Per-model namespaces** — each ``(model_id, version)`` gets a content
  fingerprint (``model_id@vN:<digest>``) pinned onto the serving model,
  which drives the result-cache key (explicit ``fingerprint`` wins in
  ``scheduling/result_cache.model_fingerprint``), and a compile-cache
  signature prefix (``model=<label>`` via ``runtime/compile_cache.
  shape_signature``) for its warmup-ladder rungs.  Plan-constant /
  exact-path device caches key on the engine objects themselves, which
  are per-version here — no cross-tenant aliasing by construction.
* **Per-tenant quotas** — a :class:`TenantQuota` (token bucket + in-flight
  bound, keyed by model_id) on TOP of the server's per-client buckets: a
  flooding tenant sheds with 429 ``tenant_*`` reasons while other
  tenants' admission is untouched.
* **Hot-swap** — registering version N+1 of an id warms it through the
  attached server's compile ladder, atomically flips the active version,
  and drains version N: in-flight requests pinned the version that
  admitted them, so they finish on it — zero lost or changed answers —
  and the drained version is then retired and its device caches dropped.

The registry is serving-agnostic (no server import at module scope); the
server attaches itself via :meth:`attach_server` and reads per-request
state through :meth:`resolve` / :class:`RegisteredModel`.
"""

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from distributedkernelshap_tpu_torch.observability.flightrec import flightrec
from distributedkernelshap_tpu_torch.registry.classify import classify_path
from distributedkernelshap_tpu_torch.scheduling.admission import TokenBucket
from distributedkernelshap_tpu_torch.analysis import lockwitness
from distributedkernelshap_tpu_torch.scheduling.result_cache import (
    model_fingerprint,
)

logger = logging.getLogger(__name__)


class TenantQuota:
    """Per-tenant admission bounds: a request-rate token bucket and/or an
    in-flight bound (queued + executing requests for the tenant — the
    registry's queue bound).  Either knob may be ``None`` (off)."""

    def __init__(self, rate_per_s: Optional[float] = None,
                 burst: Optional[float] = None,
                 max_inflight: Optional[int] = None):
        self.rate_per_s = rate_per_s
        self.burst = burst if burst is not None else (
            rate_per_s if rate_per_s else None)
        self.max_inflight = max_inflight
        self._bucket = (TokenBucket(rate_per_s, self.burst)
                        if rate_per_s else None)

    def clone(self) -> "TenantQuota":
        """A fresh quota with the same parameters but its OWN token
        bucket — the registry clones ``default_quota`` per tenant, or a
        shared default bucket would let one tenant drain every other
        tenant's allowance (exactly the interference quotas exist to
        prevent)."""

        return TenantQuota(rate_per_s=self.rate_per_s, burst=self.burst,
                           max_inflight=self.max_inflight)

    def admit(self, inflight: int) -> Tuple[bool, str, float]:
        """``(admitted, reason, retry_after_s)`` for one request of a
        tenant currently holding ``inflight`` requests."""

        if self.max_inflight is not None and inflight >= self.max_inflight:
            return False, "tenant_queue_full", 1.0
        if self._bucket is not None:
            ok, retry = self._bucket.try_acquire(1.0)
            if not ok:
                return False, "tenant_rate_limited", max(0.05, retry)
        return True, "", 0.0

    def describe(self) -> Dict:
        return {"rate_per_s": self.rate_per_s, "burst": self.burst,
                "max_inflight": self.max_inflight}


class RegisteredModel:
    """One ``(model_id, version)``: the fitted serving model plus its
    namespace facts (fingerprint, engine path) and lifecycle state.

    Requests PIN the RegisteredModel that admitted them (the server
    stores it on the pending request), so a hot-swap never changes an
    in-flight answer: dispatch, cache keying and metrics all read the
    pinned version, and :meth:`drain` waits for the pin count to reach
    zero before the old version is retired."""

    def __init__(self, model_id: str, version: int, model,
                 fingerprint: str, path: str, path_reason: str,
                 quota: Optional[TenantQuota] = None):
        self.model_id = model_id
        self.version = int(version)
        self.model = model
        self.fingerprint = fingerprint
        self.path = path
        self.path_reason = path_reason
        self.quota = quota
        self.state = "active"
        # cross-tenant shared-program identity (ops/explain.
        # shared_program_key): tenants with EQUAL keys dispatch the
        # identical compiled program over identical device constants, so
        # the server may coalesce their rows into one padded device call
        # bit-identically.  None = never share.
        self.share_key: Optional[str] = None
        # set once a server ladder has compiled this version's programs
        # (register-time warm or the start-time ladder) — the start-time
        # ladder skips already-warm models instead of re-running them
        self.warmed = False
        self.created_at = time.time()
        self._cond = lockwitness.make_condition("registry.model")
        self._inflight = 0
        # per-tenant accounting, rendered via the server's registry
        # callbacks (dks_registry_requests_total etc.)
        self.requests = 0
        self.errors = 0
        self.seconds = 0.0

    @property
    def label(self) -> str:
        return f"{self.model_id}@v{self.version}"

    # -- in-flight pinning -------------------------------------------- #

    def acquire(self) -> None:
        with self._cond:
            self._inflight += 1

    def release(self) -> None:
        with self._cond:
            self._inflight = max(0, self._inflight - 1)
            if self._inflight == 0:
                self._cond.notify_all()

    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait until every request pinned to this version has answered.
        Returns whether the drain completed inside ``timeout_s``."""

        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=min(remaining, 0.5))
        return True

    def record_answer(self, elapsed_s: float, error: bool) -> None:
        with self._cond:
            self.requests += 1
            self.seconds += float(elapsed_s)
            if error:
                self.errors += 1

    def describe(self) -> Dict:
        with self._cond:
            return {
                "model_id": self.model_id, "version": self.version,
                "state": self.state, "path": self.path,
                "path_reason": self.path_reason,
                "fingerprint": self.fingerprint,
                "inflight": self._inflight, "requests": self.requests,
                "errors": self.errors,
                "quota": self.quota.describe() if self.quota else None,
                # truncated like the fingerprint: enough for an operator
                # to SEE which tenants coalesce, not a secret
                "share_key": (self.share_key[:16]
                              if self.share_key else None),
            }


class ModelRegistry:
    """Thread-safe registry of served models, keyed by ``model_id`` with
    monotonically increasing versions (see module docstring).

    Parameters
    ----------
    default_model_id
        The id served when a request names no model.  ``None`` (default)
        resolves to the FIRST registered id.
    default_quota
        :class:`TenantQuota` applied to models registered without their
        own (``None`` = unlimited — the single-tenant behaviour).
    drain_timeout_s
        How long a hot-swap waits for the displaced version's in-flight
        requests before giving up on retiring it (the requests still
        answer; only the retire bookkeeping is abandoned, loudly).
    """

    def __init__(self, default_model_id: Optional[str] = None,
                 default_quota: Optional[TenantQuota] = None,
                 drain_timeout_s: float = 30.0):
        self._lock = lockwitness.make_lock("registry.models")
        # registrations serialise END TO END (version allocation, warm,
        # insert, drain): two concurrent register() calls for one id
        # would otherwise allocate the same auto-version during the
        # seconds-long unlocked warm window and silently overwrite each
        # other.  A separate lock from _lock so draining requests (which
        # resolve/release under _lock) never deadlock a registration.
        self._register_lock = lockwitness.make_lock("registry.register")
        #: {model_id: {"active": RegisteredModel, "versions": {v: rm}}}
        self._models: Dict[str, Dict] = {}
        self._order: List[str] = []
        self.default_model_id = default_model_id
        self.default_quota = default_quota
        self.drain_timeout_s = float(drain_timeout_s)
        self._server = None
        self._flight = flightrec()
        # shed / swap accounting for the dks_registry_* callbacks
        self._sheds: Dict[Tuple[str, str], float] = {}
        self._swaps: Dict[str, float] = {}
        # ACTIVE versions per shared-program key: the server coalesces a
        # tenant onto a share group only when it actually has peers
        # (share_peers > 1) — a lone eligible tenant keeps its per-model
        # group identity, so its quota keeps capping its per-cycle take
        self._share_counts: Dict[str, int] = {}

    # -- serving attachment ------------------------------------------- #

    def attach_server(self, server) -> None:
        """Called by the server that routes through this registry; used
        to warm newly registered versions through ITS compile ladder."""

        self._server = server

    # -- ingest -------------------------------------------------------- #

    def register(self, model_id: str, model, version: Optional[int] = None,
                 quota: Optional[TenantQuota] = None,
                 warm: Optional[bool] = None) -> RegisteredModel:
        """Register (or hot-swap) one model.

        ``model`` is a fitted serving model (``KernelShapModel``-like).
        ``version`` defaults to ``previous + 1`` (1 for a new id).
        ``warm`` defaults to warming whenever a server is attached; the
        warm runs BEFORE the version flips, so the first routed request
        lands on compiled executables.  Returns the
        :class:`RegisteredModel`.
        """

        if not model_id or "," in model_id or "=" in model_id:
            # the label feeds compile signatures (model=<id>,rows=...)
            # and metric label values; keep it delimiter-free
            raise ValueError(
                f"model_id must be a non-empty string without ','/'=' "
                f"(got {model_id!r})")
        if not hasattr(model, "explain_batch"):
            raise ValueError(
                "register() needs a fitted serving model exposing "
                "explain_batch (KernelShapModel / BatchKernelShapModel)")
        with self._register_lock:
            return self._register_locked(model_id, model, version, quota,
                                         warm)

    def _register_locked(self, model_id, model, version, quota, warm
                         ) -> RegisteredModel:
        with self._lock:
            entry = self._models.get(model_id)
            prev = entry["active"] if entry else None
            if version is None:
                version = (max(entry["versions"]) + 1) if entry else 1
            elif entry and version in entry["versions"]:
                raise ValueError(
                    f"{model_id} version {version} already registered")
        path, reason = self._deployment_path(model)
        content = model_fingerprint(model, count_weak=False)
        if quota is None and prev is not None:
            # a hot swap is a model update, not a policy change: the
            # tenant KEEPS its quota (same object — bucket state carries
            # across the flip) unless the caller explicitly passes one
            quota = prev.quota
        elif quota is None and self.default_quota is not None:
            quota = self.default_quota.clone()  # per-tenant bucket
        rm = RegisteredModel(
            model_id, version, model,
            fingerprint=f"{model_id}@v{version}:{content[:24]}",
            path=path, path_reason=reason, quota=quota)
        try:
            # shared-program eligibility probe (never fails an ingest):
            # content-identical tenants land on EQUAL keys and may share
            # padded device calls (cross-tenant continuous batching)
            from distributedkernelshap_tpu_torch.ops.explain import (
                shared_program_key,
            )

            rm.share_key = shared_program_key(model)
        except Exception:
            logger.debug("shared-program probe failed for %s", rm.label,
                         exc_info=True)
        # the pinned attribute is what scheduling/result_cache's
        # model_fingerprint returns, so every cache key is scoped to this
        # (model_id, version, content) — and survives a restart
        model.fingerprint = rm.fingerprint
        # relabel the engine's ledger-tracked device caches to this
        # tenant/version so dks_device_bytes attributes engine consts to
        # the model that owns them (best-effort: stub models have no
        # engine, a pre-ledger engine no rebind)
        try:
            engine = getattr(getattr(model, "explainer", model),
                             "_explainer", None)
            for cache_attr in ("_dev_cache", "_plan_consts_cache"):
                cache = getattr(engine, cache_attr, None)
                rebind = getattr(cache, "rebind", None)
                if rebind is not None:
                    rebind(model=model_id, version=version, path=path)
        except Exception:
            logger.debug("ledger rebind failed for %s", rm.label,
                         exc_info=True)
        # warm BEFORE the flip: the new version compiles its ladder while
        # the old one keeps serving, so the swap is hitless
        server = self._server
        if warm is None:
            warm = server is not None
        if warm and server is not None:
            try:
                server._warm_model(rm)
            except Exception:
                logger.exception("warmup of %s failed; serving it cold",
                                 rm.label)
        # canary drift sentinel (observability/quality.py): replay the
        # tenant's golden canary set against the INCOMING version before
        # traffic moves, then re-capture the baseline from the version
        # about to serve — the model_swap event below carries the
        # quantified verdict.  Best-effort like warmup: a sentinel
        # failure must never block a registration.
        drift = None
        quality = getattr(server, "_quality", None) \
            if server is not None else None
        if quality is not None:
            try:
                drift = quality.swap_check(model_id, rm.model,
                                           fingerprint=rm.fingerprint)
            except Exception:
                logger.exception("canary swap check for %s failed", rm.label)
        with self._lock:
            entry = self._models.setdefault(
                model_id, {"active": None, "versions": {}})
            entry["versions"][version] = rm
            entry["active"] = rm
            if model_id not in self._order:
                self._order.append(model_id)
            self._swaps[model_id] = self._swaps.get(model_id, 0.0) + 1.0
            # share-peer accounting tracks ACTIVE versions only: the
            # displaced version leaves its share group at the flip (its
            # still-pinned requests dispatch under their per-model key)
            if prev is not None and prev.share_key:
                n = self._share_counts.get(prev.share_key, 0) - 1
                if n > 0:
                    self._share_counts[prev.share_key] = n
                else:
                    self._share_counts.pop(prev.share_key, None)
            if rm.share_key:
                self._share_counts[rm.share_key] = \
                    self._share_counts.get(rm.share_key, 0) + 1
        self._flight.record("model_swap", model=model_id,
                            from_version=(prev.version if prev else None),
                            to_version=version, path=rm.path,
                            fingerprint=rm.fingerprint,
                            canary_drift=(drift or {}).get("drift"),
                            canary_verdict=(drift or {}).get("verdict"),
                            canary_rows=(drift or {}).get("rows"))
        logger.info("registered %s (path=%s: %s)%s", rm.label, rm.path,
                    rm.path_reason,
                    f"; draining v{prev.version}" if prev else "")
        if prev is not None:
            prev.state = "draining"
            if prev.drain(self.drain_timeout_s):
                prev.state = "retired"
                reset = getattr(prev.model, "reset", None)
                if reset is not None:
                    try:
                        reset()  # free the retired version's device caches
                    except Exception:
                        logger.exception("reset of drained %s failed",
                                         prev.label)
                # release the engine itself: the RegisteredModel stays
                # (scalar tallies feed the per-id metric sums and the
                # duplicate-version check) but a nightly-swapping tenant
                # must not accumulate one full model per swap
                prev.model = None
                # stale label retirement: the retired version's
                # version-labeled series (device-seconds) stop rendering
                # — a nightly-swapping tenant must not grow the metric
                # registry by one version's label set per swap
                self._retire_tenant_labels(model_id, version=prev.version)
            else:
                logger.warning(
                    "drain of %s did not complete within %.0fs (%d "
                    "requests still pinned); they will still answer on "
                    "their admitted version", prev.label,
                    self.drain_timeout_s, prev.inflight)
        self._notify_server_roster_changed()
        return rm

    def unregister(self, model_id: str,
                   drain_timeout_s: Optional[float] = None) -> bool:
        """Remove one tenant for good: the id leaves the roster FIRST
        (no new resolves — routed requests 404 with the remaining
        roster), the active version drains (in-flight pinned requests
        still answer), its device caches drop, and every metric series
        labeled with the tenant retires (``MetricsRegistry.
        retire_labels`` via the cost meter) so deleted tenants stop
        accumulating label space forever.  Returns whether the drain
        completed inside the timeout (the removal happens either way;
        an incomplete drain's stragglers still answer on their pinned
        version)."""

        with self._register_lock:
            with self._lock:
                entry = self._models.pop(model_id, None)
                if entry is None:
                    raise KeyError(f"unknown model id {model_id!r}")
                self._order.remove(model_id)
                if self.default_model_id == model_id:
                    self.default_model_id = None
                active = entry["active"]
                if active is not None and active.share_key:
                    n = self._share_counts.get(active.share_key, 0) - 1
                    if n > 0:
                        self._share_counts[active.share_key] = n
                    else:
                        self._share_counts.pop(active.share_key, None)
                self._sheds = {k: v for k, v in self._sheds.items()
                               if k[0] != model_id}
                self._swaps.pop(model_id, None)
            drained = True
            if drain_timeout_s is None:
                drain_timeout_s = self.drain_timeout_s
            for rm in entry["versions"].values():
                if rm.model is None:
                    continue
                rm.state = "draining"
                if rm.drain(drain_timeout_s):
                    rm.state = "retired"
                    reset = getattr(rm.model, "reset", None)
                    if reset is not None:
                        try:
                            reset()
                        except Exception:
                            logger.exception("reset of removed %s failed",
                                             rm.label)
                    rm.model = None
                else:
                    drained = False
                    logger.warning(
                        "unregister(%s): drain of %s incomplete (%d "
                        "requests still pinned); they answer on their "
                        "pinned version", model_id, rm.label, rm.inflight)
            self._retire_tenant_labels(model_id)
            self._flight.record("model_removed", model=model_id,
                                drained=drained)
            logger.info("unregistered %s (drained=%s)", model_id, drained)
        self._notify_server_roster_changed()
        return drained

    def _retire_tenant_labels(self, model_id: str,
                              version: Optional[int] = None) -> None:
        """Drop a removed tenant's (or a retired version's) stale metric
        label values on the attached server's registry — best-effort
        cleanup; a failure is logged, never raised into the swap/remove
        path."""

        server = self._server
        if server is None:
            return
        try:
            meter = getattr(server, "_costmeter", None)
            if meter is not None:
                meter.retire_tenant(model_id, version=version)
            # drop the tenant's (or the retired version's) device-memory
            # ledger accounts too, so dks_device_bytes{model=...} stops
            # rendering alongside the cost series
            from distributedkernelshap_tpu_torch.observability.memledger import (
                memledger,
            )

            memledger().retire(model_id, version=version)
            if version is None:
                server.metrics.retire_labels("dks_serve_padded_rows_total",
                                             {"model": model_id})
                # quality plane: drop the tenant's canary baseline,
                # shadow-error series and dks_quality_* label values
                quality = getattr(server, "_quality", None)
                if quality is not None:
                    quality.retire_tenant(model_id, registry=server.metrics)
        except Exception:
            logger.exception("label retirement for %s failed", model_id)

    def _notify_server_roster_changed(self) -> None:
        """Refresh the attached server's templated per-tenant SLOs after
        a registration or removal (no-op without a server, or when the
        operator pinned an explicit SLO set)."""

        server = self._server
        if server is None:
            return
        refresh = getattr(server, "_refresh_tenant_slos", None)
        if refresh is not None:
            refresh()

    @staticmethod
    def _deployment_path(model) -> Tuple[str, str]:
        """``(path, reason)`` for what this deployment actually SERVES.

        ``classify_path`` states what the predictor structurally admits;
        the serving wrapper's resolved ``explain_path`` states what the
        deployment runs after pinned ``explain_kwargs`` and the
        exact-auto opt-out — /statusz and ``dks_registry_models`` must
        report the latter, or an operator debugging estimator variance
        would be told a sampled tenant is on an exact path."""

        decision = classify_path(model)
        served = getattr(model, "explain_path", None)
        if served == "exact":
            return "exact_tree", decision.reason
        if served == "exact_tn":
            return "exact_tn", decision.reason
        if served == "deepshap":
            return "deepshap", decision.reason
        if decision.path in ("exact_tree", "exact_tn", "deepshap") \
                and served == "sampled":
            return "sampled", (f"{decision.path} structurally available "
                               f"but deployment serves sampled "
                               f"({getattr(model, 'explain_path_reason', 'pinned')})")
        return decision.path, decision.reason

    # -- request-path reads -------------------------------------------- #

    def resolve(self, model_id: Optional[str] = None, pin: bool = False
                ) -> Optional[RegisteredModel]:
        """The active version for ``model_id`` (default: the registry's
        default id), or ``None`` when unknown / nothing registered.

        ``pin=True`` (the serving handler) acquires the in-flight pin
        ATOMICALLY with the lookup: a hot-swap's drain can then never
        observe zero pins between a request resolving a version and
        pinning it — i.e. the admitted version cannot be retired (and
        its model released) under an already-routed request.  The caller
        owns the matching ``release()``."""

        with self._lock:
            if model_id is None:
                model_id = self.default_model_id or (
                    self._order[0] if self._order else None)
            entry = self._models.get(model_id) if model_id else None
            rm = entry["active"] if entry else None
            if rm is not None and pin:
                rm.acquire()
            return rm

    def admit(self, rm: RegisteredModel,
              exclude_self: bool = False) -> Tuple[bool, str, float]:
        """Apply the tenant's quota to one request (``(admitted, reason,
        retry_after_s)``); records the shed for the per-model counter.
        ``exclude_self=True`` when the caller already holds ITS pin on
        ``rm`` (the serving handler pins at resolve time), so the
        in-flight bound judges the OTHER requests."""

        if rm.quota is None:
            return True, "", 0.0
        inflight = rm.inflight - (1 if exclude_self else 0)
        ok, reason, retry = rm.quota.admit(max(0, inflight))
        if not ok:
            with self._lock:
                key = (rm.model_id, reason)
                self._sheds[key] = self._sheds.get(key, 0.0) + 1.0
        return ok, reason, retry

    def share_peers(self, share_key: Optional[str]) -> int:
        """ACTIVE versions currently carrying ``share_key`` — the server
        coalesces tenants onto one shared-program dispatch group only
        when this exceeds 1 (a lone eligible tenant keeps its per-model
        group, so its quota's per-cycle packing cap still applies)."""

        if not share_key:
            return 0
        with self._lock:
            return self._share_counts.get(share_key, 0)

    def model_ids(self) -> List[str]:
        with self._lock:
            return list(self._order)

    def active_models(self) -> List[RegisteredModel]:
        with self._lock:
            return [self._models[mid]["active"] for mid in self._order
                    if self._models[mid]["active"] is not None]

    def reset_all(self) -> None:
        """Drop device-resident state of every active model (the serving
        watchdog's wedge recovery, fleet-wide)."""

        for rm in self.active_models():
            reset = getattr(rm.model, "reset", None)
            if reset is not None:
                try:
                    reset()
                except Exception:
                    logger.exception("reset of %s failed", rm.label)

    # -- observability ------------------------------------------------- #

    def _all_versions(self) -> Dict[str, List[RegisteredModel]]:
        with self._lock:
            return {mid: list(self._models[mid]["versions"].values())
                    for mid in self._order}

    def metric_models(self) -> Dict[tuple, float]:
        return {(rm.model_id, str(rm.version), rm.path): 1.0
                for rm in self.active_models()}

    def metric_requests(self) -> Dict[tuple, float]:
        # summed across ALL versions of an id: a counter backed by only
        # the active version would DROP at every hot swap (a Prometheus
        # counter reset) and lose the retired versions' tallies
        return {(mid,): float(sum(rm.requests for rm in versions))
                for mid, versions in self._all_versions().items()}

    def metric_seconds(self) -> Dict[tuple, float]:
        return {(mid,): sum(rm.seconds for rm in versions)
                for mid, versions in self._all_versions().items()}

    def metric_inflight(self) -> Dict[tuple, float]:
        # draining versions still hold pins; the gauge must count them
        return {(mid,): float(sum(rm.inflight for rm in versions))
                for mid, versions in self._all_versions().items()}

    def metric_sheds(self) -> Dict[tuple, float]:
        with self._lock:
            return {k: v for k, v in self._sheds.items()}

    def metric_swaps(self) -> Dict[tuple, float]:
        with self._lock:
            return {(mid,): n for mid, n in self._swaps.items()}

    def statusz_panel(self) -> Dict:
        """The ``/statusz`` registry block: every id's active version
        with path/fingerprint/in-flight, plus non-retired older versions
        still draining."""

        panel = {"default_model_id": self.default_model_id
                 or (self._order[0] if self._order else None),
                 "models": []}
        with self._lock:
            entries = [(mid, dict(self._models[mid]["versions"]),
                        self._models[mid]["active"])
                       for mid in self._order]
        for mid, versions, active in entries:
            doc = active.describe() if active else {"model_id": mid}
            doc["versions"] = sorted(versions)
            doc["draining"] = [rm.version for rm in versions.values()
                               if rm.state == "draining"]
            panel["models"].append(doc)
        return panel
