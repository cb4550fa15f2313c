"""Continuous correctness observability: is the phi we serve *right*?

Eighteen PRs of observability watch latency, resources and cost — none
of them watch the statistical contract the whole system exists to
honour.  KernelSHAP's constrained WLS enforces the efficiency axiom, so
every healthy answer satisfies **additivity**:
``sum_m(phi[k][b, m]) + E[f]_k ≈ f(x_b)_k`` (link space) to solver
precision — a live invariant cheap enough to check on every answer.
This module turns it (plus NaN/Inf screening and anytime error-bound
sanity) into an alertable production signal, in three tiers:

1. :class:`QualityAuditor` — **in-band invariant auditor**.  Every
   served explanation is screened host-side at finalize time (pure
   payload parsing, no device work).  Violations count in
   ``dks_quality_violations_total{model,path,check}``, land on the
   flight recorder as ``quality_violation`` events with trace
   exemplars, and the offending request is captured into a bounded
   repro ring served on ``/qualityz``.
2. :class:`ShadowSampler` — **budgeted shadow-oracle sampler**.  A
   background thread re-explains a sampled fraction of recent live
   traffic at higher fidelity: tenants on an exact path
   (exact/exact_tn/deepshap — in-fleet ground-truth oracles) are
   re-run as their own oracle; sampled-path tenants get a
   high-``nsamples`` re-run.  Per-tenant served-vs-oracle error is
   tracked as a bounded time-series and exposed as
   ``dks_quality_shadow_err{model}``.  Oracle device-seconds are
   charged to the ``_quality`` system tenant through the cost meter
   and capped by a hard ``DKS_QUALITY_BUDGET_S`` budget — auditing is
   a metered tenant, not an unmetered tax.
3. :class:`CanarySentinel` — **hot-swap/canary drift sentinel**.  Each
   registration auto-captures a small golden canary set (background
   rows + their phi).  The registry replays it against every incoming
   version *before traffic moves* (the ``model_swap`` flight event
   carries the quantified drift verdict) and the monitor thread
   replays it periodically against the live fleet.

One :class:`QualityMonitor` composes the three per server (like
``CostMeter`` — per-registry, not process-global).  Env knobs:
``DKS_QUALITY_AUDIT`` (default on), ``DKS_QUALITY_SAMPLE`` (shadow
fraction, default 0 = off), ``DKS_QUALITY_BUDGET_S`` (shadow budget,
default 30).  Stdlib-only at module scope like the rest of
``observability/``; numpy and the wire codec are imported lazily inside
the screening calls.
"""

import json
import logging
import os
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from distributedkernelshap_tpu_torch.analysis import lockwitness
from distributedkernelshap_tpu_torch.observability.costmeter import OVERFLOW_LABEL
from distributedkernelshap_tpu_torch.observability.flightrec import flightrec

logger = logging.getLogger(__name__)

#: the system tenant the shadow oracle's device-seconds bill to
QUALITY_TENANT = "_quality"

#: the invariant screen's check names (the ``check`` label values)
CHECKS = ("additivity", "finite", "error_bound", "decode")

#: engine paths whose served answer is already ground truth — the shadow
#: oracle re-runs them as their own oracle (drift there means
#: nondeterminism or device fault, not estimator variance).  ``linear``
#: is NOT here: the registry's linear path is still the sampled
#: estimator (only its plan is cached), so its oracle is a
#: high-nsamples re-run like ``sampled``.
EXACT_PATHS = ("exact", "exact_tree", "exact_tn", "deepshap")

#: per-path additivity tolerance ``(rtol, atol)`` on
#: ``|sum(phi) + E[f] - f(x)|``: exact paths solve in closed form (f32
#: accumulation noise only); DeepSHAP distributes exactly but through a
#: longer backprop chain; the sampled WLS enforces the efficiency
#: constraint to regularized-solver precision, the loosest of the three.
#: Keys cover BOTH path vocabularies that reach the auditor: the
#: wrapper's explain path (``exact``/``deepshap``/``sampled``,
#: ``wrappers._resolve_explain_path``) and the registry's engine path
#: (``linear``/``exact_tree``/``exact_tn``/``deepshap``/``sampled``,
#: ``registry/classify.ENGINE_PATHS``) — ``linear`` and ``exact_tree``
#: dispatch exact or plan-cached solves and screen at the tight bound.
PATH_TOLERANCES = {
    "exact": (1e-3, 1e-4),
    "exact_tree": (1e-3, 1e-4),
    "exact_tn": (1e-3, 1e-4),
    "linear": (1e-3, 1e-4),
    "deepshap": (5e-3, 1e-4),
    "sampled": (1e-2, 1e-3),
}
DEFAULT_TOLERANCE = (1e-2, 1e-3)

#: reported anytime error bounds above this are nonsense, not progress
MAX_SANE_ERR = 1e3

#: canary drift at/below this is recompile noise; above it is a verdict
DRIFT_TOLERANCE = 1e-3

DEFAULT_RING = 32            #: repro-ring capacity (offending requests)
DEFAULT_QUEUE = 64           #: shadow sample queue capacity
DEFAULT_AUDIT_QUEUE = 1024   #: deferred-audit queue capacity (drop-oldest)
DEFAULT_SERIES = 120         #: per-tenant shadow error time-series points
DEFAULT_BUDGET_S = 30.0      #: DKS_QUALITY_BUDGET_S default
DEFAULT_ORACLE_NSAMPLES = 2048
DEFAULT_CANARY_ROWS = 4
DEFAULT_CANARY_INTERVAL_S = 60.0
DEFAULT_MAX_TENANTS = 64     #: label cap, mirrors the cost meter's


def resolve_audit_env(default: bool = True) -> bool:
    """``DKS_QUALITY_AUDIT``: the in-band invariant auditor (default on)."""

    from distributedkernelshap_tpu_torch.utils import resolve_bool_env

    return resolve_bool_env("DKS_QUALITY_AUDIT", default)


def resolve_sample_env(default: float = 0.0) -> float:
    """``DKS_QUALITY_SAMPLE``: shadow-oracle sampling fraction in [0, 1]
    (default 0 — the sampler is off unless opted in)."""

    raw = os.environ.get("DKS_QUALITY_SAMPLE", "").strip()
    if not raw:
        return default
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        logger.warning("DKS_QUALITY_SAMPLE=%r is not a float; using %s",
                       raw, default)
        return default


def resolve_budget_env(default: float = DEFAULT_BUDGET_S) -> float:
    """``DKS_QUALITY_BUDGET_S``: hard cap on shadow-oracle device-seconds
    per process lifetime."""

    raw = os.environ.get("DKS_QUALITY_BUDGET_S", "").strip()
    if not raw:
        return default
    try:
        return max(0.0, float(raw))
    except ValueError:
        logger.warning("DKS_QUALITY_BUDGET_S=%r is not a float; using %s",
                       raw, default)
        return default


# --------------------------------------------------------------------- #
# invariant screen
# --------------------------------------------------------------------- #

def payload_arrays(payload) -> Dict:
    """Transport-agnostic decode of one served explanation payload —
    JSON ``Explanation`` string or binary DKSW bytes — to
    ``{'shap_values': [K x (B, M)], 'expected_value': (K,),
    'raw_prediction': (B, K)}``."""

    from distributedkernelshap_tpu_torch.serving import wire

    if isinstance(payload, (bytes, bytearray)):
        if payload[:4] == b"DKSW":  # the binary wire magic
            return wire.decode_explanation(bytes(payload))
        payload = bytes(payload).decode("utf-8")  # JSON shipped as bytes
    return wire.explanation_payload_from_json(payload)


def screen_arrays(shap_values, expected_value, raw_prediction,
                  path: str = "sampled",
                  final_err: float = 0.0) -> List[Tuple[str, str]]:
    """Screen one answer's arrays against the serving invariants.
    Returns ``[(check, detail), ...]`` — empty means clean.

    Checks: ``finite`` (NaN/Inf anywhere — a non-finite element in phi,
    ``E[f]`` or ``f(x)`` propagates into the row-sum residual, so ONE
    finiteness test on the residual screens all three arrays; this is
    what keeps the screen cheap enough to ride every finalize),
    ``error_bound`` (a reported anytime bound must be a sane
    non-negative float), ``additivity`` (``|sum(phi) + E[f] - f(x)| <=
    atol + final_err + rtol * max(1, |f(x)|)`` per row and output,
    path-specific tolerance — an anytime answer served under a declared
    error budget widens the bound by exactly that budget)."""

    import numpy as np

    violations: List[Tuple[str, str]] = []
    sv = shap_values if isinstance(shap_values, list) else [shap_values]
    ev = np.asarray(expected_value, dtype=np.float64)
    if ev.ndim != 1:
        ev = ev.reshape(-1)
    raw = np.asarray(raw_prediction, dtype=np.float64)
    if raw.ndim != 2:
        raw = raw.reshape(1, -1) if raw.ndim <= 1 \
            else raw.reshape(raw.shape[0], -1)
    fe = float(final_err or 0.0)
    if fe != fe or not (0.0 <= fe <= MAX_SANE_ERR):
        violations.append((
            "error_bound",
            f"reported error bound {final_err!r} outside "
            f"[0, {MAX_SANE_ERR:g}]"))
        fe = 0.0
    k = min(len(sv), ev.shape[0], raw.shape[-1])
    if k <= 0:
        return violations
    sums = [np.asarray(sv[i], dtype=np.float64).sum(axis=-1).reshape(-1)
            for i in range(k)]
    resid = np.stack(sums, axis=-1) + ev[:k] - raw[..., :k]
    if not np.isfinite(resid).all():
        violations.insert(0, ("finite",
                              "NaN/Inf in phi/expected_value/"
                              "raw_prediction"))
        return violations  # additivity over non-finite values is noise
    resid = np.abs(resid)
    rtol, atol = PATH_TOLERANCES.get(path, DEFAULT_TOLERANCE)
    bound = atol + fe + rtol * np.maximum(1.0, np.abs(raw[..., :k]))
    if bool((resid > bound).any()):
        violations.append((
            "additivity",
            f"max |sum(phi)+E[f]-f(x)| = {float(resid.max()):.3g} "
            f"(bound {float(bound.max()):.3g}, path={path})"))
    return violations


def screen_payload(payload, path: str = "sampled", final_err: float = 0.0
                   ) -> Tuple[List[Tuple[str, str]], Optional[Dict]]:
    """Decode + screen one payload; ``(violations, arrays-or-None)``.
    A payload that will not even decode is itself a violation
    (``decode``) — it could never be replayed or cached safely."""

    try:
        arrays = payload_arrays(payload)
    except Exception as exc:  # noqa: BLE001 — any decode failure is the signal
        return [("decode", f"payload failed to decode: {exc}")], None
    return screen_arrays(arrays["shap_values"], arrays["expected_value"],
                         arrays["raw_prediction"], path=path,
                         final_err=final_err), arrays


def cacheable_payload(payload, path: str = "sampled",
                      final_err: float = 0.0) -> bool:
    """Audit-on-insert hook for the keep-best result cache: may this
    payload be cached?  A phi payload failing the invariant screen must
    never become a bit-identical repeat offender.  Payloads that do not
    decode as explanations at all pass through — the cache is generic
    keyed storage and its historical contract accepts arbitrary strings;
    only *decodable-but-wrong phi* is poison worth blocking here (the
    server's in-band auditor separately catches undecodable answers
    before its own put).  Honours ``DKS_QUALITY_AUDIT`` (screen off ⇒
    everything passes, the pre-quality behaviour)."""

    if not resolve_audit_env(True):
        return True
    try:
        arrays = payload_arrays(payload)
    except Exception:  # noqa: BLE001 — not an explanation document
        return True
    return not screen_arrays(arrays["shap_values"],
                             arrays["expected_value"],
                             arrays["raw_prediction"], path=path,
                             final_err=final_err)


# --------------------------------------------------------------------- #
# tier 1: in-band invariant auditor
# --------------------------------------------------------------------- #

class QualityAuditor:
    """Screens every served answer at finalize time; keeps a bounded
    repro ring of offenders for ``/qualityz``.  Pure host-side payload
    parsing — never touches the device, so it rides the finalizer
    threads within the ≤1 % overhead budget the bench enforces."""

    def __init__(self, enabled: bool = True, ring_size: int = DEFAULT_RING):
        self.enabled = bool(enabled)
        self.ring_size = int(ring_size)
        self._lock = lockwitness.make_lock("quality.auditor")
        self._ring: deque = deque(maxlen=self.ring_size)
        self._audited = 0
        self._violation_answers = 0
        self._flight = flightrec()
        # bound metric objects + label guard, injected by the monitor
        self._on_violation = None

    def audit(self, payload, model_id: Optional[str] = None,
              path: str = "sampled", final_err: float = 0.0,
              trace: Optional[str] = None
              ) -> Tuple[bool, Optional[Dict]]:
        """Screen one served payload.  Returns ``(ok, arrays-or-None)``
        — the parsed arrays are handed back so the shadow sampler never
        pays a second decode."""

        if not self.enabled:
            return True, None
        violations, arrays = screen_payload(payload, path=path,
                                            final_err=final_err)
        with self._lock:
            self._audited += 1
        if not violations:
            return True, arrays
        checks = [c for c, _ in violations]
        detail = "; ".join(d for _, d in violations)
        if isinstance(payload, (bytes, bytearray)):
            prefix = payload[:160].hex()
        else:
            prefix = str(payload)[:160]
        entry = {
            "ts": time.time(),
            "model": model_id or "default",
            "path": path,
            "checks": checks,
            "detail": detail,
            "final_err": float(final_err or 0.0),
            "trace": trace,
            "payload_prefix": prefix,
        }
        with self._lock:
            self._ring.append(entry)
            self._violation_answers += 1
        self._flight.record("quality_violation", model=model_id or "default",
                            path=path, checks=checks, detail=detail,
                            trace=trace)
        if self._on_violation is not None:
            for check in checks:
                self._on_violation(model_id, path, check)
        return False, arrays

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "audited_total": self._audited,
                "violation_answers_total": self._violation_answers,
                "ring_size": self.ring_size,
                "ring": list(self._ring),
            }


# --------------------------------------------------------------------- #
# tier 2: budgeted shadow-oracle sampler
# --------------------------------------------------------------------- #

class ShadowSampler:
    """Re-explains a sampled fraction of live answers at oracle
    fidelity on a background thread, under a hard device-seconds
    budget.  ``offer()`` is called from the serving finalizer (cheap:
    one RNG draw + a bounded deque append); ``drain_once()`` runs the
    oracle off the hot path."""

    def __init__(self, fraction: float = 0.0,
                 budget_s: float = DEFAULT_BUDGET_S,
                 costmeter=None,
                 oracle_nsamples: int = DEFAULT_ORACLE_NSAMPLES,
                 queue_size: int = DEFAULT_QUEUE,
                 series_size: int = DEFAULT_SERIES,
                 seed: int = 0):
        self.fraction = float(fraction)
        self.budget_s = float(budget_s)
        self.oracle_nsamples = int(oracle_nsamples)
        self.queue_size = int(queue_size)
        self.series_size = int(series_size)
        self._costmeter = costmeter
        self._lock = lockwitness.make_lock("quality.shadow")
        self._rng = random.Random(seed)
        self._queue: deque = deque()
        self._spent_s = 0.0          # wall-measured oracle seconds
        self._last_run_s = 0.0       # EWMA of one oracle run's cost
        self._max_run_s = 0.0        # costliest run seen (budget guard)
        self._exhausted = False
        self._offered = 0
        self._sampled = 0
        self._dropped = 0
        self._runs: Dict[str, int] = {}
        self._err: Dict[str, float] = {}
        self._series: Dict[str, deque] = {}

    # -- hot-path side -------------------------------------------------- #

    def offer(self, model_id: Optional[str], path: str, model,
              rows, served_sv) -> bool:
        """Maybe enqueue one live answer for shadow re-explanation.
        ``served_sv`` is the already-parsed phi list (the auditor's
        decode is reused — no second parse on the hot path)."""

        if self.fraction <= 0.0 or model is None or rows is None \
                or served_sv is None:
            return False
        with self._lock:
            self._offered += 1
            if self._exhausted or self._rng.random() >= self.fraction:
                return False
            if len(self._queue) >= self.queue_size:
                self._dropped += 1
                return False
            self._queue.append((model_id or "default", path, model,
                                rows, served_sv))
            self._sampled += 1
        return True

    # -- background side ------------------------------------------------ #

    def _budget_allows(self) -> bool:
        """A run may start only if the budget projects clean: spent plus
        the costliest run seen must stay under the hard cap.  A run
        cannot be preempted mid-explain, so the cap's contract is
        pre-gated: overspend is bounded by how much one run exceeds its
        projection (at most one run's cost in total).  The very first
        run has no estimate and is allowed — the operator contract is
        that the budget exceeds a single oracle run."""

        with self._lock:
            if self._exhausted:
                return False
            if self._spent_s + self._max_run_s >= self.budget_s:
                self._exhausted = True
                logger.warning(
                    "shadow-oracle budget exhausted: %.3fs spent of "
                    "%.3fs (DKS_QUALITY_BUDGET_S)", self._spent_s,
                    self.budget_s)
                return False
        return True

    def _oracle_kwargs(self, path: str, model) -> Dict:
        kwargs = {k: v for k, v in
                  dict(getattr(model, "explain_kwargs", None) or {}).items()
                  if k in ("nsamples", "l1_reg")}
        if path not in EXACT_PATHS:
            base = kwargs.get("nsamples")
            base = base if isinstance(base, int) else 0
            kwargs["nsamples"] = max(base, self.oracle_nsamples)
        return kwargs

    def drain_once(self) -> Optional[Dict]:
        """Run the oracle for at most one queued sample.  Returns
        ``{'model', 'path', 'err', 'rows', 'seconds'}`` when a run
        happened, else ``None``.  Device time is wall-bracketed for the
        budget AND settled to the cost meter under the ``_quality``
        system tenant (compile time excluded, the meter's rule)."""

        import numpy as np

        with self._lock:
            item = self._queue.popleft() if self._queue else None
        if item is None or not self._budget_allows():
            return None
        model_id, path, model, rows, served_sv = item
        rows = np.atleast_2d(np.asarray(rows))
        kwargs = self._oracle_kwargs(path, model)
        meter = self._costmeter
        tx = meter.begin() if meter is not None else None
        t0 = time.monotonic()
        try:
            explanation = model.explainer.explain(rows, silent=True,
                                                  **kwargs)
        except Exception:
            logger.exception("shadow-oracle re-explain failed for %s",
                             model_id)
            if meter is not None:
                meter.settle(tx, [(QUALITY_TENANT, 0, path,
                                   int(rows.shape[0]))])
            return None
        elapsed = time.monotonic() - t0
        if meter is not None:
            # the meter subtracts compile seconds; elapsed (wall) is the
            # conservative number the budget accrues
            meter.settle(tx, [(QUALITY_TENANT, 0, path,
                               int(rows.shape[0]))])
        oracle_sv = explanation.shap_values
        oracle_sv = oracle_sv if isinstance(oracle_sv, list) else [oracle_sv]
        k = min(len(oracle_sv), len(served_sv))
        err = 0.0
        for i in range(k):
            a = np.atleast_2d(np.asarray(served_sv[i], dtype=np.float64))
            b = np.atleast_2d(np.asarray(oracle_sv[i], dtype=np.float64))
            n = min(a.shape[0], b.shape[0])
            m = min(a.shape[1], b.shape[1])
            if n and m:
                err = max(err, float(np.abs(a[:n, :m] - b[:n, :m]).max()))
        now = time.time()
        with self._lock:
            self._spent_s += elapsed
            self._last_run_s = elapsed if self._last_run_s == 0.0 \
                else 0.5 * self._last_run_s + 0.5 * elapsed
            self._max_run_s = max(self._max_run_s, elapsed)
            self._runs[model_id] = self._runs.get(model_id, 0) + 1
            self._err[model_id] = err
            series = self._series.setdefault(
                model_id, deque(maxlen=self.series_size))
            series.append((now, err))
        return {"model": model_id, "path": path, "err": err,
                "rows": int(rows.shape[0]), "seconds": elapsed}

    def spent_seconds(self) -> float:
        with self._lock:
            return self._spent_s

    def retire(self, model_id: str) -> None:
        with self._lock:
            self._runs.pop(model_id, None)
            self._err.pop(model_id, None)
            self._series.pop(model_id, None)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "fraction": self.fraction,
                "budget_s": self.budget_s,
                "spent_s": self._spent_s,
                "max_run_s": self._max_run_s,
                "exhausted": self._exhausted,
                "offered": self._offered,
                "sampled": self._sampled,
                "dropped": self._dropped,
                "queued": len(self._queue),
                "tenants": {
                    mid: {"runs": self._runs.get(mid, 0),
                          "last_err": self._err.get(mid),
                          "series": [[t, e] for t, e in
                                     self._series.get(mid, ())]}
                    for mid in sorted(set(self._runs) | set(self._err))},
            }


# --------------------------------------------------------------------- #
# tier 3: hot-swap/canary drift sentinel
# --------------------------------------------------------------------- #

class CanarySentinel:
    """Golden canary set per tenant: a few background rows plus their
    phi, captured at registration.  ``swap_check`` replays the stored
    baseline against an incoming version *before the registry flips
    traffic*; the monitor thread replays periodically against the live
    model (catching silent drift between swaps — dead device handles,
    recompile changes, background mutation)."""

    def __init__(self, n_rows: int = DEFAULT_CANARY_ROWS):
        self.n_rows = int(n_rows)
        self._lock = lockwitness.make_lock("quality.canary")
        self._baselines: Dict[str, Dict] = {}
        self._drift: Dict[str, Dict] = {}
        self._flight = flightrec()

    def canary_rows(self, model):
        """Deterministic canary inputs for one model: the first few
        background rows (always in-distribution, always present on a
        fitted explainer).  ``None`` for models without an inspectable
        engine (stubs) — the sentinel then stays inert for them."""

        import numpy as np

        engine = getattr(getattr(model, "explainer", None), "_explainer",
                         None)
        background = getattr(engine, "background", None)
        if background is None:
            return None
        background = np.asarray(background)
        if background.ndim != 2 or not background.shape[0]:
            return None
        return np.array(background[:min(self.n_rows, background.shape[0])])

    def _phi(self, model, rows) -> List:
        kwargs = {k: v for k, v in
                  dict(getattr(model, "explain_kwargs", None) or {}).items()
                  if k in ("nsamples", "l1_reg")}
        explanation = model.explainer.explain(rows, silent=True, **kwargs)
        sv = explanation.shap_values
        return sv if isinstance(sv, list) else [sv]

    def capture(self, model_id: str, model,
                fingerprint: Optional[str] = None) -> bool:
        """(Re-)capture the golden baseline for one tenant from the
        version about to serve.  Returns whether a baseline exists."""

        rows = self.canary_rows(model)
        if rows is None:
            return False
        phi = self._phi(model, rows)
        with self._lock:
            self._baselines[model_id] = {
                "rows": rows, "phi": phi,
                "fingerprint": fingerprint, "ts": time.time()}
        return True

    def _max_drift(self, baseline_phi, phi) -> float:
        import numpy as np

        drift = 0.0
        for i in range(min(len(baseline_phi), len(phi))):
            a = np.atleast_2d(np.asarray(baseline_phi[i], dtype=np.float64))
            b = np.atleast_2d(np.asarray(phi[i], dtype=np.float64))
            n, m = min(a.shape[0], b.shape[0]), min(a.shape[1], b.shape[1])
            if n and m:
                drift = max(drift,
                            float(np.abs(a[:n, :m] - b[:n, :m]).max()))
        return drift

    def replay(self, model_id: str, model,
               record_event: bool = True) -> Optional[Dict]:
        """Replay the stored baseline's rows through ``model`` and
        quantify phi drift.  ``None`` when no baseline exists (first
        registration, stub model).  A drift verdict lands on the
        flight recorder as a ``swap_drift`` event."""

        with self._lock:
            base = self._baselines.get(model_id)
        if base is None:
            return None
        try:
            phi = self._phi(model, base["rows"])
        except Exception:
            logger.exception("canary replay failed for %s", model_id)
            return None
        drift = self._max_drift(base["phi"], phi)
        verdict = "ok" if drift <= DRIFT_TOLERANCE else "drift"
        result = {"model": model_id, "drift": drift, "verdict": verdict,
                  "rows": int(base["rows"].shape[0]), "ts": time.time()}
        with self._lock:
            self._drift[model_id] = result
        if record_event and verdict == "drift":
            self._flight.record("swap_drift", model=model_id, drift=drift,
                                rows=result["rows"],
                                threshold=DRIFT_TOLERANCE)
        return result

    def swap_check(self, model_id: str, model,
                   fingerprint: Optional[str] = None) -> Optional[Dict]:
        """Registry hook for one version flip: replay the OLD baseline
        against the NEW version (the drift verdict the ``model_swap``
        event carries), then re-capture the baseline from the version
        about to serve.  ``None`` on first registration."""

        verdict = self.replay(model_id, model)
        self.capture(model_id, model, fingerprint=fingerprint)
        return verdict

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._baselines)

    def retire(self, model_id: str) -> None:
        with self._lock:
            self._baselines.pop(model_id, None)
            self._drift.pop(model_id, None)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "threshold": DRIFT_TOLERANCE,
                "tenants": {
                    mid: {
                        "rows": int(base["rows"].shape[0]),
                        "fingerprint": base.get("fingerprint"),
                        "captured_ts": base.get("ts"),
                        "drift": self._drift.get(mid, {}).get("drift"),
                        "verdict": self._drift.get(mid, {}).get("verdict"),
                    } for mid, base in self._baselines.items()},
            }


# --------------------------------------------------------------------- #
# composition root
# --------------------------------------------------------------------- #

class QualityMonitor:
    """One per :class:`ExplainerServer` (the obs-check live catalog
    builds several servers in one process — per-registry, never a
    process singleton).  Owns the metric bindings, the ``/qualityz``
    document, the background drain/canary thread and the bounded tenant
    label guard."""

    def __init__(self, server=None, costmeter=None,
                 audit: Optional[bool] = None,
                 sample: Optional[float] = None,
                 budget_s: Optional[float] = None,
                 ring_size: int = DEFAULT_RING,
                 canary_interval_s: float = DEFAULT_CANARY_INTERVAL_S,
                 max_tenants: int = DEFAULT_MAX_TENANTS):
        self._server = server
        self.canary_interval_s = float(canary_interval_s)
        self.max_tenants = int(max_tenants)
        self.auditor = QualityAuditor(
            enabled=resolve_audit_env(True) if audit is None else audit,
            ring_size=ring_size)
        self.sampler = ShadowSampler(
            fraction=resolve_sample_env(0.0) if sample is None else sample,
            budget_s=resolve_budget_env() if budget_s is None else budget_s,
            costmeter=costmeter)
        self.sentinel = CanarySentinel()
        self.auditor._on_violation = self._count_violation
        self._label_lock = lockwitness.make_lock("quality.labels")
        self._labels: set = set()
        # deferred-audit queue: the serving finalizer enqueues (cheap —
        # one append + an event) and the monitor thread runs the actual
        # decode+screen, so the audit's cost never rides the GIL while a
        # waiter is trying to write the response out
        self._audit_lock = lockwitness.make_lock("quality.audit_queue")
        self._audit_queue: deque = deque()
        self._audit_dropped = 0
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_violations = None
        self._m_shadow_err = None
        self._m_shadow_runs = None
        self._m_canary = None

    # -- bounded tenant labels ------------------------------------------ #

    def label(self, model_id: Optional[str]) -> str:
        mid = "default" if not model_id else str(model_id)
        with self._label_lock:
            if mid in self._labels or len(self._labels) < self.max_tenants:
                self._labels.add(mid)
                return mid
        return OVERFLOW_LABEL

    # -- metrics -------------------------------------------------------- #

    def attach_metrics(self, registry) -> None:
        registry.counter(
            "dks_quality_audited_total",
            "Served answers screened by the in-band invariant auditor "
            "(additivity + NaN/Inf + anytime error-bound sanity, "
            "host-side at finalize time).").set_function(
            lambda: float(self.auditor.snapshot()["audited_total"]))
        self._m_violations = registry.counter(
            "dks_quality_violations_total",
            "Invariant-screen violations on served answers, by tenant, "
            "engine path and failed check (additivity | finite | "
            "error_bound | decode).  Offenders land on the flight "
            "recorder and the /qualityz repro ring.",
            labelnames=("model", "path", "check")).bound_cardinality(
            self.max_tenants * len(CHECKS) * 8)
        # the metric handles below are assigned once here, before start()
        # spawns the monitor thread; the thread only reads the references
        # dks: allow(DKS-C001): set-once-before-start handle
        self._m_shadow_err = registry.gauge(
            "dks_quality_shadow_err",
            "Last served-vs-oracle max-abs phi error per tenant from the "
            "budgeted shadow-oracle sampler (exact paths re-run as their "
            "own oracle; sampled paths re-run at high nsamples).",
            labelnames=("model",)).bound_cardinality(self.max_tenants)
        # dks: allow(DKS-C001): set-once-before-start handle
        self._m_shadow_runs = registry.counter(
            "dks_quality_shadow_runs_total",
            "Completed shadow-oracle re-explanations per tenant.",
            labelnames=("model",)).bound_cardinality(self.max_tenants)
        registry.counter(
            "dks_quality_shadow_seconds_total",
            "Wall seconds the shadow oracle has consumed — accrues "
            "toward the hard DKS_QUALITY_BUDGET_S cap; the same work is "
            "billed to the _quality tenant in dks_device_seconds_total."
        ).set_function(self.sampler.spent_seconds)
        # dks: allow(DKS-C001): set-once-before-start handle
        self._m_canary = registry.gauge(
            "dks_quality_canary_drift",
            "Max-abs phi drift of the latest canary replay per tenant "
            "(version flips replay before traffic moves; the monitor "
            "thread replays periodically).",
            labelnames=("model",)).bound_cardinality(self.max_tenants)

    def _count_violation(self, model_id: Optional[str], path: str,
                         check: str) -> None:
        if self._m_violations is not None:
            self._m_violations.inc(model=self.label(model_id),
                                   path=str(path), check=str(check))

    # -- hot-path entry point ------------------------------------------- #

    def inspect_answer(self, payload, model_id: Optional[str] = None,
                       path: str = "sampled", final_err: float = 0.0,
                       rows=None, model=None,
                       trace: Optional[str] = None) -> bool:
        """Tier-1 screen for one served answer (called from the server's
        ``_complete``); feeds the tier-2 sampler with the parsed arrays.
        Returns whether the answer passed (a failing answer must not be
        cached)."""

        if not self.auditor.enabled and self.sampler.fraction <= 0.0:
            return True
        ok, arrays = True, None
        if self.auditor.enabled:
            ok, arrays = self.auditor.audit(payload, model_id=model_id,
                                            path=path, final_err=final_err,
                                            trace=trace)
        if ok and self.sampler.fraction > 0.0 and arrays is None:
            # auditor off: the sampler pays its own decode
            try:
                arrays = payload_arrays(payload)
            except Exception:
                arrays = None
        if ok and arrays is not None:
            self.sampler.offer(model_id, path, model, rows,
                               arrays.get("shap_values"))
        return ok

    def enqueue_answer(self, payload, model_id: Optional[str] = None,
                       path: str = "sampled", final_err: float = 0.0,
                       rows=None, model=None, trace: Optional[str] = None,
                       cache=None, cache_key: Optional[str] = None) -> None:
        """Queue one served answer for the deferred invariant screen —
        the serving hot path's entry point (one bounded append; the
        screen itself runs on the monitor thread).  The queue is drained
        in batches on the monitor tick rather than per-enqueue: an
        immediate wake would contend for the GIL with the handler thread
        still writing the response out, putting the screen's cost right
        back on the latency path it was moved off of.  Detection latency
        is therefore bounded by the drain tick, not by traffic.  A
        cached answer that later fails the screen is invalidated out of
        ``cache`` (the insert stays on the finalizer; poison lives at
        most one drain cycle)."""

        if not self.auditor.enabled and self.sampler.fraction <= 0.0:
            return
        with self._audit_lock:
            if len(self._audit_queue) >= DEFAULT_AUDIT_QUEUE:
                self._audit_queue.popleft()  # drop-oldest under overload
                self._audit_dropped += 1
            self._audit_queue.append((payload, model_id, path, final_err,
                                      rows, model, trace, cache, cache_key))

    def _drain_audits(self) -> None:
        while True:
            with self._audit_lock:
                item = self._audit_queue.popleft() if self._audit_queue \
                    else None
            if item is None:
                return
            (payload, model_id, path, final_err, rows, model, trace,
             cache, cache_key) = item
            ok = self.inspect_answer(payload, model_id=model_id, path=path,
                                     final_err=final_err, rows=rows,
                                     model=model, trace=trace)
            if not ok and cache is not None and cache_key is not None:
                cache.invalidate(cache_key, audit=True)

    def audit_backlog(self) -> int:
        with self._audit_lock:
            return len(self._audit_queue)

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Wait until the deferred-audit queue is empty (tests/benches
        that need the screen's verdict for everything already served).
        Drains inline when no monitor thread is running."""

        deadline = time.monotonic() + timeout_s
        while True:
            with self._audit_lock:
                empty = not self._audit_queue
            if empty:
                return True
            if self._thread is None:
                self._drain_audits()
                continue
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.005)

    # -- swap / retirement hooks ---------------------------------------- #

    def swap_check(self, model_id: str, model,
                   fingerprint: Optional[str] = None) -> Optional[Dict]:
        verdict = self.sentinel.swap_check(model_id, model,
                                           fingerprint=fingerprint)
        if verdict is not None and self._m_canary is not None:
            self._m_canary.set(verdict["drift"], model=self.label(model_id))
        return verdict

    def retire_tenant(self, model_id: str, registry=None) -> None:
        """Drop one tenant's quality state and metric series (registry
        unregister path — label churn must not grow the registry)."""

        self.sampler.retire(model_id)
        self.sentinel.retire(model_id)
        with self._label_lock:
            self._labels.discard(str(model_id))
        if registry is not None:
            for name in ("dks_quality_violations_total",
                         "dks_quality_shadow_err",
                         "dks_quality_shadow_runs_total",
                         "dks_quality_canary_drift"):
                registry.retire_labels(name, {"model": str(model_id)})

    # -- background thread ---------------------------------------------- #

    def start(self, tick_s: float = 0.25) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, args=(tick_s,),
                                        daemon=True, name="dks-quality")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._work.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)
        self._drain_audits()  # bounded: leave no unscreened backlog behind

    def _active_models(self) -> List[Tuple[str, object]]:
        server = self._server
        if server is None:
            return []
        registry = getattr(server, "_registry", None)
        if registry is not None:
            try:
                return [(rm.model_id, rm.model)
                        for rm in registry.active_models()]
            except Exception:  # noqa: BLE001 — roster race, skip this sweep
                return []
        model = getattr(server, "model", None)
        return [("default", model)] if model is not None else []

    def _loop(self, tick_s: float) -> None:
        next_canary = time.monotonic() + self.canary_interval_s
        while not self._stop.is_set():
            self._work.wait(tick_s)  # enqueues wake the drain immediately
            self._work.clear()
            if self._stop.is_set():
                return
            try:  # guarded per-iteration: one bad sweep must not kill probing
                self._drain_audits()
                result = self.sampler.drain_once()
                if result is not None:
                    mid = self.label(result["model"])
                    if self._m_shadow_err is not None:
                        self._m_shadow_err.set(result["err"], model=mid)
                    if self._m_shadow_runs is not None:
                        self._m_shadow_runs.inc(model=mid)
                if self.canary_interval_s > 0 \
                        and time.monotonic() >= next_canary:
                    next_canary = time.monotonic() + self.canary_interval_s
                    self._periodic_canary()
            except Exception:  # noqa: BLE001
                logger.exception("quality monitor sweep failed")

    def _periodic_canary(self) -> None:
        known = set(self.sentinel.tenants())
        for model_id, model in self._active_models():
            if model is None:
                continue
            if model_id not in known:
                # registered before the server attached (no swap-check
                # hook ran): adopt a baseline so the NEXT sweep/swap has
                # something to drift against
                self.sentinel.capture(model_id, model)
                continue
            verdict = self.sentinel.replay(model_id, model)
            if verdict is not None and self._m_canary is not None:
                self._m_canary.set(verdict["drift"],
                                   model=self.label(model_id))

    # -- /qualityz ------------------------------------------------------ #

    def qualityz_payload(self, query_params: Optional[Dict] = None
                         ) -> Tuple[str, bytes]:
        audit = self.auditor.snapshot()
        with self._audit_lock:
            audit["backlog"] = len(self._audit_queue)
            audit["backlog_dropped"] = self._audit_dropped
        doc = {
            "component": "server",
            "audit": audit,
            "shadow": self.sampler.snapshot(),
            "canary": self.sentinel.snapshot(),
        }
        return "application/json", json.dumps(doc).encode("utf-8")


def stub_doc(component: str = "proxy") -> Dict:
    """The empty ``/qualityz`` document for components that serve the
    endpoint but audit nothing themselves (the fan-in proxy without
    ``?federate=1``)."""

    return {
        "component": component,
        "audit": {"enabled": False, "audited_total": 0,
                  "violation_answers_total": 0, "backlog": 0,
                  "backlog_dropped": 0, "ring_size": 0, "ring": []},
        "shadow": {"fraction": 0.0, "budget_s": 0.0, "spent_s": 0.0,
                   "max_run_s": 0.0, "exhausted": False, "offered": 0,
                   "sampled": 0, "dropped": 0, "queued": 0, "tenants": {}},
        "canary": {"threshold": DRIFT_TOLERANCE, "tenants": {}},
    }


def merge_quality_pages(pages: List[str]) -> str:
    """Fold per-replica ``/qualityz`` JSON pages into one fleet view
    (the proxy's ``?federate=1`` answer, same contract as the profiler's
    flamegraph fold): counters sum, repro rings concatenate newest-first
    under the ring bound, per-tenant shadow/canary sections keep the
    worst (max) error and sum run counts."""

    merged = stub_doc("fleet")
    merged["replicas"] = 0
    ring: List[Dict] = []
    audit, shadow, canary = (merged["audit"], merged["shadow"],
                             merged["canary"])
    for page in pages:
        try:
            doc = json.loads(page)
        except (ValueError, TypeError):
            continue
        merged["replicas"] += 1
        a = doc.get("audit", {})
        audit["enabled"] = audit["enabled"] or bool(a.get("enabled"))
        audit["audited_total"] += int(a.get("audited_total", 0))
        audit["violation_answers_total"] += \
            int(a.get("violation_answers_total", 0))
        audit["backlog"] += int(a.get("backlog", 0))
        audit["backlog_dropped"] += int(a.get("backlog_dropped", 0))
        audit["ring_size"] = max(audit["ring_size"],
                                 int(a.get("ring_size", 0)))
        ring.extend(a.get("ring", []))
        s = doc.get("shadow", {})
        for key in ("spent_s", "budget_s", "fraction"):
            shadow[key] += float(s.get(key, 0.0))
        shadow["max_run_s"] = max(shadow["max_run_s"],
                                  float(s.get("max_run_s", 0.0)))
        for key in ("offered", "sampled", "dropped", "queued"):
            shadow[key] += int(s.get(key, 0))
        shadow["exhausted"] = shadow["exhausted"] or bool(s.get("exhausted"))
        for mid, t in (s.get("tenants") or {}).items():
            agg = shadow["tenants"].setdefault(
                mid, {"runs": 0, "last_err": None, "series": []})
            agg["runs"] += int(t.get("runs", 0))
            err = t.get("last_err")
            if err is not None:
                agg["last_err"] = err if agg["last_err"] is None \
                    else max(agg["last_err"], err)
            agg["series"].extend(t.get("series", []))
        c = doc.get("canary", {})
        canary["threshold"] = max(canary["threshold"],
                                  float(c.get("threshold", 0.0)))
        for mid, t in (c.get("tenants") or {}).items():
            prev = canary["tenants"].get(mid)
            if prev is None or (t.get("drift") or 0.0) >= \
                    (prev.get("drift") or 0.0):
                canary["tenants"][mid] = t
    ring.sort(key=lambda e: e.get("ts", 0.0), reverse=True)
    bound = audit["ring_size"] or DEFAULT_RING
    audit["ring"] = ring[:bound]
    for agg in shadow["tenants"].values():
        agg["series"] = sorted(agg["series"])[-DEFAULT_SERIES:]
    return json.dumps(merged)
