"""Federated fleet telemetry: merge per-replica expositions into one
page and roll per-tenant cost up across the fleet.

Podracer's host/mesh split (PAPERS.md, arXiv 2104.06272) assumes exactly
the per-host telemetry rollup the ``FanInProxy`` lacked: every replica
exposes its own ``/metrics``, so answering "how many device-seconds did
tenant X consume across the fleet" meant N scrapes and hand-written
PromQL.  This module is the merge/rollup core behind the proxy's two new
read paths:

* ``GET /metrics?federate=1`` — every routable replica's exposition,
  merged into ONE compliant page with a ``replica`` label distinguishing
  the sources (:func:`merge_expositions`): HELP/TYPE rendered once per
  family, per-replica histogram series kept separately monotone, the
  whole page re-validating under ``validate_exposition``.
* ``GET /fleetz`` — the interpreted rollup (:func:`fleet_rollup`):
  per-tenant device-seconds / rows / requests / errors / sheds / wire
  bytes summed across replicas, per-tenant SLO budget remaining (the
  minimum across replicas — the fleet is only as healthy as its worst
  member), top-N tenants by cost, and the trace exemplars that link an
  SLO breach to concrete Perfetto-viewable traces.

**Conflicting TYPE lines**: two replicas disagreeing on a family's type
(a mid-rolling-upgrade fleet) cannot produce a valid merged family.  The
merge keeps the FIRST-seen replica's type and DROPS the conflicting
replicas' samples for that family (counted in the merge report) — a
deterministic rule that keeps the page valid instead of emitting a
family that fails bucket/type validation downstream.

Pure functions over parsed expositions — no sockets here; the proxy owns
the scraping (pooled connections, timeouts, error accounting).
"""

import time
from typing import Dict, List, Optional, Sequence, Tuple

from distributedkernelshap_tpu_torch.observability.metrics import (
    _escape_help,
    _escape_label_value,
    format_value,
    parse_exposition,
)

#: the label the merge stamps on every federated sample; a replica-side
#: sample already carrying it is overwritten (the proxy's view of which
#: replica answered wins — it is the one that scraped)
REPLICA_LABEL = "replica"

#: tenants listed in the rollup's top-by-cost table
TOP_TENANTS = 10


def _render_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(str(v))}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def merge_expositions(pages: Dict[str, str],
                      replica_label: str = REPLICA_LABEL
                      ) -> Tuple[str, Dict]:
    """Merge per-replica exposition pages (``{replica_value: page_text}``)
    into one compliant page with ``replica_label`` stamped on every
    sample.  Returns ``(merged_text, report)`` where ``report`` carries
    ``{"families": n, "samples": n, "replicas": [...],
    "type_conflicts": [(family, replica, type), ...],
    "parse_failures": [(replica, error), ...]}``.

    Merge rules (see module doc): HELP/TYPE once per family
    (first-seen replica wins — iteration follows ``pages`` order, which
    the proxy keeps sorted by replica index for determinism); samples of
    a replica whose TYPE conflicts with the established one are dropped
    and reported; histogram sample ordering within one (replica, series)
    preserves the source page's bucket order, so per-series bucket
    monotonicity survives the merge."""

    families: "Dict[str, Dict]" = {}
    order: List[str] = []
    report = {"families": 0, "samples": 0, "replicas": list(pages),
              "type_conflicts": [], "parse_failures": []}
    for replica, text in pages.items():
        try:
            parsed = parse_exposition(text)
        except ValueError as e:
            report["parse_failures"].append((replica, str(e)))
            continue
        for fam, info in parsed.items():
            if not info["samples"]:
                continue
            existing = families.get(fam)
            if existing is None:
                families[fam] = {"type": info["type"] or "untyped",
                                 "help": info["help"] or fam,
                                 "samples": []}
                order.append(fam)
            elif (info["type"] or "untyped") != existing["type"]:
                # conflicting TYPE (untyped counts as its own type —
                # merging an untyped replica's plain samples into a
                # histogram family, or histogram samples into an
                # untyped one, breaks sample grouping downstream):
                # this replica's samples for the family cannot merge
                # validly — drop them, loudly
                report["type_conflicts"].append(
                    (fam, replica, info["type"] or "untyped"))
                continue
            for name, labels, value in info["samples"]:
                merged = dict(labels)
                merged[replica_label] = str(replica)
                families[fam]["samples"].append((name, merged, value))
    lines: List[str] = []
    for fam in order:
        info = families[fam]
        lines.append(f"# HELP {fam} {_escape_help(info['help'])}")
        lines.append(f"# TYPE {fam} {info['type']}")
        for name, labels, value in info["samples"]:
            lines.append(f"{name}{_render_labels(labels)} "
                         f"{format_value(value)}")
        report["samples"] += len(info["samples"])
    report["families"] = len(order)
    return ("\n".join(lines) + "\n") if lines else "\n", report


# --------------------------------------------------------------------- #
# rollup
# --------------------------------------------------------------------- #

def _sum_counter(parsed: Dict, name: str, by_label: str = "model",
                 skip_labels: Sequence[str] = ()) -> Dict[str, float]:
    """Sum one family's samples by one label value (histograms excluded;
    use the ``_sum``/``_count`` derived names for those)."""

    out: Dict[str, float] = {}
    fam = parsed.get(name)
    if not fam:
        return out
    for sample_name, labels, value in fam["samples"]:
        if sample_name != name:
            continue  # histogram-derived samples handled by caller
        if any(labels.get(s) for s in skip_labels):
            continue
        key = labels.get(by_label)
        if key is None:
            continue
        out[key] = out.get(key, 0.0) + value
    return out


def _tenant_block(parsed: Dict) -> Dict[str, Dict]:
    """Per-tenant scalar sums from ONE replica's parsed exposition."""

    tenants: Dict[str, Dict] = {}

    def fold(field: str, values: Dict[str, float]) -> None:
        for model, v in values.items():
            tenants.setdefault(model, {})[field] = \
                tenants.get(model, {}).get(field, 0.0) + v

    device = {}
    fam = parsed.get("dks_device_seconds_total")
    if fam:
        for name, labels, value in fam["samples"]:
            model = labels.get("model")
            if model is None:
                continue
            device[model] = device.get(model, 0.0) + value
    fold("device_seconds", device)
    fold("rows", _sum_counter(parsed, "dks_tenant_rows_total"))
    fold("requests", _sum_counter(parsed, "dks_tenant_requests_total"))
    fold("errors", _sum_counter(parsed, "dks_tenant_errors_total"))
    fold("cache_hits", _sum_counter(parsed, "dks_tenant_cache_hits_total"))
    sheds = {}
    fam = parsed.get("dks_tenant_sheds_total")
    if fam:
        for name, labels, value in fam["samples"]:
            model = labels.get("model")
            if model is not None:
                sheds[model] = sheds.get(model, 0.0) + value
    fold("sheds", sheds)
    # device-memory ledger gauge (observability/memledger.py): computed
    # device bytes by owning model — the capacity twin of device_seconds
    # (gauge, so the fleet sum is a point-in-time footprint)
    mem = {}
    fam = parsed.get("dks_device_bytes")
    if fam:
        for name, labels, value in fam["samples"]:
            model = labels.get("model")
            if model is None:
                continue
            mem[model] = mem.get(model, 0.0) + value
    fold("device_bytes", mem)
    wire = parsed.get("dks_tenant_wire_bytes_total")
    if wire:
        for name, labels, value in wire["samples"]:
            model, direction = labels.get("model"), labels.get("direction")
            if model is None or direction not in ("rx", "tx"):
                continue
            field = f"wire_bytes_{direction}"
            tenants.setdefault(model, {})[field] = \
                tenants.get(model, {}).get(field, 0.0) + value
    return tenants


def _tenant_of_slo(slo_name: str) -> Optional[str]:
    """The model id behind a templated per-tenant SLO name
    (``tenant:<id>_latency`` / ``tenant:<id>_availability`` — see
    ``slo.tenant_slos``), or ``None`` for fleet-level SLOs."""

    if not slo_name.startswith("tenant:"):
        return None
    return slo_name[len("tenant:"):].rsplit("_", 1)[0]


def fleet_rollup(parsed_pages: Dict[str, Dict],
                 exemplars: Optional[Dict[str, List[Dict]]] = None,
                 replica_meta: Optional[Dict[str, Dict]] = None,
                 top_n: int = TOP_TENANTS,
                 now: Optional[float] = None) -> Dict:
    """The ``/fleetz`` document from per-replica parsed expositions
    (``{replica_value: parse_exposition(page)}``), optional per-replica
    exemplar lists (each entry as ``Histogram.exemplars`` yields them)
    and optional replica metadata (address, state).  Stable schema —
    documented in docs/OBSERVABILITY.md — consumed by operators, the
    autoscaler and the cost-attribution bench alike."""

    tenants: Dict[str, Dict] = {}
    budgets: Dict[str, float] = {}
    per_replica_device: Dict[str, Dict[str, float]] = {}
    slo_budgets: Dict[str, float] = {}
    for replica, parsed in parsed_pages.items():
        block = _tenant_block(parsed)
        for model, fields in block.items():
            agg = tenants.setdefault(model, {})
            for field, v in fields.items():
                agg[field] = agg.get(field, 0.0) + v
            if fields.get("device_seconds"):
                per_replica_device.setdefault(model, {})[replica] = \
                    round(fields["device_seconds"], 6)
        fam = parsed.get("dks_slo_budget_remaining")
        if fam:
            # ONE pass feeds both views: the per-SLO fleet minima and —
            # for templated tenant SLOs — the per-tenant minimum over
            # the tenant's objectives and the replicas
            for name, labels, value in fam["samples"]:
                slo = labels.get("slo")
                if not slo:
                    continue
                slo_budgets[slo] = min(
                    slo_budgets.get(slo, float("inf")), value)
                model = _tenant_of_slo(slo)
                if model is not None:
                    budgets[model] = min(budgets.get(model, float("inf")),
                                         value)
    for model, agg in tenants.items():
        for field, v in list(agg.items()):
            agg[field] = round(v, 6)
        agg["answered_ok"] = round(
            agg.get("requests", 0.0) - agg.get("errors", 0.0), 6)
        if model in budgets:
            agg["budget_remaining"] = round(budgets[model], 6)
        agg["per_replica_device_seconds"] = per_replica_device.get(model, {})
    top = sorted(tenants.items(),
                 key=lambda kv: -kv[1].get("device_seconds", 0.0))[:top_n]
    merged_exemplars: List[Dict] = []
    for replica, entries in (exemplars or {}).items():
        for e in entries:
            e = dict(e)
            e["replica"] = str(replica)
            merged_exemplars.append(e)
    merged_exemplars.sort(key=lambda e: -float(e.get("value", 0.0)))
    # the replica block covers every replica the sweep ATTEMPTED
    # (replica_meta), not just the ones that answered — an operator must
    # see scraped=false for the member missing from the sums
    replica_keys = (list(replica_meta) if replica_meta
                    else [str(r) for r in parsed_pages])
    return {
        "generated_at": time.time() if now is None else now,
        "replicas": {str(r): dict(replica_meta.get(str(r), {})
                                  if replica_meta else {})
                     for r in replica_keys},
        "tenants": tenants,
        "top_tenants_by_cost": [[model, agg.get("device_seconds", 0.0)]
                                for model, agg in top],
        "fleet": {
            "device_seconds": round(sum(
                a.get("device_seconds", 0.0) for a in tenants.values()), 6),
            "requests": round(sum(
                a.get("requests", 0.0) for a in tenants.values()), 6),
            "answered_ok": round(sum(
                a.get("answered_ok", 0.0) for a in tenants.values()), 6),
        },
        "slo_budget_remaining": {k: round(v, 6)
                                 for k, v in sorted(slo_budgets.items())},
        "exemplars": merged_exemplars[:64],
    }
