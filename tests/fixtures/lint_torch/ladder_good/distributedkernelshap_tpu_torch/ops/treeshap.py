"""Mini exact-tree ops: the fallback counter family."""


def attach_fallback_metrics(registry):
    registry.counter("dks_treeshap_fallback_total",
                     "Exact-path fallbacks by reason.",
                     labelnames=("reason",))
