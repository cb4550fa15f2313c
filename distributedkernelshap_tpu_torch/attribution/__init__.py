"""Deep-model attribution (DeepSHAP/DeepLIFT backprop), port of
``distributedkernelshap_tpu/attribution/``: for lifted neural graphs the
graph itself is the cheaper explainer — one forward and backward pair per
(instance, background row) instead of ``nsamples`` forward passes over
synthetic coalitions.  ``attribution/deepshap.py`` implements the
layer-rule engine over ``registry/onnx_lift.GraphSpec`` graphs; the engine
takes it under ``nsamples='exact'`` (the ``'deepshap'`` flavour)."""

from distributedkernelshap_tpu_torch.attribution.deepshap import (  # noqa: F401
    attach_deepshap_metrics,
    brute_force_shapley,
    build_deepshap_fn,
    deepshap_fallback_counts,
    deepshap_ready,
    record_deepshap_fallback,
    supports_deepshap,
    validate_deepshap,
)
