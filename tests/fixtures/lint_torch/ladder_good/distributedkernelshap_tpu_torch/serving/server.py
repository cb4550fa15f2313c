"""Mini server: the warmup rung passes the model's explain_path."""

from distributedkernelshap_tpu_torch.runtime.compile_cache import shape_signature


def warm_rung(model, b):
    return shape_signature(b, getattr(model, "explain_path", None))
