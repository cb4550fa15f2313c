"""The model registry's graph lift (port of ``distributedkernelshap_tpu/
registry/``): ONNX graphs onto port predictors.  The path classifier and
the registry itself wait for ROADMAP.md queue A item 12c."""

from distributedkernelshap_tpu_torch.registry.onnx_lift import (  # noqa: F401
    SUPPORTED_ONNX_OPS,
    GraphSpec,
    NodeSpec,
    UnsupportedOpError,
    lift_graph,
    lift_onnx,
)
