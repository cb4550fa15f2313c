"""The model registry's graph lift and path classifier (port of
``distributedkernelshap_tpu/registry/``): ONNX graphs onto port
predictors, and the ONE engine-path classifier the serving wrappers
auto-select from.  The registry itself waits for ROADMAP.md queue A
item 12c."""

from distributedkernelshap_tpu_torch.registry.classify import (  # noqa: F401
    ENGINE_PATHS,
    PathDecision,
    classify_path,
)
from distributedkernelshap_tpu_torch.registry.onnx_lift import (  # noqa: F401
    SUPPORTED_ONNX_OPS,
    GraphSpec,
    NodeSpec,
    UnsupportedOpError,
    lift_graph,
    lift_onnx,
)
