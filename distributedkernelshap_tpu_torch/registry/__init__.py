"""The multi-tenant model registry of the PyTorch port (port of
``distributedkernelshap_tpu/registry/``): the registry itself (many
models behind one gateway, hot swap, per-tenant quotas), ONNX graphs onto
port predictors, and the ONE engine-path classifier the serving wrappers
auto-select from."""

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
from distributedkernelshap_tpu_torch.registry.registry import (  # noqa: F401
    ModelRegistry,
    RegisteredModel,
    TenantQuota,
)
