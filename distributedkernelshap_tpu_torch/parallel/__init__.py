"""One process over many devices (``mesh``, ``coalition_sharding``,
``distributed``) and dispatch pipelining (``pipeline``).  Several processes
are ROADMAP.md queue A item 10."""

from distributedkernelshap_tpu_torch.parallel.mesh import (  # noqa: F401
    device_mesh,
    initialize_multihost,
    local_device_count,
)
from distributedkernelshap_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedExplainer,
    invert_permutation,
    kernel_shap_postprocess_fn,
    kernel_shap_target_fn,
)
