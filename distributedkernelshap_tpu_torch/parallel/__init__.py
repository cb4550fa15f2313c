"""A mesh of devices driven from one process or from several processes
joined by ``torch.distributed`` (``mesh``, ``coalition_sharding``,
``distributed``) and dispatch pipelining (``pipeline``)."""

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
