"""HTTP serving of the PyTorch port (port of ``distributedkernelshap_tpu/
serving/``): the model wrappers, the single-process ``ExplainerServer``,
the client and the JSON / binary wire, and the pod fabric that serves one
mesh from several processes (``multihost``)."""

from distributedkernelshap_tpu_torch.serving.wrappers import (  # noqa: F401
    BatchKernelShapModel,
    KernelShapModel,
)
from distributedkernelshap_tpu_torch.serving.server import ExplainerServer, serve_explainer  # noqa: F401
from distributedkernelshap_tpu_torch.serving.client import distribute_requests, explain_request  # noqa: F401
from distributedkernelshap_tpu_torch.serving.multihost import (  # noqa: F401
    MultihostServingModel,
    follower_loop,
    serve_multihost,
)
