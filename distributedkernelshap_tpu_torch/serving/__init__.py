"""HTTP serving of the PyTorch port (port of ``distributedkernelshap_tpu/
serving/``): the model wrappers, the single-process ``ExplainerServer``,
the client and the JSON / binary wire.  The multi-host entry points are
exported as in the reference and raise ``NotImplementedError`` until
ROADMAP.md queue A item 10."""

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
