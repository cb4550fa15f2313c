"""PyTorch + CUDA port of ``distributedkernelshap_tpu`` (KernelSHAP on an
NVIDIA GPU).

The JAX package stays the reference; this package imports neither JAX nor
anything of it.  Entry points run on the current CUDA device unless the
caller passes ``device='cpu'``, and raise when there is no GPU and no device
was given.  The masked evaluation of the linear fast path runs in the
hand-written kernel ``csrc/fused_linear_ey.cu``; tree ensembles and MLPs take
their structure-aware ``masked_ey``, other device predictors (``nn.Module``s,
torch functions) row materialisation, and black-box host callables
(``CallbackPredictor``) either that route or, with
``EngineConfig(host_eval=True)``, host evaluation.  Exact TreeSHAP
(``nsamples='exact'`` on lifted tree ensembles) runs in
``csrc/exact_tree_phi.cu`` and its Shapley interactions (``interactions=True``) in
``csrc/exact_tree_inter.cu`` (wrappers in ``ops/cuda_kernels.py``).
"""

from distributedkernelshap_tpu_torch.data import DenseData  # noqa: F401
from distributedkernelshap_tpu_torch.interface import Explanation  # noqa: F401
from distributedkernelshap_tpu_torch.kernel_shap import (  # noqa: F401
    EngineConfig,
    KernelExplainerEngine,
    KernelShap,
    rank_by_importance,
    rank_interaction_pairs,
    sum_categories,
)
from distributedkernelshap_tpu_torch.models.predictors import (  # noqa: F401
    CallbackPredictor,
    LinearPredictor,
    TorchPredictor,
    as_predictor,
)
from distributedkernelshap_tpu_torch.models.torch_lift import TorchMLPPredictor  # noqa: F401
from distributedkernelshap_tpu_torch.models.trees import TreeEnsemblePredictor  # noqa: F401
