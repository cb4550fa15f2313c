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
``csrc/exact_tree_inter.cu`` (wrappers in ``ops/cuda_kernels.py``).  The
engine's serving entry points (instance chunks through
``parallel/pipeline.py``, staged async explains, anytime rounds in
``anytime/``, ``profiling.py`` phases, ``KernelShap.save`` / ``load``) drive
the same kernels.  XGBoost and LightGBM dumps (``models/xgb.py``,
``models/lgbm.py``) and IsolationForest lift to tree ensembles, affine
output heads (``models/compose.AffineOutputPredictor``) keep the exact path,
and tensor-train predictors (``models/tensor_net.py``) take the exact
size-indexed contraction of ``ops/tensor_shap.py`` under
``nsamples='exact'``.  SVMs (``models/svm.py``), Gaussian quadratic
classifiers (``models/quadratic.py``) and scikit-learn compositions
(``models/compose.py``: pipelines, voting, bagging, stacking, one-vs-rest,
calibrated, search-CV, AdaBoost, transformed-target) lift too; a
``Pipeline(scaler, LogisticRegression)`` folds into one
``LinearPredictor`` and takes ``fused_linear_ey``, and the linear members
of forwarding ensembles launch it through ``LinearPredictor.masked_ey``.
``KernelShap(..., distributed_opts={'n_devices': n})`` explains over a mesh
of devices driven from this process (``parallel/``), every shard running
the same kernels.
"""

from distributedkernelshap_tpu_torch.interface import (  # noqa: F401
    DEFAULT_DATA_KERNEL_SHAP,
    DEFAULT_META_KERNEL_SHAP,
    Explainer,
    Explanation,
    FitMixin,
    NumpyEncoder,
)
from distributedkernelshap_tpu_torch.utils import Bunch, batch, get_filename, methdispatch  # noqa: F401
from distributedkernelshap_tpu_torch.data import Data, DenseData, DenseDataWithIndex  # noqa: F401
from distributedkernelshap_tpu_torch.kernel_shap import (  # noqa: F401
    DISTRIBUTED_OPTS,
    KERNEL_SHAP_BACKGROUND_THRESHOLD,
    KERNEL_SHAP_PARAMS,
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
from distributedkernelshap_tpu_torch.models.compose import (  # noqa: F401
    AffineOutputPredictor,
    CalibratedBinaryPredictor,
    MeanEnsemblePredictor,
    OneVsRestPredictor,
    PipelinePredictor,
    StackingPredictor,
)
from distributedkernelshap_tpu_torch.models.quadratic import (  # noqa: F401
    QuadraticDiscriminantPredictor,
    lift_gaussian_quadratic,
)
from distributedkernelshap_tpu_torch.models.svm import SVMPredictor, lift_svm  # noqa: F401
from distributedkernelshap_tpu_torch.models.tensor_net import (  # noqa: F401
    TensorTrainPredictor,
    fit_tt_surrogate,
)
from distributedkernelshap_tpu_torch.models.torch_lift import TorchMLPPredictor  # noqa: F401
from distributedkernelshap_tpu_torch.models.trees import TreeEnsemblePredictor  # noqa: F401

__version__ = "0.1.0"
