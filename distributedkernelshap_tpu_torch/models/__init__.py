from distributedkernelshap_tpu_torch.models.predictors import (  # noqa: F401
    BasePredictor,
    CallbackPredictor,
    LinearPredictor,
    TorchPredictor,
    as_predictor,
)
from distributedkernelshap_tpu_torch.models.quadratic import (  # noqa: F401
    QuadraticDiscriminantPredictor,
    lift_gaussian_quadratic,
)
from distributedkernelshap_tpu_torch.models.svm import (  # noqa: F401
    SVMPredictor,
    lift_svm,
)
from distributedkernelshap_tpu_torch.models.compose import (  # noqa: F401
    AffineOutputPredictor,
    CalibratedBinaryPredictor,
    MeanEnsemblePredictor,
    OneVsRestPredictor,
    PipelinePredictor,
    StackingPredictor,
)
from distributedkernelshap_tpu_torch.models.lgbm import (  # noqa: F401
    lift_lightgbm,
    predictor_from_lightgbm_dump,
)
from distributedkernelshap_tpu_torch.models.tensor_net import (  # noqa: F401
    TensorTrainPredictor,
    fit_tt_surrogate,
)
from distributedkernelshap_tpu_torch.models.torch_lift import (  # noqa: F401
    TorchMLPPredictor,
    lift_torch,
    mlp_stages,
)
from distributedkernelshap_tpu_torch.models.trees import (  # noqa: F401
    TreeEnsemblePredictor,
    lift_tree_ensemble,
)
from distributedkernelshap_tpu_torch.models.xgb import (  # noqa: F401
    lift_xgboost,
    predictor_from_xgboost_json,
)
