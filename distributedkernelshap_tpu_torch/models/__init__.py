from distributedkernelshap_tpu_torch.models.predictors import (  # noqa: F401
    BasePredictor,
    LinearPredictor,
    as_predictor,
)
from distributedkernelshap_tpu_torch.models.trees import TreeEnsemblePredictor  # noqa: F401
