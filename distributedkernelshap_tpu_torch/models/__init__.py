from distributedkernelshap_tpu_torch.models.predictors import (  # noqa: F401
    BasePredictor,
    CallbackPredictor,
    LinearPredictor,
    TorchPredictor,
    as_predictor,
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
