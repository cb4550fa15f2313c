from distributedkernelshap_tpu_torch.scheduling.scheduler import (  # noqa: F401
    DEFAULT_CLASS_BUDGETS_S,
    PRIORITY_CLASSES,
    FIFOScheduler,
    SLOScheduler,
    StagingBuffer,
    make_scheduler,
)
from distributedkernelshap_tpu_torch.scheduling.admission import (  # noqa: F401
    AdmissionController,
    AdmissionDecision,
    ServiceRateEstimator,
    TokenBucket,
)
from distributedkernelshap_tpu_torch.scheduling.result_cache import (  # noqa: F401
    ResultCache,
    array_fingerprint,
    model_fingerprint,
    request_cache_key,
)
