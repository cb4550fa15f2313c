"""Fault injection and fault tolerance for the serving and batch layers of
the PyTorch port (port of ``distributedkernelshap_tpu/resilience/``).

* :mod:`~distributedkernelshap_tpu_torch.resilience.faults` — the
  deterministic, seedable fault-injection harness (crash / hang / slow /
  connection drop / corrupt payload) wired into the real serving code
  paths via ``DKS_FAULTS`` or ``ExplainerServer(fault_injector=...)``;
* :mod:`~distributedkernelshap_tpu_torch.resilience.supervisor` — replica
  process supervision with crash-loop exponential backoff + jitter,
  feeding liveness into the fan-in proxy;
* :mod:`~distributedkernelshap_tpu_torch.resilience.journal` —
  chunk-granular checkpoint/resume for long batch runs, keyed by a
  content fingerprint of the model (fingerprint change ⇒ journal
  ignored);
* :mod:`~distributedkernelshap_tpu_torch.resilience.hedging` — tail-latency
  request hedging with per-class streaming quantile tracking.
"""

from distributedkernelshap_tpu_torch.resilience.faults import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    from_env,
    parse_faults,
)
from distributedkernelshap_tpu_torch.resilience.hedging import (  # noqa: F401
    HedgePolicy,
    LatencyQuantiles,
)
from distributedkernelshap_tpu_torch.resilience.journal import (  # noqa: F401
    ShardJournal,
    journal_fingerprint,
)
from distributedkernelshap_tpu_torch.resilience.supervisor import (  # noqa: F401
    ReplicaSupervisor,
    RestartPolicy,
)
