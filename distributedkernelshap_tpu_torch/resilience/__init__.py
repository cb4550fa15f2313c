"""Fault injection for the serving layer of the PyTorch port (port of
``distributedkernelshap_tpu/resilience/``).

* :mod:`~distributedkernelshap_tpu_torch.resilience.faults` — the
  deterministic, seedable fault-injection harness (crash / hang / slow /
  connection drop / corrupt payload) wired into the real serving code
  paths via ``DKS_FAULTS`` or ``ExplainerServer(fault_injector=...)``.

The journal, request hedging and replica supervision wait for ROADMAP.md
queue A items 12b and 12c.
"""

from distributedkernelshap_tpu_torch.resilience.faults import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    from_env,
    parse_faults,
)
