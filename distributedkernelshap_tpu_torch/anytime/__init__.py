"""Anytime KernelSHAP of the PyTorch port: progressive-refinement estimation
under an error-budget contract (port of ``distributedkernelshap_tpu/anytime``).

The sampled estimator runs in **rounds** (geometric coalition schedule,
``rounds.py``): every round appends a block of paired coalition draws to
the WLS sufficient statistics accumulated on the device (``engine.py``: the
Gram/moment state carries across rounds, nothing is recomputed), solves
the constrained WLS from the running totals and emits a partial phi plus
a split-half convergence estimate (``convergence.py``, calibrated by
``calibration.py``).  ``rounds``, ``calibration`` and ``convergence`` are
host numpy copies of the reference's modules; ``engine`` runs on torch
tensors, and its linear route launches ``fused_linear_ey`` on CUDA.
"""

from distributedkernelshap_tpu_torch.anytime.calibration import (  # noqa: F401
    calibration_factor,
    fit_calibration,
)
from distributedkernelshap_tpu_torch.anytime.convergence import (  # noqa: F401
    monotone_min,
)
from distributedkernelshap_tpu_torch.anytime.rounds import (  # noqa: F401
    RoundSchedule,
    build_schedule,
    round_draw_mask,
)
