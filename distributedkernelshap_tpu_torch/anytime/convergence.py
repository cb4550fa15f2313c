"""Split-half convergence estimation for the anytime estimator.

A copy of ``distributedkernelshap_tpu/anytime/convergence.py`` (host numpy,
no framework), kept in the port so it imports nothing of the JAX package.

The per-round draw blocks alternate complement-pairs between two strata
(``rounds.round_draw_mask``): stratum A accumulates the even pairs'
Gram/moment sums, stratum B the odd pairs'.  Solving the constrained WLS
from each stratum alone (plus the shared enumerated block) yields two
half-sample phi estimates whose half-gap ``|phi_a - phi_b| / 2``
estimates the sampling error of the pooled estimate — the classic
split-half (2-fold jackknife) variance proxy, computed from statistics
the engine accumulates anyway, so the estimate is device-cheap.

The raw gap is calibrated (``calibration.py``) and reported as a running
minimum across rounds (:func:`monotone_min`): more samples never
*increase* what we claim to know, which is the monotonicity leg of the
serving contract (``benchmarks/anytime_bench.py --check``).
"""

import numpy as np

from distributedkernelshap_tpu_torch.anytime.calibration import (
    ERR_FLOOR,
    calibration_factor,
)


def calibrated_err(raw_gap: np.ndarray, round_idx: int,
                   table=None) -> np.ndarray:
    """Per-feature calibrated error estimate from the raw split-half gap
    (``(B, M)``), floored at :data:`~distributedkernelshap_tpu_torch.anytime.
    calibration.ERR_FLOOR`."""

    factor = calibration_factor(round_idx, table)
    return np.maximum(np.asarray(raw_gap, dtype=np.float32) * factor,
                      ERR_FLOOR).astype(np.float32)


def monotone_min(prev: np.ndarray, cur: np.ndarray) -> np.ndarray:
    """Running minimum of reported error across rounds (``prev`` may be
    ``None`` on the first round)."""

    if prev is None:
        return np.asarray(cur, dtype=np.float32)
    return np.minimum(prev, cur).astype(np.float32)
