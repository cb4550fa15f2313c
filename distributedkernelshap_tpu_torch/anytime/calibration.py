"""Calibration of the split-half convergence estimate.

A copy of ``distributedkernelshap_tpu/anytime/calibration.py`` (host numpy,
no framework), kept in the port so it imports nothing of the JAX package.

The raw split-half gap (``convergence.py``) is an *estimate* of the
estimator's sampling error, not a bound: at small draw counts it can be
optimistic by chance.  The serving contract ("reported error bars bound
true error within x2 at >=90% of rounds", gated by ``make
accuracy-gate``) therefore applies a calibration factor fitted offline
against the exact ground-truth paths (exact-TN / exact-tree / deepshap
via ``benchmarks/estimator_accuracy.py --families anytime``).

The default table was fitted on the accuracy bench's linear/logistic
reference tasks; ``fit_calibration`` re-derives a factor from recorded
``(raw_gap, true_err)`` pairs when the gate detects drift.
"""

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

#: default multiplier applied to the raw split-half gap.  Early rounds
#: carry few draws per stratum, so their gap estimate is noisier — the
#: per-round overrides widen them (fitted offline, see module docstring).
DEFAULT_FACTOR = 4.0

#: per-round-index overrides of :data:`DEFAULT_FACTOR`
DEFAULT_TABLE: Dict[int, float] = {0: 6.0, 1: 5.0}

#: reported error never drops below this floor while draws remain — a
#: zero split-half gap (tiny strata agreeing by chance) must not report
#: certainty the estimator does not have
ERR_FLOOR = 1e-6


def calibration_factor(round_idx: int,
                       table: Optional[Dict[int, float]] = None) -> float:
    """The multiplier for round ``round_idx`` (``table`` overrides the
    default per-round table; missing rounds fall back to
    :data:`DEFAULT_FACTOR`)."""

    t = DEFAULT_TABLE if table is None else table
    return float(t.get(int(round_idx), DEFAULT_FACTOR))


def fit_calibration(pairs: Sequence[Tuple[float, float]],
                    coverage: float = 0.95) -> float:
    """Fit a single calibration factor from ``(raw_gap, true_err)``
    pairs: the smallest multiplier such that ``factor * raw_gap``
    bounds ``true_err`` at the requested coverage quantile.

    Pairs with a zero raw gap are clamped to :data:`ERR_FLOOR` (the same
    floor the runtime applies), so a degenerate gap cannot demand an
    infinite factor."""

    if not pairs:
        return DEFAULT_FACTOR
    ratios = [t / max(r, ERR_FLOOR) for r, t in pairs]
    return float(np.quantile(np.asarray(ratios, dtype=np.float64),
                             min(max(coverage, 0.0), 1.0)))
