"""Round schedules and incremental coalition generation.

A copy of ``distributedkernelshap_tpu/anytime/rounds.py`` (host numpy,
no framework), kept in the port so it imports nothing of the JAX package.

The classic plan (``ops/coalitions.coalition_plan``) spends its whole
``nsamples`` budget at once: greedy complete size-pairs, then sampled
draws for the leftover kernel mass.  The anytime schedule splits the SAME
estimator into rounds:

* round 0 carries the **enumerated block** (identical greedy outside-in
  size-pair completion, fixed kernel-mass weights) plus a first block of
  paired sampled draws;
* every later round appends a further block of paired draws, sizes drawn
  from the leftover-mass distribution.

Draw blocks are generated from a per-round seeded Generator
(``SeedSequence((seed, round))``), so round ``r`` is reproducible without
replaying rounds ``0..r-1`` — the resumability contract.  Each block's
row count is a multiple of 4 so complement-pairs split evenly into the
two convergence strata (pairs alternate between strata; splitting a pair
ACROSS strata would correlate the halves and bias the variance estimate
low).  Duplicates are NOT merged inside a block: a repeated row simply
contributes twice to the accumulated Gram/moment sums, which is exactly
the weight accumulation ``coalition_plan``'s dedup performs (counts ARE
weights), without a data-dependent row count.
"""

import hashlib
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from distributedkernelshap_tpu_torch.ops.coalitions import (
    _enumerate_size,
    default_nsamples,
    kernel_size_masses,
)

#: default refinement depth: 4 geometric rounds double the cumulative
#: draw budget per round (the last round lands on the full classic
#: budget, so "schedule exhausted" answers match the fixed-nsamples
#: estimator's sample count)
DEFAULT_ROUNDS = 4
DEFAULT_GROWTH = 2.0

#: smallest per-round draw block (must stay a multiple of 4 — see the
#: strata-split contract above)
MIN_ROUND_DRAWS = 8


def _round4(n: int) -> int:
    return max(MIN_ROUND_DRAWS, 4 * math.ceil(n / 4))


@dataclass(frozen=True)
class RoundSchedule:
    """Static anytime schedule for ``M`` feature groups.

    Attributes
    ----------
    enum_mask / enum_weights
        The round-0 enumerated size-pair block and its fixed kernel-mass
        weights (summing to ``1 - weight_left``); empty arrays when no
        pair fits the round-0 budget.
    weight_left
        Kernel mass carried by the sampled sizes — the scale applied to
        the accumulated unit-count draw statistics.
    sampled_sizes / size_probs
        Non-enumerated subset sizes and their normalised leftover-mass
        draw distribution.
    draws
        Per-round sampled-row counts (paired complements included); each
        a positive multiple of 4.
    """

    M: int
    seed: int
    enum_mask: np.ndarray
    enum_weights: np.ndarray
    weight_left: float
    sampled_sizes: np.ndarray
    size_probs: np.ndarray
    draws: Tuple[int, ...]

    @property
    def n_rounds(self) -> int:
        return len(self.draws)

    @property
    def n_enumerated(self) -> int:
        return int(self.enum_mask.shape[0])

    def cumulative_draws(self, round_idx: int) -> int:
        """Total draw rows accumulated after round ``round_idx`` ran."""

        return int(sum(self.draws[:round_idx + 1]))

    def cumulative_nsamples(self, round_idx: int) -> int:
        return self.n_enumerated + self.cumulative_draws(round_idx)

    def fingerprint(self) -> str:
        """Content fingerprint (mirrors ``plan_fingerprint``): keys the
        device-constant cache, so equal bytes ARE the same constants."""

        cached = self.__dict__.get("_content_fp")
        if cached is not None:
            return cached
        h = hashlib.sha256()
        h.update(repr((self.M, self.seed, self.draws,
                       float(self.weight_left))).encode())
        h.update(np.ascontiguousarray(self.enum_mask).tobytes())
        h.update(np.ascontiguousarray(self.enum_weights).tobytes())
        h.update(np.ascontiguousarray(self.sampled_sizes).tobytes())
        fp = h.hexdigest()
        object.__setattr__(self, "_content_fp", fp)
        return fp


def build_schedule(M: int,
                   nsamples: Optional[int] = None,
                   rounds: int = DEFAULT_ROUNDS,
                   growth: float = DEFAULT_GROWTH,
                   seed: int = 0) -> Optional[RoundSchedule]:
    """Build the anytime round schedule, or ``None`` when refinement
    cannot help: ``M < 2`` (additivity alone determines phi), a budget
    that enumerates every coalition exactly, or a round-0 budget whose
    greedy completion already covers every subset size (no sampled mass
    left to refine)."""

    if M < 2:
        return None
    total = int(nsamples) if nsamples not in (None, "auto") else \
        default_nsamples(M)
    if M <= 62 and 2 ** M - 2 <= total:
        return None

    size_mass = kernel_size_masses(M)
    rounds = max(1, int(rounds))
    # cumulative geometric targets ending exactly on the full budget
    cums = [max(MIN_ROUND_DRAWS,
                int(round(total / growth ** (rounds - r))))
            for r in range(1, rounds + 1)]
    cums[-1] = total

    # greedy outside-in size-pair completion within the round-0 budget —
    # the same loop as coalition_plan, so round 0 IS the classic plan's
    # enumerated block at this budget
    blocks, weights = [], []
    remaining = cums[0]
    weight_left = 1.0
    enumerated_sizes = set()
    for k in range(1, M // 2 + 1):
        pair = [k] if 2 * k == M else [k, M - k]
        count = sum(math.comb(M, s) for s in pair)
        if count > remaining:
            break
        for s in pair:
            rows = _enumerate_size(M, s)
            blocks.append(rows)
            weights.append(np.full(rows.shape[0],
                                   size_mass[s - 1] / rows.shape[0],
                                   dtype=np.float64))
            weight_left -= size_mass[s - 1]
            enumerated_sizes.add(s)
        remaining -= count

    sampled_sizes = np.array(
        [s for s in range(1, M) if s not in enumerated_sizes])
    if sampled_sizes.size == 0 or weight_left <= 0.0:
        return None

    if blocks:
        enum_mask = np.concatenate(blocks, 0).astype(np.float32)
        enum_weights = np.concatenate(weights, 0).astype(np.float32)
    else:
        enum_mask = np.zeros((0, M), dtype=np.float32)
        enum_weights = np.zeros((0,), dtype=np.float32)

    probs = size_mass[sampled_sizes - 1]
    probs = probs / probs.sum()

    n_enum = enum_mask.shape[0]
    draws = [_round4(cums[0] - n_enum)]
    for r in range(1, rounds):
        draws.append(_round4(cums[r] - cums[r - 1]))

    return RoundSchedule(
        M=M, seed=int(seed), enum_mask=enum_mask,
        enum_weights=enum_weights, weight_left=float(weight_left),
        sampled_sizes=sampled_sizes, size_probs=probs,
        draws=tuple(draws))


def round_draw_mask(schedule: RoundSchedule, round_idx: int) -> np.ndarray:
    """The round's ``(draws[round_idx], M)`` 0/1 draw block.

    Paired complements interleaved: pair ``j`` occupies rows ``2j`` and
    ``2j+1``.  Deterministic from ``(seed, round_idx)`` alone — a resumed
    run regenerates round ``r`` without replaying earlier rounds, and a
    from-scratch run at the same schedule produces byte-identical rows.
    """

    if not 0 <= round_idx < schedule.n_rounds:
        raise IndexError(
            f"round {round_idx} outside schedule of {schedule.n_rounds}")
    n = schedule.draws[round_idx]
    M = schedule.M
    rng = np.random.default_rng(
        np.random.SeedSequence((schedule.seed, 0x414E5954, round_idx)))
    n_pairs = n // 2
    sizes = rng.choice(schedule.sampled_sizes, size=n_pairs,
                       p=schedule.size_probs)
    sampled = np.zeros((n_pairs, M), dtype=np.float32)
    for i, s in enumerate(sizes):
        sampled[i, rng.permutation(M)[:s]] = 1.0
    rows = np.empty((n, M), dtype=np.float32)
    rows[0::2] = sampled
    rows[1::2] = 1.0 - sampled
    return rows
