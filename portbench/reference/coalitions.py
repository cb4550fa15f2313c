"""The KernelSHAP coalition plan, worked out from ``(M, nsamples, seed)``.

The configuration fixes the plan's rule (shap 0.35's budget ``2 M + 2**11``
and its sampling, as the port documents it): coalition sizes are enumerated
in pairs ``(s, M - s)`` from the outside in while their count fits the
budget, each enumerated coalition weighted by its size's Shapley-kernel
mass shared evenly; the rest of the budget is sampled from
``numpy.random.default_rng(seed)``: half the rows drawn as sizes in
proportion to the sizes' leftover mass, each a random subset of that size
followed by its complement (one unpaired draw for an odd budget),
duplicates merged by count, the leftover mass shared in proportion to the
counts, zero-weight empty rows padding the plan to the budget.  Weights are
normalised in float64 and stored as float32.
"""

from itertools import combinations
from math import comb

import numpy as np


def default_nsamples(M: int) -> int:
    return 2 * M + 2 ** 11


def size_masses(M: int) -> np.ndarray:
    """Shapley-kernel mass of each coalition size 1..M-1, summing to 1."""

    s = np.arange(1, M, dtype=np.float64)
    mass = (M - 1) / (s * (M - s))
    return mass / mass.sum()


def _all_of_size(M: int, s: int) -> np.ndarray:
    out = np.zeros((comb(M, s), M), np.float32)
    for r, members in enumerate(combinations(range(M), s)):
        out[r, list(members)] = 1.0
    return out


def plan(M: int, nsamples=None, seed: int = 0):
    """``(mask (S, M) float32 0/1, weights (S,) float32)`` of the plan."""

    if M == 1:
        return np.zeros((1, 1), np.float32), np.ones(1, np.float32)
    budget = default_nsamples(M) if nsamples is None else int(nsamples)
    mass = size_masses(M)
    rows, weights = [], []
    if 2 ** M - 2 <= budget:
        for s in range(1, M):
            block = _all_of_size(M, s)
            rows.append(block)
            weights.append(np.full(len(block), mass[s - 1] / len(block)))
    else:
        left_mass, left_budget, done = 1.0, budget, set()
        for k in range(1, M // 2 + 1):
            sizes = [k] if 2 * k == M else [k, M - k]
            need = sum(comb(M, s) for s in sizes)
            if need > left_budget:
                break
            for s in sizes:
                block = _all_of_size(M, s)
                rows.append(block)
                weights.append(np.full(len(block), mass[s - 1] / len(block)))
                left_mass -= mass[s - 1]
                done.add(s)
            left_budget -= need
        open_sizes = np.array([s for s in range(1, M) if s not in done])
        if len(open_sizes) and left_budget > 0:
            rng = np.random.default_rng(seed)
            p = mass[open_sizes - 1] / mass[open_sizes - 1].sum()
            pairs, odd = divmod(left_budget, 2)
            drawn_sizes = rng.choice(open_sizes, size=pairs + odd, p=p)
            drawn = np.zeros((pairs + odd, M), np.float32)
            for r, s in enumerate(drawn_sizes):
                drawn[r, rng.permutation(M)[:s]] = 1.0
            seq = np.zeros((2 * pairs + odd, M), np.float32)
            seq[0:2 * pairs:2] = drawn[:pairs]
            seq[1:2 * pairs:2] = 1.0 - drawn[:pairs]
            if odd:
                seq[-1] = drawn[-1]
            uniq, counts = np.unique(seq, axis=0, return_counts=True)
            w = counts.astype(np.float64) * (left_mass / counts.sum())
            pad = left_budget - len(uniq)
            rows.append(np.concatenate([uniq, np.zeros((max(pad, 0), M), np.float32)]))
            weights.append(np.concatenate([w, np.zeros(max(pad, 0))]))
    mask = np.concatenate(rows).astype(np.float32)
    w = np.concatenate(weights)
    return mask, (w / w.sum()).astype(np.float32)
