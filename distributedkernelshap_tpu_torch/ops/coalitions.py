"""Coalition sampling plan for KernelSHAP.

Copy of ``distributedkernelshap_tpu/ops/coalitions.py`` for the PyTorch port
(pure numpy; plans must stay ``array_equal`` with the JAX package's).
Re-derivation of the coalition enumeration/sampling strategy that
the reference delegates to shap 0.35's ``KernelExplainer`` (contract described
in SURVEY.md §2.2; surfaced tunables ``nsamples``/``l1_reg`` documented at
``explainers/kernel_shap.py:836-845``).

Key design departure from the CPU reference: the per-instance, data-dependent
Python loop ("detect varying features, enumerate or sample per instance")
becomes a **static, host-side plan** computed once per ``(M, nsamples, seed)``
configuration:

* If all ``2^M - 2`` non-trivial coalitions fit in the budget, they are fully
  enumerated with exact Shapley-kernel weights — the downstream weighted
  least-squares solve then recovers *exact* Shapley values.
* Otherwise, subset sizes are completed greedily from the outside in (size
  ``s`` paired with ``M-s``, largest kernel mass first) while they fit, and
  the remaining budget is sampled: sizes drawn proportionally to leftover
  kernel mass, random subsets with paired complements, duplicates merged by
  weight accumulation, rows padded with zero weight back to a fixed count so
  the jitted computation never retraces across seeds.

Because the plan is static, the mask matrix is a compile-time constant shared
by every instance in a batch: the WLS Gram matrix is factorised once per
batch instead of once per instance — the single biggest algorithmic win over
the reference's per-instance solve.
"""

import math
from dataclasses import dataclass
from itertools import combinations
from typing import Optional

import numpy as np


def default_nsamples(M: int) -> int:
    """shap 0.35's default coalition budget: ``2*M + 2**11``."""
    return 2 * M + 2 ** 11


def kernel_size_masses(M: int) -> np.ndarray:
    """Total Shapley-kernel probability mass per subset size ``s = 1..M-1``.

    The kernel weight of one size-``s`` coalition is
    ``(M-1) / (C(M,s) * s * (M-s))``; multiplying by the ``C(M,s)`` subsets of
    that size gives the per-size mass ``(M-1)/(s*(M-s))``, normalised to 1.
    """

    s = np.arange(1, M)
    mass = (M - 1) / (s * (M - s))
    return mass / mass.sum()


@dataclass(frozen=True)
class CoalitionPlan:
    """Static coalition plan: mask matrix + row weights.

    Attributes
    ----------
    mask
        ``(S, M)`` float32 0/1 matrix; row ``i`` is coalition ``z_i``.
    weights
        ``(S,)`` float32 row weights summing to 1 (padded rows weigh 0).
    exact
        True when all ``2^M - 2`` coalitions are enumerated (Shapley values
        from the WLS solve are then exact up to float error).
    n_enumerated
        Number of leading rows that are deterministically enumerated.
    """

    mask: np.ndarray
    weights: np.ndarray
    exact: bool
    n_enumerated: int

    @property
    def n_rows(self) -> int:
        return self.mask.shape[0]


def plan_fingerprint(plan: "CoalitionPlan") -> str:
    """Stable CONTENT fingerprint of a plan: sha256 over the mask and
    weight bytes (plus shapes, so transposed aliases cannot collide).

    Device-constant caches used to key by ``id(plan)``; a garbage-collected
    plan whose address got recycled by a different plan would then silently
    serve the old plan's device constants.  Content keying makes that
    impossible — equal bytes ARE the same constants.  Memoised on the plan
    object (frozen dataclasses still carry a ``__dict__``), so the hash is
    paid once per plan, not once per explain.
    """

    cached = plan.__dict__.get("_content_fp")
    if cached is not None:
        return cached
    import hashlib

    h = hashlib.sha256()
    mask = np.ascontiguousarray(plan.mask)
    weights = np.ascontiguousarray(plan.weights)
    h.update(repr((mask.shape, str(mask.dtype), weights.shape,
                   str(weights.dtype))).encode())
    h.update(mask.tobytes())
    h.update(weights.tobytes())
    fp = h.hexdigest()
    object.__setattr__(plan, "_content_fp", fp)
    return fp


def _enumerate_size(M: int, s: int) -> np.ndarray:
    rows = np.zeros((math.comb(M, s), M), dtype=np.float32)
    for i, idx in enumerate(combinations(range(M), s)):
        rows[i, list(idx)] = 1.0
    return rows


def coalition_plan(M: int,
                   nsamples: Optional[int] = None,
                   seed: int = 0,
                   pair_sampling: bool = True) -> CoalitionPlan:
    """Build the static coalition plan for ``M`` feature groups.

    Parameters
    ----------
    M
        Number of (grouped) features varied during perturbation.
    nsamples
        Coalition budget; defaults to ``2*M + 2**11`` like shap 0.35.
    seed
        Seed for the sampled remainder (numpy Generator; deterministic).
    pair_sampling
        Emit the complement of every sampled coalition as well (variance
        reduction, mirrors shap's paired sampling).
    """

    if M < 1:
        raise ValueError(f"Need at least one feature group, got M={M}")
    if M == 1:
        # single group: phi = f(x) - E[f] by the additivity constraint alone
        return CoalitionPlan(
            mask=np.zeros((1, 1), dtype=np.float32),
            weights=np.ones((1,), dtype=np.float32),
            exact=True,
            n_enumerated=1,
        )

    if nsamples is None:
        nsamples = default_nsamples(M)
    nsamples = int(nsamples)

    total = 2 ** M - 2 if M <= 62 else np.inf
    size_mass = kernel_size_masses(M)  # index s-1

    if total <= nsamples:
        # exact path: enumerate every non-trivial coalition
        blocks, weights = [], []
        for s in range(1, M):
            rows = _enumerate_size(M, s)
            blocks.append(rows)
            weights.append(np.full(rows.shape[0], size_mass[s - 1] / rows.shape[0], dtype=np.float64))
        mask = np.concatenate(blocks, 0)
        w = np.concatenate(weights, 0)
        return CoalitionPlan(
            mask=mask,
            weights=(w / w.sum()).astype(np.float32),
            exact=True,
            n_enumerated=mask.shape[0],
        )

    # ---- sampled path ----------------------------------------------------
    # complete size pairs (s, M-s) greedily while they fit in the budget
    blocks, weights = [], []
    remaining_budget = nsamples
    weight_left = 1.0
    enumerated_sizes = set()
    n_pairs = M // 2  # pairs (1,M-1), (2,M-2), ...; middle size alone if M even
    for k in range(1, n_pairs + 1):
        pair = [k] if 2 * k == M else [k, M - k]
        count = sum(math.comb(M, s) for s in pair)
        if count > remaining_budget:
            break
        for s in pair:
            rows = _enumerate_size(M, s)
            blocks.append(rows)
            weights.append(np.full(rows.shape[0], size_mass[s - 1] / rows.shape[0], dtype=np.float64))
            weight_left -= size_mass[s - 1]
            enumerated_sizes.add(s)
        remaining_budget -= count

    n_enumerated = sum(b.shape[0] for b in blocks)
    sampled_sizes = [s for s in range(1, M) if s not in enumerated_sizes]

    if sampled_sizes and remaining_budget > 0:
        rng = np.random.default_rng(seed)
        probs = size_mass[np.array(sampled_sizes) - 1]
        probs = probs / probs.sum()

        if pair_sampling:
            # draw budget//2 complement pairs; an odd budget gets one final
            # unpaired draw so the plan never exceeds `nsamples` rows
            n_pairs_draw = remaining_budget // 2
            n_single = remaining_budget % 2
            n_draw = n_pairs_draw + n_single
        else:
            n_pairs_draw, n_single = 0, 0
            n_draw = remaining_budget
        sizes = rng.choice(np.array(sampled_sizes), size=n_draw, p=probs)
        sampled = np.zeros((n_draw, M), dtype=np.float32)
        for i, s in enumerate(sizes):
            sampled[i, rng.permutation(M)[:s]] = 1.0
        if pair_sampling:
            # complement of each paired draw, interleaved; the odd draw
            # (if any) is appended on its own
            rows = np.empty((2 * n_pairs_draw + n_single, M), dtype=np.float32)
            rows[0:2 * n_pairs_draw:2] = sampled[:n_pairs_draw]
            rows[1:2 * n_pairs_draw:2] = 1.0 - sampled[:n_pairs_draw]
            if n_single:
                rows[-1] = sampled[-1]
        else:
            rows = sampled

        # merge duplicates, accumulating counts -> weights
        uniq, inv, counts = np.unique(rows, axis=0, return_inverse=True, return_counts=True)
        w_sampled = counts.astype(np.float64)
        w_sampled *= weight_left / w_sampled.sum()

        # pad back to a fixed row count so shapes are seed-independent
        pad = remaining_budget - uniq.shape[0]
        if pad > 0:
            uniq = np.concatenate([uniq, np.zeros((pad, M), dtype=np.float32)], 0)
            w_sampled = np.concatenate([w_sampled, np.zeros(pad)], 0)
        blocks.append(uniq.astype(np.float32))
        weights.append(w_sampled)

    mask = np.concatenate(blocks, 0)
    w = np.concatenate(weights, 0)
    return CoalitionPlan(
        mask=mask,
        weights=(w / w.sum()).astype(np.float32),
        exact=False,
        n_enumerated=n_enumerated,
    )
