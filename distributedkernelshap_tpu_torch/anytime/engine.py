"""The resumable round engine: accumulated WLS sufficient statistics.

Port of ``distributedkernelshap_tpu/anytime/engine.py``.  Both halves of
the constrained WLS normal equations are **sums over coalition rows**
(``ops/explain.normal_equations``), so a round adds its draw block's
contribution to running totals and the solve from the totals is *the same
estimator* as a single-shot solve over the concatenated rows.

Decomposition (round ``k``, draw scale ``wl = weight_left``):

* ``A(k)   = A_enum + (wl / N_k) * (A_a + A_b)``
* ``rhs(k) = rhs_enum + (wl / N_k) * (rhs_a + rhs_b)``

where ``A_enum`` / ``rhs_enum`` come from the fixed-weight enumerated
block (``A_enum`` does not depend on X: a device constant), the ``a`` /
``b`` accumulators sum **unit-count** per-draw statistics split by
convergence stratum, and ``N_k`` is the cumulative draw count.  Solving
each stratum alone yields the split-half convergence estimate
(``convergence.py``) from state the engine carries anyway.

A round function is a plain function on tensors (there is no jit).  The
run's state is a flat dict of device tensors that each round rebinds to
new tensors: every update is out of place, so neither the plan-constant
cache entry (``consts``, shared by every run) nor a state tensor that an
exported snapshot or another run still holds is ever written.  The masked
evaluation of a round block takes the same three-way dispatch as
``ops/explain.build_explainer_fn``: the linear route (on CUDA tensors the
hand-written kernel ``fused_linear_ey``), a predictor's ``masked_ey``, or
row materialisation.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from distributedkernelshap_tpu_torch.anytime.rounds import RoundSchedule
from distributedkernelshap_tpu_torch.ops.explain import (
    _auto_chunk,
    _ey_generic,
    _ey_linear,
    _use_masked_ey,
    normal_rhs,
    record_kernel_path,
    resolve_use_kernel,
    solve_from_normal,
    wls_operand,
)
from distributedkernelshap_tpu_torch.ops.links import convert_to_link

#: state-dict keys carried across rounds
STATE_KEYS = ("X", "fx", "fx_minus_e", "rhs_enum",
              "A_a", "A_b", "rhs_a", "rhs_b")


def build_ey_fn(predictor, config) -> Callable:
    """``ey(X, bg, bgw_n, mask, G) -> (B, S, K)`` with the masked-evaluation
    dispatch of ``ops/explain.build_explainer_fn`` (the linear route,
    structure-aware ``masked_ey``, row materialisation), so a round block's
    expected outputs take the same ops as the classic single-shot plan's.
    The linear route launches ``fused_linear_ey`` on CUDA tensors (unless
    ``config.use_kernel`` is False) and runs its plain version on CPU
    tensors; ``_ey_linear`` records which."""

    linear = predictor.linear_decomposition

    def ey(X, bg, bgw_n, mask, G):
        B, D = X.shape
        N = bg.shape[0]
        S, M = mask.shape
        K = predictor.n_outputs
        if linear is not None:
            W, b, activation = linear
            chunk = config.coalition_chunk or _auto_chunk(
                S, B * N * K, config.target_chunk_elems)
            return _ey_linear(W, b, activation, X, bg, bgw_n, mask, G, chunk,
                              use_kernel=resolve_use_kernel(config.use_kernel,
                                                            X.device))
        if _use_masked_ey(predictor, B, N, S, M, config):
            ey = predictor.masked_ey(X, bg, bgw_n, mask, G,
                                     config.target_chunk_elems,
                                     coalition_chunk=config.coalition_chunk)
            # recorded after the call: a linear member's _ey_linear records
            # its own route inside it
            record_kernel_path('ey', 'masked_ey')
            return ey
        record_kernel_path('ey', 'generic')
        zc = mask @ G
        chunk = config.coalition_chunk or _auto_chunk(
            S, B * N * D, config.target_chunk_elems)
        return _ey_generic(predictor, X, bg, bgw_n, zc, chunk)

    return ey


def _unit_normal_equations(mask, ey_adj, fx_minus_e):
    """Unit-weight Gram/moment contribution of a draw block: the ``w = 1``
    case of ``ops/explain.normal_equations`` (counts become weights at
    solve time through the ``wl / N_k`` scale)."""

    zl = mask[:, -1]
    Zt = mask[:, :-1] - zl[:, None]
    A = Zt.T @ Zt
    return A, normal_rhs(Zt, wls_operand(ey_adj, zl, fx_minus_e))


def build_anytime_consts_fn(predictor, config, link: str) -> Callable:
    """The precompute function of the anytime constants that do not depend
    on X: the background on the device, normalised weights, the link-space
    expected value, and the enumerated block's weighted Gram matrix and
    eliminated mask columns.  The engine keeps its result in the
    plan-constant cache."""

    link_fn = convert_to_link(link)

    @torch.no_grad()
    def consts(bg, bgw, enum_mask, enum_w, G):
        bg = bg.to(torch.float32)
        bgw_n = bgw / torch.sum(bgw)
        e_out = torch.einsum("nk,n->k", predictor(bg), bgw_n)
        out = {"bg": bg, "bgw_n": bgw_n, "G": G,
               "enum_mask": enum_mask,
               "expected_value": link_fn(e_out)}
        zl = enum_mask[:, -1]
        Zt = enum_mask[:, :-1] - zl[:, None]
        Aw = Zt * enum_w[:, None]
        out.update(zl_enum=zl, Aw_enum=Aw, A_enum=Aw.T @ Zt)
        return out

    return consts


def build_round_fn(predictor, config, link: str, ridge: float,
                   schedule: RoundSchedule, round_idx: int) -> Callable:
    """The round function for ``round_idx``.

    Round 0: ``(Xp, draw_mask, consts) -> (phi, raw_gap, state)``: evaluates
    the model on ``Xp``, builds the enumerated block's right-hand sides and
    seeds the stratum accumulators from the first draw block.  Later
    rounds: ``(state, draw_mask, consts) -> ...``: pure accumulation into
    new tensors; nothing from earlier rounds is recomputed, and neither
    ``state`` nor ``consts`` is written."""

    link_fn = convert_to_link(link)
    ey_fn = build_ey_fn(predictor, config)
    wl = schedule.weight_left
    n_half = schedule.cumulative_draws(round_idx) / 2.0
    has_enum = schedule.n_enumerated > 0
    M = schedule.M

    def _accumulate(state, draw_mask, consts):
        S = draw_mask.shape[0]
        B = state["X"].shape[0]
        K = predictor.n_outputs
        e_val = consts["expected_value"]
        ey_d = ey_fn(state["X"], consts["bg"], consts["bgw_n"],
                     draw_mask, consts["G"])
        ey_adj = link_fn(ey_d) - e_val[None, None, :]
        # complement-pairs alternate strata in blocks of 4 rows (pair 2t ->
        # stratum a, pair 2t+1 -> stratum b); splitting a PAIR across
        # strata would correlate the halves (rounds.round_draw_mask).  The
        # (B, S, K) ey is contiguous, row (b, s, k) at (b*S + s)*K + k, as
        # the kernel writes it, so the quads are a plain reshape
        quads_m = draw_mask.reshape(S // 4, 4, M)
        quads_e = ey_adj.reshape(B, S // 4, 4, K)
        mask_a = quads_m[:, :2].reshape(-1, M)
        mask_b = quads_m[:, 2:].reshape(-1, M)
        ey_a = quads_e[:, :, :2].reshape(B, -1, K)
        ey_b = quads_e[:, :, 2:].reshape(B, -1, K)
        dA_a, drhs_a = _unit_normal_equations(mask_a, ey_a,
                                              state["fx_minus_e"])
        dA_b, drhs_b = _unit_normal_equations(mask_b, ey_b,
                                              state["fx_minus_e"])
        new_state = dict(state)
        new_state.update(A_a=state["A_a"] + dA_a,
                         A_b=state["A_b"] + dA_b,
                         rhs_a=state["rhs_a"] + drhs_a,
                         rhs_b=state["rhs_b"] + drhs_b)
        return new_state

    def _solve(state, consts):
        fx_minus_e = state["fx_minus_e"]
        if has_enum:
            A0, rhs0 = consts["A_enum"], state["rhs_enum"]
        else:
            A0, rhs0 = 0.0, 0.0
        scale = wl / (2.0 * n_half)
        phi = solve_from_normal(
            A0 + scale * (state["A_a"] + state["A_b"]),
            rhs0 + scale * (state["rhs_a"] + state["rhs_b"]),
            fx_minus_e, ridge)
        sa = wl / n_half
        phi_a = solve_from_normal(A0 + sa * state["A_a"],
                                  rhs0 + sa * state["rhs_a"],
                                  fx_minus_e, ridge)
        phi_b = solve_from_normal(A0 + sa * state["A_b"],
                                  rhs0 + sa * state["rhs_b"],
                                  fx_minus_e, ridge)
        raw_gap = 0.5 * torch.amax(torch.abs(phi_a - phi_b), dim=1)  # (B, M)
        return phi, raw_gap

    if round_idx == 0:
        @torch.no_grad()
        def round0(Xp, draw_mask, consts):
            X = Xp.to(torch.float32)
            B = X.shape[0]
            K = predictor.n_outputs
            e_val = consts["expected_value"]
            fx = link_fn(predictor(X))
            fx_minus_e = fx - e_val[None, :]
            if has_enum:
                ey_e = ey_fn(X, consts["bg"], consts["bgw_n"],
                             consts["enum_mask"], consts["G"])
                ey_adj_e = link_fn(ey_e) - e_val[None, None, :]
                rhs_enum = normal_rhs(consts["Aw_enum"],
                                      wls_operand(ey_adj_e, consts["zl_enum"], fx_minus_e))
            else:
                rhs_enum = X.new_zeros((B, K, M - 1))
            zero_A = X.new_zeros((M - 1, M - 1))
            zero_rhs = X.new_zeros((B, K, M - 1))
            state = {"X": X, "fx": fx, "fx_minus_e": fx_minus_e,
                     "rhs_enum": rhs_enum,
                     "A_a": zero_A, "A_b": zero_A,
                     "rhs_a": zero_rhs, "rhs_b": zero_rhs}
            state = _accumulate(state, draw_mask, consts)
            phi, raw_gap = _solve(state, consts)
            return phi, raw_gap, state

        return round0

    @torch.no_grad()
    def round_k(state, draw_mask, consts):
        state = _accumulate(state, draw_mask, consts)
        phi, raw_gap = _solve(state, consts)
        return phi, raw_gap, state

    return round_k


@dataclass
class RoundResult:
    """One refinement round's outputs, host-side."""

    round_index: int          # 0-based index of the round that just ran
    phi: np.ndarray           # (B, K, M) partial Shapley values
    expected_value: np.ndarray
    raw_prediction: np.ndarray
    est_err: np.ndarray       # (B, M) calibrated, monotone reported error
    raw_gap: np.ndarray       # (B, M) uncalibrated split-half gap
    cumulative_nsamples: int
    done: bool                # schedule exhausted after this round

    @property
    def max_err(self) -> float:
        return float(np.max(self.est_err)) if self.est_err.size else 0.0


@dataclass
class AnytimeRun:
    """Per-request refinement handle.

    Holds the run's device state between rounds; the owning engine's
    ``_dispatch_anytime_round`` drives one round per :meth:`step` call.  The
    run object IS the resumable state: a server preempting between rounds
    re-enqueues whatever holds it."""

    owner: Any                       # KernelExplainerEngine
    schedule: RoundSchedule
    Xp: np.ndarray                   # bucket-padded request rows
    B: int                           # live rows (<= Xp.shape[0])
    round_idx: int = 0
    state: Optional[Dict[str, Any]] = None
    reported_err: Optional[np.ndarray] = None
    expected_value: Optional[np.ndarray] = None
    raw_prediction: Optional[np.ndarray] = None
    last_result: Optional[RoundResult] = None
    last_round_s: float = 0.0
    calibration: Optional[Dict[int, float]] = None

    @property
    def done(self) -> bool:
        return self.round_idx >= self.schedule.n_rounds

    @property
    def rounds_run(self) -> int:
        return self.round_idx

    def step(self) -> RoundResult:
        """Run the next round (blocking) and return its result."""

        if self.done:
            raise RuntimeError("anytime schedule exhausted")
        return self.owner._dispatch_anytime_round(self)

    # ---- resume support (state must survive engine restarts) --------- #

    def export_state(self) -> Dict[str, Any]:
        """Host-side snapshot of the carried state: everything a fresh
        engine needs to continue from ``round_idx``."""

        if self.state is None:
            raise RuntimeError("no state to export before round 0 ran")
        return {
            "round_idx": self.round_idx,
            "B": self.B,
            "Xp": np.asarray(self.Xp),
            "reported_err": None if self.reported_err is None
            else np.asarray(self.reported_err),
            # copies: on the CPU a tensor's numpy view would share the run's
            # memory, and a snapshot must not change with the run
            "state": {k: v.cpu().numpy().copy() for k, v in self.state.items()},
        }

    @classmethod
    def restore(cls, owner, schedule: RoundSchedule,
                snapshot: Dict[str, Any]) -> "AnytimeRun":
        """A run continuing from ``snapshot`` on ``owner``'s device."""

        run = cls(owner=owner, schedule=schedule,
                  Xp=snapshot["Xp"], B=int(snapshot["B"]),
                  round_idx=int(snapshot["round_idx"]))
        run.state = {k: torch.as_tensor(np.array(v), device=owner.device)
                     for k, v in snapshot["state"].items()}
        if snapshot.get("reported_err") is not None:
            run.reported_err = np.asarray(snapshot["reported_err"])
        run.raw_prediction = np.asarray(snapshot["state"]["fx"])[:run.B]
        return run
