"""The factored arithmetic of the port's ``fused_linear_ey`` kernel, on the CPU.

``csrc/fused_linear_ey.cu`` computes its sigmoid-form branches (binary
softmax and sigmoid) as ``1 / (1 + u·v)`` with ``u = exp(-(dp - c))`` per
row and ``v = exp(t' - c)`` per staged background row, a shift ``c`` per
(class, coalition, chunk), a clamp on ``dp - c``, a guard that sends a chunk
whose t' range is too wide to the exact sigmoid, and a flush-to-zero
approximate reciprocal.  These tests run without a card, so they emulate
that arithmetic in float32 numpy, step for step, and hold it against the
plain version and against the JAX package's Pallas kernel in interpret
mode, on seeded inputs that include the adversarial cases ``chip_smoke.py``
gives the kernel on the card.  They also check the recounted bound at the
headline shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from distributedkernelshap_tpu.ops.pallas_kernels import fused_linear_ey as pallas_ey
from distributedkernelshap_tpu_torch.ops import cuda_kernels as tck

F32 = np.float32
FLT_MIN = np.finfo(np.float32).tiny
GUARD = tck.ey_guard_constants()
SPREAD, CLAMP = GUARD["spread"], GUARD["clamp"]


def _fma(a, b, c):
    # the product of two float32 is exact in float64
    return (a.astype(np.float64) * b + c).astype(F32)


def _group_sum(mask, X):
    """``sum_m mask[s,m]·X[r,m]`` as the kernel forms it: one fmaf per m in
    order.  Returns ``(S, R)``."""

    out = np.zeros((mask.shape[0], X.shape[0]), F32)
    for m in range(mask.shape[1]):
        out = _fma(mask[:, m:m + 1], X[None, :, m], out)
    return out


def emulate(XWg, bgWg, bgW, bgw, mask, activation, nc=None, spread=SPREAD, clamp=CLAMP):
    """The kernel's sigmoid-form arithmetic in float32 numpy, the background
    staged in chunks of ``nc`` rows (default: one chunk).  Returns
    ``(ey (B, S, K), stats)`` with the counts of (class, coalition, chunk)
    columns on the exact loop and of factored rows clamped."""

    B, M, K = XWg.shape
    binary = activation == "softmax" and K == 2
    if binary:
        XWg, bgWg, bgW = (a[..., 1:] - a[..., :1] for a in (XWg, bgWg, bgW))
    KE = XWg.shape[2]
    N = bgWg.shape[0]
    nc = nc or N
    w = (bgw / bgw.sum(dtype=F32)).astype(F32)
    acc = np.zeros((B, mask.shape[0], KE), F32)
    stats = {"columns": 0, "exact_route": 0, "rows": 0, "rows_clamped": 0}
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        for k in range(KE):
            dp = _group_sum(mask, XWg[:, :, k]).T[:, :, None]           # (B, S, 1)
            tp = (_group_sum(mask, bgWg[:, :, k]) - bgW[None, :, k]).astype(F32)  # (S, N)
            for n0 in range(0, N, nc):
                t = tp[:, n0:n0 + nc]
                lo, hi = np.fmin.reduce(t, axis=1), np.fmax.reduce(t, axis=1)
                exact = ~((hi - lo) <= F32(spread))                     # (S,)
                c = (F32(0.5) * (lo + hi)).astype(F32)
                v = np.exp((t - c[:, None]).astype(F32)).astype(F32)    # (S, nc)
                a = np.clip(dp - c[None, :, None], F32(-clamp), F32(clamp)).astype(F32)
                u = np.exp(-a).astype(F32)                              # (B, S, 1)
                stats["columns"] += exact.size
                stats["exact_route"] += int(exact.sum())
                rows = np.broadcast_to(~exact[None, :, None], dp.shape)
                stats["rows"] += int(rows.sum())
                stats["rows_clamped"] += int((np.abs(dp - c[None, :, None]) > clamp)[rows].sum())
                part = np.zeros_like(acc[..., k:k + 1])
                for j in range(t.shape[1]):
                    d = _fma(u, v[None, :, j:j + 1], F32(1.0))
                    q = (1.0 / d.astype(np.float64)).astype(F32)
                    q[q < FLT_MIN] = 0.0                                # rcp.approx.ftz
                    x = (dp - t[None, :, j:j + 1]).astype(F32)
                    sig = (1.0 / (1.0 + np.exp(-x).astype(np.float64))).astype(F32)
                    q = np.where(exact[None, :, None], sig, q)
                    part = _fma(w[n0 + j], q, part)
                # each chunk's sums are added to the output after the chunk
                acc[..., k:k + 1] = (acc[..., k:k + 1] + part).astype(F32)
    if binary:
        return np.concatenate([1.0 - acc, acc], axis=-1).astype(F32), stats
    return acc, stats


def _inputs(kind, B, S, N, M, K, activation, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        args = cs.group_space_inputs(rng, B, S, N, M, K, "cpu")
    else:
        args = cs.adversarial_ey_inputs(rng, kind, B, S, N, M, K, activation, "cpu")
    return [a.numpy() for a in args]


ACTIVATIONS = [(2, "softmax"), (1, "sigmoid"), (2, "sigmoid")]
KINDS = ("random",) + cs.EY_ADVERSARIAL


@pytest.mark.parametrize("K,activation", ACTIVATIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_factored_emulation_matches_plain(kind, K, activation):
    """Over several staged chunks (N = 40 in chunks of 16) and in one chunk
    (the kernel's chunk holds 120 rows), within the kernel's 1e-5 bar; each
    adversarial kind presses where it should."""

    B, S, N, M = 24, 96, 40, 12
    args = _inputs(kind, B, S, N, M, K, activation, seed=K)
    ref = tck.fused_linear_ey_plain(*(torch.as_tensor(a) for a in args), activation).numpy()
    for nc in (None, 16):
        got, stats = emulate(*args, activation, nc=nc)
        assert got.shape == (B, S, K) and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=0, atol=cs.EY_ATOL)
    # the counts chip_smoke prints on the card, from the same guard
    assert cs.ey_guard_stats([torch.as_tensor(a) for a in args], activation, 16) == stats
    if kind == "large logits":
        assert stats["rows_clamped"] > 0 and stats["exact_route"] == 0
    if kind == "spread past the guard":
        assert 0 < stats["exact_route"] < stats["columns"]
    if kind in ("random", "cancelling"):
        assert stats["exact_route"] == 0 and stats["rows_clamped"] == 0


@pytest.mark.parametrize("M,K,activation", [(17, 2, "softmax"), (48, 2, "softmax"),
                                            (17, 3, "sigmoid"), (48, 7, "sigmoid")])
@pytest.mark.parametrize("kind", KINDS)
def test_factored_emulation_over_group_slices_and_classes(kind, M, K, activation):
    """Groups past one staged slice of 16 (ungrouped Adult has M = 48: the
    kernel carries t' and dp across slices in the same fmaf order) and
    sigmoid at several classes (one class a block on the card)."""

    B, S, N = 20, 64, 30
    args = _inputs(kind, B, S, N, M, K, activation, seed=M + K)
    ref = tck.fused_linear_ey_plain(*(torch.as_tensor(a) for a in args), activation).numpy()
    got, _ = emulate(*args, activation, nc=12)
    assert got.shape == (B, S, K) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=cs.EY_ATOL)


@pytest.mark.parametrize("K,activation", [(2, "softmax"), (2, "sigmoid")])
@pytest.mark.parametrize("kind", KINDS)
def test_factored_emulation_matches_pallas_interpret(kind, K, activation):
    """Against the JAX package's kernel, run as its own tests run it on the
    CPU (interpret mode)."""

    args = _inputs(kind, 16, 64, 20, 12, K, activation, seed=10 + K)
    ref = np.asarray(pallas_ey(*(jnp.asarray(a) for a in args), activation,
                               interpret=True))
    got, _ = emulate(*args, activation, nc=8)
    np.testing.assert_allclose(got, ref, rtol=0, atol=cs.EY_ATOL)


@pytest.mark.parametrize("K,activation", [(2, "softmax"), (2, "sigmoid")])
def test_factored_form_needs_its_guard(K, activation):
    """Without the guard, a chunk whose t' range is hundreds wide makes v
    overflow or vanish and the factored form misses the plain version."""

    args = _inputs("spread past the guard", 24, 96, 40, 12, K, activation, seed=3)
    ref = tck.fused_linear_ey_plain(*(torch.as_tensor(a) for a in args), activation).numpy()
    got, stats = emulate(*args, activation, spread=np.inf)
    assert stats["exact_route"] == 0
    assert not np.allclose(got, ref, rtol=0, atol=cs.EY_ATOL)


def test_guard_constants_agree():
    """The source's guard constants, read as chip_smoke.py reads them, and
    their argument: v within e^±40 and u within e^±87 stay normal floats."""

    assert GUARD == {"spread": 80.0, "clamp": 87.0}
    info = np.finfo(np.float32)
    assert info.tiny < np.exp(-SPREAD / 2) and np.exp(SPREAD / 2) < info.max
    assert info.tiny < np.exp(-CLAMP) and np.exp(CLAMP) < info.max
    # a clamped row has |x| > CLAMP - SPREAD/2 = 47, where sigmoid is 1 in
    # f32 or below 4e-21
    assert np.float32(1.0) + np.float32(np.exp(-(CLAMP - SPREAD / 2))) == np.float32(1.0)


@pytest.mark.parametrize("design,want_ms", [("factored", 0.12816219), ("unfactored", 0.25368840),
                                            ("paired", 0.06474009)])
def test_ey_bound_recount_at_headline(design, want_ms):
    """The recounted bound: paired reciprocals, 265.2 M and 5.5 M
    exponentials on 132 SMs x 16 SFU lanes at 1980 MHz, the default; the
    kernel's own design, one reciprocal per activation (530.4 M); the
    unfactored yardstick, an exp and a reciprocal per activation."""

    B, S, N, M, K = 2560, 2072, 100, 12, 2
    ms, by = cs.ey_bound_ms(B, S, N, M, K, "softmax", 132, 1.98e9, design=design)
    assert by == "operations"
    assert ms == pytest.approx(want_ms, rel=1e-6)
    acts, exps = B * S * N, B * S + S * N
    assert (acts, exps) == (530_432_000, 5_511_520)
    if design == "factored":
        assert ms == pytest.approx(1e3 * (acts + exps) / (132 * 16 * 1.98e9), rel=1e-12)
    if design == "paired":
        assert ms == pytest.approx(1e3 * (acts / 2 + exps) / (132 * 16 * 1.98e9), rel=1e-12)
        assert cs.ey_bound_ms(B, S, N, M, K, "softmax", 132, 1.98e9) == (ms, by)
        # the FP32 lanes, 3.5 instructions a paired activation, come second
        assert 1e3 * (3.5 * acts + M * exps) / (132 * 128 * 1.98e9) < ms
    # a general softmax takes its own factored count in the paired and
    # factored designs, and its earlier count in the unfactored one
    general = cs.ey_bound_ms(B, S, N, M, 7, "softmax", 132, 1.98e9, design=design)
    assert (general == cs.ey_bound_ms(B, S, N, M, 7, "softmax", 132, 1.98e9,
                                      design="factored")) == (design != "unfactored")
