"""The factored general softmax of the port's ``fused_linear_ey`` kernel, on
the CPU.

``csrc/fused_linear_ey.cu`` computes softmax at every K but 2 in factored
form: ``u = exp(p1 − max_k p1)`` per row, ``v = exp(−t' − max_k −t')`` per
background row (a prologue, 0 where a t' is not finite), ``D = Σ_k u·v``,
``r = w · rcp.approx.ftz(D)`` and ``ey = u · Σ_n r·v``, with the background
rows of a pass summed in ``16 / CG`` groups (``CG`` the class groups of a
class tile) and a guard: a ``(b, s, n)`` whose D falls below ``kTau`` (or is
NaN) is computed exactly in the kernel, its max-subtracted exponentials
added to the output after the pass.  These tests run without a card, so
they emulate that arithmetic in float32 numpy, step for step, and hold it
against the plain version and against the JAX package's Pallas kernel in
interpret mode within the kernel's 1e-5 bar, on seeded inputs that include
the adversarial cases ``chip_smoke.py`` gives the kernel on the card.  They
also check the recounted bound of the general softmax.
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
TAU = tck.ey_softmax_tau()
#: the class counts of the general softmax the tests take
KS = (1, 3, 7, 33, 100)
KINDS = ("random",) + cs.EY_SOFTMAX_ADVERSARIAL


def _fma(a, b, c):
    # the product of two float32 is exact in float64
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def _group_sum(mask, X):
    """``sum_m mask[s,m]·X[r,m]`` as the kernel forms it: one fmaf per m in
    order.  Returns ``(S, R)``."""

    out = np.zeros((mask.shape[0], X.shape[0]), F32)
    for m in range(mask.shape[1]):
        out = _fma(mask[:, m:m + 1], X[None, :, m], out)
    return out


def class_groups(K):
    """The kernel's class groups of 4 in a class tile (``factored_plan``):
    the least power of two, at most 16, with 4·CG >= K."""

    cg = 1
    while cg < 16 and 4 * cg < K:
        cg *= 2
    return cg


def _factored_terms(XWg, bgWg, bgW, bgw, mask, tau):
    """What both general-softmax kernels form before their sums, in float32:
    ``p1 (B, S, K)``, ``t' (S, N, K)``, the normalised weights ``w``, ``u``,
    the prologue's ``v`` (a row of zeros where a t' is not finite), ``D`` in
    class order, whether each (b, s, n) is factored (D at least ``tau``) and
    ``r = w · rcp.approx.ftz(D)`` there (0 on the exact route)."""

    B, M, K = XWg.shape
    N, S = bgWg.shape[0], mask.shape[0]
    w = (bgw / bgw.sum(dtype=F32)).astype(F32)
    p1 = _group_sum(mask, XWg.transpose(0, 2, 1).reshape(B * K, M))
    p1 = p1.reshape(S, B, K).transpose(1, 0, 2)                         # (B, S, K)
    tp = _group_sum(mask, bgWg.transpose(0, 2, 1).reshape(N * K, M))
    tp = (tp.reshape(S, N, K) - bgW[None]).astype(F32)                 # (S, N, K)
    gamma = np.fmax.reduce(-tp, axis=-1)
    v = np.exp((-tp - gamma[..., None]).astype(F32)).astype(F32)
    v[~np.isfinite(tp).all(-1)] = 0.0
    alpha = np.fmax.reduce(p1, axis=-1)
    u = np.exp((p1 - alpha[..., None]).astype(F32)).astype(F32)
    D = np.zeros((B, S, N), F32)
    for k in range(K):
        D = _fma(u[:, :, None, k], v[None, :, :, k], D)
    factored = D >= F32(tau)
    rcp = (1.0 / np.where(D < FLT_MIN, 0.0, D.astype(np.float64))).astype(F32)
    r = np.where(factored, (w * rcp).astype(F32), F32(0.0))
    return p1, tp, w, u, v, D, factored, r


def _exact_route(out, p1, tp, w, factored, ns):
    """The in-kernel exact route of background rows ``ns``, in that order:
    each flagged (b, s, n) adds ``w / Z · exp(x − m)`` to ``out``."""

    K = p1.shape[-1]
    for n in ns:
        ex = ~factored[:, :, n]
        if not ex.any():
            continue
        x = (p1 - tp[None, :, n, :]).astype(F32)
        m = np.fmax.reduce(x, axis=-1)
        z = np.zeros(x.shape[:2], F32)
        for k in range(K):
            z = (z + np.exp((x[..., k] - m).astype(F32))).astype(F32)
        c = (w[n] / z).astype(F32)
        e = np.exp((x - m[..., None]).astype(F32)).astype(F32)
        out = np.where(ex[..., None], _fma(c[..., None], e, out), out)
    return out


def emulate_softmax(XWg, bgWg, bgW, bgw, mask, tau=TAU, nr=None):
    """The factored kernel's arithmetic in float32 numpy, ``nr`` background
    rows a pass (default: the kernel's, up to 256).  Returns ``(ey (B, S,
    K), stats)`` with the count of ``(b, s, n)`` triples on the exact
    route."""

    B, M, K = XWg.shape
    N = bgWg.shape[0]
    ng = 16 // class_groups(K)
    nr = nr or min(N, 256)
    with np.errstate(over="ignore", under="ignore", invalid="ignore", divide="ignore"):
        # pass 1: D in class order, then r = w · rcp.approx.ftz(D) or the flag
        p1, tp, w, u, v, D, factored, r = _factored_terms(XWg, bgWg, bgW, bgw, mask, tau)
        out = np.zeros(u.shape, F32)
        for p0 in range(0, N, nr):
            pend = min(N, p0 + nr)
            # pass 2: background groups n = g mod ng, added in group order,
            # times u, written (added on later passes)
            o = np.zeros(u.shape, F32)
            for g in range(ng):
                acc = np.zeros(u.shape, F32)
                for n in range(p0 + g, pend, ng):
                    acc = _fma(r[:, :, n:n + 1], v[None, :, n, :], acc)
                o = (o + acc).astype(F32)
            o = (o * u).astype(F32)
            out = o if p0 == 0 else (out + o).astype(F32)
            # the exact route of the pass, in background order
            out = _exact_route(out, p1, tp, w, factored, range(p0, pend))
    return out, {"triples": D.size, "exact_route": int((~factored).sum())}


def emulate_softmax_regs(XWg, bgWg, bgW, bgw, mask, tau=TAU):
    """The small-K route's arithmetic (``softmax_factored_kernel_regs``) in
    float32 numpy: the same u, v, D and r, the output sums one fmaf chain a
    (b, s, k) over every background row in order, ``ey = u · acc``, then
    the exact route in background order.  Returns ``(ey, stats)``."""

    N = bgWg.shape[0]
    with np.errstate(over="ignore", under="ignore", invalid="ignore", divide="ignore"):
        p1, tp, w, u, v, D, factored, r = _factored_terms(XWg, bgWg, bgW, bgw, mask, tau)
        acc = np.zeros(u.shape, F32)
        for n in range(N):
            acc = _fma(r[:, :, n:n + 1], v[None, :, n, :], acc)
        out = _exact_route((u * acc).astype(F32), p1, tp, w, factored, range(N))
    return out, {"triples": D.size, "exact_route": int((~factored).sum())}


def _inputs(kind, B, S, N, M, K, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        args = cs.group_space_inputs(rng, B, S, N, M, K, "cpu")
    else:
        args = cs.adversarial_ey_inputs(rng, kind, B, S, N, M, K, "softmax", "cpu")
    return [a.numpy() for a in args]


def _plain(args):
    return tck.fused_linear_ey_plain(*(torch.as_tensor(a) for a in args), "softmax").numpy()


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("kind", KINDS)
def test_factored_softmax_emulation_matches_plain(kind, K):
    """At the Pallas CPU tests' shapes (B = 8, S = 64, N = 9, M = 5), in one
    pass and in passes of 4 background rows, within the kernel's 1e-5 bar;
    the guard's split is the one ``chip_smoke.py`` prints on the card."""

    args = _inputs(kind, 8, 64, 9, 5, K, seed=K)
    ref = _plain(args)
    for nr in (None, 4):
        got, stats = emulate_softmax(*args, nr=nr)
        assert got.shape == (8, 64, K) and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=0, atol=cs.EY_ATOL)
    assert cs.softmax_guard_stats([torch.as_tensor(a) for a in args]) == stats
    if kind == "random" or K == 1:
        assert stats["exact_route"] == 0
    if kind == "top classes apart" and K > 1:
        assert 0 < stats["exact_route"] < stats["triples"]


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("kind", ("random", "top classes apart"))
def test_factored_softmax_emulation_matches_pallas_interpret(kind, K):
    """Against the JAX package's kernel, run as its own tests run it on the
    CPU (interpret mode), at its tests' shapes."""

    args = _inputs(kind, 8, 64, 9, 5, K, seed=20 + K)
    ref = np.asarray(pallas_ey(*(jnp.asarray(a) for a in args), "softmax", interpret=True))
    got, _ = emulate_softmax(*args)
    np.testing.assert_allclose(got, ref, rtol=0, atol=cs.EY_ATOL)


@pytest.mark.parametrize("K", (3, 7, 33, 100))
def test_factored_softmax_over_groups_and_passes(K):
    """Twelve groups and 40 background rows, in one pass and in passes of 16
    and 7 rows (a pass's background groups then start mid-group), on the
    inputs whose top classes disagree."""

    args = _inputs("top classes apart", 12, 48, 40, 12, K, seed=30 + K)
    ref = _plain(args)
    for nr in (None, 16, 7):
        got, stats = emulate_softmax(*args, nr=nr)
        assert np.isfinite(got).all() and stats["exact_route"] > 0
        np.testing.assert_allclose(got, ref, rtol=0, atol=cs.EY_ATOL)


@pytest.mark.parametrize("K", (3, 7, 33, 100))
def test_factored_softmax_needs_its_guard(K):
    """Without the guard, a (b, s, n) whose top classes disagree by hundreds
    has D = 0 in float32, its r is infinite and the factored form misses
    the plain version; with it, the exact route keeps the 1e-5 bar."""

    args = _inputs("top classes apart", 12, 48, 40, 12, K, seed=40 + K)
    ref = _plain(args)
    got, stats = emulate_softmax(*args, tau=0.0)
    assert stats["exact_route"] == 0
    assert not np.allclose(got, ref, rtol=0, atol=cs.EY_ATOL)
    got, stats = emulate_softmax(*args)
    assert stats["exact_route"] > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=cs.EY_ATOL)


def test_factored_softmax_takes_non_finite_rows_exactly():
    """A background row with a logit of -inf (t' = +inf: its class weighs
    nothing) and an instance row with a NaN one: the prologue's row of
    zeros (D = 0) and the NaN D send them to the exact route, which gives
    the plain version's values and its NaNs."""

    args = _inputs("random", 6, 32, 9, 5, 7, seed=5)
    args[2][3, 2] = -np.inf          # background row 3: t' = +inf in class 2
    args[0][1, 0, 4] = np.nan        # instance row 1, group 0, class 4
    ref = _plain(args)
    got, stats = emulate_softmax(*args)
    assert stats["exact_route"] > 0
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    keep = ~np.isnan(ref)
    np.testing.assert_allclose(got[keep], ref[keep], rtol=0, atol=cs.EY_ATOL)


def test_softmax_guard_constant_and_its_margins():
    """``kTau`` as read from the source, and its argument (the kernel's head
    comment): D normal, so the reciprocal is not flushed; r·v sums bounded by
    2^100; K subnormal roundings of 2^-150 far below the 1e-5 bar at
    K = 257."""

    assert TAU == 2.0 ** -100
    info = np.finfo(np.float32)
    assert F32(TAU) == TAU and TAU > info.tiny * 2.0 ** 25
    assert 1.0 / TAU < float(info.max) / 2.0 ** 27
    assert 257 * 2.0 ** -150 / TAU < 1e-5 * 2.0 ** -20
    assert "constexpr float kTau = 0x1p-100f;" in (tck.CSRC_DIR / "fused_linear_ey.cu").read_text()


@pytest.mark.parametrize("case,shape,want_ms,old_ms", [
    ("K = 100, headline", (2560, 2072, 100, 12, 100), 3.36880, 12.8113),
    ("Covertype chunk", (65536, 2072, 100, 12, 7), 6.02410, 25.9777)])
def test_ey_bound_recount_general_softmax(case, shape, want_ms, old_ms):
    """The factored count of the general softmax at 132 SMs and 1980 MHz:
    B·S·N reciprocals and K·(B·S + S·N) exponentials on the SFUs, 2·K·B·S·N
    FFMAs and M·K·(B·S + S·N) on the FP32 lanes, which bound it; the earlier
    count (an exp per (b, s, n, k)) stays beside it as ``"unfactored"``."""

    B, S, N, M, K = shape
    ms, by = cs.ey_bound_ms(B, S, N, M, K, "softmax", 132, 1.98e9)
    assert by == "operations" and ms == pytest.approx(want_ms, abs=5e-5)
    fp32 = 2 * K * B * S * N + M * K * (B * S + S * N)
    assert ms == pytest.approx(1e3 * fp32 / (132 * 128 * 1.98e9), rel=1e-12)
    sfu = B * S * N + K * (B * S + S * N)
    assert 1e3 * sfu / (132 * 16 * 1.98e9) < ms
    assert cs.ey_bound_ms(B, S, N, M, K, "softmax", 132, 1.98e9, design="factored") == (ms, by)
    old, _ = cs.ey_bound_ms(B, S, N, M, K, "softmax", 132, 1.98e9, design="unfactored")
    assert old == pytest.approx(old_ms, abs=5e-5)


def test_kernel_ab_reads_the_parents_ey_interface():
    """``scripts/torch_kernel_ab.py`` tells this checkout's ``fused_linear_ey``
    C interface (with the general softmax's scratch) from the one before it,
    and passes each its arguments."""

    from scripts import torch_kernel_ab as ab

    assert ab.interface((tck.CSRC_DIR / "fused_linear_ey.cu").read_text()) == "ey"
    old = "int fused_linear_ey_launch(const float* XWg, ..., float* out, int B, int S,"
    assert ab.interface(old) == "ey_no_scratch"
    assert ab._ARGS["ey"] == tck._SYMBOLS["fused_linear_ey"]["fused_linear_ey_launch"][0]
    assert len(ab._ARGS["ey_no_scratch"]) == len(ab._ARGS["ey"]) - 1


def test_one_kernel_function_serves_the_general_softmax():
    """The source's kernel functions: the sigmoid form's template, the
    general softmax's factored kernel, its small-K route (a template over
    the class count, named so that the benchmark's ``softmax_factored_kernel``
    prefix reads it) and their one prologue, and nothing of the register and
    class-tiled softmax kernels PR 20 replaced."""

    src = (tck.CSRC_DIR / "fused_linear_ey.cu").read_text()
    assert "softmax_kernel<" not in src and "softmax_tiled_kernel" not in src
    assert "kRegisterK" not in src
    assert src.count("__global__") == 4
    for name in ("softmax_factored_kernel(", "softmax_factored_kernel_regs(",
                 "softmax_v_kernel(", "sigmoid_kernel("):
        assert name in src
    assert not hasattr(tck, "REGISTER_K") and not hasattr(tck, "fused_linear_ey_tiled")


def test_kernel_ab_launcher_keeps_its_inputs_alive(monkeypatch):
    """``torch_kernel_ab.ey_launcher`` hands the C call raw pointers, so it
    holds the tensors they point into for as long as it lives: a case's
    inputs must outlive the loop that made them."""

    import gc
    import weakref
    from types import SimpleNamespace

    from scripts import torch_kernel_ab as ab

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: SimpleNamespace(cuda_stream=0))
    calls = []
    lib = SimpleNamespace(interface="ey",
                          fused_linear_ey_scratch_floats=lambda S, N, K, code: S * N * K,
                          fused_linear_ey_launch=lambda *a: calls.append(a) or 0)
    args = [torch.as_tensor(a) for a in _inputs("random", 4, 8, 3, 2, 5, seed=0)]
    refs = [weakref.ref(t) for t in args]
    launch = ab.ey_launcher(lib, args, "softmax")
    del args
    gc.collect()
    assert all(r() is not None for r in refs)
    out = launch()
    assert out.shape == (4, 8, 5) and len(calls) == 1 and len(calls[0]) == 14
    assert calls[0][0] == refs[0]().data_ptr() and calls[0][4] == refs[4]().data_ptr()


#: the class counts of the small-K route the tests take: 1, 3, 7 and 8 (one
#: and two float4s of v), and the route's last (classes past K zero)
SMALL_KS = (1, 3, 7, 8, tck.ey_regs_max_k())


@pytest.mark.parametrize("K", SMALL_KS)
@pytest.mark.parametrize("kind", KINDS)
def test_small_k_route_emulation_matches_plain(kind, K):
    """The small-K route's order (one chain a (b, s, k) over the background
    rows) at the Pallas CPU tests' shapes, within the kernel's 1e-5 bar; its
    guard splits the triples as the factored kernel's does."""

    args = _inputs(kind, 8, 64, 9, 5, K, seed=50 + K)
    ref = _plain(args)
    got, stats = emulate_softmax_regs(*args)
    assert got.shape == (8, 64, K) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=cs.EY_ATOL)
    assert stats == emulate_softmax(*args)[1]
    assert cs.softmax_guard_stats([torch.as_tensor(a) for a in args]) == stats


@pytest.mark.parametrize("K", SMALL_KS)
@pytest.mark.parametrize("kind", ("random", "top classes apart"))
def test_small_k_route_emulation_matches_pallas_interpret(kind, K):
    """Against the JAX package's kernel in interpret mode, at its tests'
    shapes."""

    args = _inputs(kind, 8, 64, 9, 5, K, seed=60 + K)
    ref = np.asarray(pallas_ey(*(jnp.asarray(a) for a in args), "softmax", interpret=True))
    got, _ = emulate_softmax_regs(*args)
    np.testing.assert_allclose(got, ref, rtol=0, atol=cs.EY_ATOL)


@pytest.mark.parametrize("K", (3, 7, tck.ey_regs_max_k()))
def test_small_k_route_splits_at_its_guard(K):
    """Twelve groups and 130 background rows (past a chunk of 128 at K <= 8)
    whose top classes disagree: without the guard some D is 0 in float32 and
    the route misses the plain version; with it the triples below ``kTau``
    take the exact route and the 1e-5 bar holds."""

    args = _inputs("top classes apart", 12, 48, 130, 12, K, seed=70 + K)
    ref = _plain(args)
    got, stats = emulate_softmax_regs(*args, tau=0.0)
    assert stats["exact_route"] == 0
    assert not np.allclose(got, ref, rtol=0, atol=cs.EY_ATOL)
    got, stats = emulate_softmax_regs(*args)
    assert 0 < stats["exact_route"] < stats["triples"]
    np.testing.assert_allclose(got, ref, rtol=0, atol=cs.EY_ATOL)


def test_small_k_route_takes_non_finite_rows_exactly():
    """A background row with a logit of -inf (its v a row of zeros) and an
    instance row with a NaN one (a NaN u) take the exact route, which gives
    the plain version's values and its NaNs."""

    args = _inputs("random", 6, 32, 9, 5, 7, seed=7)
    args[2][3, 2] = -np.inf
    args[0][1, 0, 4] = np.nan
    ref = _plain(args)
    got, stats = emulate_softmax_regs(*args)
    assert stats["exact_route"] > 0
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    keep = ~np.isnan(ref)
    np.testing.assert_allclose(got[keep], ref[keep], rtol=0, atol=cs.EY_ATOL)


def test_small_k_route_threshold_from_the_source():
    """``kRegsMaxK`` as the source defines it, and the route the source's
    ``route`` gives around it: the wrapper asks the library, never this."""

    src = (tck.CSRC_DIR / "fused_linear_ey.cu").read_text()
    assert tck.ey_regs_max_k() == 16
    assert "return K <= kRegsMaxK ? kRouteRegs : kRouteFactored;" in src
    assert tck.EY_ROUTES == ("sigmoid", "factored", "regs")


@pytest.mark.parametrize("code,route", [(0, "sigmoid"), (1, "factored"), (2, "regs")])
def test_route_launches_count_the_librarys_route(monkeypatch, code, route):
    """Each launch counts once in ``fused_linear_ey.launches`` and once under
    the route the library reports for its K and activation, and
    ``ey_route`` names what the library reports; a K no route takes
    raises."""

    from types import SimpleNamespace

    asked = []

    def route_of(K, act):
        asked.append((K, act))
        return code if K > 0 else -1

    lib = SimpleNamespace(fused_linear_ey_route=route_of)
    monkeypatch.setattr(tck.fused_linear_ey, "launches", 0)
    monkeypatch.setattr(tck.fused_linear_ey, "route_launches", dict.fromkeys(tck.EY_ROUTES, 0))
    monkeypatch.setattr(tck, "_library", lambda name: lib)
    tck._count_ey_launch(lib, 7, 0)
    tck._count_ey_launch(lib, 7, 0)
    assert tck.fused_linear_ey.launches == 2
    assert tck.fused_linear_ey.route_launches == {r: 2 * (r == route) for r in tck.EY_ROUTES}
    assert tck.ey_route(5, "sigmoid") == route and asked[-1] == (5, 1)
    with pytest.raises(ValueError):
        tck.ey_route(0)
