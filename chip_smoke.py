#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``distributedkernelshap_tpu_torch``) on one
CUDA card: builds every kernel from ``csrc/``, holds each against its plain
PyTorch version on the card, drives the Adult headline explain through the
public API, checks the answer, and times kernel, plain version and explain.

    python3 chip_smoke.py [--seed 0]

Phases (each raises on failure, so the script exits non-zero):

1. device: the card's name and power limit; float32 matmuls must be full f32
   (no TF32), the reference's ``matmul_precision="highest"``;
2. build: ``nvcc`` for ``sm_90a`` into ``build/kernels/``, one process per
   source, all started together;
3. kernel vs plain on the card at the main path's shapes and the edge
   shapes, max abs diff <= 1e-5 on ``ey``; a class width above the kernel's
   limit must raise;
4. main path: ``KernelShap(est.predict_proba, link="logit", seed=0)
   .fit(bg, group_names=..., groups=...).explain(X)`` on an Adult-shaped task
   made from ``--seed`` (B=2560, D=48 in the Adult group widths, N=100), with
   launch counts set to 0 just before and read just after; the answer must be
   additive (< 1e-3, the gate of bench.py), agree with the same explain
   through the kernel's plain version on the card, and with the port on the
   CPU on the first rows;
5. times: explain wall (one warm-up, median of 3), kernel and plain version
   by CUDA events at the headline shape, and the kernel's bound.

The second-to-last line of stdout is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Adult (bench.py's task): 4 continuous columns, then one-hot blocks
ADULT_GROUP_NAMES = ['Age', 'Capital Gain', 'Capital Loss', 'Hours per week',
                     'Workclass', 'Education', 'Marital Status', 'Occupation',
                     'Relationship', 'Race', 'Sex', 'Country']
ADULT_WIDTHS = [1, 1, 1, 1, 8, 5, 3, 8, 5, 4, 1, 10]
B_HEADLINE, N_BACKGROUND = 2560, 100

EY_ATOL = 1e-5          # kernel vs plain on ey, the bar of tests/test_pallas.py
ADDITIVITY = 1e-3       # the gate of bench.py
# phi (logit space) of the kernel route vs the plain route, and of the card vs
# the CPU: f32 sums in other orders, amplified by the logit link near
# saturation (d logit = dp / (p (1-p))) and spread by the WLS solve
PHI_ATOL = 1e-3

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SFU_OPS_PER_SM_PER_CLOCK = 16      # special-function unit results per SM per clock


def adult_groups():
    groups, start = [], 0
    for w in ADULT_WIDTHS:
        groups.append(list(range(start, start + w)))
        start += w
    return groups


def adult_shaped_rows(rng, n):
    """``n`` rows shaped like the processed Adult data: standardised
    continuous columns, then one-hot categorical blocks (a width-1 block is
    a 0/1 column)."""

    cols = []
    for w in ADULT_WIDTHS:
        if len(cols) < 4:
            cols.append(rng.normal(size=(n, 1)))
        elif w == 1:
            cols.append(rng.integers(0, 2, size=(n, 1)).astype(np.float64))
        else:
            cols.append(np.eye(w)[rng.integers(0, w, size=n)])
    return np.concatenate(cols, axis=1).astype(np.float32)


class AdultShapedLogisticRegression:
    """A binary logistic regression with scikit-learn's attributes
    (``coef_ (1, 48)``, ``intercept_ (1,)``) and a numpy ``predict_proba``,
    with logits of the range the repo's fitted Adult model gives."""

    def __init__(self, rng):
        self.coef_ = rng.normal(scale=0.75, size=(1, sum(ADULT_WIDTHS)))
        self.intercept_ = np.array([-1.25])

    def predict_proba(self, X):
        z = np.asarray(X, dtype=np.float64) @ self.coef_.T + self.intercept_
        p = 1.0 / (1.0 + np.exp(-z))
        return np.hstack([1.0 - p, p])


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def group_space_inputs(rng, B, S, N, M, K, device, mask=None):
    """Random ``fused_linear_ey`` inputs as ``_ey_linear`` forms them: two
    columns per group, logits of O(1)."""

    import torch

    D = 2 * M
    X = rng.normal(size=(B, D))
    bg = rng.normal(size=(N, D))
    W = rng.normal(scale=0.7, size=(D, K))
    b = rng.normal(size=K)
    G = np.zeros((M, D))
    for m in range(M):
        G[m, 2 * m:2 * m + 2] = 1.0
    if mask is None:
        mask = (rng.random(size=(S, M)) < 0.5).astype(np.float32)
    GW = G[:, :, None] * W[None]
    arrays = (np.einsum("bd,mdk->bmk", X, GW), np.einsum("nd,mdk->nmk", bg, GW),
              bg @ W + b, rng.random(N) + 0.5, mask)
    return [torch.tensor(np.asarray(a, dtype=np.float32), device=device) for a in arrays]


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ey_bound_ms(B, S, N, M, K, activation, sm_count, sm_clock_hz):
    """The least time the card could take for one ``fused_linear_ey`` call:
    the larger of its bytes over HBM bandwidth and its operations over the
    peak rate of their unit.  Operations: each (b, s, n) activation costs
    one exp and one reciprocal on the special-function units for a sigmoid
    (binary softmax is one sigmoid), K exps and one reciprocal for a general
    softmax; the group-space products are 2·M FLOP per (b, s, class) and
    the (s, n, class) background term, plus ~3 FLOP per activation."""

    binary = activation == "softmax" and K == 2
    KE = 1 if binary else K
    acts = B * S * N
    sfu = acts * (2 * KE if activation == "sigmoid" or binary else KE + 1)
    fp32 = 2 * M * KE * (B * S + S * N) + 3 * acts * KE
    nbytes = 4 * (B * M * K + N * M * K + N * K + N + S * M + B * S * K)
    times = {
        "bytes": nbytes / HBM_BYTES_PER_S,
        "operations": max(sfu / (sm_count * SFU_OPS_PER_SM_PER_CLOCK * sm_clock_hz),
                          fp32 / FP32_FLOPS_PER_S),
    }
    bound_by = max(times, key=times.get)
    return 1e3 * times[bound_by], bound_by


def compare_kernel(seed, device):
    """Phase 3: the wrapper (kernel) against the plain version on the card."""

    from distributedkernelshap_tpu_torch.ops import cuda_kernels
    from distributedkernelshap_tpu_torch.ops.coalitions import coalition_plan
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        fused_linear_ey,
        fused_linear_ey_plain,
    )

    rng = np.random.default_rng(seed)
    headline_mask = coalition_plan(len(ADULT_WIDTHS), None, seed=0).mask
    cases = [
        ("headline binary softmax", 2560, 2072, 100, 12, 2, "softmax", headline_mask),
        ("general softmax K=7", 512, 1024, 100, 12, 7, "softmax", None),
        ("sigmoid K=1", 512, 1024, 100, 12, 1, "sigmoid", None),
        ("sigmoid K=2", 512, 1024, 100, 12, 2, "sigmoid", None),
        ("ragged edges binary", 33, 700, 9, 7, 2, "softmax", None),
        ("ragged edges K=7", 33, 700, 9, 7, 7, "softmax", None),
        ("wide K=32 softmax", 40, 300, 20, 12, 32, "softmax", None),
    ]
    worst = 0.0
    for name, B, S, N, M, K, act, mask in cases:
        args = group_space_inputs(rng, B, S, N, M, K, device, mask)
        got = fused_linear_ey(*args, act)
        ref = fused_linear_ey_plain(*args, act)
        err = float((got - ref).abs().max())
        finite = bool(got.isfinite().all())
        print(f"kernel vs plain [{name}] B={B} S={S} N={N} M={M} K={K}: "
              f"max_abs_diff={err:.3e} (tol {EY_ATOL:g})", flush=True)
        if not finite or not err <= EY_ATOL:
            raise AssertionError(f"fused_linear_ey disagrees with its plain version "
                                 f"at {name}: {err} (finite={finite})")
        worst = max(worst, err)
    # above the kernel's class limit a card tensor raises, never runs plain
    K = cuda_kernels.MAX_K + 1
    try:
        cuda_kernels.fused_linear_ey(*group_space_inputs(rng, 8, 64, 5, 4, K, device),
                                     "softmax")
    except ValueError as e:
        print(f"kernel at K={K} raises on the card: {e}", flush=True)
    else:
        raise AssertionError(f"fused_linear_ey took K={K} > MAX_K on the card")
    return worst


def adult_task(seed):
    rng = np.random.default_rng(seed)
    X = adult_shaped_rows(rng, B_HEADLINE)
    bg = adult_shaped_rows(rng, N_BACKGROUND)
    return X, bg, AdultShapedLogisticRegression(rng)


def explain_headline(X, bg, est, device, use_kernel=None):
    from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
    from distributedkernelshap_tpu_torch.ops.explain import ShapConfig

    explainer = KernelShap(est.predict_proba, link="logit",
                           feature_names=ADULT_GROUP_NAMES, seed=0, device=device,
                           engine_config=EngineConfig(shap=ShapConfig(use_kernel=use_kernel)))
    explainer.fit(bg, group_names=ADULT_GROUP_NAMES, groups=adult_groups())
    return explainer, explainer.explain(X, silent=True)


def additivity(expl) -> float:
    total = np.stack(expl.shap_values, 1).sum(-1) + np.asarray(expl.expected_value)[None]
    return float(np.abs(total - expl.data["raw"]["raw_prediction"]).max())


def check_explanation(expl, B):
    phi = np.stack(expl.shap_values, 1)
    if phi.shape != (B, 2, len(ADULT_WIDTHS)) or not np.isfinite(phi).all():
        raise AssertionError(f"bad shap values: shape {phi.shape}, "
                             f"finite={np.isfinite(phi).all()}")
    err = additivity(expl)
    if not err < ADDITIVITY:
        raise AssertionError(f"additivity violated: {err}")
    return phi, err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2

    from distributedkernelshap_tpu_torch.ops import cuda_kernels

    # 1. device
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    props = torch.cuda.get_device_properties(0)
    print(f"device: {kind}; nvidia-smi: {card}; SMs={props.multi_processor_count}; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the port computes in full f32")

    # 2. build
    t0 = time.perf_counter()
    libs = cuda_kernels.build()
    for name, path in libs.items():
        print(f"built {name}: {path} in {time.perf_counter() - t0:.1f} s", flush=True)
        log = path.with_name(path.name + ".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    # 3. kernel vs plain
    max_err = compare_kernel(args.seed, device)

    # 4. main path, counted
    X, bg, est = adult_task(args.seed)
    cuda_kernels.fused_linear_ey.launches = 0
    explainer, expl = explain_headline(X, bg, est, device)
    torch.cuda.synchronize()
    launches = cuda_kernels.fused_linear_ey.launches
    path = explainer.kernel_path
    print(f"main path: launches fused_linear_ey={launches}, kernel_path={path}", flush=True)
    if launches < 1 or path.get("ey") != "cuda":
        raise AssertionError("the headline explain did not go through fused_linear_ey")
    phi, add_err = check_explanation(expl, B_HEADLINE)
    _, expl_plain = explain_headline(X, bg, est, device, use_kernel=False)
    phi_plain, _ = check_explanation(expl_plain, B_HEADLINE)
    d_route = float(np.abs(phi - phi_plain).max())
    n_small = 64
    _, expl_cpu = explain_headline(X[:n_small], bg, est, "cpu")
    d_cpu = float(np.abs(phi[:n_small] - check_explanation(expl_cpu, n_small)[0]).max())
    print(f"main path: additivity={add_err:.3e} (< {ADDITIVITY:g}); |phi kernel - phi "
          f"plain route|={d_route:.3e}, |phi card - phi cpu| (first {n_small} rows)="
          f"{d_cpu:.3e} (tol {PHI_ATOL:g}); max|phi|={np.abs(phi).max():.3f}", flush=True)
    if not (d_route <= PHI_ATOL and d_cpu <= PHI_ATOL):
        raise AssertionError("the headline explain disagrees with its references")

    # 5. times
    walls = []
    explainer.explain(X, silent=True)
    for _ in range(3):
        t0 = time.perf_counter()
        explainer.explain(X, silent=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = 1e3 * statistics.median(walls)
    S = explainer._explainer._plan(None).n_rows
    M, N, K = len(ADULT_WIDTHS), N_BACKGROUND, 2
    ey_args = group_space_inputs(np.random.default_rng(args.seed), B_HEADLINE, S, N, M, K,
                                 device, explainer._explainer._plan(None).mask)
    kernel_ms = cuda_time_ms(lambda: cuda_kernels.fused_linear_ey(*ey_args, "softmax"), 50)
    plain_ms = cuda_time_ms(lambda: cuda_kernels.fused_linear_ey_plain(*ey_args, "softmax"), 10)
    bound_ms, bound_by = ey_bound_ms(B_HEADLINE, S, N, M, K, "softmax",
                                     props.multi_processor_count, max_sm_clock_hz())
    print(f"times on {card}: explain B={B_HEADLINE} wall median of 3 = {wall_ms:.3f} ms "
          f"(runs {[round(1e3 * w, 3) for w in walls]}); fused_linear_ey at B={B_HEADLINE} "
          f"S={S} N={N} M={M} K={K}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / kernel_ms:.1f}% of "
          f"bound; library_ms null: no single PyTorch call computes this function",
          flush=True)

    print(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": "fused_linear_ey", "route": "cuda",
        "source": "distributedkernelshap_tpu_torch/csrc/fused_linear_ey.cu",
        "replaces": "distributedkernelshap_tpu/ops/pallas_kernels.py:497",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
