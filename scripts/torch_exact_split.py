#!/usr/bin/env python3
"""Where the exact kernels' time goes at the wide shapes, on one CUDA card.

    python3 scripts/torch_exact_split.py [--seed 0] [--reps 20]

At the dense inputs of ``chip_smoke.py`` phase 52 (``exact_tree_phi``, 100
ungrouped columns, B = 256) and phase 53 (``exact_tree_inter``, 64
columns, B = 64), this checkout's kernels are timed two ways:

* the wrapper by CUDA events, and each device kernel of one call by
  ``torch.profiler`` (the slot-table passes, the pack pass, the tile kernel,
  the tile sum);
* ablations: copies of the kernel's source with one piece taken out or
  swapped, built with this checkout's ``nvcc`` flags into
  ``build/exact_split/`` and launched through the C interface with buffers
  prepared once, so each copy's time against ``full`` prices that piece.
  The copies compute wrong answers; they only time.  ``exact_tree_inter``:
  ``one_row`` (one live row a step instead of two), ``no_corner`` (every
  table read from global memory), ``no_walk`` (no path walked: staging,
  sweeps, gathers, the tile write and the tile sum only);
  ``exact_tree_phi``: ``no_gather`` (the instance bits made up, not
  gathered from x), ``no_body`` (no live row summed), ``no_kernel_work``
  (the epilogue cut, so the compiler drops the sums too).

Prints one line per time and, as its last line, a JSON record; the card's
name and power limit first.  Exits 2 without a CUDA device.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CSRC = REPO / "distributedkernelshap_tpu_torch" / "csrc"
OUT = REPO / "build" / "exact_split"

_INTER_ONE_ROW = """  for (u64 l = lq; l; l &= l - 1) {
    const int n = __ffsll(l) - 1;
    const W su = xo & ~(W)zs[n * kTP + q];
    const int u = popc(su);
    const float w = ws[n];
    const float* tu = t + u * row;
    vvs += w * (FAST ? tu[2 * step] : __ldg(tu + 2 * step));
    if (u == 0) continue;
    const float wuu = w * (FAST ? tu[0] : __ldg(tu));
    const float wuv = w * (FAST ? tu[step] : __ldg(tu + step));
#pragma unroll
    for (int e = 0; e < NE; ++e)
      if ((su & need[e]) == need[e]) acc[e] += mixed[e] ? wuv : wuu;
  }
}

"""

#: per kernel: variant -> [(file, text, replacement)], file "cu" (the
#: kernel's source) or "cuh" (exact_tree_common.cuh)
VARIANTS = {
    "exact_tree_inter": {
        "full": [],
        "one_row": [("cu", "two_rows", _INTER_ONE_ROW)],
        "no_corner": [("cu", "const bool in_corner = vq < kFastTab && popc(xoq) < kFastTab;",
                       "const bool in_corner = false;")],
        "no_walk": [("cu", "for (int q = 0; q < kTP; ++q) {   // the warp's paths, one at a time",
                     "for (int q = 0; q < (live == 12345ull ? 1 : 0); ++q) {")],
    },
    "exact_tree_phi": {
        "full": [],
        "no_gather": [("cuh", "      if (a[sl[j]] > 0.5f) xo |= 1ull << j;\n"
                              "      if (c[sl[j]] > 0.5f) xn |= 1ull << j;",
                       "      if ((bp + j) % 3 == 0) xo |= 1ull << j;\n"
                       "      if ((bp + j) % 3 == 1) xn |= 1ull << j;")],
        "no_body": [("cu", "      const int n = __ffsll(live) - 1;\n      const MaskT su",
                     "      if (live != 12345ull) continue;\n"
                     "      const int n = __ffsll(live) - 1;\n      const MaskT su")],
        "no_kernel_work": [("cu", "      if (j >= jmax) break;\n      const bool has",
                            "      if (j >= 0) break;\n      const bool has")],
    },
}


def variant_sources(name, subs):
    """The kernel's and the shared header's text with ``subs`` applied
    (``"two_rows"`` stands for inter's two-row loop, up to the next
    function)."""

    text = {"cu": (CSRC / f"{name}.cu").read_text(),
            "cuh": (CSRC / "exact_tree_common.cuh").read_text()}
    for f, old, new in subs:
        if old == "two_rows":
            src = text[f]
            old = src[src.index("  // two rows a step"):src.index("// walk_rows for the band")]
        if old not in text[f]:
            raise RuntimeError(f"{name}: the text to replace is not in the source:\n{old}")
        text[f] = text[f].replace(old, new)
    return text


def build_variants(name):
    """Build every variant of ``name``, one ``nvcc`` each, all started
    together; ``{variant: library}``."""

    from distributedkernelshap_tpu_torch.ops import cuda_kernels as ck

    procs = {}
    for var, subs in VARIANTS[name].items():
        d = OUT / f"{name}_{var}"
        d.mkdir(parents=True, exist_ok=True)
        text = variant_sources(name, subs)
        (d / f"{name}.cu").write_text(text["cu"])
        (d / "exact_tree_common.cuh").write_text(text["cuh"])
        so = d / f"{name}.so"
        procs[var] = (so, subprocess.Popen(
            [ck._nvcc(), *ck.NVCC_FLAGS, "-o", str(so), str(d / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for var, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"building {name} {var} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for sym, (argtypes, restype) in ck._SYMBOLS[name].items():
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = argtypes, restype
        libs[var] = lib
    return libs


def launcher(lib, name, args, dmax):
    """One C-interface launch of ``lib`` on ``args`` with every buffer (the
    slot table from this checkout's wrapper path) prepared once."""

    import torch

    from distributedkernelshap_tpu_torch.ops import cuda_kernels as ck

    x_only = args[0]
    B, P, M = x_only.shape
    N, K = args[2].shape[0], args[4].shape[1]
    dev, dm = x_only.device, min(int(dmax), M)
    shape = (B, M, K) if name == "exact_tree_phi" else (B, M, M, K)
    out = torch.empty(shape, device=dev)
    kind = "phi" if name == "exact_tree_phi" else "inter"
    tables = ck.exact_weight_tables(kind, dm, M, dev)
    slots, _ = ck.slot_table(x_only, args[1])
    zbits = torch.empty((N, P), dtype=torch.int64, device=dev)
    zdead = torch.empty((N, P), dtype=torch.uint8, device=dev)
    partial = torch.empty((getattr(lib, f"{name}_partial_tiles")(P), *shape), device=dev)
    ptrs = [t.data_ptr() for t in args] + [t.data_ptr() for t in (
        tables, slots, zbits, zdead, partial, out)]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = getattr(lib, f"{name}_launch")(*ptrs, B, P, N, M, K, dm, stream)
        if err:
            raise RuntimeError(f"{name} launch failed with CUDA error {err}")
        return out

    launch.buffers = (args, tables, slots, zbits, zdead, partial, out)
    return launch


def profile_split(fn, calls=10):
    """Device time per kernel name of one ``fn()``, ms, by torch.profiler
    over ``calls`` calls."""

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(r.key, r.device_time_total / calls / 1e3) for r in prof.key_averages()
            if r.device_time_total > 0]

    def short(key):
        return key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]

    out = {}
    for key, ms in sorted(rows, key=lambda r: -r[1]):
        out[short(key)] = out.get(short(key), 0.0) + ms
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_exact_split: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from distributedkernelshap_tpu_torch.ops import cuda_kernels as ck

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    device = torch.device("cuda", 0)
    cases = []
    for name, M, B, inter in (("exact_tree_phi", cs.M_WIDE, cs.B_EXACT, False),
                              ("exact_tree_inter", cs.M_INTER_WIDE, cs.B_INTER_WIDE, True)):
        tables, X, bg = cs.wide_gbt(args.seed, M)
        X = X[:B]
        explainer, _ = cs.explain_exact(tables, X, bg, device, pack_paths=None if inter else False,
                                        interactions=inter, grouped=False)
        kargs, dmax = cs.dense_inputs(explainer, X, device)
        cases.append((name, M, B, kargs, dmax))
    record = {"card": card, "cases": []}
    for name, M, B, kargs, dmax in cases:
        wrapper = getattr(ck, name)
        wrapper_ms = cs.cuda_time_ms(lambda: wrapper(*kargs, dmax=dmax), args.reps)
        split = profile_split(lambda: wrapper(*kargs, dmax=dmax))
        libs = build_variants(name)
        runs = {var: launcher(lib, name, kargs, dmax) for var, lib in libs.items()}
        times = {var: [] for var in runs}
        for _ in range(2):
            for var, go in runs.items():
                times[var].append(cs.cuda_time_ms(go, args.reps))
        label = f"{name} dense M={M} B={B} dmax={dmax}"
        print(f"{label} on {card}: wrapper {wrapper_ms:.4f} ms; device kernels of one call "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
        for var, t in times.items():
            print(f"{label} on {card}: C launch (slot table apart), {var}: "
                  f"{t[0]:.4f} / {t[1]:.4f} ms", flush=True)
        record["cases"].append({"case": label, "wrapper_ms": wrapper_ms, "kernels_ms": split,
                                "variants_ms": times})
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
