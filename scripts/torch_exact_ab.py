#!/usr/bin/env python3
"""Time the exact kernels of this checkout against those of another
checkout of the port (an earlier commit), on the same card in one process,
at the main path's inputs.

    python3 scripts/torch_exact_ab.py --base DIR [--seed 0] [--reps 50]

``DIR`` is the root of the other checkout (for instance a ``git archive`` of
the parent commit unpacked into ``build/``).  Its ``csrc/exact_tree_phi.cu``
and ``csrc/exact_tree_inter.cu`` are built with this checkout's ``nvcc``
flags and called through the C interface they had before the weight tables
moved to the wrapper (``..., bgw, zbits, table, partial, out, B, P, N, M, K,
dmax, stream``, the binomial table built on the card).

Inputs are those of ``chip_smoke.py``'s exact and interaction phases: the
seeded Adult-shaped GBT at B = 256, N = 100, M = 12 -- the two packed depth
buckets of the exact explain and the dense inputs of the interaction
explain.  Each kernel is timed by CUDA events in the order base, this,
this, base; the two outputs must agree within the kernels' bars (phi
2e-5·max(1, max|phi|), the raw pair sum atol = rtol = 3e-5).  Prints the
card's name and power limit and, as its last line, a JSON record with
every time; exits 2 without a CUDA device.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

_VOID, _INT = ctypes.c_void_p, ctypes.c_int


def build_base(base: Path):
    """Build the other checkout's two exact kernels; returns their libraries."""

    from distributedkernelshap_tpu_torch.ops import cuda_kernels

    out_dir = REPO / "build" / "base_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = base / "distributedkernelshap_tpu_torch" / "csrc"
    procs, libs = {}, {}
    for name in ("exact_tree_phi", "exact_tree_inter"):
        so = out_dir / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [cuda_kernels._nvcc(), *cuda_kernels.NVCC_FLAGS, "-o", str(so),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"building the base {name} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        getattr(lib, f"{name}_launch").argtypes = [_VOID] * 10 + [_INT] * 6 + [_VOID]
        getattr(lib, f"{name}_launch").restype = _INT
        getattr(lib, f"{name}_partial_tiles").argtypes = [_INT]
        libs[name] = lib
    return libs


def base_call(lib, name, args, dmax):
    """One launch of the base kernel through its earlier C interface."""

    import torch

    x_only = args[0]
    B, P, M = x_only.shape
    N, K = args[2].shape[0], args[4].shape[1]
    dm = min(int(dmax), M)
    dev = x_only.device
    shape = (B, M, K) if name == "exact_tree_phi" else (B, M, M, K)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    zbits = torch.empty((N, P), dtype=torch.int64, device=dev)
    table = torch.empty(((dm + 1) * (M + 1),), dtype=torch.float32, device=dev)
    partial = torch.empty((getattr(lib, f"{name}_partial_tiles")(P), *shape),
                          dtype=torch.float32, device=dev)
    err = getattr(lib, f"{name}_launch")(
        *(t.data_ptr() for t in args), zbits.data_ptr(), table.data_ptr(),
        partial.data_ptr(), out.data_ptr(), B, P, N, M, K, dm,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"base {name} launch failed with CUDA error {err}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_exact_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        exact_tree_inter,
        exact_tree_phi,
    )

    card = cs.card_line()
    base = build_base(args.base.resolve())
    device = torch.device("cuda", 0)
    X, bg, _ = cs.adult_task(args.seed)
    X = X[:cs.B_EXACT]
    tables = cs.adult_shaped_gbt(args.seed)
    packed, _ = cs.explain_exact(tables, X, bg, device, pack_paths=True)
    inter, _ = cs.explain_exact(tables, X, bg, device, interactions=True)
    cases = [(f"exact_tree_phi packed bucket {i} dmax={d}", "exact_tree_phi", a, d)
             for i, (a, d) in enumerate(cs.bucket_inputs(packed, X, device))]
    dense, dmax = cs.dense_inputs(inter, X, device)
    cases += [("exact_tree_phi dense", "exact_tree_phi", dense, dmax),
              ("exact_tree_inter dense", "exact_tree_inter", dense, dmax)]
    mine = {"exact_tree_phi": exact_tree_phi, "exact_tree_inter": exact_tree_inter}
    record = {"card": card, "reps": args.reps, "cases": []}
    for label, name, kargs, d in cases:
        def run_base():
            return base_call(base[name], name, kargs, d)

        def run_mine():
            return mine[name](*kargs, dmax=d)

        got, ref = run_mine(), run_base()
        torch.cuda.synchronize()
        if name == "exact_tree_phi":
            diff = float((got - ref).abs().max())
            agree = diff <= cs.phi_tol(ref.cpu().numpy())
        else:
            diff, agree = cs.raw_close(got, ref)
        if not agree:
            raise AssertionError(f"{label}: this checkout and the base disagree ({diff})")
        times = [cs.cuda_time_ms(fn, args.reps)
                 for fn in (run_base, run_mine, run_mine, run_base)]
        b_ms, m_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        record["cases"].append({"case": label, "shape": list(kargs[0].shape[:2]) + [
            kargs[2].shape[0], kargs[0].shape[2], kargs[4].shape[1]], "dmax": d,
            "base_ms": [times[0], times[3]], "this_ms": [times[1], times[2]],
            "speedup": b_ms / m_ms, "max_abs_diff": diff})
        print(f"{label} on {card}: base {times[0]:.4f} / {times[3]:.4f} ms, this "
              f"{times[1]:.4f} / {times[2]:.4f} ms, speedup {b_ms / m_ms:.2f}x, "
              f"max |this - base| {diff:.3e}", flush=True)
    packed_rows = [c for c in record["cases"] if "packed" in c["case"]]
    record["packed_per_explain"] = {
        "base_ms": float(np.mean([sum(c["base_ms"][i] for c in packed_rows) for i in (0, 1)])),
        "this_ms": float(np.mean([sum(c["this_ms"][i] for c in packed_rows) for i in (0, 1)]))}
    print(f"exact_tree_phi packed per explain ({len(packed_rows)} launches) on {card}: "
          f"base {record['packed_per_explain']['base_ms']:.4f} ms, this "
          f"{record['packed_per_explain']['this_ms']:.4f} ms", flush=True)
    print(f"card: {card}")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
