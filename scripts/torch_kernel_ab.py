#!/usr/bin/env python3
"""Time kernels of this checkout against those of another checkout of the
port (an earlier commit), on the same card in one process.

    python3 scripts/torch_kernel_ab.py --kernel {ey,exact} --base DIR [--seed 0] [--reps 50]
    python3 scripts/torch_kernel_ab.py --kernel exact --walls --base TREE [--seed 0]

``DIR`` is the root of the other checkout (for instance a ``git archive`` of
the parent commit unpacked into ``build/``).  Its kernel sources are built
with this checkout's ``nvcc`` flags into ``build/base_kernels/`` and called
through their C interface.

- ``--kernel ey``: ``csrc/fused_linear_ey.cu`` of both checkouts through
  ``fused_linear_ey_launch`` (with the general softmax's scratch, and the
  epilogue's link and tensors, where the source takes them; the background
  weights normalised and the buffers
  allocated as the wrapper does, once and outside the timed launches, and
  the wrapper's own checks out of both arms, so the times at small shapes
  compare kernels, not host issue), at the headline inputs of
  ``chip_smoke.py`` (binary softmax, B = 2560, S = 2072 coalitions of the
  Adult plan, N = 100, M = 12, K = 2), at sigmoid K = 2, 7 (B = 512, S =
  1024) and 32 (B = 128, S = 512), at general softmax K = 3, 7, 8, the
  small-K route's last K and the first past it (read from this checkout's
  ``fused_linear_ey_route``) and 32 (B = 512, S = 1024), at K = 100 at the
  headline shape, at one Covertype chunk (B = 65536, K = 7, S = 2072; both
  at a tenth of the reps) and at K = 7 over 48 groups (B = 8192, S =
  2048), N = 100, M = 12 elsewhere; the outputs must agree within 1e-5.
  Then the epilogue's own cost, at the Covertype chunk, at K = 3, 8 and 16
  (B = 512, S = 1024), at K = 100 and at the headline: the base's raw
  ``ey`` against this checkout writing the logit link's least-squares
  operand (``link=2``, E and f(x) − E seeded), whose output is held to the
  torch ops on the base's ``ey`` (``ey_epilogue_plain``): bit for bit
  where the card's ``logf`` is torch's, and within 1e-3 (ROADMAP C.9's
  floor) in any case; a base that has the epilogue runs it too.
- ``--kernel exact``: ``csrc/exact_tree_phi.cu`` and
  ``csrc/exact_tree_inter.cu`` through the C interface of the base's
  sources, read from them: the one before the weight tables moved to the
  wrapper (``..., bgw, zbits, table, partial, out, B, P, N, M, K, dmax,
  stream``, the binomial table built on the card), the one with the tables
  and the dead bit in the group word (``..., bgw, tables, zbits, partial,
  out, ...``), or this one (``..., bgw, tables, slots, zbits, zdead,
  partial, out, ...``, the slot table passed where this checkout's wrapper
  builds one, so a base that runs by group at a width ignores it); at the
  inputs of ``chip_smoke.py``'s exact and interaction phases: the seeded
  Adult-shaped GBT at B = 256, N = 100, M = 12 -- the inputs of the exact
  and interaction explains' one block, which must stay bit-identical to
  the base; then the wide
  shapes: phase 52's dense ``exact_tree_phi`` inputs at M = 100 (B = 256)
  and M = 300 (B = 64), phase 53's dense inputs at M = 64 (B = 64) for
  both kernels, and a seeded banded ``exact_tree_inter`` case at M = 32, K
  = 3, N = 130 (``chip_smoke.phi_edge_inputs``); the outputs must agree
  within the kernels' bars (phi 2e-5·max(1, max|phi|), the raw pair sum
  atol = rtol = 3e-5).

With ``--walls`` the script times explains instead of kernels: ``TREE`` is
a whole other checkout (its ``chip_smoke.py`` beside its package), and each
checkout, in its own process in the order base, this, this, base, times
the exact explains of ``chip_smoke.py`` phases 52 and 53 with its own
package (the dense route over 100 columns at B = 256 and over 300 at B =
64, the interactions over 64 at B = 64; ``chip_smoke.median_wall_ms`` of
5 after a warm-up); the line per explain gives each run's median and the
ratio of the medians.

Each kernel is timed by CUDA events in the order base, this, this, base,
twice, and each case prints the median of each arm's four times and their
ratio, base/this (the small exact launches are host-bound: one slow run
moves a mean).  Prints the card's name and power
limit and, as its last line, a JSON record with every time; exits 2 without
a CUDA device.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

_VOID, _INT = ctypes.c_void_p, ctypes.c_int
#: per kernel choice: each source's launch function
SOURCES = {"ey": ("fused_linear_ey",), "exact": ("exact_tree_phi", "exact_tree_inter")}


def interface(source: str) -> str:
    """The C interface of a kernel source: ``"ey_epilogue"`` (the scratch,
    then the epilogue's E and f(x) − E after ``out``, its link after the
    activation), ``"ey"`` (the general softmax's scratch after ``out``) or
    ``"ey_no_scratch"`` (before it); for an exact kernel
    ``"binomial"`` (the binomial table built on the card), ``"tables"`` (the
    wrapper's weight tables, the dead bit in the group word) or ``"slots"``
    (the tables, a slot table and a dead-flag array)."""

    if "fused_linear_ey_launch(" in source:
        if "const float* fxme" in source:
            return "ey_epilogue"
        return "ey" if "float* scratch" in source else "ey_no_scratch"
    if "void* zdead" in source:
        return "slots"
    return "tables" if "_smem_bytes(int M)" in source else "binomial"


#: launch argument types per interface
_ARGS = {"ey_epilogue": [_VOID] * 9 + [_INT] * 7 + [_VOID],
         "ey": [_VOID] * 7 + [_INT] * 6 + [_VOID],
         "ey_no_scratch": [_VOID] * 6 + [_INT] * 6 + [_VOID],
         "binomial": [_VOID] * 10 + [_INT] * 6 + [_VOID],
         "tables": [_VOID] * 10 + [_INT] * 6 + [_VOID],
         "slots": [_VOID] * 12 + [_INT] * 6 + [_VOID]}


def build_base(base: Path, kernel: str):
    """Build the other checkout's sources for ``kernel``, one ``nvcc`` each,
    all started together; returns their libraries by name."""

    from distributedkernelshap_tpu_torch.ops import cuda_kernels

    out_dir = REPO / "build" / "base_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = base / "distributedkernelshap_tpu_torch" / "csrc"
    procs, libs = {}, {}
    for name in SOURCES[kernel]:
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
        lib.interface = interface((csrc / f"{name}.cu").read_text())
        getattr(lib, f"{name}_launch").argtypes = _ARGS[lib.interface]
        getattr(lib, f"{name}_launch").restype = _INT
        if lib.interface in ("ey", "ey_epilogue"):
            lib.fused_linear_ey_scratch_floats.argtypes = [_INT] * 4
            lib.fused_linear_ey_scratch_floats.restype = ctypes.c_longlong
        if kernel == "exact":
            getattr(lib, f"{name}_partial_tiles").argtypes = [_INT]
        libs[name] = lib
    return libs


def ey_launcher(lib, args, activation, epilogue=None):
    """A launch of a checkout's ``fused_linear_ey`` library ``lib`` on
    ``args`` as the wrapper makes it (the background weights normalised,
    the output and any scratch allocated), those done once: the returned
    function only calls the C interface and returns the output.
    ``epilogue``, ``(link code, E, f(x) − E)``, asks an ``"ey_epilogue"``
    library for the least squares' operand in place of ``ey``."""

    import torch

    from distributedkernelshap_tpu_torch.ops import cuda_kernels

    XWg, bgWg, bgW, bgw, mask = args
    B, M, K = XWg.shape
    N, S = bgWg.shape[0], mask.shape[0]
    code = {"softmax": 0, "sigmoid": 1}[activation]
    if epilogue is not None and lib.interface != "ey_epilogue":
        raise ValueError(f"a {lib.interface!r} library has no epilogue")
    bgw = (bgw / bgw.sum()).contiguous()
    if epilogue is not None and cuda_kernels.operand_coalition_major(lib, K, code, "logit"):
        out = torch.empty((S, B, K), dtype=torch.float32, device=XWg.device).permute(1, 0, 2)
    else:
        out = torch.empty((B, S, K), dtype=torch.float32, device=XWg.device)
    ptrs = [t.data_ptr() for t in (XWg, bgWg, bgW, bgw, mask, out)]
    scratch, link = None, []
    if lib.interface in ("ey", "ey_epilogue"):
        n = lib.fused_linear_ey_scratch_floats(S, N, K, code)
        scratch = torch.empty((n,), dtype=torch.float32, device=XWg.device) if n else None
        ptrs.append(None if scratch is None else scratch.data_ptr())
    if lib.interface == "ey_epilogue":
        ptrs += [None, None] if epilogue is None else [t.data_ptr() for t in epilogue[1:]]
        link = [0 if epilogue is None else epilogue[0]]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.fused_linear_ey_launch(*ptrs, B, S, N, M, K, code, *link, stream)
        if err:
            raise RuntimeError(f"fused_linear_ey launch failed with CUDA error {err}")
        return out

    # the launcher holds only pointers: it keeps their tensors alive
    launch.buffers = (args, bgw, scratch, epilogue)
    return launch


def exact_base_call(lib, name, args, dmax):
    """One launch of a base exact kernel through its C interface
    (:func:`interface`); the weight tables of the later interfaces are this
    checkout's (the same for up to 64 groups); the slot table of the
    ``"slots"`` interface is :func:`path_slots`' (the plain version, as the
    earlier wrappers built it), where this checkout's wrapper builds one (a
    source that runs by group at that width ignores it)."""

    import torch

    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        _SLOT_M,
        exact_weight_tables,
        path_slots,
    )

    x_only = args[0]
    B, P, M = x_only.shape
    N, K = args[2].shape[0], args[4].shape[1]
    dm = min(int(dmax), M)
    dev = x_only.device
    shape = (B, M, K) if name == "exact_tree_phi" else (B, M, M, K)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    zbits = torch.empty((N, P), dtype=torch.int64, device=dev)
    partial = torch.empty((getattr(lib, f"{name}_partial_tiles")(P), *shape),
                          dtype=torch.float32, device=dev)
    kind = "phi" if name == "exact_tree_phi" else "inter"
    if lib.interface == "binomial":
        table = torch.empty(((dm + 1) * (M + 1),), dtype=torch.float32, device=dev)
        scratch = (zbits.data_ptr(), table.data_ptr())
    elif lib.interface == "tables":
        scratch = (exact_weight_tables(kind, dm, M, dev).data_ptr(), zbits.data_ptr())
    else:
        zdead = torch.empty((N, P), dtype=torch.uint8, device=dev)
        slots = path_slots(args[0], args[1]) if M >= _SLOT_M[name][1] else None
        scratch = (exact_weight_tables(kind, dm, M, dev).data_ptr(),
                   None if slots is None else slots.data_ptr(), zbits.data_ptr(),
                   zdead.data_ptr())
    err = getattr(lib, f"{name}_launch")(
        *(t.data_ptr() for t in args), *scratch, partial.data_ptr(), out.data_ptr(),
        B, P, N, M, K, dm, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"base {name} launch failed with CUDA error {err}")
    return out


def ey_cases(base, seed, device):
    """``(label, shape, run_base, run_this, agree, reps_divisor, expect)``
    for ``--kernel ey``; ``agree(got, ref)`` gives the max abs difference
    and whether it is within the bar, ``expect`` (or None) what this
    checkout should give for the base's output."""

    import numpy as np
    import torch

    import chip_smoke as cs
    from distributedkernelshap_tpu_torch.ops import cuda_kernels

    mine = cuda_kernels._library("fused_linear_ey")
    mine.interface = "ey_epilogue"
    rng = np.random.default_rng(seed)
    M, N = len(cs.ADULT_WIDTHS), cs.N_BACKGROUND
    mask = cs.coalition_plan_mask()
    # the small-K route's last K, from this checkout's library
    small = max(K for K in range(1, 257) if mine.fused_linear_ey_route(K, 0) == 2)
    specs = [("headline binary softmax", "softmax", cs.B_HEADLINE, len(mask), 2, mask, 1),
             ("sigmoid K=2", "sigmoid", 512, 1024, 2, None, 1)]
    specs += [(f"general softmax K={K}", "softmax", 512, 1024, K, None, 1)
              for K in sorted({3, 7, 8, small, small + 1, 32})]
    specs += [("general softmax K=100, headline shape", "softmax", cs.B_HEADLINE, len(mask),
               100, mask, 10),
              ("general softmax K=7, Covertype chunk", "softmax", cs.COVERTYPE_CHUNK,
               len(mask), cs.COVERTYPE_CLASSES, mask, 10),
              ("general softmax K=7, M=48", "softmax", 8192, 2048, 7, None, 10),
              ("sigmoid K=7", "sigmoid", 512, 1024, 7, None, 1),
              ("sigmoid K=32", "sigmoid", 128, 512, 32, None, 1)]

    def agree(got, ref):
        diff = float((got - ref).abs().max())
        return diff, diff <= cs.EY_ATOL

    def operand_agree(got, ref):
        diff = float((got - ref).abs().max())
        return diff, diff <= cs.PHI_ATOL

    cases = []
    epilogue_of = {"general softmax K=7, Covertype chunk", "general softmax K=3",
                   "general softmax K=8", "general softmax K=16",
                   "general softmax K=100, headline shape", "headline binary softmax"}
    for label, act, B, S, K, m, div in specs:
        kargs = cs.group_space_inputs(rng, B, S, N, 48 if "M=48" in label else M, K, device, m)
        run_base = ey_launcher(base["fused_linear_ey"], kargs, act)
        cases.append((label, [B, S, N, M, K], run_base, ey_launcher(mine, kargs, act), agree,
                      div, None))
        if label not in epilogue_of:
            continue
        # the logit link's operand, from a seeded E and f(x) - E of logit size
        ev = torch.tensor(rng.normal(size=K), dtype=torch.float32, device=device)
        fxme = torch.tensor(rng.normal(scale=2.0, size=(B, K)), dtype=torch.float32,
                            device=device)

        def expect(ref, mask=kargs[4], ev=ev, fxme=fxme):
            return cuda_kernels.ey_epilogue_plain(ref, mask, "logit", ev, fxme)

        epi = (cuda_kernels.EY_LINK_CODES["logit"], ev, fxme)
        if base["fused_linear_ey"].interface == "ey_epilogue":
            # a base with the epilogue runs it too
            run_base, expect = ey_launcher(base["fused_linear_ey"], kargs, act, epi), None
        cases.append((f"{label}, logit epilogue", [B, S, N, M, K], run_base,
                      ey_launcher(mine, kargs, act, epi), operand_agree, div, expect))
    return cases


def exact_cases(base, seed, device):
    """``(label, shape, run_base, run_this, agree, reps_divisor)`` for
    ``--kernel exact``; the fixture-width cases' ``agree`` also asks for
    bit-identity with the base."""

    import numpy as np
    import torch

    import chip_smoke as cs
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        exact_tree_inter,
        exact_tree_phi,
    )

    X, bg, _ = cs.adult_task(seed)
    X = X[:cs.B_EXACT]
    tables = cs.adult_shaped_gbt(seed)
    inter, _ = cs.explain_exact(tables, X, bg, device, interactions=True)
    dense, dmax = cs.dense_inputs(inter, X, device)
    specs = [("exact_tree_phi dense", "exact_tree_phi", dense, dmax, True),
             ("exact_tree_inter dense", "exact_tree_inter", dense, dmax, True)]
    # the wide shapes of phases 52 and 53, as those phases form them
    for M, B in ((cs.M_WIDE, cs.B_EXACT), (cs.M_WIDEST, cs.B_WIDEST)):
        t, Xw, bgw = cs.wide_gbt(seed, M)
        expl, _ = cs.explain_exact(t, Xw[:B], bgw, device, grouped=False)
        a, d = cs.dense_inputs(expl, Xw[:B], device)
        specs.append((f"exact_tree_phi dense M={M} B={B}", "exact_tree_phi", a, d, False))
    t, Xw, bgw = cs.wide_gbt(seed, cs.M_INTER_WIDE)
    Xw = Xw[:cs.B_INTER_WIDE]
    expl, _ = cs.explain_exact(t, Xw, bgw, device, interactions=True, grouped=False)
    a, d = cs.dense_inputs(expl, Xw, device)
    for name in ("exact_tree_phi", "exact_tree_inter"):
        specs.append((f"{name} dense M={cs.M_INTER_WIDE} B={cs.B_INTER_WIDE}", name, a, d,
                      False))
    rng = np.random.default_rng([seed, 21])
    specs.append(("exact_tree_inter banded M=32 K=3 N=130", "exact_tree_inter",
                  cs.phi_edge_inputs(rng, 64, 256, 130, 32, 3, device), 32, False))
    mine = {"exact_tree_phi": exact_tree_phi, "exact_tree_inter": exact_tree_inter}

    def phi_agree(got, ref):
        diff = float((got - ref).abs().max())
        return diff, diff <= cs.phi_tol(ref.cpu().numpy())

    def bitwise(agree):
        def both(got, ref):
            diff, ok = agree(got, ref)
            return diff, ok and bool(torch.equal(got, ref))
        return both

    cases = []
    for label, name, kargs, d, fixture in specs:
        shape = list(kargs[0].shape[:2]) + [kargs[2].shape[0], kargs[0].shape[2],
                                            kargs[4].shape[1]]
        agree = cs.raw_close if name == "exact_tree_inter" else phi_agree
        cases.append((label, shape,
                      lambda name=name, kargs=kargs, d=d: exact_base_call(base[name], name,
                                                                          kargs, d),
                      lambda name=name, kargs=kargs, d=d: mine[name](*kargs, dmax=d),
                      bitwise(agree) if fixture else agree, 1, None))
    return cases


#: one checkout's wide exact explain walls (``--walls``), run with that
#: checkout as the working directory: its own chip_smoke and package
WALLS_CODE = r"""
import json, sys
import torch
import chip_smoke as cs
seed, dev, out = int(sys.argv[1]), torch.device("cuda", 0), {}
for M, B, inter in ((cs.M_WIDE, cs.B_EXACT, False), (cs.M_WIDEST, cs.B_WIDEST, False),
                    (cs.M_INTER_WIDE, cs.B_INTER_WIDE, True)):
    tables, X, bg = cs.wide_gbt(seed, M)
    X = X[:B]
    explainer, _ = cs.explain_exact(tables, X, bg, dev, interactions=inter, grouped=False)
    ms, _ = cs.median_wall_ms(lambda: explainer.explain(X, nsamples="exact", silent=True,
                                                        interactions=inter), 5)
    out[f"{'interactions' if inter else 'dense'} M={M} B={B}"] = ms
print(json.dumps(out))
"""


def explain_walls(base: Path, seed: int, card: str) -> int:
    """``--walls``: the wide exact explain walls of ``base`` and of this
    checkout, each in its own process, base, this, this, base."""

    runs = {"base": [], "this": []}
    for arm, tree in (("base", base), ("this", REPO), ("this", REPO), ("base", base)):
        proc = subprocess.run([sys.executable, "-c", WALLS_CODE, str(seed)], cwd=tree,
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"the {arm} walls at {tree} failed:\n{proc.stderr[-4000:]}")
        runs[arm].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    record = {"card": card, "walls": []}
    for name in runs["this"][0]:
        b = [r[name] for r in runs["base"]]
        t = [r[name] for r in runs["this"]]
        ratio = statistics.median(b) / statistics.median(t)
        record["walls"].append({"explain": name, "base_ms": b, "this_ms": t, "speedup": ratio})
        print(f"{name} explain wall on {card}: base {' / '.join(f'{x:.3f}' for x in b)} ms, "
              f"this {' / '.join(f'{x:.3f}' for x in t)} ms, base/this (medians) "
              f"{ratio:.2f}x", flush=True)
    print(f"card: {card}")
    print(json.dumps(record))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES), required=True)
    ap.add_argument("--base", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--walls", action="store_true",
                    help="time the wide exact explains of two whole checkouts")
    args = ap.parse_args()
    if args.walls and args.kernel != "exact":
        ap.error("--walls times the exact explains: use it with --kernel exact")

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    card = cs.card_line()
    if args.walls:
        return explain_walls(args.base.resolve(), args.seed, card)
    base = build_base(args.base.resolve(), args.kernel)
    device = torch.device("cuda", 0)
    make = ey_cases if args.kernel == "ey" else exact_cases
    cases = make(base, args.seed, device)
    record = {"card": card, "kernel": args.kernel, "reps": args.reps, "cases": []}
    for label, shape, run_base, run_mine, agree, div, expect in cases:
        got = run_mine().clone()
        ref = run_base()
        if expect is not None:
            ref = expect(ref)
        torch.cuda.synchronize()
        if not bool(got.isfinite().all()):
            raise AssertionError(f"{label}: this checkout's output is not finite")
        diff, ok = agree(got, ref)
        if not ok:
            raise AssertionError(f"{label}: this checkout and the base disagree ({diff})")
        reps = max(1, args.reps // div)
        order = (run_base, run_mine, run_mine, run_base) * 2
        times = [cs.cuda_time_ms(fn, reps) for fn in order]
        base_t = [t for fn, t in zip(order, times) if fn is run_base]
        this_t = [t for fn, t in zip(order, times) if fn is run_mine]
        b_ms, m_ms = statistics.median(base_t), statistics.median(this_t)
        same = bool(torch.equal(got, ref))
        record["cases"].append({"case": label, "shape": shape, "reps": reps,
                                "base_ms": base_t, "this_ms": this_t, "base_median_ms": b_ms,
                                "this_median_ms": m_ms, "speedup": b_ms / m_ms,
                                "max_abs_diff": diff, "bit_identical": same})
        print(f"{label} {shape} on {card}: base {' / '.join(f'{t:.4f}' for t in base_t)} ms, "
              f"this {' / '.join(f'{t:.4f}' for t in this_t)} ms, base/this (medians) "
              f"{b_ms / m_ms:.2f}x, max |this - base| {diff:.3e}, bit-identical {same}",
              flush=True)
    print(f"card: {card}")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
