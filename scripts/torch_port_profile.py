#!/usr/bin/env python3
"""Where the PyTorch port's explain time goes, on one CUDA card.

Drives the Adult-shaped headline task of ``chip_smoke.py`` (same generator,
same ``--seed``) through ``KernelShap.explain`` — or, with ``--exact``, the
exact TreeSHAP explain (``nsamples='exact'``) of ``chip_smoke.py``'s seeded
Adult-shaped GBT on the same rows, and with ``--interactions`` its exact
interaction explain (``interactions=True``) — and reports, on the card:

* the explain wall per batch size (one warm-up, then ``--reps`` rounds),
  and in the same rounds, right after each explain, the engine call (device
  work + copy back) and ``build_explanation`` (host) timed apart: medians,
  minima and maxima, so the parts and the whole come from one stretch of
  the run;
* the host split of one explain (``--reps`` more rounds per batch size):
  ``perf_counter`` ranges wrapped around each host stage from outside the
  package (:class:`HostSplit`), each stage's own time with its sub-stages
  taken out, so the stages add up to the wall: input conversion and
  ``_fingerprint``, plan lookup and ``_device_args``, the host-to-device
  upload, the explain function's launches split as the ey products, the
  link and the WLS, the result packing where the tree has it, the
  device-to-host copies (which also wait for the device) and
  ``build_explanation``'s ranking, ``_raw_predictions`` and metadata copies;
* at the largest batch, a ``torch.profiler`` trace of 3 explains: device
  busy time per explain, the device's idle share of the wall, and device
  time by kernel name.

    python3 scripts/torch_port_profile.py [--exact | --interactions] [--seed 0] [--reps 20] [--batches 1 16 256 2560] [--tree DIR] [--out NAME]

``--tree DIR`` imports the port (and ``chip_smoke``) from another checkout,
e.g. ``git archive HEAD | tar -x -C build/base``, so two trees are profiled
by one script; run it twice in one call to compare them.  Prints one line
per measurement and writes the JSON record to ``chiprun_out/NAME.json``
(default ``torch_port_profile``).  Exits 2 without a CUDA device.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stats(ms):
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}


def _busy_us(intervals):
    """Length of the union of ``(start, end)`` intervals."""

    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


class HostSplit:
    """``perf_counter`` ranges around named host stages, patched in from
    outside the package.  Each range books its own time, with the time of
    the ranges opened inside it taken out, under the path of the ranges
    that enclose it (``'get_explanation/_device_args'``), so the stages of
    one explain add up to its wall.  :meth:`restore` undoes every patch."""

    def __init__(self):
        self.self_s = {}
        self._stack = []          # [label path, time of the ranges inside it]
        self._undo = []

    def timed(self, label, fn):
        def wrapper(*args, **kwargs):
            frame = [f"{self._stack[-1][0]}/{label}" if self._stack else label, 0.0]
            self._stack.append(frame)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                self._stack.pop()
                self.self_s[frame[0]] = self.self_s.get(frame[0], 0.0) + dt - frame[1]
                if self._stack:
                    self._stack[-1][1] += dt
        return wrapper

    def patch(self, owner, name, label=None, make=None):
        """Replace ``owner.name`` (a module function, a method of an
        instance or class) by ``make(orig)``, by default ``orig`` in a range
        called ``label``; a missing ``name`` is skipped."""

        orig = getattr(owner, name, None)
        if orig is None:
            return
        self._undo.append((owner, name, orig, name in vars(owner)))
        setattr(owner, name, (make or (lambda f: self.timed(label or name, f)))(orig))

    def restore(self):
        for owner, name, orig, own in reversed(self._undo):
            if own:
                setattr(owner, name, orig)
            else:
                delattr(owner, name)
        self._undo.clear()

    def take(self):
        out, self.self_s = self.self_s, {}
        return out


def instrument(split, explainer, torch):
    """Wrap the host stages of ``explainer``'s explain in ``split``'s
    ranges.  Stages a tree lacks (the packed transfer before it existed)
    are skipped; the explain function is rebuilt so its closure picks up
    the wrapped ey products, link and WLS."""

    from distributedkernelshap_tpu_torch import kernel_shap as ks_mod
    from distributedkernelshap_tpu_torch.ops import explain as ex_mod

    engine = explainer._explainer
    split.patch(explainer, "explain")
    split.patch(explainer, "build_explanation")
    split.patch(explainer, "_raw_predictions")
    split.patch(ks_mod, "rank_by_importance")
    split.patch(engine, "get_explanation")
    split.patch(ks_mod, "_fingerprint")
    for name in ("_plan", "_device_args", "_linear_fast_call", "_pack_fn", "_l1_solve"):
        split.patch(engine, name)
    for mod in (ks_mod, ex_mod):
        split.patch(mod, "pack_transfer")
        split.patch(mod, "unpack_transfer")
    split.patch(ex_mod, "_ey_linear", "ey products (_ey_linear)")
    split.patch(ex_mod, "_wls_solve", "WLS (_wls_solve)")
    split.patch(ex_mod, "convert_to_link",
                make=lambda orig: lambda link: split.timed("link", orig(link)))
    split.patch(ks_mod, "build_explainer_fn", make=lambda orig: lambda *a, **k: split.timed(
        "explain function", orig(*a, **k)))
    split.patch(torch, "as_tensor", "host-to-device upload (torch.as_tensor)")
    split.patch(torch.Tensor, "cpu", "device-to-host copy (.cpu, waits for the device)")
    engine._fn_cache.clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 16, 256, 2560])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--exact", action="store_true",
                    help="profile the exact TreeSHAP explain instead of the headline")
    ap.add_argument("--interactions", action="store_true",
                    help="profile the exact interaction explain instead of the headline")
    ap.add_argument("--tree", default=REPO,
                    help="checkout whose port and chip_smoke.py are profiled")
    ap.add_argument("--out", default="torch_port_profile",
                    help="record name under chiprun_out/")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    card = cs.card_line()
    X, bg, est = cs.adult_task(args.seed)
    path = "interactions" if args.interactions else "exact" if args.exact else "headline"
    if path == "headline":
        explainer, _ = cs.explain_headline(X[:1], bg, est, "cuda")
        kw = {"silent": True}
    else:
        kw = {"nsamples": "exact", "silent": True, "interactions": path == "interactions"}
        explainer, _ = cs.explain_exact(cs.adult_shaped_gbt(args.seed), X[:1], bg, "cuda",
                                        interactions=kw["interactions"])
    engine = explainer._explainer
    record = {"card": card, "path": path, "tree": os.path.abspath(args.tree),
              "batches": []}
    print(f"profiling {path} of the port in {os.path.abspath(args.tree)} on {card}",
          flush=True)
    for B in args.batches:
        Xb = X[:B]
        explainer.explain(Xb, **kw)
        walls, engs, hosts = [], [], []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            explainer.explain(Xb, **kw)             # ends in D2H copies: synced
            t1 = time.perf_counter()
            values = engine.get_explanation(Xb, **kw)
            if isinstance(values, np.ndarray):
                values = [values]                   # as KernelShap.explain wraps it
            t2 = time.perf_counter()
            explainer.build_explanation(Xb, values, list(np.atleast_1d(engine.expected_value)))
            t3 = time.perf_counter()
            walls.append(1e3 * (t1 - t0))
            engs.append(1e3 * (t2 - t1))
            hosts.append(1e3 * (t3 - t2))
        row = {"B": B, "reps": args.reps, "explain_ms": _stats(walls),
               "engine_ms": _stats(engs), "build_explanation_ms": _stats(hosts),
               "engine_plus_build_ms": _stats([e + h for e, h in zip(engs, hosts)])}
        print(f"B={B} on {card}, {args.reps} rounds (median [min, max] ms): "
              + ", ".join(f"{k[:-3]} {v['median']:.3f} [{v['min']:.3f}, {v['max']:.3f}]"
                          for k, v in row.items() if k.endswith("_ms")), flush=True)

        # host split: the same explain with every stage in a range
        split = HostSplit()
        instrument(split, explainer, torch)
        try:
            explainer.explain(Xb, **kw)
            split.take()
            rounds, split_walls = [], []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                explainer.explain(Xb, **kw)
                split_walls.append(1e3 * (time.perf_counter() - t0))
                rounds.append(split.take())
        finally:
            split.restore()
            engine._fn_cache.clear()
        stages = sorted({k for r in rounds for k in r})
        row["host_split_ms"] = {k: statistics.median([1e3 * r.get(k, 0.0) for r in rounds])
                                for k in stages}
        row["host_split_wall_ms"] = _stats(split_walls)
        record["batches"].append(row)
        print(f"  host split at B={B} (median of {args.reps} instrumented rounds, "
              f"wall {row['host_split_wall_ms']['median']:.3f} ms; each stage's own "
              f"time, its sub-stages taken out):", flush=True)
        for k, v in row["host_split_ms"].items():
            print(f"    {v:8.4f} ms  {k}", flush=True)

    B = args.batches[-1]
    Xb = X[:B]
    explainer.explain(Xb, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            explainer.explain(Xb, **kw)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    prof_rec = {"B": B, "explains": 3, "wall_ms_per_explain": wall_us / 3e3,
                "device_busy_ms_per_explain": busy / 3e3,
                "device_idle_share": (1.0 - busy / wall_us) if wall_us else None,
                "n_device_events_per_explain": len(kernels) / 3,
                "top_device_ms_per_explain": {k: v / 3e3 for k, v in top}}
    record["profile"] = prof_rec
    print(f"profile B={B} on {card}: wall {prof_rec['wall_ms_per_explain']:.3f} ms/explain "
          f"(profiler on), device busy {prof_rec['device_busy_ms_per_explain']:.3f} ms, "
          f"idle share {prof_rec['device_idle_share']}, "
          f"{prof_rec['n_device_events_per_explain']:.0f} device events/explain", flush=True)
    for name, ms in prof_rec["top_device_ms_per_explain"].items():
        print(f"  {ms:9.4f} ms  {name[:110]}", flush=True)

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"{args.out}.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
