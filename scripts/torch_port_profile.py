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
* at the largest batch, a ``torch.profiler`` trace of 3 explains: device
  busy time per explain, the device's idle share of the wall, and device
  time by kernel name.

    python3 scripts/torch_port_profile.py [--exact | --interactions] [--seed 0] [--reps 20] [--batches 1 16 256 2560]

Prints one line per measurement and writes the JSON record to
``chiprun_out/torch_port_profile.json``.  Exits 2 without a CUDA device.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 16, 256, 2560])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--exact", action="store_true",
                    help="profile the exact TreeSHAP explain instead of the headline")
    ap.add_argument("--interactions", action="store_true",
                    help="profile the exact interaction explain instead of the headline")
    args = ap.parse_args()

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
    record = {"card": card, "path": path, "batches": []}
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
        record["batches"].append(row)
        print(f"B={B} on {card}, {args.reps} rounds (median [min, max] ms): "
              + ", ".join(f"{k[:-3]} {v['median']:.3f} [{v['min']:.3f}, {v['max']:.3f}]"
                          for k, v in row.items() if k.endswith("_ms")), flush=True)

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
    with open(os.path.join(REPO, "chiprun_out", "torch_port_profile.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
