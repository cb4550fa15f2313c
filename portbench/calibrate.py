"""Readings that set a cell's limits: the port's and the control's, seed by
seed, at the cell's own size.

    python3 portbench/calibrate.py --workload <config>.<mix> --seeds 1 2 3 \
        [--calls 2] [--out readings.jsonl]

For each seed the cell is built as a run builds it, the traffic's call runs
through the port once to warm up and then ``--calls`` times, and what they
returned is judged as a run judges it.  Then the control, the reference
computed in the next precision below the configuration's (float32 products
on TF32, phi rounded to the result dtype as the port's copy rounds it),
stands in the port's place and is judged the same way.  One JSON line per
seed: the port's numbers and the control's.  The benchmark's own runs do
not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell, seed, calls, device):
    """``{"seed", "program": {name: value}, "control": {name: value}}``."""

    import torch

    from portbench import harness

    device = torch.device(device)
    system, traffic = harness.set_up(cell, seed, device, harness.load_spec())
    kept = [system.keep(system.call(traffic), traffic, i) for i in range(calls)]
    kept = [k for k in kept if k is not None]
    harness.free_program(system, device)
    t0 = time.perf_counter()
    program = {n: v for n, v, _ in system.judge(kept, traffic, device)}
    judge_s = time.perf_counter() - t0
    control = {n: v for n, v, _ in system.judge([system.control(traffic, device)],
                                                  traffic, device)}
    return {"seed": seed, "program": program, "control": control, "judge_s": judge_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 3
    out = open(args.out, "a", encoding="utf-8") if args.out else None
    try:
        for seed in args.seeds:
            rec = readings(args.workload, seed, args.calls, "cuda:0")
            rec["workload"] = args.workload
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
