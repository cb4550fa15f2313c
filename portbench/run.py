"""Run one cell of the benchmark and print its result line.

    python3 portbench/run.py --workload <config>.<mix> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  Needs a CUDA card (exits 3 and prints no
result without one, or with fewer than the cell asks for); builds the
port's kernels into the checkout's ``build/kernels`` on its first run, and
keeps the bytecode of every module it imports (PyTorch's too) under
``build/pycache``, written on the first run whatever
``PYTHONDONTWRITEBYTECODE`` says: without it each run compiles PyTorch's
Python sources anew, seconds of set-up that swing with the host's load.
Standard error ends with every compared number beside its limit; the last
line of standard output is the result object, whose last key, ``checks``,
holds the same numbers.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
sys.dont_write_bytecode = False
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""

    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi unavailable"


def report(line, checks, out=sys.stdout, err=sys.stderr) -> None:
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=err)
    print(json.dumps(line), file=out, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "distributedkernelshap_tpu_torch")):
        print("distributedkernelshap_tpu_torch is not in this checkout", file=sys.stderr)
        return 2
    from portbench import harness

    spec = harness.load_spec()
    workload = harness.find_cell(spec, args.workload)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(workload["chips"]):
        print(f"{args.workload} needs {workload['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    line, checks = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                               spec=spec, started=STARTED)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules the run may not load are loaded: {bad}", file=sys.stderr)
        return 4
    print(f"card: {card_line()}; launches {line['counters']['launches']} over "
          f"{line['counters']['calls']} calls", file=sys.stderr)
    report(line, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
