"""Static analysis of the PyTorch port and its unified gate (the port's
counterpart of ``scripts/dks_lint.py``).

Runs the three analyzer families of ``distributedkernelshap_tpu_torch/
analysis/`` (concurrency ``DKS-C``, torch contract ``DKS-J``, serving ladder
``DKS-L``) over the port's package, applies the inline-pragma + port
``analysis/baseline.toml`` suppression contract, and prints one line per
finding::

    file:line: DKS-C001 [Class.attr] message (fix: hint)

``--check`` additionally chains the port's observability drift lint
(``scripts/torch_observability_check.py``) and alert-engine golden replay
(``scripts/torch_health_check.py``) behind ONE exit code, and asserts the
static pass stayed inside its 60 s budget.  Imports nothing of JAX or of
the JAX package.

Exit 0: no unsuppressed findings, no stale baseline entries, gates green,
and no module of JAX or of the JAX package loaded in this process
(``foreign_modules``).  Exit 1 otherwise.  The last line of stdout is
the JSON report.

    python scripts/torch_lint.py            # static findings only
    python scripts/torch_lint.py --check    # the full unified gate
"""

import argparse
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

#: the static pass must stay cheap enough to gate every test run
STATIC_BUDGET_S = 60.0


def run_static(verbose: bool = True):
    from distributedkernelshap_tpu_torch.analysis.driver import lint_repo

    result = lint_repo(REPO_ROOT)
    if verbose:
        for finding in result.active:
            print(f"torch-lint: {finding.render()}")
        for err in result.parse_errors:
            print(f"torch-lint: PARSE ERROR {err}")
        for entry in result.stale_baseline:
            print(f"torch-lint: STALE BASELINE entry {entry.id} "
                  f"{entry.file} [{entry.symbol or '*'}] -- the accepted "
                  f"finding no longer exists; delete the entry")
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check", action="store_true",
                        help="unified gate: static lint + observability "
                             "check + health replay behind one exit code, "
                             "with the static runtime budget asserted")
    args = parser.parse_args()

    result = run_static()
    report = {
        "files_scanned": result.files_scanned,
        "findings": len(result.active),
        "suppressed": len(result.suppressed),
        "stale_baseline": len(result.stale_baseline),
        "parse_errors": len(result.parse_errors),
        "static_elapsed_s": round(result.elapsed_s, 3),
    }
    ok = result.ok

    if args.check:
        if result.elapsed_s > STATIC_BUDGET_S:
            print(f"torch-lint: static pass took {result.elapsed_s:.1f}s "
                  f"(budget {STATIC_BUDGET_S:.0f}s) -- the gate is too "
                  f"slow to run on every test invocation")
            ok = False
        report["static_budget_s"] = STATIC_BUDGET_S
        import scripts.torch_observability_check as obs_check

        device = obs_check.default_device()
        obs_problems = obs_check.check(device, verbose=True)
        report["obs_check_problems"] = len(obs_problems)
        report["obs_check_device"] = device
        ok = ok and not obs_problems

        import scripts.torch_health_check as health_check

        health_report = health_check.run_check()
        report["health_check_ok"] = bool(health_report["ok"])
        if not health_report["ok"]:
            for p in health_report["problems"]:
                print(f"health-check: {p}")
        ok = ok and health_report["ok"]

    # the gate runs where JAX is absent: it must load nothing of it
    report["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "distributedkernelshap_tpu"))
    ok = ok and not report["foreign_modules"]
    report["ok"] = bool(ok)
    print(json.dumps(report))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
