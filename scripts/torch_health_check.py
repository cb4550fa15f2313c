"""Alert-engine golden replay of the PyTorch port (the port's counterpart of
``scripts/health_check.py``).

Replays the committed time-series fixture ``tests/fixtures/slo_replay.jsonl``
-- 120 s of sampled request and error counters (steady 10 req/s, a 5 err/s
burst between t=30 and t=60) -- through the port's
``observability.timeseries``, ``slo`` and ``alerts`` and asserts the
burn-rate alert's transitions match the golden timeline:

* ``pending``  at t~31 (condition true, ``for`` running),
* ``firing``   at t~36 (condition held for ``for_s=5``),
* ``resolved`` at t~74 (burst over at 60, the 5 s short window clears by
  ~66, ``keep_firing_s=10`` elapses).

Exit 0 on match, 1 on mismatch; one JSON report line either way.

    python scripts/torch_health_check.py [--fixture PATH]
"""

import argparse
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

FIXTURE = os.path.join(REPO_ROOT, "tests", "fixtures", "slo_replay.jsonl")

#: golden transition timeline: (state, expected_ts, tolerance_s), the
#: reference's; the tolerance absorbs boundary-sample inclusion changes,
#: not semantics
GOLDEN = (("pending", 31.0, 2.0),
          ("firing", 36.0, 2.0),
          ("resolved", 74.0, 2.0))


def make_rule():
    from distributedkernelshap_tpu_torch.observability.alerts import slo_burn_rule
    from distributedkernelshap_tpu_torch.observability.slo import (
        AvailabilitySLO,
        BurnRateWindow,
    )

    slo = AvailabilitySLO(
        "availability", total="dks_serve_requests_total",
        bad="dks_serve_errors_total", target=0.99,
        windows=(BurnRateWindow(long_s=20.0, short_s=5.0, factor=2.0),),
        description="health-check replay SLO")
    return slo_burn_rule(slo, for_s=5.0, keep_firing_s=10.0)


def run_check(fixture_path: str = FIXTURE) -> dict:
    """Replay the fixture through the port's alert engine; returns the
    report dict (``ok`` = golden match)."""

    from distributedkernelshap_tpu_torch.observability.alerts import (
        AlertManager,
        CollectSink,
    )
    from distributedkernelshap_tpu_torch.observability.timeseries import (
        iter_jsonl_times,
        load_jsonl,
    )

    store = load_jsonl(fixture_path)
    sink = CollectSink()
    manager = AlertManager(store, [make_rule()], sinks=[sink],
                           component="health-check")
    for t in iter_jsonl_times(store):
        manager.evaluate(now=t)
    transitions = [{"state": e["state"], "ts": e["ts"]} for e in sink.events]
    problems = []
    if len(transitions) != len(GOLDEN):
        problems.append(f"expected {len(GOLDEN)} transitions "
                        f"({[g[0] for g in GOLDEN]}), got "
                        f"{[t['state'] for t in transitions]}")
    else:
        for got, (state, expected_ts, tol) in zip(transitions, GOLDEN):
            if got["state"] != state:
                problems.append(f"expected {state}, got {got['state']}")
            elif abs(got["ts"] - expected_ts) > tol:
                problems.append(f"{state} at t={got['ts']:.1f}, expected "
                                f"{expected_ts:.1f}±{tol:.0f}")
    return {"fixture": os.path.relpath(fixture_path, REPO_ROOT),
            "transitions": transitions,
            "golden": [list(g) for g in GOLDEN],
            "problems": problems,
            "final_state": manager.states(),
            "ok": not problems}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--fixture", default=FIXTURE)
    args = parser.parse_args()
    report = run_check(args.fixture)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
