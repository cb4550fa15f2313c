#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port on one CUDA card: explain 2560
Adult-shaped instances against 100 background rows with ``link='logit'``.

The twin of ``bench.py:141-176`` on ``chip_smoke.py``'s Adult-shaped task
(same B, D = 48 in the Adult group widths, N, groups and one-hot structure,
rows and a binary logistic regression made from ``--seed``: the Adult files
are not in git).  One warm-up explain, then the median wall of 3, each
ending in the result's copy to the host, timed by ``chip_smoke.median_wall_ms``
(the timer of ``chip_smoke.py``'s phase 5).  Prints one JSON line:

    {"metric": "adult_shaped_2560_bg100_wall_s", "value": <s>, "unit": "s",
     "platform": "gpu", "card": "<name, power limit>", "kernel_path": {...},
     "walls_s": [...], "additivity": <max |sum phi + E - f(x)|>, ...}

and exits 1 when the additivity error is 1e-3 or more (the gate of
``bench.py``), 2 without a CUDA device.

    python3 scripts/torch_bench.py [--seed 0]
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

METRIC = "adult_shaped_2560_bg100_wall_s"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"metric": METRIC, "error": "no CUDA device"}))
        return 2
    import chip_smoke as cs

    X, bg, est = cs.adult_task(args.seed)
    explainer, explanation = cs.explain_headline(X, bg, est, "cuda")
    # the timer of chip_smoke.py's phase 5: one warm-up, the median of 3
    wall_ms, walls_ms = cs.median_wall_ms(lambda: explainer.explain(X, silent=True), 3)
    err = cs.additivity(explanation)
    value, walls = wall_ms / 1e3, [w / 1e3 for w in walls_ms]
    record = {"metric": METRIC, "value": value, "unit": "s", "platform": "gpu",
              "card": cs.card_line(), "kind": torch.cuda.get_device_name(0),
              "kernel_path": explainer.kernel_path, "walls_s": walls,
              "additivity": err, "B": int(X.shape[0]), "N": int(bg.shape[0]),
              "data": f"Adult-shaped, chip_smoke.adult_task(seed={args.seed})",
              "goodput_rows_per_s": X.shape[0] / value}
    if not err < cs.ADDITIVITY:
        record["error"] = f"additivity violated: {err}"
    print(json.dumps(record))
    return 0 if err < cs.ADDITIVITY else 1


if __name__ == "__main__":
    sys.exit(main())
