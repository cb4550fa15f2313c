"""The least time for a piece of work on the card.

A piece of work is a dict of counts:

- ``bytes``: input bytes read once plus output bytes written once;
- ``contraction_flop``: multiply-adds of sums of products (2 FLOP each),
  which the tensor cores (as three TF32 products per float32 product) and
  the FP32 lanes can both do;
- ``fp32_flop``: other float32 arithmetic, FP32 lanes only;
- ``special``: reciprocals, exponentials and logarithms, which the
  special-function units do at one a result or the FP32 lanes at
  ``SPECIAL_FP32_FLOP`` FLOP (the smallest count such an evaluation could
  take);
- ``int_ops``: 32-bit integer operations, on the integer lanes, which run
  beside the FP32 lanes.

The float work is spread over the units as well as it can be: the least
time is the largest, over every subset of the three float kinds, of the
subset's work over the units that can do it (in FP32 FLOP, the currency
the shared FP32 lanes are paid in).  Each kind has one unit of its own
besides the shared lanes, so that largest ratio is the least time.
"""

from itertools import combinations

from portbench.counts.peaks import H100_SXM, rates

SPECIAL_FP32_FLOP = 2.0


def empty():
    return {"bytes": 0.0, "contraction_flop": 0.0, "fp32_flop": 0.0, "special": 0.0,
            "int_ops": 0.0}


def add(*works):
    out = empty()
    for w in works:
        for k, v in w.items():
            out[k] += float(v)
    return out


def scale(work, factor):
    return {k: float(v) * factor for k, v in work.items()}


def least_seconds(work, peaks=H100_SXM):
    """``(seconds, bound_by)``: the larger of the byte time and the
    operation time, and which of the two it is."""

    r = rates(peaks)
    kinds = [
        (work["contraction_flop"], r["tc"]),
        (work["fp32_flop"], 0.0),
        (work["special"] * SPECIAL_FP32_FLOP, r["sfu"] * SPECIAL_FP32_FLOP),
    ]
    ops = work["int_ops"] / r["int"]
    for n in range(1, len(kinds) + 1):
        for subset in combinations(kinds, n):
            amount = sum(a for a, _ in subset)
            ops = max(ops, amount / (r["fp32"] + sum(c for _, c in subset)))
    byte_s = work["bytes"] / r["hbm"]
    return (byte_s, "bytes") if byte_s >= ops else (ops, "operations")
