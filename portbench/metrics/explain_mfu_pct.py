"""The whole call's share of the card's peak: the least time of all the
work one call needs (the masked evaluations, the link and the least
squares, or the exact reach tests, phi and interaction sums, with the
call's input and output bytes; ``counts/``) over the measured time per
call in the traced window."""

from portbench.counts.roofline import least_seconds


def read(record):
    work = record.work.get("call")
    if work is None or record.calls == 0 or record.window_s <= 0.0:
        return None
    return 100.0 * least_seconds(work)[0] * record.calls / record.window_s
