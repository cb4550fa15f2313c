"""``fused_linear_ey``'s share of its roofline: the least time of the
masked evaluations the window's calls needed (``counts/linear.py``) over
the summed device time of the kernels its launches ran
(``softmax_v_kernel`` and ``softmax_factored_kernel``: the general
softmax)."""

from portbench.counts.roofline import least_seconds

KERNELS = ("softmax_v_kernel", "softmax_factored_kernel")


def read(record):
    work = record.work.get("fused_linear_ey")
    spent = record.seconds(record.kernels(*KERNELS))
    if work is None or spent <= 0.0:
        return None
    return 100.0 * least_seconds(work)[0] * record.calls / spent
