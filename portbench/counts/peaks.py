"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3).

Rates from NVIDIA's H100 data sheet (SXM part, dense, no sparsity, at the
700 W power limit); the SM count, the boost clock and the per-SM rates of
the special-function units and the 32-bit integer lanes from the arithmetic
throughput table of NVIDIA's CUDA C++ documentation for compute capability
9.0.  A card set below 700 W runs slower under load: the
benchmark prints the card's name and power limit beside every share.
"""

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flop_per_s": 67e12,           # FP32 lanes, an FMA counted as 2 FLOP
    "tf32_tensor_flop_per_s": 495e12,   # tensor cores, TF32 inputs, dense
    "sm_count": 132,
    "boost_clock_hz": 1.98e9,
    "sfu_per_sm_per_clock": 16,         # reciprocal, exp2, log2, ... results
    "int32_per_sm_per_clock": 64,       # 32-bit integer add, logic, compare
}


def rates(peaks=H100_SXM):
    """Units per second: ``fp32`` FLOP, ``tc`` float32-accurate contraction
    FLOP on the tensor cores (three TF32 products per float32 product, the
    split that keeps float32 accuracy), ``sfu`` special functions, ``int``
    32-bit integer operations, ``hbm`` bytes."""

    per_clock = peaks["sm_count"] * peaks["boost_clock_hz"]
    return {
        "fp32": peaks["fp32_flop_per_s"],
        "tc": peaks["tf32_tensor_flop_per_s"] / 3.0,
        "sfu": per_clock * peaks["sfu_per_sm_per_clock"],
        "int": per_clock * peaks["int32_per_sm_per_clock"],
        "hbm": peaks["hbm_bytes_per_s"],
    }
