"""B2 (``csrc/ln_ffn.cu``, the bf16 LN-FFN) against its roofline: each traced
call's least time (operations over 989.4 TFLOP/s or bytes over 3.35 TB/s,
whichever is larger) summed, over the summed device time of B2's kernels in the
traced sub-window."""

from benchmark.readers import ffn_roofline_percent


def read(run):
    return ffn_roofline_percent(run, "B2")
