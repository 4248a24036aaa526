"""B3 (``csrc/ln_ffn_int8.cu``, the int8 LN-FFN) against its roofline: each traced
call's least time (operations over 1979 TOP/s or bytes over 3.35 TB/s, whichever
is larger, from its rows and widths) summed, over the summed device time of B3's
kernels in the traced sub-window."""

from benchmark.readers import ffn_roofline_percent


def read(run):
    return ffn_roofline_percent(run, "B3")
