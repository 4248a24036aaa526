"""Host ms an ``AudioCodec.decode`` call: the mean, over the window's calls, of a
call's summed ``codec.detokenize.host`` spans (batch assembly, staging and
pageable copies, masks, trims and concatenation), from the program's spans."""

from benchmark.program_spans import mean_contained_ms


def read(run):
    return mean_contained_ms(run, "codec.decode", lambda name: name == "codec.detokenize.host")
