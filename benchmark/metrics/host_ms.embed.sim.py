"""Host ms a ``SpeakerEmbedder.embed_batch`` call: the mean, over the window's
``speaker.embed`` spans, of a call's summed ``speaker.embed.host`` spans
(sorting and grouping the rows, packing them into the staging buffer, its
upload launched, each program's embeddings copied into the call's result),
from the program's spans."""

from benchmark.program_spans import mean_contained_ms


def read(run):
    return mean_contained_ms(run, "speaker.embed", lambda name: name == "speaker.embed.host")
