"""Audio seconds the tokenize programs computed (rows x samples of each call's
input: chunk and batch padding included) over the input audio seconds of the
window's utterances."""

from benchmark.readers import tokenized_audio_s


def read(run):
    given = run.counters.get("input_audio_s", 0.0)
    return tokenized_audio_s(run) / given if given > 0 else None
