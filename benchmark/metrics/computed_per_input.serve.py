"""Audio seconds the tokenize programs computed (rows x samples of each call's
input) over the audio seconds of the /encode requests the micro-batches carried."""

from benchmark.readers import tokenized_audio_s


def read(run):
    given = sum(c["input_audio_s"] for c in run.recorder.runner_calls if c["kind"] == "encode")
    return tokenized_audio_s(run) / given if given > 0 else None
