"""Samples the speaker programs computed (rows x bucket samples of each
``speaker.embed.program`` span: empty rows and each row's padding to its
bucket included) over the input samples of the window's ``speaker.embed``
calls, from the program's spans."""

from benchmark.program_spans import window


def read(run):
    spans = window(run)
    if spans is None:
        return None
    given = sum(s.attrs["samples"] for s in spans if s.name == "speaker.embed")
    computed = sum(s.attrs["rows"] * s.attrs["bucket_samples"] for s in spans if s.name == "speaker.embed.program")
    return computed / given if given > 0 and computed > 0 else None
