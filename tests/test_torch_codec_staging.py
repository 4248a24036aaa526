"""``AudioCodec.encode`` / ``decode`` keep a call's batch on the device from
its one upload to its one download; their results are bit for bit those of
the host-staged algorithm they replace, kept here as the reference: pad,
slice, mask and concatenate in numpy around ``inference_tokenize`` /
``inference_detokenize``, one chunk at a time.

 - ragged batches whose rows end before, at and across chunk boundaries,
   fewer and more rows than ``batch_size``, a row shorter than one code
   frame, float32 and int16 input on the ``float32`` and ``pcm16`` wires,
   an odd-second stride (whose grid keeps encode's mask), through plain
   stand-ins for the two programs that read the padding, mask nothing and
   give the lengths the real programs give, and once through the codec's
   own programs; the streaming sessions on the grid the batch calls read;
 - the programs' lengths cover every position the final trim keeps, for
   every overlap, except encode's on odd-second strides (``ChunkGrid.masked``);
 - the arrays a call returned are not touched by the next call;
 - on the card (marked ``chip``; run there with ``python -m pytest
   --noconftest -m chip tests/test_torch_codec_staging.py``), the batch is
   staged in page-locked memory and each call waits for the device once.
"""

import dataclasses

import numpy as np
import pytest
import torch

from simwhisper_codec_tpu_torch.models import codec as codec_mod
from simwhisper_codec_tpu_torch.models.codec import AudioCodec, ChunkGrid, init_params
from simwhisper_codec_tpu_torch.models.streaming import StreamingDecoder, StreamingEncoder
from simwhisper_codec_tpu_torch.utils import profiling
from simwhisper_codec_tpu_torch.utils.audio_io import to_pcm16

from test_torch_spans import TINY  # width 64, two layers a tower, 30 s chunks

# one layer a tower: staging does not depend on depth, and the 30 s chunks cost the CPU enough
ONE_LAYER = dataclasses.replace(
    TINY, acoustic_encoder=dataclasses.replace(TINY.acoustic_encoder, encoder_layers=1),
    acoustic_decoder=dataclasses.replace(TINY.acoustic_decoder, decoder_layers=1),
    vocos=dataclasses.replace(TINY.vocos, num_layers=1))

SR = 16000
HOP = 1280


def reference_encode(codec, wav_list, overlap_seconds=10):
    """The host-staged encode: each chunk padded to the chunk and the batch on
    the host, its codes brought home and masked there, the chunks concatenated."""
    duration_size = (codec.max_audio_seconds - overlap_seconds) * SR
    chunk_size = codec.max_audio_seconds * SR
    keep_len = duration_size // HOP
    b = len(wav_list)
    lengths = np.array([len(w) for w in wav_list], np.int64)
    max_length = int(lengths.max())
    wire16 = codec.wire == "pcm16" or all(np.asarray(w).dtype == np.int16 for w in wav_list)
    batch = np.zeros((b, max_length), np.int16 if wire16 else np.float32)
    for i, w in enumerate(wav_list):
        w = np.asarray(w)
        if wire16 and w.dtype != np.int16:
            w = to_pcm16(w)
        elif not wire16 and w.dtype == np.int16:
            w = w.astype(np.float32) / 32768.0
        batch[i, :len(w)] = w
    bp = codec._pad_batch_dim(b)
    chunks = []
    for start in range(0, max_length, duration_size):
        end = min(start + chunk_size, max_length)
        padded = np.zeros((bp, codec.cfg.chunk_samples), batch.dtype)
        padded[:b, :end - start] = batch[:, start:end]
        chunk_lengths = np.zeros(bp, np.int64)
        chunk_lengths[:b] = np.clip(lengths - start, 0, end - start)
        out = codec.inference_tokenize(padded, chunk_lengths)
        codes = out["codes"].cpu().numpy()[:, :b, :keep_len].copy()
        valid = np.clip(out["codes_lengths"].cpu().numpy()[:b], 0, keep_len)
        codes *= (np.arange(codes.shape[2])[None, None, :] < valid[None, :, None]).astype(codes.dtype)
        chunks.append(codes)
    codes = np.concatenate(chunks, axis=-1)
    return [codes[:, i, :lengths[i] // HOP] for i in range(b)]


def reference_decode(codec, codes_list, overlap_seconds=10):
    """The host-staged decode: each chunk of codes padded on the host, its
    waveform brought home and masked there, the chunks concatenated."""
    keep_codes = (codec.max_audio_seconds - overlap_seconds) * SR // HOP
    chunk_codes = codec.max_audio_seconds * SR // HOP
    keep_wav = keep_codes * HOP
    b = len(codes_list)
    lengths = np.array([c.shape[-1] for c in codes_list], np.int64)
    max_length = int(lengths.max())
    batch = np.zeros((codec.num_groups, b, max_length), np.int32)
    for i, c in enumerate(codes_list):
        batch[:, i, :c.shape[-1]] = c
    bp = codec._pad_batch_dim(b)
    chunks = []
    for start in range(0, max_length, keep_codes):
        end = min(start + chunk_codes, max_length)
        padded = np.zeros((codec.num_groups, bp, codec.cfg.code_frames), np.int32)
        padded[:, :b, :end - start] = batch[:, :, start:end]
        chunk_lengths = np.zeros(bp, np.int64)
        chunk_lengths[:b] = np.clip(lengths - start, 0, end - start)
        out = codec.inference_detokenize(padded, chunk_lengths, chunk_width=end - start, out_samples=keep_wav)
        y = out["y"][:b, :keep_wav]
        wav = (y if y.dtype == torch.int16 else y.to(torch.float32)).cpu().numpy()
        valid = np.clip(out["output_length"].cpu().numpy()[:b], 0, keep_wav)
        chunks.append(wav * (np.arange(wav.shape[1])[None, :] < valid[:, None]).astype(wav.dtype))
    wav = np.concatenate(chunks, axis=-1)
    return [wav[i, :lengths[i] * HOP] for i in range(b)]


@pytest.fixture(scope="module")
def model():
    """ONE_LAYER with its latent projection scaled x30, so that the codes span
    the FSQ levels (at the raw init every code is the zero level).  Both
    programs run once first at two code frames, on one thread: the first
    multi-threaded call of a vectorised sin / cos / exp / log / erf in a
    process picks its implementation lazily, and one thread's block of it
    can come out with other roundings, which the codec-against-reference
    comparisons would read as a difference."""
    m = init_params(ONE_LAYER)
    with torch.no_grad():
        m.downsample.to_latent.weight.mul_(30.0)
        codec_mod.tokenize(m, torch.zeros(1, 2 * HOP), torch.tensor([2 * HOP]))
        codec_mod.detokenize(m, torch.zeros((ONE_LAYER.quantizer.num_groups, 1, 2), dtype=torch.int32),
                             torch.tensor([2]), 2)
    return m


def waves(rng, seconds, kind):
    """Noise on the 16-bit grid; ``int16`` PCM, ``float32`` or, for ``mixed``, int16 every other row."""
    out = []
    for i, s in enumerate(seconds):
        pcm = rng.integers(-12000, 12000, int(round(s * SR))).astype(np.int16)
        as_int = kind == "int16" or (kind == "mixed" and i % 2 == 0)
        out.append(pcm if as_int else pcm.astype(np.float32) / 32768.0)
    return out


def assert_bit_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


class Plain:
    """A stand-in for one of the codec's programs: plain tensor code, run eagerly."""

    source = "eager"

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


def code_lengths(n):
    """The programs' length rule for n samples: ceil(n / 160) mel frames (at
    most a chunk's), the encoder's // 2, the frame stack's ceil(/ 4)."""
    mel = ((n + ONE_LAYER.mel_hop_length - 1) // ONE_LAYER.mel_hop_length).clip(max=ONE_LAYER.mel_frames)
    stack = ONE_LAYER.downsample.stack_factor
    return (mel // ONE_LAYER.acoustic_encoder.stride_size + stack - 1) // stack


def plain_tokenize(wav, lengths):
    """Codes from every sample of each frame, padding included, nothing masked,
    and the real programs' lengths: the codec's padding and the final trim to
    each row's length decide the result."""
    b, n = wav.shape
    q = torch.round(wav * 32768.0).to(torch.int64).view(b, n // HOP, HOP).sum(-1)  # exact in any order
    groups = ONE_LAYER.quantizer.num_groups
    codes = torch.stack([(q + 7 * g) % 4096 for g in range(groups)]).to(torch.int32)
    return {"zq": torch.zeros(b, n // HOP, 1), "codes": codes, "codes_lengths": code_lengths(lengths)}


def plain_detokenize(codes, lengths, width):
    """A waveform in [-0.5, 0.5) from each frame's codes, its position and the
    chunk width, in integers (exact on any thread); nothing masked, the real
    programs' lengths."""
    t = codes.shape[2]
    frame = codes.sum(0).to(torch.int64).repeat_interleave(HOP, dim=1)
    pos = torch.arange(t * HOP)
    y = ((7 * frame + 13 * pos + 101 * width.to(torch.int64)) % 65536 - 32768).to(torch.float32) / 65536
    return {"y": y, "output_length": lengths * HOP}


def make_codec(model, batch_size, wire="float32", programs="plain"):
    codec = AudioCodec(ONE_LAYER, model, batch_size=batch_size, mode="parity", device="cpu", wire=wire)
    if programs == "plain":
        codec._tokenize, codec._detokenize = Plain(plain_tokenize), Plain(plain_detokenize)
    return codec


def case(seconds, batch_size, kind, wire, programs, overlap=10, streams=False):
    return seconds, batch_size, kind, wire, programs, overlap, streams


CASES = {
    # two chunks (stride 20 s): rows ending inside the first stride, on it, on the first chunk's end and past it
    "ragged_more_rows_than_batch": case([15, 20, 30, 35.7], 2, "float32", "float32", "plain"),
    "fewer_rows_than_batch": case([12.5, 18], 3, "float32", "float32", "plain"),
    "int16_on_float_wire": case([9, 19], 2, "int16", "float32", "plain"),
    "mixed_on_float_wire": case([9, 19], 2, "mixed", "float32", "plain"),
    "float_on_pcm16_wire": case([9, 19], 2, "float32", "pcm16", "plain"),
    "int16_on_pcm16_wire": case([19, 3], 2, "int16", "pcm16", "plain"),
    "row_shorter_than_a_code_frame": case([700 / SR, 12], 2, "float32", "float32", "plain"),
    # stride 21 s, half a code frame over: the 42 s row ends on chunk 2's start, where the trim keeps a column
    "odd_stride_keeps_the_mask": case([42, 50, 20.7], 2, "float32", "float32", "plain", 9),
    # stride 14 s, four chunks: the streaming sessions on the longest row give the batch calls' results
    "sessions_read_the_batch_grid": case([47, 20.5], 2, "float32", "float32", "plain", 16, streams=True),
    # the codec's own programs, two chunks each way
    "model_programs": case([25, 8.5], 2, "float32", "float32", "model"),
}


def streamed(session, items, block):
    """Everything ``session`` gives for ``items`` fed ``block`` at a time, its flush included."""
    outs = [session.feed(items[..., i:i + block]) for i in range(0, items.shape[-1], block)] + [session.flush()]
    return np.concatenate([o for o in outs if o is not None], axis=-1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_staged_round_trip_is_the_host_staged_one(model, case, monkeypatch):
    seconds, batch_size, kind, wire, programs, overlap, streams = CASES[case]
    codec = make_codec(model, batch_size, wire, programs)
    grids, of = [], ChunkGrid.of
    monkeypatch.setattr(ChunkGrid, "of", staticmethod(lambda cfg, o: grids.append(of(cfg, o)) or grids[-1]))
    wavs = waves(np.random.default_rng(len(case)), seconds, kind)
    codes = codec.encode(wavs, overlap)["codes_list"]
    want_codes = reference_encode(codec, wavs, overlap)
    assert_bit_equal(codes, want_codes)
    assert all(len(np.unique(c)) > 1 for c in codes if c.size)
    assert [c.shape for c in codes] == [(ONE_LAYER.quantizer.num_groups, len(w) // HOP) for w in wavs]
    decoded = codec.decode(codes, overlap)["syn_wav_list"]
    assert_bit_equal(decoded, reference_decode(codec, want_codes, overlap))
    if streams:
        i = int(np.argmax(seconds))  # a session's chunks are the batch's for its longest row
        assert_bit_equal([streamed(StreamingEncoder(codec, overlap), wavs[i], 12345)], [codes[i]])
        assert_bit_equal([streamed(StreamingDecoder(codec, overlap), codes[i], 37)], [decoded[i]])
    assert grids == [of(ONE_LAYER, overlap)] * (4 if streams else 2)


EDGE_SAMPLES = (0, 1, 159, 160, 1279, 1280, 1281)
GRIDS = [ChunkGrid.of(ONE_LAYER, overlap) for overlap in range(30)]


@pytest.fixture(scope="module")
def program_lengths(model):
    """The codec's own programs' lengths, one call each: samples 0, 1, a mel
    hop and a code frame each side, the chunk and the stride +- 1; code
    frames 0, 1, the chunk's and the kept frames +- 1; the strides of the
    default overlap and an odd one (each row of 30 s costs the CPU)."""
    codec = make_codec(model, batch_size=1, programs="model")
    chunk, chunk_codes = ONE_LAYER.chunk_samples, ONE_LAYER.code_frames
    samples = sorted({*EDGE_SAMPLES, chunk, *(GRIDS[o].stride + d for o in (10, 9) for d in (-1, 1))})
    frames = sorted({0, 1, chunk_codes, *(GRIDS[o].kept + d for o in (10, 9) for d in (-1, 1))})
    n, c = torch.tensor(samples), torch.tensor(frames)
    codes = torch.zeros((ONE_LAYER.quantizer.num_groups, len(c), chunk_codes), dtype=torch.int32)
    with torch.no_grad():
        tok = codec._tokenize(torch.zeros(len(n), chunk), n)["codes_lengths"]
        detok = codec._detokenize(codes, c, torch.tensor(chunk_codes, dtype=torch.int32))["output_length"]
    return dict(zip(samples, tok.tolist())), dict(zip(frames, detok.tolist()))


@pytest.mark.parametrize("overlap", range(30))
def test_program_lengths_cover_what_the_trim_keeps(program_lengths, overlap):
    """For every row length and chunk k, ``tokenize``'s ``codes_lengths`` of
    the row's samples in chunk k cover the columns of it that the trim to
    ``length // hop`` keeps, and ``detokenize``'s ``output_length`` the
    samples the trim to ``codes * up`` keeps, for every overlap the API
    takes, except encode's where ``ChunkGrid.masked`` says so: there encode
    zeroes past the lengths.  The rules are the real programs' at the edges."""
    grid = GRIDS[overlap]
    tok, detok = program_lengths
    assert tok == {n: int(code_lengths(np.int64(n))) for n in tok}
    samples_a_frame = (ONE_LAYER.upsample.stack_factor * ONE_LAYER.acoustic_decoder.stride_size
                       * ONE_LAYER.vocos.hop_size)
    assert detok == {c: c * samples_a_frame for c in detok}
    # A row of L samples has n = clip(L - k * stride, 0, chunk) of them in chunk k, whose kept columns
    # the trim keeps min(kept, L // hop - k * kept) <= min(kept, (n + k * r) // hop) of, r = stride % hop:
    # at most kept, reached for every n by k * r >= kept * hop, beyond which nothing grows.
    n = np.arange(grid.chunk + 1)
    r = grid.stride % grid.hop
    k = -(-grid.kept * grid.hop // r) if r else 0
    assert bool(np.all(code_lengths(n) >= np.minimum(grid.kept, (n + k * r) // grid.hop))) != grid.masked
    assert grid.masked == (overlap % 2 == 1)  # 16000 samples a second, 1280 a code frame
    # decode's chunks start on whole code frames: chunk k holds c = clip(C - k * kept, 0, chunk_codes)
    c = np.arange(grid.chunk_codes + 1)
    assert np.all(c * samples_a_frame >= np.minimum(grid.kept, c) * grid.up)


def test_returned_arrays_outlive_the_next_call(model):
    codec = make_codec(model, batch_size=2)
    rng = np.random.default_rng(5)
    # the second batch's rows end where the first's ran on: its tails are stale unless zeroed
    first, second = waves(rng, [18, 7], "float32"), waves(rng, [7, 18], "float32")
    codes = codec.encode(first)["codes_list"]
    wavs = codec.decode(codes)["syn_wav_list"]
    held = [a.copy() for a in codes + wavs]
    other = codec.encode(second)["codes_list"]
    other_wavs = codec.decode(other)["syn_wav_list"]
    assert_bit_equal(other, reference_encode(codec, second))
    assert_bit_equal(other_wavs, reference_decode(codec, other))
    assert_bit_equal(codes + wavs, held)


@pytest.mark.chip
def test_on_the_card_one_pinned_upload_and_one_wait_a_call(model):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    codec = AudioCodec(ONE_LAYER, model, batch_size=4, mode="parity", device="cuda")
    wavs = waves(np.random.default_rng(6), [55, 41, 20, 7.5], "float32")  # three chunks each way
    since = profiling.clock_ns()
    codes = codec.encode(wavs)["codes_list"]
    out = codec.decode(codes)["syn_wav_list"]
    calls = [s for s in profiling.spans(since) if s.name in ("codec.encode", "codec.decode")]
    assert sorted(s.name for s in calls) == ["codec.decode", "codec.encode"]
    for s in calls:
        assert s.attrs == {"rows": 4, "chunks": 3, "staging": "pinned", "fetches": 1}, s
    want_codes = reference_encode(codec, wavs)
    assert_bit_equal(codes, want_codes)
    assert_bit_equal(out, reference_decode(codec, want_codes))
