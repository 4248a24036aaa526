"""The port's corpus evaluator against the JAX package's, on the CPU at TINY:
one directory of FLAC and WAV files and a corrupt file through both
``evaluate_corpus`` calls (parity mode, same weights): the same files done,
skipped and listed, the same batches and bitrate, the same written names,
and reconstructions within the parity bound of tests/test_torch_codec.py
(5e-3)."""

import numpy as np

from simwhisper_codec_tpu.eval.corpus import evaluate_corpus as jax_evaluate_corpus
from simwhisper_codec_tpu.models import codec as jcodec
from simwhisper_codec_tpu_torch.eval.corpus import evaluate_corpus, process_index_count
from simwhisper_codec_tpu_torch.models import codec as tcodec
from simwhisper_codec_tpu_torch.ops.fsq import bits_per_frame
from simwhisper_codec_tpu_torch.utils.audio_io import load_audio, save_audio
from simwhisper_codec_tpu_torch.utils.flac import write_flac

from torch_port import TINY, jax_params, port_model


def test_corpus_eval_matches_jax(tmp_path):
    corpus = tmp_path / "corpus"
    (corpus / "sub").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lengths = {"u0.flac": 16000, "u1.flac": 12000, "sub/w0.wav": 9000, "w1.wav": 23000}
    for name, n in lengths.items():
        wav = (rng.standard_normal(n) * 0.1).astype(np.float32)
        if name.endswith(".flac"):
            write_flac(corpus / name, np.round(wav * 32767).astype(np.int64), 16000)
        else:
            save_audio(corpus / name, wav)
    (corpus / "bad.wav").write_bytes(b"RIFFgarbage")

    params = jax_params(0)
    codec = tcodec.AudioCodec(TINY, port_model(params), batch_size=2, mode="parity", device="cpu")
    got = evaluate_corpus(codec, str(corpus), str(tmp_path / "port"), batch_size=2)
    want = jax_evaluate_corpus(jcodec.AudioCodec(TINY, params, batch_size=2, mode="parity"), str(corpus),
                               str(tmp_path / "jax"), batch_size=2)
    for key in ("files", "skipped", "skipped_files", "num_batches", "bitrate_bps", "audio_seconds"):
        assert got[key] == want[key], key
    assert got["files"] == 4 and got["skipped_files"] == [str(corpus / "bad.wav")]
    frames = sum(n // 1280 for n in lengths.values())
    assert got["bitrate_bps"] == round(frames * bits_per_frame(TINY.quantizer) / (sum(lengths.values()) / 16000), 1)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) == ["u0.wav", "u1.wav", "w0.wav", "w1.wav"]
    for name in names:
        a, b = load_audio(tmp_path / "port" / name), load_audio(tmp_path / "jax" / name)
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) < 5e-3
    assert process_index_count() == (0, 1)
