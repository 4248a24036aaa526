"""The port's batch CLI (``python -m simwhisper_codec_tpu_torch.inference``)
on the CPU: a small config written as YAML, a reference-layout ``.pt``, two
inputs (two WAVs, or a FLAC and a WAV), and the written WAVs equal
``save_audio`` of the port's own parity round trip."""

import numpy as np
import pytest
import torch
import yaml

from simwhisper_codec_tpu.config import CodecConfig as JaxCodecConfig
from simwhisper_codec_tpu_torch import inference
from simwhisper_codec_tpu_torch.config import CodecConfig
from simwhisper_codec_tpu_torch.models.codec import AudioCodec
from simwhisper_codec_tpu_torch.utils.audio_io import load_audio, save_audio
from simwhisper_codec_tpu_torch.utils.flac import write_flac

from test_codec_e2e import GENERATOR_PARAMS
from torch_port import jax_params, port_model


def _run_cli(tmp_path, in_suffix: dict):
    """Write the inputs (``stem -> ".wav" | ".flac"``), run the CLI, and hold
    its outputs against the port's own round trip."""
    cfg = CodecConfig.from_dict(GENERATOR_PARAMS)
    model = port_model(jax_params(5, JaxCodecConfig.from_dict(GENERATOR_PARAMS)), cfg)
    torch.save({"model": model.state_dict()}, tmp_path / "ckpt.pt")
    (tmp_path / "config.yaml").write_text(yaml.safe_dump({"generator_params": GENERATOR_PARAMS}))
    in_dir, out_dir, want_dir = tmp_path / "in", tmp_path / "out", tmp_path / "want"
    in_dir.mkdir()
    want_dir.mkdir()
    rng = np.random.default_rng(0)
    lengths = {"a": 3 * 16000 + 500, "b": 2 * 16000}
    for stem, k in lengths.items():
        wav = (rng.standard_normal(k) * 0.1).astype(np.float32)
        if in_suffix[stem] == ".flac":
            write_flac(in_dir / f"{stem}.flac", np.round(wav * 32767).astype(np.int64), 16000)
        else:
            save_audio(in_dir / f"{stem}.wav", wav)

    inference.main(["--config_path", str(tmp_path / "config.yaml"), "--checkpoint_path", str(tmp_path / "ckpt.pt"),
                    "--input_dir", str(in_dir), "--output_dir", str(out_dir), "--device", "cpu",
                    "--batch_size", "2", "--mode", "parity"])

    codec = AudioCodec(cfg, model, batch_size=2, mode="parity", device="cpu")
    wavs = [load_audio(in_dir / f"{stem}{in_suffix[stem]}") for stem in lengths]
    for stem, y in zip(lengths, codec.decode(codec.encode(wavs)["codes_list"])["syn_wav_list"]):
        save_audio(want_dir / f"{stem}.wav", y)
        got = (out_dir / f"{stem}.wav").read_bytes()
        assert got == (want_dir / f"{stem}.wav").read_bytes()
        assert len(load_audio(out_dir / f"{stem}.wav")) == lengths[stem] // 1280 * 1280
    assert sorted(p.name for p in out_dir.iterdir()) == ["a.wav", "b.wav"]


def test_inference_cli_writes_the_round_trip(tmp_path):
    _run_cli(tmp_path, {"a": ".wav", "b": ".wav"})


@pytest.mark.parametrize("flac_stem", ["a", "b"])
def test_inference_cli_reads_flac(tmp_path, flac_stem):
    """One of the two inputs is FLAC; the CLI writes its reconstruction as WAV."""
    _run_cli(tmp_path, {stem: ".flac" if stem == flac_stem else ".wav" for stem in ("a", "b")})
