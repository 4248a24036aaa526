"""The port's tower checkpoint layouts against the JAX package's, on the CPU
at tiny widths: inverse converters both ways (leaf for leaf), the
safetensors reader and writer, Hugging Face ``HubertForCTC`` directories
(saved by ``transformers``, read by the port; written by the port, read by
the JAX loader) and the port's synthetic-weight tool.
"""

import json
import sys
from functools import partial

import jax
import numpy as np
import pytest
import torch

from conftest import REPO_ROOT

sys.path.insert(0, str(REPO_ROOT / "tools"))
import make_synthetic_tower_weights as jgen  # noqa: E402  (the JAX package's tool)
from simwhisper_codec_tpu.eval import speaker as jspk
from simwhisper_codec_tpu.eval import utmos as jutmos
from simwhisper_codec_tpu.eval import wer as jwer
from simwhisper_codec_tpu.models import ssl as jssl
from simwhisper_codec_tpu.utils import ssl_checkpoint as jckpt
from simwhisper_codec_tpu_torch.eval import speaker as tspk
from simwhisper_codec_tpu_torch.eval import utmos as tutmos
from simwhisper_codec_tpu_torch.eval import wer as twer
from simwhisper_codec_tpu_torch.models import ssl as tssl
from simwhisper_codec_tpu_torch.tools import make_synthetic_tower_weights as tgen
from simwhisper_codec_tpu_torch.utils import ssl_checkpoint as tckpt
from simwhisper_codec_tpu_torch.utils.hf_dir import read_hf_ctc_dir, read_safetensors, write_safetensors

from test_torch_ssl import CONFIGS, batch
from test_torch_towers import HUBERT_KW, UTMOS_KW, close, leaves_equal, speaker_pair, utmos_pair
from torch_port import t


# -- converters, both ways ------------------------------------------------------


def test_jax_inverse_converters_feed_the_port_loaders():
    """The JAX tool's inverse converters -> the port's loaders: leaf-equal to
    the carried JAX trees, and the forwards agree."""
    jcfg, tcfg, jtree, ttree = utmos_pair(4)
    sd = jgen.utmos_tree_to_lightning(jtree, jcfg)
    loaded = tutmos.convert_utmos_checkpoint(sd, tcfg)
    leaves_equal(loaded, ttree, "utmos")
    wav, lens = batch(seed=14)
    want = jax.jit(partial(jutmos.utmos_forward, jcfg))(jtree, wav, lens)
    with torch.no_grad():
        close(tutmos.utmos_forward(tcfg, loaded, t(wav), t(lens, torch.int64)), want, "utmos")

    jcfg, tcfg, jwavlm, jecapa, fw = speaker_pair(5)
    sd = jgen.ecapa_tree_to_torch(jecapa)
    sd.update(jgen.ssl_tree_to_fairseq(jwavlm, jcfg, prefix=tspk.WAVLM_PREFIX, msft=True))
    leaves_equal(tspk.convert_ecapa_state_dict(sd), tckpt.tower_params_from_jax(jecapa), "ecapa")
    wavlm = tckpt.convert_msft_wavlm(sd, tcfg, prefix=tspk.WAVLM_PREFIX)
    leaves_equal(wavlm, tckpt.ssl_params_from_jax(jwavlm), "wavlm")
    jfeats, _ = jax.jit(partial(jspk.wavlm_weighted_features, jcfg))(jwavlm, fw, wav, lens)
    with torch.no_grad():
        close(tspk.wavlm_weighted_features(tcfg, wavlm, t(fw), t(wav), t(lens, torch.int64))[0], jfeats, "wavlm")


@pytest.mark.parametrize("layout", ["fairseq", "msft", "utmos", "ecapa"])
def test_port_writers_feed_the_jax_converters(layout):
    """The port's inverse converters (weight-normed positional convs) -> the
    JAX package's converters: leaf-equal to the port's own loaders."""
    gen = torch.Generator().manual_seed(7)
    if layout == "ecapa":
        tree = tspk.init_ecapa(gen, feat_dim=32)
        sd = tgen.ecapa_tree_to_torch(tree)
        jtree = jspk.convert_ecapa_state_dict({k: v.numpy() for k, v in sd.items()})
        leaves_equal(tckpt.tower_params_from_jax(jtree), tspk.convert_ecapa_state_dict(sd), layout)
        leaves_equal(tspk.convert_ecapa_state_dict(sd), tree, layout)
        return
    if layout == "utmos":
        cfg = tutmos.UTMOSConfig(ssl=tssl.SSLConfig(**CONFIGS["fairseq"]), **UTMOS_KW)
        tree = tutmos.init_utmos_params(cfg, gen)
        gv = tgen.weight_norm_pos_conv(tree["ssl"])
        sd = tgen.utmos_tree_to_lightning(tree, cfg, gv)
        jcfg = jutmos.UTMOSConfig(ssl=jssl.SSLConfig(**CONFIGS["fairseq"]), **UTMOS_KW)
        jtree = jutmos.convert_utmos_checkpoint({k: v.numpy() for k, v in sd.items()}, jcfg)
        port = tutmos.convert_utmos_checkpoint(sd, cfg)
    else:
        cfg = tssl.SSLConfig(**CONFIGS[layout])
        tree = tssl.init_ssl_params(cfg, gen)
        gv = tgen.weight_norm_pos_conv(tree)
        sd = tgen.ssl_tree_to_fairseq(tree, cfg, gv, msft=layout == "msft")
        assert "encoder.pos_conv.0.weight_g" in sd
        convert = jckpt.convert_msft_wavlm if layout == "msft" else jckpt.convert_fairseq_wav2vec2
        jtree = convert({k: v.numpy() for k, v in sd.items()}, jssl.SSLConfig(**CONFIGS[layout]))
        port = (tckpt.convert_msft_wavlm if layout == "msft" else tckpt.convert_fairseq_wav2vec2)(sd, cfg)
    leaves_equal(tckpt.tower_params_from_jax(jtree), port, layout)
    leaves_equal(port, tree, layout)


def test_safetensors_round_trip_and_bf16(tmp_path):
    rng = np.random.default_rng(15)
    tensors = {"a": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)), "b.c": torch.zeros(7)}
    write_safetensors(tmp_path / "x.safetensors", tensors)
    back = read_safetensors(tmp_path / "x.safetensors")
    assert back.keys() == tensors.keys() and all(torch.equal(back[k], tensors[k]) for k in tensors)
    # a BF16 entry, written by hand: the reader widens it exactly
    vals = np.array([1.0, -2.5, 3.140625], np.float32)
    blob = (vals.view(np.uint32) >> 16).astype("<u2").tobytes()
    head = b'{"w":{"dtype":"BF16","shape":[3],"data_offsets":[0,6]}}'
    head += b" " * (-len(head) % 8)
    (tmp_path / "y.safetensors").write_bytes(len(head).to_bytes(8, "little") + head + blob)
    assert torch.equal(read_safetensors(tmp_path / "y.safetensors")["w"], torch.from_numpy(vals))


def test_hf_dir_from_transformers_reads_as_the_jax_loader(tmp_path):
    """A HubertForCTC directory that ``transformers`` saves -> the port's
    reader gives the JAX ``load_hf_ctc_params``'s params, vocab, do_normalize."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(3)
    hf_kw = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                 conv_dim=(16, 16), conv_kernel=(10, 4), conv_stride=(5, 4), num_conv_pos_embeddings=16,
                 num_conv_pos_embedding_groups=4, do_stable_layer_norm=True, feat_extract_norm="layer",
                 conv_bias=True, vocab_size=32)
    transformers.HubertForCTC(transformers.HubertConfig(**hf_kw)).save_pretrained(tmp_path)
    (tmp_path / "vocab.json").write_text(json.dumps(tgen.CTC_VOCAB))
    tok = transformers.Wav2Vec2CTCTokenizer(str(tmp_path / "vocab.json"), unk_token="<unk>", pad_token="<pad>",
                                            word_delimiter_token="|")
    tok.save_pretrained(tmp_path)
    transformers.Wav2Vec2FeatureExtractor(feature_size=1, sampling_rate=16000, padding_value=0.0,
                                          do_normalize=False).save_pretrained(tmp_path)
    jparams, jvocab, jnorm, jcfg = jwer.load_hf_ctc_params(str(tmp_path))
    params, vocab, norm, cfg = read_hf_ctc_dir(tmp_path)
    assert cfg.__dict__ == jcfg.__dict__ and vocab == jvocab and norm == jnorm is False
    leaves_equal(params, tckpt.tower_params_from_jax(jparams), "hf")
    assert twer.have_asr(str(tmp_path)) and not twer.have_asr(str(tmp_path / "missing"))


def test_port_written_hf_dir_reads_in_the_jax_loader(tmp_path):
    pytest.importorskip("transformers")
    cfg = tssl.SSLConfig(**HUBERT_KW)
    info = tgen.make_hubert_ctc(tmp_path / "hubert_ctc", seed=2, cfg=cfg)
    assert info["tensors"] > 0
    jparams, jvocab, jnorm, jcfg = jwer.load_hf_ctc_params(str(tmp_path / "hubert_ctc"))
    params, vocab, norm, back = read_hf_ctc_dir(tmp_path / "hubert_ctc")
    assert jcfg.__dict__ == back.__dict__ == cfg.__dict__ and jvocab == vocab and jnorm == norm is True
    leaves_equal(tckpt.tower_params_from_jax(jparams), params, "port-written hf dir")


def test_tool_writes_the_three_layouts(tmp_path):
    """The port's tool at tiny configs: the three files load back through the
    port's loaders (it asserts that itself) and score finitely."""
    cfg_f, cfg_m, cfg_h = (tssl.SSLConfig(**CONFIGS["fairseq"]), tssl.SSLConfig(**CONFIGS["msft"]),
                           tssl.SSLConfig(**HUBERT_KW))
    ucfg = tutmos.UTMOSConfig(ssl=cfg_f, **UTMOS_KW)
    tgen.make_hubert_ctc(tmp_path / "hubert_ctc", 0, cfg_h)
    tgen.make_wavlm_ecapa(tmp_path / "w.pth", 0, cfg_m)
    tgen.make_utmos(tmp_path / "u.ckpt", 0, ucfg)
    wav = (np.random.default_rng(16).standard_normal(20000) * 0.1).astype(np.float32)
    scorer = tutmos.UTMOSScorer(str(tmp_path / "u.ckpt"), device="cpu")
    assert scorer.cfg.ssl == cfg_f and np.isfinite(scorer.score(wav))
    ecapa, wavlm, fw, cfg = tspk.load_wavlm_ecapa_checkpoint(str(tmp_path / "w.pth"))
    assert cfg == cfg_m
    emb = tspk.SpeakerEmbedder.from_checkpoint(str(tmp_path / "w.pth"), device="cpu").embed(wav)
    assert emb.shape == (tspk.EMB_DIM,) and np.isfinite(emb).all()
    assert isinstance(twer.CTCTranscriber(str(tmp_path / "hubert_ctc"), device="cpu").transcribe(wav), str)
