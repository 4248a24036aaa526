"""Write synthetic checkpoints of the three metric towers in their published layouts.

Counterpart of ``tools/make_synthetic_tower_weights.py``, torch only.  The
towers' published weights are not in the repository, so corpus-scale runs
of the WER, speaker-similarity and UTMOS reports use files that have the
published layout and shapes with random values (seed 0):

  <out>/hubert_ctc/              HF HubertForCTC directory at the
                                 facebook/hubert-large-ls960-ft config, with
                                 the 32-token CTC vocabulary (utils/hf_dir.py)
  <out>/wavlm_large_finetune.pth torch {"model": ...}: microsoft-layout
                                 WavLM-large under feature_extract.model.,
                                 the ECAPA trunk and feature_weight
  <out>/utmos22_strong.ckpt      lightning {"state_dict": ...}: fairseq
                                 wav2vec2-base under
                                 feature_extractors.0.ssl_model., and the head

Each torch file also carries its SSL config as ``ssl_config`` (the
loaders take the published config where a file has none, as the published
files do not).  The positional convs are written weight-normed (``weight_g`` / ``weight_v``;
``parametrizations.weight.original0/1`` in the HF directory), as the
published files hold them.  Each file is checked to load back through the
port's own loaders leaf for leaf (the HF directory is read back from disk).

Run:  python -m simwhisper_codec_tpu_torch.tools.make_synthetic_tower_weights --out tower_weights
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from simwhisper_codec_tpu_torch.eval.speaker import (
    SCALE,
    WAVLM_PREFIX,
    convert_ecapa_state_dict,
    init_ecapa,
)
from simwhisper_codec_tpu_torch.eval.utmos import RNN, SSL_PREFIX, UTMOSConfig, convert_utmos_checkpoint, init_utmos_params
from simwhisper_codec_tpu_torch.models.ssl import (
    SSLConfig,
    count_params,
    hubert_large_ft_config,
    init_ssl_params,
    tree_leaves,
    wavlm_large_config,
)
from simwhisper_codec_tpu_torch.utils.hf_dir import read_hf_ctc_dir, write_hf_ctc_dir
from simwhisper_codec_tpu_torch.utils.ssl_checkpoint import convert_msft_wavlm, fold_weight_norm

# the published CTC vocabulary (wav2vec2 / HuBERT character set)
CTC_VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4, "E": 5, "T": 6, "A": 7, "O": 8, "N": 9,
             "I": 10, "H": 11, "S": 12, "R": 13, "D": 14, "L": 15, "U": 16, "M": 17, "W": 18, "C": 19,
             "F": 20, "G": 21, "Y": 22, "P": 23, "B": 24, "V": 25, "K": 26, "'": 27, "X": 28, "J": 29,
             "Q": 30, "Z": 31}


def weight_norm_pos_conv(tree: dict) -> tuple:
    """Give an SSL tree a weight-normed positional conv: v = its weight,
    g = the per-tap norm of v; the tree's weight becomes fold(g, v), so a
    file holding (g, v) loads back to it bit for bit.  Returns (g, v)."""
    v = tree["pos_conv"]["w"].numpy()
    g = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True)).astype(np.float32)
    tree["pos_conv"]["w"] = torch.from_numpy(fold_weight_norm(g, v))
    return torch.from_numpy(g), torch.from_numpy(v)


# ---------------------------------------------------------------------------
# inverse converters: the port's trees -> published state-dict layouts
# ---------------------------------------------------------------------------


def _lin(sd: dict, prefix: str, leaf: dict) -> None:
    sd[f"{prefix}.weight"] = leaf["w"]
    if leaf.get("b") is not None:
        sd[f"{prefix}.bias"] = leaf["b"]


def _ln(sd: dict, prefix: str, leaf: dict) -> None:
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = leaf["scale"], leaf["bias"]


def ssl_tree_to_fairseq(tree: dict, cfg: SSLConfig, pos_conv_gv, prefix: str = "", msft: bool = False) -> dict:
    """Inverse of ``convert_fairseq_wav2vec2`` / ``convert_msft_wavlm``; the
    positional conv as ``weight_g`` / ``weight_v`` (``pos_conv_gv``)."""
    sd = {}
    for i, layer in enumerate(tree["conv_layers"]):
        _lin(sd, f"{prefix}feature_extractor.conv_layers.{i}.0", layer)
        if "norm_scale" in layer:
            nk = (f"{prefix}feature_extractor.conv_layers.{i}.2.1" if msft and cfg.extract_norm == "layer"
                  else f"{prefix}feature_extractor.conv_layers.{i}.2")
            sd[f"{nk}.weight"], sd[f"{nk}.bias"] = layer["norm_scale"], layer["norm_bias"]
    _ln(sd, f"{prefix}layer_norm", tree["feat_ln"])
    _lin(sd, f"{prefix}post_extract_proj", tree["feat_proj"])
    pc = f"{prefix}encoder.pos_conv.0"
    sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"] = pos_conv_gv
    sd[f"{pc}.bias"] = tree["pos_conv"]["b"]
    _ln(sd, f"{prefix}encoder.layer_norm", tree["encoder_ln"])
    for i, lp in enumerate(tree["layers"]):
        p = f"{prefix}encoder.layers.{i}"
        for name, key in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "o")):
            _lin(sd, f"{p}.self_attn.{name}", lp[key])
        _ln(sd, f"{p}.self_attn_layer_norm", lp["attn_ln"])
        _lin(sd, f"{p}.fc1", lp["fc1"])
        _lin(sd, f"{p}.fc2", lp["fc2"])
        _ln(sd, f"{p}.final_layer_norm", lp["final_ln"])
        if cfg.rel_pos_bias:
            _lin(sd, f"{p}.self_attn.grep_linear", {"w": lp["gru_w"], "b": lp["gru_b"]})
            sd[f"{p}.self_attn.grep_a"] = lp["gru_const"].reshape(1, -1, 1, 1)
    if cfg.rel_pos_bias:
        sd[f"{prefix}encoder.layers.0.self_attn.relative_attention_bias.weight"] = tree["rel_attn_embed"]
    return sd


def ssl_tree_to_hf(tree: dict, cfg: SSLConfig, pos_conv_gv, prefix: str = "hubert.") -> dict:
    """Inverse of ``convert_hf_ssl`` for HubertModel (no relative bias); the
    positional conv as ``parametrizations.weight.original0/1``."""
    sd = {}
    for i, layer in enumerate(tree["conv_layers"]):
        _lin(sd, f"{prefix}feature_extractor.conv_layers.{i}.conv", layer)
        if "norm_scale" in layer:
            nk = f"{prefix}feature_extractor.conv_layers.{i}.layer_norm"
            sd[f"{nk}.weight"], sd[f"{nk}.bias"] = layer["norm_scale"], layer["norm_bias"]
    _ln(sd, f"{prefix}feature_projection.layer_norm", tree["feat_ln"])
    _lin(sd, f"{prefix}feature_projection.projection", tree["feat_proj"])
    pc = f"{prefix}encoder.pos_conv_embed.conv"
    sd[f"{pc}.bias"] = tree["pos_conv"]["b"]
    sd[f"{pc}.parametrizations.weight.original0"], sd[f"{pc}.parametrizations.weight.original1"] = pos_conv_gv
    _ln(sd, f"{prefix}encoder.layer_norm", tree["encoder_ln"])
    for i, lp in enumerate(tree["layers"]):
        p = f"{prefix}encoder.layers.{i}"
        for name, key in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "o")):
            _lin(sd, f"{p}.attention.{name}", lp[key])
        _ln(sd, f"{p}.layer_norm", lp["attn_ln"])
        _lin(sd, f"{p}.feed_forward.intermediate_dense", lp["fc1"])
        _lin(sd, f"{p}.feed_forward.output_dense", lp["fc2"])
        _ln(sd, f"{p}.final_layer_norm", lp["final_ln"])
    return sd


def ecapa_tree_to_torch(tree: dict) -> dict:
    """Inverse of ``convert_ecapa_state_dict`` (the reference ECAPA keys)."""
    sd = {}

    def bn(prefix, leaf):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = leaf["scale"], leaf["bias"]
        sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"] = leaf["mean"], leaf["var"]

    def crb(name, leaf):
        _lin(sd, f"{name}.conv", leaf["conv"])
        bn(f"{name}.bn", leaf["bn"])

    def se_res2(name, leaf):
        crb(f"{name}.Conv1dReluBn1", leaf["in"])
        for i in range(SCALE - 1):
            _lin(sd, f"{name}.Res2Conv1dReluBn.convs.{i}", leaf["res2"]["convs"][i])
            bn(f"{name}.Res2Conv1dReluBn.bns.{i}", leaf["res2"]["bns"][i])
        crb(f"{name}.Conv1dReluBn2", leaf["out"])
        _lin(sd, f"{name}.SE_Connect.linear1", leaf["se"]["fc1"])
        _lin(sd, f"{name}.SE_Connect.linear2", leaf["se"]["fc2"])

    crb("layer1", tree["layer1"])
    for name in ("layer2", "layer3", "layer4"):
        se_res2(name, tree[name])
    _lin(sd, "conv", tree["mfa"])
    _lin(sd, "pooling.linear1", tree["pool"]["att1"])
    _lin(sd, "pooling.linear2", tree["pool"]["att2"])
    bn("bn", tree["bn"])
    _lin(sd, "linear", tree["fc"])
    return sd


def utmos_tree_to_lightning(tree: dict, cfg: UTMOSConfig, pos_conv_gv) -> dict:
    """Inverse of ``convert_utmos_checkpoint``."""
    sd = ssl_tree_to_fairseq(tree["ssl"], cfg.ssl, pos_conv_gv, prefix=SSL_PREFIX)
    sd["feature_extractors.1.embedding.weight"] = tree["domain_emb"]
    sd["output_layers.0.judge_embedding.weight"] = tree["judge_emb"]
    for suffix, d in (("", tree["lstm"]["fwd"]), ("_reverse", tree["lstm"]["bwd"])):
        for k in ("ih", "hh"):
            sd[f"{RNN}.weight_{k}_l0{suffix}"] = d[f"w_{k}"]
            sd[f"{RNN}.bias_{k}_l0{suffix}"] = d[f"b_{k}"]
    _lin(sd, "output_layers.1.net.0", tree["proj1"])
    _lin(sd, "output_layers.1.net.3", tree["proj2"])
    return sd


# ---------------------------------------------------------------------------
# writers, each checked against the port's loaders
# ---------------------------------------------------------------------------


def assert_trees_equal(a, b, where: str) -> None:
    la, lb = dict(tree_leaves(a)), dict(tree_leaves(b))
    assert sorted(la) == sorted(lb), f"{where}: keys differ: {sorted(set(la) ^ set(lb))}"
    for k, x in la.items():
        assert x.shape == lb[k].shape and torch.equal(x, lb[k]), f"{where}: {k}"


def make_wavlm_ecapa(out_path: Path, seed: int = 0, cfg: SSLConfig = None, ecapa_feat_dim: int = None) -> dict:
    cfg = cfg or wavlm_large_config()
    wavlm = init_ssl_params(cfg, torch.Generator().manual_seed(seed + 1))
    gv = weight_norm_pos_conv(wavlm)
    ecapa = init_ecapa(torch.Generator().manual_seed(seed), feat_dim=ecapa_feat_dim or cfg.d_model)
    fw = torch.from_numpy(np.linspace(-0.1, 0.1, cfg.num_layers + 1).astype(np.float32))
    sd = ecapa_tree_to_torch(ecapa)
    sd.update(ssl_tree_to_fairseq(wavlm, cfg, gv, prefix=WAVLM_PREFIX, msft=True))
    sd["feature_weight"] = fw
    assert_trees_equal(convert_ecapa_state_dict(sd), ecapa, "ecapa")
    assert_trees_equal(convert_msft_wavlm(sd, cfg, prefix=WAVLM_PREFIX), wavlm, "wavlm")
    torch.save({"model": sd, "ssl_config": dataclasses.asdict(cfg)}, out_path)
    return {"file": str(out_path), "tensors": len(sd), "params": count_params(wavlm) + count_params(ecapa) + fw.numel()}


def make_utmos(out_path: Path, seed: int = 0, cfg: UTMOSConfig = None) -> dict:
    cfg = cfg or UTMOSConfig()
    tree = init_utmos_params(cfg, torch.Generator().manual_seed(seed))
    gv = weight_norm_pos_conv(tree["ssl"])
    sd = utmos_tree_to_lightning(tree, cfg, gv)
    assert_trees_equal(convert_utmos_checkpoint(sd, cfg), tree, "utmos")
    torch.save({"state_dict": sd, "ssl_config": dataclasses.asdict(cfg.ssl)}, out_path)
    return {"file": str(out_path), "tensors": len(sd), "params": count_params(tree)}


def make_hubert_ctc(out_dir: Path, seed: int = 0, cfg: SSLConfig = None) -> dict:
    cfg = cfg or hubert_large_ft_config()
    gen = torch.Generator().manual_seed(seed)
    tree = {"ssl": init_ssl_params(cfg, gen),
            "lm_head": {"w": torch.randn((len(CTC_VOCAB), cfg.d_model), generator=gen) / np.sqrt(cfg.d_model),
                        "b": torch.zeros(len(CTC_VOCAB))}}
    gv = weight_norm_pos_conv(tree["ssl"])
    sd = ssl_tree_to_hf(tree["ssl"], cfg, gv)
    sd["hubert.masked_spec_embed"] = torch.rand(cfg.d_model, generator=gen)
    _lin(sd, "lm_head", tree["lm_head"])
    write_hf_ctc_dir(out_dir, cfg, sd, CTC_VOCAB)
    params, vocab, do_norm, back_cfg = read_hf_ctc_dir(out_dir)
    assert back_cfg == cfg and do_norm and vocab == {i: t for t, i in CTC_VOCAB.items()}
    assert_trees_equal(params, tree, "hubert_ctc")
    return {"file": str(out_dir), "tensors": len(sd), "params": count_params(tree)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=["hubert", "wavlm", "utmos"], default=None)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    makers = {"hubert": (make_hubert_ctc, out / "hubert_ctc"),
              "wavlm": (make_wavlm_ecapa, out / "wavlm_large_finetune.pth"),
              "utmos": (make_utmos, out / "utmos22_strong.ckpt")}
    for name, (make, path) in makers.items():
        if args.only in (None, name):
            t0 = time.perf_counter()
            info = make(path, args.seed)
            size = sum(f.stat().st_size for f in ([path] if path.is_file() else path.iterdir()))
            print(f"wrote {info['file']}: {info['params']} parameters, {info['tensors']} tensors, {size} bytes, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
