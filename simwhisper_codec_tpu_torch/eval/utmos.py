"""UTMOS (UTMOS22-strong) MOS predictor.

Counterpart of ``simwhisper_codec_tpu/eval/utmos.py`` (reference
``tools/utmos/utmos.py:35-245``):

  wav2vec2-small SSL tower (features only)                  -> (B, T, 768)
  + domain embedding (3, 128), domain id 0                  -> broadcast over T
  + judge embedding (3000, 128), judge id 288               -> broadcast over T
  concat (B, T, 1024) -> BLSTM hidden 512 bidirectional     -> (B, T, 1024)
  -> Linear 1024->2048 -> ReLU -> Linear 2048->1            -> (B, T, 1)
  score = mean over the valid frames * 2 + 3                (utmos.py:73)

The BiLSTM is ``torch.nn.LSTM`` over a packed sequence: each item runs
over its own valid frames only, which is what the JAX ``lax.scan``'s
valid-hold gives on valid frames (its pad-frame outputs differ, and never
reach the score).  Run under ``f32_precision("highest")``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from simwhisper_codec_tpu_torch.models.codec import f32_precision, resolve_device
from simwhisper_codec_tpu_torch.models.ssl import (
    SSLConfig,
    init_ssl_params,
    power_of_two_bucket,
    ssl_config_from_dict,
    ssl_forward,
    tree_map,
    wav2vec2_base_config,
)
from simwhisper_codec_tpu_torch.utils.ssl_checkpoint import convert_fairseq_wav2vec2, to_tensor

DOMAIN_ID = 0  # utmos.py:67
JUDGE_ID = 288  # utmos.py:68
LSTM_HIDDEN = 512
EMB_DIM = 128
PROJ_HIDDEN = 2048
SSL_PREFIX = "feature_extractors.0.ssl_model."
RNN = "output_layers.0.decoder_rnn"


@dataclasses.dataclass(frozen=True)
class UTMOSConfig:
    ssl: SSLConfig = dataclasses.field(default_factory=wav2vec2_base_config)
    num_domains: int = 3
    num_judges: int = 3000
    lstm_hidden: int = LSTM_HIDDEN
    emb_dim: int = EMB_DIM
    proj_hidden: int = PROJ_HIDDEN


def bilstm(p: dict, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``nn.LSTM(batch_first=True, bidirectional=True)`` with the weights of
    ``p`` ({"fwd", "bwd"}: w_ih (4H, F), w_hh (4H, H), b_ih, b_hh; gates
    i, f, g, o).  With ``lengths`` (B,), each item runs over its first
    ``lengths[b]`` frames; pad-frame outputs are zero."""
    h = p["fwd"]["w_hh"].shape[1]
    lstm = nn.LSTM(x.shape[-1], h, batch_first=True, bidirectional=True, device="meta")
    sd = {}
    for suffix, d in (("", p["fwd"]), ("_reverse", p["bwd"])):
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            kind, part = name.split("_")
            sd[f"{'weight' if kind == 'w' else 'bias'}_{part}_l0{suffix}"] = d[name]
    lstm.load_state_dict(sd, assign=True)
    lstm.flatten_parameters()
    if lengths is None:
        return lstm(x)[0]
    packed = nn.utils.rnn.pack_padded_sequence(x, lengths.cpu(), batch_first=True, enforce_sorted=False)
    out, _ = lstm(packed)
    return nn.utils.rnn.pad_packed_sequence(out, batch_first=True, total_length=x.shape[1])[0]


def utmos_head(params: dict, ssl_features: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SSL features (B, T, D) -> per-frame scores (B, T), domain 0, judge 288."""
    b, t, _ = ssl_features.shape
    dom = params["domain_emb"][DOMAIN_ID].expand(b, t, -1)
    jud = params["judge_emb"][JUDGE_ID].expand(b, t, -1)
    x = bilstm(params["lstm"], torch.cat([ssl_features, dom, jud], dim=-1), lengths)
    x = F.relu(F.linear(x, params["proj1"]["w"], params["proj1"]["b"]))
    return F.linear(x, params["proj2"]["w"], params["proj2"]["b"])[..., 0]


def utmos_forward(cfg: UTMOSConfig, params: dict, wav: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Waveform (B, S) at 16 kHz -> MOS scores (B,): frame scores averaged
    over the (valid) frames, then ``* 2 + 3`` (``UTMOSScore.score``,
    utmos.py:49-73)."""
    out = ssl_forward(cfg.ssl, params["ssl"], wav, lengths)
    feats = out["x"]
    if lengths is None:
        return utmos_head(params, feats).mean(dim=1) * 2.0 + 3.0
    frame_lengths = out["frame_lengths"]
    frame_scores = utmos_head(params, feats, frame_lengths)
    valid = (torch.arange(feats.shape[1], device=feats.device)[None, :] < frame_lengths[:, None]).to(feats.dtype)
    mean = (frame_scores * valid).sum(dim=1) / torch.clamp(valid.sum(dim=1), min=1.0)
    return mean * 2.0 + 3.0


# ---------------------------------------------------------------------------
# Checkpoint conversion (UTMOS lightning layout, utmos.py:112-131)
# ---------------------------------------------------------------------------


def convert_utmos_head(sd: Dict) -> dict:
    """The head (everything but the SSL tower) from the lightning layout:

      feature_extractors.1.embedding.weight     domain embedding (3, 128)
      output_layers.0.judge_embedding.weight    judge embedding (3000, 128)
      output_layers.0.decoder_rnn.{weight,bias}_{ih,hh}_l0[_reverse]  BLSTM
      output_layers.1.net.{0,3}.{weight,bias}   projection MLP
    """
    def lstm_dir(suffix):
        return {f"{k}_{p}": to_tensor(sd[f"{RNN}.{'weight' if k == 'w' else 'bias'}_{p}_l0{suffix}"])
                for k in ("w", "b") for p in ("ih", "hh")}

    def lin(prefix):
        return {"w": to_tensor(sd[f"{prefix}.weight"]), "b": to_tensor(sd[f"{prefix}.bias"])}

    return {
        "domain_emb": to_tensor(sd["feature_extractors.1.embedding.weight"]),
        "judge_emb": to_tensor(sd["output_layers.0.judge_embedding.weight"]),
        "lstm": {"fwd": lstm_dir(""), "bwd": lstm_dir("_reverse")},
        "proj1": lin("output_layers.1.net.0"),
        "proj2": lin("output_layers.1.net.3"),
    }


def convert_utmos_checkpoint(sd: Dict, cfg: UTMOSConfig = None) -> dict:
    """Lightning ``state_dict`` of BaselineLightningModule -> tree; the SSL
    tower is fairseq wav2vec2 under ``feature_extractors.0.ssl_model.``."""
    cfg = cfg or UTMOSConfig()
    params = convert_utmos_head(sd)
    params["ssl"] = convert_fairseq_wav2vec2(sd, cfg.ssl, prefix=SSL_PREFIX)
    return params


def init_utmos_params(cfg: UTMOSConfig, generator: torch.Generator) -> dict:
    """Random tree (the JAX ``init_utmos_params``'s scales), drawn from ``generator``."""
    d, h = cfg.ssl.d_model, cfg.lstm_hidden
    feat_in = d + 2 * cfg.emb_dim

    def uniform(shape, s):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * s

    def lstm_dir():
        s = 1.0 / np.sqrt(h)
        return {"w_ih": uniform((4 * h, feat_in), s), "w_hh": uniform((4 * h, h), s),
                "b_ih": torch.zeros(4 * h), "b_hh": torch.zeros(4 * h)}

    def lin(cin, cout):
        return {"w": torch.randn((cout, cin), generator=generator) / np.sqrt(cin), "b": torch.zeros(cout)}

    return {
        "ssl": init_ssl_params(cfg.ssl, generator),
        "domain_emb": torch.randn((cfg.num_domains, cfg.emb_dim), generator=generator),
        "judge_emb": torch.randn((cfg.num_judges, cfg.emb_dim), generator=generator),
        "lstm": {"fwd": lstm_dir(), "bwd": lstm_dir()},
        "proj1": lin(2 * h, cfg.proj_hidden),
        "proj2": lin(cfg.proj_hidden, 1),
    }


def load_utmos_checkpoint(ckpt_path: str, cfg: UTMOSConfig = None) -> Tuple[dict, UTMOSConfig]:
    """A lightning ``{"state_dict": ...}`` file -> (tree, config); the SSL
    config is the file's ``ssl_config`` entry where it has one (synthetic
    files at other widths), else wav2vec2-base.  ``weights_only=False``:
    lightning checkpoints pickle more than tensors."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    if cfg is None:
        cfg = UTMOSConfig(ssl=ssl_config_from_dict(ckpt["ssl_config"])) if "ssl_config" in ckpt else UTMOSConfig()
    state = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}
    return convert_utmos_checkpoint(sd, cfg), cfg


def load_utmos_params(ckpt_path: str, cfg: UTMOSConfig = None) -> dict:
    return load_utmos_checkpoint(ckpt_path, cfg)[0]


class UTMOSScorer:
    """Scores one waveform at a time (the tools/utmos CLI's backend), padded
    to a power-of-two-second bucket with the padding left out of the mean."""

    def __init__(self, ckpt_path: str = None, params: dict = None, cfg: UTMOSConfig = None, device=None,
                 precision: str = "highest"):
        self.precision = precision  # "highest": TF32 off; "default": TF32 on
        self.device = resolve_device(device)
        if params is None:
            if ckpt_path is None:
                raise ValueError("need ckpt_path or params")
            params, cfg = load_utmos_checkpoint(ckpt_path, cfg)
        self.cfg = cfg or UTMOSConfig()
        self.params = tree_map(lambda t: t.to(self.device), params)

    @torch.no_grad()
    def score(self, wav: np.ndarray, sample_rate: int = 16000) -> float:
        if sample_rate != 16000:
            raise ValueError("UTMOS expects 16 kHz input (resample on load)")
        wav = np.asarray(wav, np.float32).reshape(-1)
        n = len(wav)
        padded = np.zeros((1, power_of_two_bucket(n)), np.float32)
        padded[0, :n] = wav
        with f32_precision(self.precision):
            out = utmos_forward(self.cfg, self.params, torch.from_numpy(padded).to(self.device),
                                torch.tensor([max(n, 400)], device=self.device))
        return float(out[0])
