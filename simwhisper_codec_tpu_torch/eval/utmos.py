"""UTMOS (UTMOS22-strong) MOS predictor.

Counterpart of ``simwhisper_codec_tpu/eval/utmos.py`` (reference
``tools/utmos/utmos.py:35-245``):

  wav2vec2-small SSL tower (features only)                  -> (B, T, 768)
  + domain embedding (3, 128), domain id 0                  -> broadcast over T
  + judge embedding (3000, 128), judge id 288               -> broadcast over T
  concat (B, T, 1024) -> BLSTM hidden 512 bidirectional     -> (B, T, 1024)
  -> Linear 1024->2048 -> ReLU -> Linear 2048->1            -> (B, T, 1)
  score = mean over the valid frames * 2 + 3                (utmos.py:73)

The BiLSTM (``BiLSTM``) is two unidirectional ``torch.nn.LSTM``s (cuDNN
on the card) over the padded frames, with no host read: the forward one
runs as it is (its valid frames never see the pads that follow them); the
backward one runs forward over each item reversed within its own length (a
device-side gather: frame ``L - 1 - t`` for ``t < L``, the pads left in
place), and its output is gathered back.  On the valid frames that is what
the JAX ``lax.scan``'s valid-hold gives, and what an LSTM over a packed
sequence gives; pad frames are zero (the JAX scan's pad outputs differ, and
never reach the score).  So ``UTMOSScorer.program`` can run the whole
scorer as one ``utils/aot.py`` program, a CUDA graph per length bucket, as
the JAX scorer jits it once per bucket.  Run under
``f32_precision("highest")``.
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
from simwhisper_codec_tpu_torch.utils import aot
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


def reverse_within(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, F): each item's first ``lengths[b]`` frames in reverse order,
    the frames after them where they are (frame ``L - 1 - t`` for ``t < L``,
    else ``t``); its own inverse.  A gather on the device."""
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    last = lengths[:, None] - 1
    index = torch.where(t <= last, last - t, t)
    return x.gather(1, index[..., None].expand(-1, -1, x.shape[-1]))


class BiLSTM:
    """``nn.LSTM(batch_first=True, bidirectional=True)`` with the weights of
    ``p`` ({"fwd", "bwd"}: w_ih (4H, F), w_hh (4H, H), b_ih, b_hh; gates i,
    f, g, o) as two unidirectional LSTMs on the weights' device, their
    weights flattened once (cuDNN's layout); see the module docstring."""

    def __init__(self, p: dict):
        self.dirs = []
        for d in (p["fwd"], p["bwd"]):
            h = d["w_hh"].shape[1]
            lstm = nn.LSTM(d["w_ih"].shape[1], h, batch_first=True, device="meta")
            lstm.load_state_dict({f"{'weight' if n[0] == 'w' else 'bias'}_{n[2:]}_l0": d[n]
                                  for n in ("w_ih", "w_hh", "b_ih", "b_hh")}, assign=True)
            lstm.flatten_parameters()
            self.dirs.append(lstm)

    def __call__(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, F) -> (B, T, 2H); with ``lengths`` (B,), each item over its
        first ``lengths[b]`` frames, pad-frame outputs zero."""
        fwd, bwd = self.dirs
        if lengths is None:
            return torch.cat([fwd(x)[0], bwd(x.flip(1))[0].flip(1)], dim=-1)
        out = torch.cat([fwd(x)[0], reverse_within(bwd(reverse_within(x, lengths))[0], lengths)], dim=-1)
        valid = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
        return out * valid[..., None]


def bilstm(p: dict, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``BiLSTM(p)(x, lengths)``, the LSTMs built for this call."""
    return BiLSTM(p)(x, lengths)


def utmos_head(params: dict, ssl_features: torch.Tensor, lengths: Optional[torch.Tensor] = None,
               lstm: Optional[BiLSTM] = None) -> torch.Tensor:
    """SSL features (B, T, D) -> per-frame scores (B, T), domain 0, judge 288;
    ``lstm``: ``params["lstm"]``'s ``BiLSTM`` (else built for the call)."""
    b, t, _ = ssl_features.shape
    dom = params["domain_emb"][DOMAIN_ID].expand(b, t, -1)
    jud = params["judge_emb"][JUDGE_ID].expand(b, t, -1)
    x = (lstm or BiLSTM(params["lstm"]))(torch.cat([ssl_features, dom, jud], dim=-1), lengths)
    x = F.relu(F.linear(x, params["proj1"]["w"], params["proj1"]["b"]))
    return F.linear(x, params["proj2"]["w"], params["proj2"]["b"])[..., 0]


def utmos_forward(cfg: UTMOSConfig, params: dict, wav: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None, lstm: Optional[BiLSTM] = None) -> torch.Tensor:
    """Waveform (B, S) at 16 kHz -> MOS scores (B,): frame scores averaged
    over the (valid) frames, then ``* 2 + 3`` (``UTMOSScore.score``,
    utmos.py:49-73)."""
    out = ssl_forward(cfg.ssl, params["ssl"], wav, lengths)
    feats = out["x"]
    if lengths is None:
        return utmos_head(params, feats, lstm=lstm).mean(dim=1) * 2.0 + 3.0
    frame_lengths = out["frame_lengths"]
    frame_scores = utmos_head(params, feats, frame_lengths, lstm)
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
    to a power-of-two-second bucket with the padding left out of the mean;
    ``program``: ``utmos_forward`` on the weights and the scorer's
    ``BiLSTM``, one program per bucket."""

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
        self.lstm = BiLSTM(self.params["lstm"])
        self.program = aot.CapturedProgram(self._forward, "utmos")

    def _forward(self, wav: torch.Tensor, lengths: torch.Tensor) -> dict:
        return {"score": utmos_forward(self.cfg, self.params, wav, lengths, self.lstm)}

    @torch.no_grad()
    def score(self, wav: np.ndarray, sample_rate: int = 16000) -> float:
        if sample_rate != 16000:
            raise ValueError("UTMOS expects 16 kHz input (resample on load)")
        wav = np.asarray(wav, np.float32).reshape(-1)
        n = len(wav)
        padded = np.zeros((1, power_of_two_bucket(n)), np.float32)
        padded[0, :n] = wav
        with f32_precision(self.precision):
            out = self.program(torch.from_numpy(padded).to(self.device),
                               torch.tensor([max(n, 400)], device=self.device))
        return float(out["score"][0])
