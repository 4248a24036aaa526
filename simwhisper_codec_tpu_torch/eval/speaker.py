"""ECAPA-TDNN speaker embedder over WavLM-large features.

Counterpart of ``simwhisper_codec_tpu/eval/speaker.py`` (reference
``tools/speaker/utils/ecapa_tdnn.py:163-307``, ``ECAPA_TDNN_SMALL(feat_dim=1024,
feat_type='wavlm_large')``, the lawlict/UniSpeech variant):

  features -> InstanceNorm (no affine)
  layer1: Conv1d k5 pad2 -> ReLU -> BN
  layer2..4: SE-Res2Block(512, k3, dil 2/3/4, scale 8):
      1x1 Conv-ReLU-BN -> Res2 (7 convs, each conv->ReLU->BN, the LAST split
      passes through) -> 1x1 Conv-ReLU-BN -> SE -> + residual
  cat(out2, out3, out4) (1536) -> 1x1 conv -> ReLU
  AttentiveStatsPool (tanh(lin1) -> softmax(lin2), no global context)
  BN -> Linear -> 256-d embedding

Frontends: ``wavlm_large`` (softmax-weighted sum of WavLM-large's 25 hidden
states, + 1e-6, InstanceNorm) and ``fbank`` (torchaudio-style log-mel).
With frame lengths, a right-padded batch equals exact-length runs: masked
statistics, zero pads.  Trees hold torch-layout weights; batch norm runs in
eval mode on the stored statistics.  Run under ``f32_precision("highest")``.
``SpeakerEmbedder.program`` runs a frontend and ECAPA as one
``utils/aot.py`` program (a CUDA graph per input shape on the card), the
twin of the JAX ``_forward_wavlm`` / ``_forward_fbank`` jits.

``SpeakerEmbedder.embed_batch`` is the one path: rows sorted by length and
grouped by power-of-two-second bucket, each group one program call of a
power-of-two number of rows (``wavlm_groups``) padded with empty rows, so
that a bucket is a few signatures; one upload and one download a call.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.nn import functional as F

from simwhisper_codec_tpu_torch.models.codec import HostStaging, f32_precision, resolve_device
from simwhisper_codec_tpu_torch.models.ssl import (
    SSLConfig,
    init_ssl_params,
    power_of_two_bucket,
    ssl_config_from_dict,
    ssl_forward,
    tree_map,
    wavlm_large_config,
)
from simwhisper_codec_tpu_torch.utils import aot
from simwhisper_codec_tpu_torch.utils.profiling import annotate
from simwhisper_codec_tpu_torch.utils.ssl_checkpoint import convert_msft_wavlm, to_tensor

EMB_DIM = 256  # ECAPA_TDNN_SMALL default (ecapa_tdnn.py:295)
CHANNELS = 512
SCALE = 8
CAT_CHANNELS = 1536  # self.channels[-1] (ecapa_tdnn.py:227)
WAVLM_PREFIX = "feature_extract.model."
MIN_SAMPLES = 800  # a shorter row is zero-padded to this length (the conv stack needs 400)
MAX_ROWS = 16  # rows of one WavLM program up to the 32 s bucket
ROWS_BUCKET = 32 * 16000
PAIRS_PER_CALL = 64  # ``similarities``: pairs a call, both rows of a pair in one call


def group_rows(bucket: int, max_rows: int) -> int:
    """The most rows of one program at ``bucket`` samples, at least one:
    ``max_rows`` up to the 32 s bucket; above it rows x bucket (the memory of
    the GEMMs and convolutions) no more than at 32 s, and rows x bucket^2
    (the (rows, heads, T, T) attention's) no more than at 64 s.  At 16:
    16, 8, 2, 1, 1 rows at 32, 64, 128, 256, 512 s."""
    linear = max_rows * ROWS_BUCKET // max(bucket, ROWS_BUCKET)
    square = 2 * max_rows * ROWS_BUCKET ** 2 // bucket ** 2
    return max(1, min(linear, square))


def wavlm_groups(lengths: np.ndarray, max_rows: int) -> List[tuple]:
    """(bucket samples, program rows, input rows) of each program call for rows
    of ``lengths`` samples: sorted by length, grouped by power-of-two-second
    bucket, full groups of ``group_rows`` rows, then the bucket's last rows
    in a group padded to the next power of two.  A bucket's signatures are
    its power-of-two row counts: 5 at most up to the 32 s bucket."""
    order = np.argsort(lengths, kind="stable")
    buckets = np.array([power_of_two_bucket(int(n)) for n in lengths[order]], np.int64)
    groups = []
    for bucket in np.unique(buckets).tolist():
        rows, most = order[buckets == bucket], group_rows(bucket, max_rows)
        s = 0
        while s < len(rows):
            r = min(most, 1 << (len(rows) - s - 1).bit_length())
            groups.append((bucket, r, rows[s:s + r]))
            s += r
    return groups


def pair_calls(pairs: Sequence[tuple]) -> List[list]:
    """The rows of each ``embed_batch`` call of ``similarities(pairs)``:
    both rows of ``PAIRS_PER_CALL`` pairs a call."""
    return [[w for pair in pairs[s:s + PAIRS_PER_CALL] for w in pair] for s in range(0, len(pairs), PAIRS_PER_CALL)]


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    """The reference's SIM of two embeddings (``spk_sim_cal.py``)."""
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _valid_mask(x: torch.Tensor, frame_lengths: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, T, 1) float validity mask, or None."""
    if frame_lengths is None:
        return None
    t = x.shape[1]
    return (torch.arange(t, device=x.device)[None, :] < frame_lengths[:, None])[..., None].to(x.dtype)


def instance_norm(x: torch.Tensor, eps: float = 1e-5, frame_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``nn.InstanceNorm1d`` (affine=False) on (B, T, C): per-channel norm over
    time, biased variance, eps inside the sqrt; with ``frame_lengths`` the
    statistics cover valid frames only and pad frames are zeroed."""
    valid = _valid_mask(x, frame_lengths)
    if valid is None:
        mean = x.mean(dim=1, keepdim=True)
        var = torch.square(x - mean).mean(dim=1, keepdim=True)
    else:
        x = x * valid
        cnt = torch.clamp(valid.sum(dim=1, keepdim=True), min=1.0)
        mean = x.sum(dim=1, keepdim=True) / cnt
        var = (torch.square(x - mean) * valid).sum(dim=1, keepdim=True) / cnt
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * valid if valid is not None else y


def _bn(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode batch norm over the trailing channel dim."""
    return (x - p["mean"]) * torch.rsqrt(p["var"] + eps) * p["scale"] + p["bias"]


def _conv(p: dict, x: torch.Tensor, dilation: int = 1, padding: int = 0) -> torch.Tensor:
    """Conv1d on channels-last (B, T, C)."""
    return F.conv1d(x.transpose(1, 2), p["w"], p.get("b"), dilation=dilation, padding=padding).transpose(1, 2)


def _conv_relu_bn(p: dict, x: torch.Tensor, dilation: int = 1, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Conv1dReluBn (ecapa_tdnn.py:57-64), 'same' padding; pad frames re-zeroed."""
    k = p["conv"]["w"].shape[-1]
    y = _bn(p["bn"], F.relu(_conv(p["conv"], x, dilation, (k - 1) * dilation // 2)))
    return y * valid if valid is not None else y


def _res2_conv_relu_bn(p: dict, x: torch.Tensor, dilation: int, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Res2Conv1dReluBn (ecapa_tdnn.py:14-50): chained convs over SCALE - 1
    splits, each conv -> relu -> bn; the last split passes through."""
    parts = torch.chunk(x, SCALE, dim=-1)
    outs, sp = [], None
    for i in range(SCALE - 1):
        sp = parts[i] if i == 0 else sp + parts[i]
        k = p["convs"][i]["w"].shape[-1]
        sp = _bn(p["bns"][i], F.relu(_conv(p["convs"][i], sp, dilation, (k - 1) * dilation // 2)))
        if valid is not None:
            sp = sp * valid
        outs.append(sp)
    outs.append(parts[SCALE - 1])
    return torch.cat(outs, dim=-1)


def _se(p: dict, x: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SE_Connect (ecapa_tdnn.py:71-83); the squeeze mean leaves pad frames out."""
    if valid is None:
        s = x.mean(dim=1)
    else:
        s = (x * valid).sum(dim=1) / torch.clamp(valid.sum(dim=1), min=1.0)
    s = F.relu(F.linear(s, p["fc1"]["w"], p["fc1"]["b"]))
    s = torch.sigmoid(F.linear(s, p["fc2"]["w"], p["fc2"]["b"]))
    return x * s[:, None, :]


def _se_res2_block(p: dict, x: torch.Tensor, dilation: int, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SE_Res2Block (ecapa_tdnn.py:99-125) with its identity shortcut."""
    h = _conv_relu_bn(p["in"], x, valid=valid)
    h = _res2_conv_relu_bn(p["res2"], h, dilation, valid=valid)
    h = _conv_relu_bn(p["out"], h, valid=valid)
    return _se(p["se"], h, valid=valid) + x


def _attentive_stats(p: dict, x: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """AttentiveStatsPool, global_context_att=False (ecapa_tdnn.py:132-160);
    pad frames get the f32-min logit, the variance is clipped at 1e-9."""
    a = _conv(p["att2"], torch.tanh(_conv(p["att1"], x)))
    if valid is not None:
        a = torch.where(valid > 0, a, torch.finfo(a.dtype).min)
    a = torch.softmax(a, dim=1)
    mean = (a * x).sum(dim=1)
    residuals = (a * x * x).sum(dim=1) - mean * mean
    std = torch.sqrt(torch.clamp(residuals, min=1e-9))
    return torch.cat([mean, std], dim=-1)


def ecapa_forward(p: dict, feats: torch.Tensor, frame_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Instance-normed features (B, T, F) -> embeddings (B, emb_dim)
    (``ECAPA_TDNN.forward``, ecapa_tdnn.py:279-292, after get_feat)."""
    valid = _valid_mask(feats, frame_lengths)
    out1 = _conv_relu_bn(p["layer1"], feats, valid=valid)
    out2 = _se_res2_block(p["layer2"], out1, 2, valid=valid)
    out3 = _se_res2_block(p["layer3"], out2, 3, valid=valid)
    out4 = _se_res2_block(p["layer4"], out3, 4, valid=valid)
    h = F.relu(_conv(p["mfa"], torch.cat([out2, out3, out4], dim=-1)))
    if valid is not None:
        h = h * valid
    pooled = _bn(p["bn"], _attentive_stats(p["pool"], h, valid=valid))
    return F.linear(pooled, p["fc"]["w"], p["fc"]["b"])


# ---------------------------------------------------------------------------
# Feature frontends
# ---------------------------------------------------------------------------


def wavlm_weighted_features(ssl_cfg: SSLConfig, ssl_params: dict, feature_weight: torch.Tensor, wav: torch.Tensor,
                            lengths: Optional[torch.Tensor] = None):
    """WavLM hidden states -> softmax(feature_weight)-weighted sum + 1e-6 ->
    InstanceNorm (``ECAPA_TDNN.get_feat``, ecapa_tdnn.py:266-277).  Returns
    (features, frame_lengths or None)."""
    out = ssl_forward(ssl_cfg, ssl_params, wav, lengths)
    w = torch.softmax(feature_weight, dim=0)
    x = torch.einsum("l,lbtd->btd", w, out["hidden_states"]) + 1e-6
    frame_lengths = out.get("frame_lengths")
    return instance_norm(x, frame_lengths=frame_lengths), frame_lengths


def htk_mel_filter_bank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float, f_max: float) -> np.ndarray:
    """torchaudio ``melscale_fbanks`` (mel_scale='htk', norm=None): (F, M)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # (F, M+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


class FbankFrontend:
    """torchaudio-style log-MelSpectrogram (the reference 'fbank' option,
    ecapa_tdnn.py:179-182,258-264): n_fft 512, periodic Hann 400 centred in
    the FFT window, hop 160, HTK mel, power 2, centre / reflect pad."""

    N_FFT = 512
    WIN = 400
    HOP = 160

    def __init__(self, feat_dim: int = 80, sample_rate: int = 16000):
        window = np.hanning(self.WIN + 1)[:-1].astype(np.float32)  # periodic
        lpad = (self.N_FFT - self.WIN) // 2
        self.window = torch.from_numpy(np.pad(window, (lpad, self.N_FFT - self.WIN - lpad)))
        self.mel_fb = torch.from_numpy(htk_mel_filter_bank(self.N_FFT // 2 + 1, feat_dim, sample_rate, 0.0,
                                                           sample_rate / 2))

    def to(self, device) -> "FbankFrontend":
        """The window and the filter bank on ``device``; returns self."""
        self.window, self.mel_fb = self.window.to(device), self.mel_fb.to(device)
        return self

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, S) -> instance-normed log-mel (B, T, M)."""
        half = self.N_FFT // 2
        x = F.pad(wav[:, None, :], (half, half), mode="reflect")[:, 0]
        frames = x.unfold(-1, self.N_FFT, self.HOP)[:, : 1 + wav.shape[1] // self.HOP]
        spec = torch.fft.rfft(frames * self.window.to(wav.device), dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        mel = power @ self.mel_fb.to(wav.device)
        return instance_norm(torch.log(mel + 1e-6))


# ---------------------------------------------------------------------------
# Init and conversion
# ---------------------------------------------------------------------------


def init_ecapa(generator: torch.Generator, feat_dim: int = 1024, emb_dim: int = EMB_DIM) -> dict:
    """Random tree (the JAX ``init_ecapa``'s U(+-1/sqrt(fan_in)) scales)."""

    def uniform(shape, bound):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound

    def conv(k, cin, cout):
        bound = 1.0 / math.sqrt(cin * k)
        return {"w": uniform((cout, cin, k), bound), "b": uniform((cout,), bound)}

    def linear(cin, cout):
        bound = 1.0 / math.sqrt(cin)
        return {"w": uniform((cout, cin), bound), "b": uniform((cout,), bound)}

    def bn(c):
        return {"scale": torch.ones(c), "bias": torch.zeros(c), "mean": torch.zeros(c), "var": torch.ones(c)}

    def crb(k, cin, cout):
        return {"conv": conv(k, cin, cout), "bn": bn(cout)}

    def se_res2(c):
        width = c // SCALE
        return {"in": crb(1, c, c),
                "res2": {"convs": [conv(3, width, width) for _ in range(SCALE - 1)],
                         "bns": [bn(width) for _ in range(SCALE - 1)]},
                "out": crb(1, c, c),
                "se": {"fc1": linear(c, 128), "fc2": linear(128, c)}}

    c = CHANNELS
    return {
        "layer1": crb(5, feat_dim, c),
        "layer2": se_res2(c),
        "layer3": se_res2(c),
        "layer4": se_res2(c),
        "mfa": conv(1, 3 * c, CAT_CHANNELS),
        "pool": {"att1": conv(1, CAT_CHANNELS, 128), "att2": conv(1, 128, CAT_CHANNELS)},
        "bn": bn(2 * CAT_CHANNELS),
        "fc": linear(2 * CAT_CHANNELS, emb_dim),
    }


def convert_ecapa_state_dict(sd: Dict, prefix: str = "") -> dict:
    """torch ``ECAPA_TDNN`` state dict (ecapa_tdnn.py:163-239) -> tree; the
    WavLM tower and ``feature_weight`` convert separately."""
    def key(name):
        return f"{prefix}{name}"

    def conv(name):
        out = {"w": to_tensor(sd[key(f"{name}.weight")])}
        out["b"] = to_tensor(sd[key(f"{name}.bias")]) if key(f"{name}.bias") in sd else None
        return out

    def bn(name):
        return {"scale": to_tensor(sd[key(f"{name}.weight")]), "bias": to_tensor(sd[key(f"{name}.bias")]),
                "mean": to_tensor(sd[key(f"{name}.running_mean")]), "var": to_tensor(sd[key(f"{name}.running_var")])}

    def lin(name):
        return {"w": to_tensor(sd[key(f"{name}.weight")]), "b": to_tensor(sd[key(f"{name}.bias")])}

    def crb(name):
        return {"conv": conv(f"{name}.conv"), "bn": bn(f"{name}.bn")}

    def se_res2(name):
        return {"in": crb(f"{name}.Conv1dReluBn1"),
                "res2": {"convs": [conv(f"{name}.Res2Conv1dReluBn.convs.{i}") for i in range(SCALE - 1)],
                         "bns": [bn(f"{name}.Res2Conv1dReluBn.bns.{i}") for i in range(SCALE - 1)]},
                "out": crb(f"{name}.Conv1dReluBn2"),
                "se": {"fc1": lin(f"{name}.SE_Connect.linear1"), "fc2": lin(f"{name}.SE_Connect.linear2")}}

    return {
        "layer1": crb("layer1"),
        "layer2": se_res2("layer2"),
        "layer3": se_res2("layer3"),
        "layer4": se_res2("layer4"),
        "mfa": conv("conv"),
        "pool": {"att1": conv("pooling.linear1"), "att2": conv("pooling.linear2")},
        "bn": bn("bn"),
        "fc": lin("linear"),
    }


def load_wavlm_ecapa_checkpoint(ckpt_path: str, ssl_cfg: SSLConfig = None):
    """``wavlm_large_finetune.pth`` -> (ecapa tree, wavlm tree, feature_weight,
    WavLM config): ECAPA at the top level, WavLM under
    ``feature_extract.model.`` in the microsoft layout; the config is the
    file's ``ssl_config`` entry where it has one, else WavLM-large
    (``weights_only=False``, as the published file needs)."""
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    if ssl_cfg is None:
        ssl_cfg = ssl_config_from_dict(raw["ssl_config"]) if "ssl_config" in raw else wavlm_large_config()
    state = raw.get("model", raw.get("state_dict", raw))
    sd = {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}
    wavlm = convert_msft_wavlm(sd, ssl_cfg, prefix=WAVLM_PREFIX)
    return convert_ecapa_state_dict(sd), wavlm, to_tensor(sd["feature_weight"]), ssl_cfg


class SpeakerEmbedder:
    """Reference-matching speaker embedder, WavLM-large (or fbank) -> ECAPA.

    ``embed_batch(wavs)`` is the one path (``embed(wav)`` is a call of one
    row): ``extract_spk_emb.py``'s per-utterance flow, each row embedded as
    if alone.  WavLM rows (a row shorter than ``MIN_SAMPLES`` counts as that
    long, zero-padded) are sorted by length and grouped by power-of-two-second
    bucket (``wavlm_groups``); each group is one ``program`` call, its last
    rows padded with empty rows of ``MIN_SAMPLES`` zeros, masked statistics
    keeping each row to its own length.  ``max_rows`` (``MAX_ROWS``; a test
    lowers it) bounds a group (``group_rows``): a bucket up to 32 s is then at
    most 5 graphs.  fbank rows run one
    a program at their hop-truncated exact length.  ``precision``:
    ``highest`` (TF32 off) or ``default`` (TF32 for matmuls and cuDNN)."""

    def __init__(self, ecapa_params: dict = None, feat_type: str = "fbank", wavlm_params: dict = None,
                 feature_weight=None, ssl_cfg: SSLConfig = None, seed: int = 0, device=None,
                 precision: str = "highest", max_rows: Optional[int] = None):
        self.precision = precision  # "highest": TF32 off; "default": TF32 on
        self.device = resolve_device(device)
        self.max_rows = max_rows or MAX_ROWS
        self.feat_type = feat_type
        move = lambda tree: tree_map(lambda t: t.to(self.device), tree)  # noqa: E731
        if feat_type == "wavlm_large":
            self.ssl_cfg = ssl_cfg or wavlm_large_config()
            if wavlm_params is None:
                wavlm_params = init_ssl_params(self.ssl_cfg, torch.Generator().manual_seed(seed + 1))
            self.wavlm_params = move(wavlm_params)
            self.feature_weight = (torch.zeros(self.ssl_cfg.num_layers + 1) if feature_weight is None
                                   else torch.as_tensor(feature_weight, dtype=torch.float32)).to(self.device)
            feat_dim = self.ssl_cfg.d_model
        elif feat_type == "fbank":
            self.frontend = FbankFrontend(80).to(self.device)
            feat_dim = 80
        else:
            raise ValueError(f"unsupported feat_type: {feat_type}")
        if ecapa_params is None:
            ecapa_params = init_ecapa(torch.Generator().manual_seed(seed), feat_dim)
        self.params = move(ecapa_params)
        forward = self._forward_wavlm if feat_type == "wavlm_large" else self._forward_fbank
        self.program = aot.CapturedProgram(forward, f"speaker_{feat_type}")
        self._staging = HostStaging(self.device)

    def _forward_wavlm(self, wav: torch.Tensor, lengths: torch.Tensor) -> dict:
        feats, frame_lengths = wavlm_weighted_features(self.ssl_cfg, self.wavlm_params, self.feature_weight, wav,
                                                       lengths)
        return {"embedding": ecapa_forward(self.params, feats, frame_lengths)}

    def _forward_fbank(self, wav: torch.Tensor) -> dict:
        return {"embedding": ecapa_forward(self.params, self.frontend(wav))}

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, device=None, precision: str = "highest",
                        max_rows: Optional[int] = None) -> "SpeakerEmbedder":
        ecapa, wavlm, fw, ssl_cfg = load_wavlm_ecapa_checkpoint(ckpt_path)
        return cls(ecapa, feat_type="wavlm_large", wavlm_params=wavlm, feature_weight=fw, ssl_cfg=ssl_cfg,
                   device=device, precision=precision, max_rows=max_rows)

    def embed(self, wav: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
        """One utterance's (256,) embedding: ``embed_batch([wav])[0]``."""
        return self.embed_batch([wav], sample_rate)[0]

    @torch.no_grad()
    def embed_batch(self, wavs: Sequence[np.ndarray], sample_rate: int = 16000) -> np.ndarray:
        """1-D float waveforms at 16 kHz -> (N, 256) float32 embeddings in input order.

        One ``speaker.embed`` span a call (``rows``, ``samples``: the input
        samples summed, ``groups``: program calls, ``staging``), tiled by
        ``speaker.embed.host`` (``step``: pack / stage / unpack),
        ``speaker.embed.program`` (``rows``, ``bucket_samples``, ``source``)
        and one ``speaker.embed.fetch`` span."""
        if sample_rate != 16000:
            raise ValueError("resample to 16 kHz on load (audio_io.load_audio)")
        wavs = [np.asarray(w, np.float32).reshape(-1) for w in wavs]
        with annotate("speaker.embed", rows=len(wavs), samples=sum(len(w) for w in wavs),
                      staging=self._staging.kind) as attrs, f32_precision(self.precision):
            return self._embed_batch(wavs, attrs)

    def _groups(self, lengths: np.ndarray) -> List[tuple]:
        """(program samples, program rows, input rows) of each program call."""
        if self.feat_type == "fbank":
            # the reflect-centred STFT's tail frames depend on the true end:
            # each row runs alone at its hop-truncated exact length
            return [(int(n) // FbankFrontend.HOP * FbankFrontend.HOP, 1, np.array([i]))
                    for i, n in enumerate(lengths)]
        return wavlm_groups(lengths, self.max_rows)

    def _embed_batch(self, wavs: List[np.ndarray], attrs: dict) -> np.ndarray:
        emb_dim = self.params["fc"]["w"].shape[0]
        if not wavs:
            attrs["groups"] = 0
            return np.zeros((0, emb_dim), np.float32)
        with annotate("speaker.embed.host", step="pack"):
            lengths = np.array([max(len(w), MIN_SAMPLES) for w in wavs], np.int64)
            groups = self._groups(lengths)
            attrs["groups"] = len(groups)
            wavlm = self.feat_type == "wavlm_large"
            specs = [((r, n), torch.float32) for n, r, _ in groups]
            if wavlm:
                specs += [((r,), torch.int64) for _, r, _ in groups]
            host = self._staging.pack(*specs, ((len(wavs),), torch.int64))
            for (n, _, rows), x in zip(groups, host):
                for i, j in enumerate(rows):
                    w = wavs[j][:n]
                    x[i, : len(w)] = w
                    x[i, len(w):] = 0
                x[len(rows):] = 0
            if wavlm:
                for (_, _, rows), lens in zip(groups, host[len(groups):]):
                    lens[: len(rows)] = lengths[rows]
                    lens[len(rows):] = MIN_SAMPLES  # an empty row: no row is all masked
            host[-1][:] = np.concatenate([rows for _, _, rows in groups])
        with annotate("speaker.embed.host", step="stage"):
            dev = self._staging.upload()
            positions = dev[-1]
            result = torch.empty((len(wavs), emb_dim), device=self.device)
        start = 0
        for g, (n, r, rows) in enumerate(groups):
            args = (dev[g], dev[len(groups) + g]) if wavlm else (dev[g],)
            with annotate("speaker.embed.program", rows=r, bucket_samples=n) as program:
                emb = self.program(*args)["embedding"]
                program["source"] = self.program.source
            with annotate("speaker.embed.host", step="unpack"):
                # before the next program: a replay's outputs are its own until the next replay
                result.index_copy_(0, positions[start:start + len(rows)], emb[: len(rows)])
                start += len(rows)
        with annotate("speaker.embed.fetch"):
            return self._staging.download(result)

    def warm(self, calls: Sequence[Sequence[np.ndarray]], sample_rate: int = 16000) -> None:
        """Run each program signature that ``embed_batch`` meets on ``calls``
        (the rows of each call) once, so that those calls capture nothing."""
        signatures = {}
        for wavs in calls:
            lengths = np.array([max(len(w), MIN_SAMPLES) for w in wavs], np.int64)
            for n, r, rows in self._groups(lengths):
                signatures.setdefault((n, r), wavs[rows[0]])
        for (_, r), w in signatures.items():
            self.embed_batch([w] * r, sample_rate)  # r rows of one bucket: one group of r

    def similarities(self, pairs: Sequence[tuple], sample_rate: int = 16000) -> np.ndarray:
        """SIM of each (a, b) waveform pair: the cosine of their embeddings,
        both rows of ``PAIRS_PER_CALL`` pairs in one ``embed_batch`` call."""
        sims = []
        for rows in pair_calls(pairs):
            emb = self.embed_batch(rows, sample_rate)
            sims += [cosine(emb[2 * i], emb[2 * i + 1]) for i in range(len(emb) // 2)]
        return np.array(sims, np.float64)
