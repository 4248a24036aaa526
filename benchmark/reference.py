"""Plain PyTorch reference of the SimWhisper-Codec round trip, in float32.

It follows the published generator (``config/SimWhisperCodec.yaml`` of
ZhangXinWhut/SimWhisper-Codec; the upstream ``audiocodec/model.py`` and
``audiocodec/nn/``) on a state dict under the upstream keys:

    wav --log-mel--> encoder --frame-stack down--> GroupFSQ --> codes
    codes --FSQ^-1--> frame-stack up --> decoder --> Vocos --> ISTFT --> wav

and the upstream chunk loops (30 s chunks, a stride of 30 s - overlap, only
each chunk's first stride kept; a chunk's width is the batch's last sample
or code frame it reaches, which bounds the Vocos convolutions and the ISTFT
envelope).  Attention is dense, GELU exact, every product float32 with TF32
off.  It imports nothing of the program.

``Products`` carries every weight product and attention product; the
control (``LowerPrecision``) rounds both operands of each product of a
stage to a format below the one the configuration states.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

MAX_AUDIO_SECONDS = 30


# -- products: exact, or with the operands rounded (the control) ------------

def fake_quant(x: torch.Tensor, fmt: str, dim: int = -1) -> torch.Tensor:
    """``x`` rounded to ``fmt`` with one scale per slice along ``dim`` (absmax)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    if fmt == "fp8":
        s = amax / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    levels = {"int8": 127.0, "int4": 7.0}[fmt]
    s = amax / levels
    return torch.clamp(torch.round(x / s), -levels, levels) * s


class Products:
    """Exact float32 products.  ``stage`` names the part of the codec a product belongs to."""

    def fmt(self, stage: str) -> Optional[str]:
        return None

    def linear(self, x, w, b, stage):
        f = self.fmt(stage)
        if f:
            x, w = fake_quant(x, f), fake_quant(w, f)
        return F.linear(x, w, b)

    def conv(self, x, w, b, stage, **kw):
        """x (B, T, C) channels-last -> (B, T', O); torch ``conv1d`` semantics."""
        f = self.fmt(stage)
        xc = x.transpose(1, 2)
        if f:
            xc = fake_quant(xc, f, dim=1)
            w = fake_quant(w.reshape(w.shape[0], -1), f).reshape(w.shape)
        return F.conv1d(xc, w, b, **kw).transpose(1, 2)

    def conv_transpose(self, x, w, b, stage, **kw):
        f = self.fmt(stage)
        xc = x.transpose(1, 2)
        if f:
            xc = fake_quant(xc, f, dim=1)
            wt = w.permute(1, 0, 2)
            w = fake_quant(wt.reshape(wt.shape[0], -1), f).reshape(wt.shape).permute(1, 0, 2)
        return F.conv_transpose1d(xc, w, b, **kw).transpose(1, 2)

    def scores(self, q, k, stage):
        f = self.fmt(stage)
        if f:
            q, k = fake_quant(q, f), fake_quant(k, f)
        return q @ k.transpose(-1, -2)

    def weighted_values(self, p, v, stage):
        f = self.fmt(stage)
        if f:
            p, v = fake_quant(p, f), fake_quant(v, f, dim=-2)
        return p @ v


class LowerPrecision(Products):
    """The control: each stage's products with both operands rounded to ``formats[stage]``."""

    def __init__(self, formats: Dict[str, str]):
        self.formats = dict(formats)

    def fmt(self, stage):
        return self.formats.get(stage)


@contextlib.contextmanager
def float32_exact():
    """TF32 off for float32 matmuls and cuDNN convolutions inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# -- constants ---------------------------------------------------------------

def _hz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    logstep = 27.0 / np.log(6.4)
    return np.where(freq >= 1000.0, 15.0 + np.log(np.maximum(freq, 1e-12) / 1000.0) * logstep, 3.0 * freq / 200.0)


def _mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    return np.where(mels >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (mels - 15.0)), 200.0 * mels / 3.0)


def slaney_filter_bank(n_freq: int, n_mels: int, sr: int) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangular filters, (n_freq, n_mels)."""
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freq)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    slopes = hz[None, :] - fft_freqs[:, None]
    diff = np.diff(hz)
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[:-1], slopes[:, 2:] / diff[1:]))
    return fb * (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[None, :]


def kaiser_sinc_taps(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass (the alias-free resamplers' filter)."""
    half = kernel_size // 2
    a = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    beta = 0.1102 * (a - 8.7) if a > 50.0 else (0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0) if a >= 21.0 else 0.0)
    time = np.arange(-half, half) + 0.5 if kernel_size % 2 == 0 else np.arange(kernel_size) - half
    filt = 2 * cutoff * np.kaiser(kernel_size, beta) * np.sinc(2 * cutoff * time)
    return (filt / filt.sum()).astype(np.float32)


def hann(n: int) -> np.ndarray:
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n, dtype=np.float64) / n))


# -- the codec -----------------------------------------------------------------

class ReferenceCodec:
    """The codec of generator params ``gp`` on ``state`` (upstream keys, float32)."""

    def __init__(self, gp: dict, state: Dict[str, torch.Tensor], products: Optional[Products] = None):
        self.gp = gp
        self.p = state
        self.prod = products or Products()
        dev = next(iter(state.values())).device
        self.device = dev
        fe = gp["feature_extractor"]
        self.sr = fe["sampling_rate"]
        self.n_fft, self.hop = fe["n_fft"], fe["hop_length"]
        self.n_samples, self.n_frames = fe["n_samples"], fe["n_samples"] // fe["hop_length"]
        n_freq = self.n_fft // 2 + 1
        win = hann(self.n_fft)
        phase = 2.0 * np.pi * np.outer(np.arange(self.n_fft), np.arange(n_freq)) / self.n_fft
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        self.dft_cos, self.dft_sin = t(np.cos(phase) * win[:, None]), t(-np.sin(phase) * win[:, None])
        self.mel_fb = t(slaney_filter_bank(n_freq, fe["feature_size"], self.sr))
        f = kaiser_sinc_taps(0.25, 0.3, 12)
        self.up0, self.up1 = t(2.0 * f[11::-2]), t(2.0 * f[10::-2])
        self.down_even, self.down_odd = t(f[0::2]), t(f[1::2])
        q = gp["quantizer"]
        levels = np.array(q["num_levels_per_group"], np.int64)
        self.groups, self.dims = q["num_groups"], len(levels)
        self.levels = t(np.tile(levels, self.groups))
        self.base = torch.from_numpy(np.tile(np.cumprod([1] + list(levels[:-1])), self.groups)).to(dev)
        scale = (levels - 1) / 2.0 * (1.0 - q["eps"])
        offset = np.where(levels % 2 == 0, 0.5, 0.0)
        self.fsq_scale, self.fsq_offset = t(np.tile(scale, self.groups)), t(np.tile(offset, self.groups))
        self.fsq_shift = t(np.tile(np.tan(offset / scale), self.groups))
        self.half = t(np.tile(levels // 2, self.groups))
        v = gp["vocos"]
        self.v_fft, self.v_hop = v["n_fft"], v["hop_size"]
        vf = self.v_fft // 2 + 1
        vwin = hann(self.v_fft)
        ph = 2.0 * np.pi * np.outer(np.arange(vf), np.arange(self.v_fft)) / self.v_fft
        coef = np.full((vf, 1), 2.0)
        coef[0, 0] = 1.0
        if self.v_fft % 2 == 0:
            coef[-1, 0] = 1.0
        self.ibasis_re = t(coef * np.cos(ph) / self.v_fft * vwin[None, :])
        self.ibasis_im = t(-coef * np.sin(ph) / self.v_fft * vwin[None, :])
        self.win_sq = t(vwin * vwin)
        self.hop_samples = gp.get("encoder_downsample_rate", 1280)

    # -- shared pieces ---------------------------------------------------------
    def layer_norm(self, x, key, eps):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{key}.weight"], self.p[f"{key}.bias"], eps)

    def lin(self, x, key, stage, bias=True):
        return self.prod.linear(x, self.p[f"{key}.weight"], self.p.get(f"{key}.bias") if bias else None, stage)

    def conv(self, x, key, stage, **kw):
        return self.prod.conv(x, self.p[f"{key}.weight"], self.p[f"{key}.bias"], stage, **kw)

    def transformer(self, x, lengths, prefix, layers, heads, attn_stage, ffn_stage):
        b, t, d = x.shape
        hd = d // heads
        valid = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
        key_bias = torch.where(valid, 0.0, float("-inf"))[:, None, None, :]
        for i in range(layers):
            key = f"{prefix}.layers.{i}"
            h = self.layer_norm(x, f"{key}.self_attn_layer_norm", 1e-5)
            q = self.lin(h, f"{key}.self_attn.q_proj", attn_stage) * hd ** -0.5
            k = self.lin(h, f"{key}.self_attn.k_proj", attn_stage, bias=False)
            v = self.lin(h, f"{key}.self_attn.v_proj", attn_stage)
            q, k, v = (z.reshape(b, t, heads, hd).transpose(1, 2) for z in (q, k, v))
            w = torch.softmax(self.prod.scores(q, k, attn_stage) + key_bias, dim=-1)
            w = torch.nan_to_num(w)  # a row with no valid key (length 0) attends nothing
            o = self.prod.weighted_values(w, v, attn_stage).transpose(1, 2).reshape(b, t, d)
            x = x + self.lin(o, f"{key}.self_attn.out_proj", attn_stage)
            h = self.layer_norm(x, f"{key}.final_layer_norm", 1e-5)
            h = F.gelu(self.lin(h, f"{key}.fc1", ffn_stage))
            x = x + self.lin(h, f"{key}.fc2", ffn_stage)
        return x

    def snake_alias_free(self, x, key):
        """Alias-free SnakeBeta: 2x up (kaiser sinc), snake, 2x down."""
        b, t, c = x.shape
        pad = lambda z, lo, hi: torch.cat([z[:, :1].expand(-1, lo, -1), z, z[:, -1:].expand(-1, hi, -1)], 1)
        shifts = lambda z, taps, n, off: sum(z[:, off + i: off + i + n] * taps[i] for i in range(taps.shape[0]))
        xp = pad(x, 5, 5)
        up = torch.stack([shifts(xp, self.up0, t, 2), shifts(xp, self.up1, t, 3)], 2).reshape(b, 2 * t, c)
        alpha, beta = torch.exp(self.p[f"{key}.act.alpha"]), torch.exp(self.p[f"{key}.act.beta"])
        up = up + (1.0 / (beta + 1e-9)) * torch.sin(up * alpha) ** 2
        yp = pad(up, 5, 6)
        return shifts(yp[:, 0::2], self.down_even, t, 0) + shifts(yp[:, 1::2], self.down_odd, t, 0)

    def res_units(self, h, prefix, stage):
        for j, dil in enumerate(self.gp[prefix.split(".")[0]].get("dilations", (1, 3, 9))):
            key = f"{prefix}.{j}.block"
            r = self.snake_alias_free(h, f"{key}.0")
            r = self.conv(r, f"{key}.1", stage, dilation=dil, padding=3 * dil)
            r = self.snake_alias_free(r, f"{key}.2")
            h = h + self.conv(r, f"{key}.3", stage)
        return h

    # -- tokenize --------------------------------------------------------------
    def log_mel(self, wav):
        half = self.n_fft // 2
        x = torch.cat([wav[:, 1:half + 1].flip(-1), wav, wav[:, -half - 1:-1].flip(-1)], 1)
        frames = x.unfold(1, self.n_fft, self.hop)[:, :self.n_frames]
        re, im = frames @ self.dft_cos, frames @ self.dft_sin
        mel = torch.log10(torch.clamp((re * re + im * im) @ self.mel_fb, min=1e-10))
        mel = torch.maximum(mel, mel.amax(dim=(1, 2), keepdim=True) - 8.0)
        return (mel + 4.0) / 4.0

    def tokenize(self, wav: torch.Tensor, lengths: torch.Tensor):
        """wav (B, n_samples) f32, lengths (B,) -> (continuous level values (B, T, D)
        before rounding, indices (G, B, T) int64, code lengths (B,))."""
        gp, st = self.gp, "tokenize"
        enc, down = gp["acoustic_encoder"], gp["downsample"]
        mel = self.log_mel(wav)
        mel_len = torch.clamp((lengths + self.hop - 1) // self.hop, max=self.n_frames)
        x = self.conv(mel, "acoustic_encoder.conv1", st, padding=1)
        x = self.conv(x, "acoustic_encoder.conv2", st, stride=enc["stride_size"], padding=1)
        enc_len = mel_len // enc["stride_size"]
        x = self.transformer(x, enc_len, "acoustic_encoder", enc["encoder_layers"], enc["encoder_attention_heads"],
                             st, st)
        x = self.layer_norm(x, "acoustic_encoder.layer_norm", 1e-5)
        t = x.shape[1]
        x = x * (torch.arange(t, device=x.device)[None, :] < enc_len[:, None])[..., None]
        s = down["stack_factor"]
        t_pad = -(-t // s) * s
        x = F.pad(x, (0, 0, 0, t_pad - t))
        b, _, d = x.shape
        x = x.reshape(b, t_pad // s, s, d).transpose(2, 3).reshape(b, t_pad // s, d * s)
        h = self.conv(x, "downsample.in_proj", st)
        h = self.res_units(h, "downsample.res_blocks", st)
        z = self.conv(h, "downsample.to_latent", st)
        z_len = (enc_len + s - 1) // s
        c = self.fsq_scale * torch.tanh(z + self.fsq_shift) - self.fsq_offset
        level = torch.round(c) + self.half  # the level index of each dim, 0 .. L - 1
        idx = (level.to(torch.int64) * self.base).reshape(b, -1, self.groups, self.dims).sum(-1)
        valid = torch.arange(idx.shape[1], device=idx.device)[None, :] < z_len[:, None]
        idx = idx * valid[..., None]
        return c + self.half, idx.permute(2, 0, 1), z_len

    # -- detokenize ------------------------------------------------------------
    def detokenize(self, codes: torch.Tensor, lengths: torch.Tensor, width: torch.Tensor):
        """codes (G, B, Tc), lengths (B,), width (B,): each row's chunk width in
        code frames (its right edge) -> waveform (B, Tc * hop_samples)."""
        gp, st = self.gp, "detokenize"
        up, dec, v = gp["upsample"], gp["acoustic_decoder"], gp["vocos"]
        g, b, tc = codes.shape
        valid = (torch.arange(tc, device=codes.device)[None, :] < lengths[:, None])[..., None]
        idx = codes.permute(1, 2, 0).to(torch.int64).repeat_interleave(self.dims, -1)
        level = torch.remainder(torch.div(idx, self.base, rounding_mode="floor"), self.levels.to(torch.int64))
        zq = (level.to(torch.float32) - self.half) / self.half * valid
        h = self.conv(zq, "upsample.from_latent", st)
        h = self.res_units(h, "upsample.res_blocks", st)
        h = self.conv(h, "upsample.to_stacked", st)
        s = up["stack_factor"]
        x = h.reshape(b, tc, up["out_dim"], s).transpose(2, 3).reshape(b, tc * s, up["out_dim"])
        x_len = lengths * s
        t = x.shape[1]
        x = self.transformer(x, x_len, "acoustic_decoder", dec["decoder_layers"], dec["decoder_attention_heads"],
                             st, "decoder_ffn")
        x = self.layer_norm(x, "acoustic_decoder.layer_norm", 1e-5)
        x = x * (torch.arange(t, device=x.device)[None, :] < x_len[:, None])[..., None]
        p = self.p
        x = self.prod.conv_transpose(x, p["acoustic_decoder.deconv1.weight"], p["acoustic_decoder.deconv1.bias"], st,
                                     stride=dec["stride_size"])
        x = self.prod.conv_transpose(x, p["acoustic_decoder.deconv2.weight"], p["acoustic_decoder.deconv2.bias"], st,
                                     stride=1)
        mel = x[:, : t * dec["stride_size"]]
        frame_valid = width * s * dec["stride_size"]
        return self.vocos(mel, frame_valid)

    def vocos(self, mel, frame_valid):
        st = "detokenize"
        b, t, _ = mel.shape
        fmask = (torch.arange(t, device=mel.device)[None, :] < frame_valid[:, None]).to(torch.float32)
        mask = fmask[..., None]
        x = self.conv(mel * mask, "vocos.backbone.embed", st, padding=3)
        x = self.layer_norm(x, "vocos.backbone.norm", 1e-6)
        for i in range(self.gp["vocos"]["num_layers"]):
            key = f"vocos.backbone.convnext.{i}"
            h = self.prod.conv(x * mask, self.p[f"{key}.dwconv.weight"], self.p[f"{key}.dwconv.bias"], st,
                               padding=3, groups=x.shape[-1])
            h = self.layer_norm(h, f"{key}.norm", 1e-6)
            h = F.gelu(self.lin(h, f"{key}.pwconv1", "vocos_pointwise"))
            x = x + self.p[f"{key}.gamma"] * self.lin(h, f"{key}.pwconv2", "vocos_pointwise")
        x = self.layer_norm(x, "vocos.backbone.final_layer_norm", 1e-6)
        x = self.lin(x, "vocos.head.out", st)
        n_freq = self.v_fft // 2 + 1
        mag = torch.clamp(torch.exp(x[..., :n_freq]), max=1e2)
        re, im = mag * torch.cos(x[..., n_freq:]), mag * torch.sin(x[..., n_freq:])
        frames = (re @ self.ibasis_re + im @ self.ibasis_im) * mask
        r = self.v_fft // self.v_hop
        y = self._overlap_add(frames, r)
        env = self._overlap_add(self.win_sq[None, None, :] * mask, r)
        y = y / torch.where(env > 1e-11, env, torch.ones_like(env))
        pad = (self.v_fft - self.v_hop) // 2
        return y[:, pad: y.shape[1] - pad]

    def _overlap_add(self, frames, r):
        b, t, n = frames.shape
        parts = frames.reshape(b, t, r, n // r)
        out = sum(F.pad(parts[:, :, j], (0, 0, j, r - 1 - j)) for j in range(r))
        return out.reshape(b, (t + r - 1) * (n // r))

    # -- the chunk loops ---------------------------------------------------------
    def encode(self, wavs: Sequence[np.ndarray], overlap_seconds: int = 10, rows: int = 8):
        """Utterances -> per utterance (codes (G, T_i) int64, continuous levels (T_i, D)),
        T_i = len // hop_samples, taken ``rows`` at a time."""
        out = []  # rows of a chunk do not depend on each other
        for i in range(0, len(wavs), rows):
            out += self._encode_rows(wavs[i:i + rows], overlap_seconds)
        return out

    def _encode_rows(self, wavs, overlap_seconds):
        if not len(wavs):
            return []
        chunk = MAX_AUDIO_SECONDS * self.sr
        stride = (MAX_AUDIO_SECONDS - overlap_seconds) * self.sr
        keep = stride // self.hop_samples
        lens = np.array([len(w) for w in wavs], np.int64)
        n_chunks = int(-(-lens.max() // stride))
        codes, levels = [[] for _ in wavs], [[] for _ in wavs]
        for k in range(n_chunks):
            start = k * stride
            batch = np.zeros((len(wavs), chunk), np.float32)
            for i, w in enumerate(wavs):
                seg = np.asarray(w, np.float32)[start:start + chunk]
                batch[i, :len(seg)] = seg
            clen = np.clip(lens - start, 0, chunk)
            c, idx, zl = self.tokenize(torch.from_numpy(batch).to(self.device),
                                       torch.from_numpy(clen).to(self.device))
            valid = torch.clamp(zl, max=keep)
            for i in range(len(wavs)):
                n = int(valid[i])
                ci = torch.zeros(self.groups, keep, dtype=torch.int64, device=self.device)
                ci[:, :n] = idx[:, i, :n]
                li = torch.zeros(keep, c.shape[-1], device=self.device)
                li[:n] = c[i, :n]
                codes[i].append(ci)
                levels[i].append(li)
        return [(torch.cat(codes[i], 1)[:, : lens[i] // self.hop_samples].cpu().numpy(),
                 torch.cat(levels[i], 0)[: lens[i] // self.hop_samples].cpu().numpy()) for i in range(len(wavs))]

    def decode(self, codes_list: Sequence[np.ndarray], batch_frames: Sequence[int], overlap_seconds: int = 10,
               rows: int = 8) -> List[np.ndarray]:
        """Code arrays (G, T_i) -> waveforms (T_i * hop_samples,).  ``batch_frames[i]``
        is the longest code length in the batch that utterance i was decoded in,
        which sets each of its chunks' width."""
        out = []
        for i in range(0, len(codes_list), rows):
            out += self._decode_rows(codes_list[i:i + rows], batch_frames[i:i + rows], overlap_seconds)
        return out

    def _decode_rows(self, codes_list, batch_frames, overlap_seconds):
        if not len(codes_list):
            return []
        chunk = MAX_AUDIO_SECONDS * self.sr // self.hop_samples
        stride = (MAX_AUDIO_SECONDS - overlap_seconds) * self.sr // self.hop_samples
        keep = stride * self.hop_samples
        lens = np.array([c.shape[-1] for c in codes_list], np.int64)
        bmax = np.asarray(batch_frames, np.int64)
        n_chunks = int(-(-lens.max() // stride))
        wavs = [[] for _ in codes_list]
        for k in range(n_chunks):
            start = k * stride
            batch = np.zeros((self.groups, len(codes_list), chunk), np.int64)
            for i, c in enumerate(codes_list):
                seg = np.asarray(c)[:, start:start + chunk]
                batch[:, i, :seg.shape[1]] = seg
            width = np.clip(np.minimum(start + chunk, bmax) - start, 0, chunk)
            clen = np.clip(lens - start, 0, width)
            y = self.detokenize(torch.from_numpy(batch).to(self.device), torch.from_numpy(clen).to(self.device),
                                torch.from_numpy(width).to(self.device))[:, :keep]
            valid = np.clip(clen * self.hop_samples, 0, keep)
            for i in range(len(codes_list)):
                wi = torch.zeros(keep, device=self.device)
                wi[: valid[i]] = y[i, : valid[i]]
                wavs[i].append(wi)
        return [torch.cat(wavs[i])[: lens[i] * self.hop_samples].cpu().numpy() for i in range(len(codes_list))]
