"""The full codec: weights, tokenize/detokenize, and the chunked ``AudioCodec``.

Counterpart of ``simwhisper_codec_tpu/models/codec.py`` (reference
``audiocodec/model.py``):

    wav (B, 480000) --mel--encoder--downsample--FSQ--> codes (8, B, 375)
    codes (8, B, 375) --FSQ^-1--upsample--decoder--Vocos--> wav (B, 480000)

``SimWhisperCodec`` holds the weights under the reference's state-dict keys
(``acoustic_encoder``, ``downsample``, ``upsample``, ``acoustic_decoder``,
``vocos``); its constants are non-persistent buffers.  ``AudioCodec`` keeps
the reference's chunk arithmetic (stride = 30 s - overlap, valid-region
extraction, final ``length // 1280`` trim), pads every batch to
``batch_size`` and passes the chunk width as a virtual right edge, exactly
as the JAX package does.  As the JAX package runs each direction as one
``jax.jit`` program per padded shape, ``AudioCodec`` runs ``tokenize`` and
``detokenize`` as ``utils/aot.py`` programs: on the card each signature is
captured once as a CUDA graph of the hand kernels and replayed after;
``trace_counts`` counts the signatures.  The chunk width reaches
``detokenize`` as a device scalar, so one detokenize graph serves every
last-chunk width.

Modes: ``parity`` (f32, dense attention, exact GELU), ``fast`` (bf16, the
pflash attention kernel and the fused LN-FFN kernel in every transformer FFN
and Vocos chain), ``fast-int8`` (as ``fast`` for tokenize; the decoder FFNs
and Vocos chains run the fused int8 kernel, so codes equal ``fast`` codes)
and ``fast-int8-full`` (int8 FFNs on both sides).  ``attn_impl`` picks the
attention core (``flash``: kernel B5) and, in ``fast``, ``vocos_impl`` the
Vocos block (``fused-dw``: kernel B4).  In ``parity`` TF32 is off for every
float32 matmul and convolution by default, the counterpart of
``Precision.HIGHEST``; the fast modes run at ``default`` precision (TF32 on,
the counterpart of ``Precision.DEFAULT``) whatever the caller asks, as the
JAX package's fast modes do.

The ``wire`` is the host <-> device waveform format: ``float32``, or
``pcm16``, which ships int16 (dequantised on the device) and brings decoded
waveforms home as int16 quantised on the device by the ``save_audio``
formula: half the bytes each way.  ``data_parallel`` splits each batch over
the ranks of a ``torch.distributed`` group and gathers the result.

``training_forward`` is the trainer's forward (``train/``): dense f32, the
FSQ round straight-through, mel features in, no virtual edge.

``tokenize``, ``detokenize`` and ``training_forward`` also run on a rank's
shard of the model (``parallel.mesh.shard_model``, tensor parallelism):
activations are replicated over the model group, each sharded layer
reduces its partial sums, and the caller splits the batch over the data
axis (``parallel.mesh.batch_rows`` / ``gather_rows``).
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from simwhisper_codec_tpu_torch.config import CodecConfig, load_config
from simwhisper_codec_tpu_torch.models import sampling, transformer, vocos
from simwhisper_codec_tpu_torch.ops import _cuda, fsq, mel
from simwhisper_codec_tpu_torch.ops.quant import quantize_stacked_convnext, quantize_stacked_ffn
from simwhisper_codec_tpu_torch.ops.snake import AliasFreeConstants
from simwhisper_codec_tpu_torch.parallel import dist as dist_ctx
from simwhisper_codec_tpu_torch.utils import aot
from simwhisper_codec_tpu_torch.utils.audio_io import to_pcm16

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class CodecConstants(nn.Module):
    """Mel bases, kaiser taps and FSQ levels (non-persistent buffers)."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        self.mel = mel.MelConstants(cfg.feature_extractor)
        self.af = AliasFreeConstants()
        self.fsq = fsq.FSQConstants(cfg.quantizer)


class SimWhisperCodec(nn.Module):
    """All weights of the codec, named as in the reference state dict."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        self.cfg = cfg
        self.acoustic_encoder = transformer.Encoder(cfg.acoustic_encoder)
        self.downsample = sampling.FrameStackDown(cfg.downsample)
        self.upsample = sampling.FrameStackUp(cfg.upsample)
        self.acoustic_decoder = transformer.Decoder(cfg.acoustic_decoder)
        self.vocos = vocos.Vocos(cfg.vocos)
        self.consts = CodecConstants(cfg)


def init_params(cfg: CodecConfig, generator: Optional[torch.Generator] = None) -> SimWhisperCodec:
    """Randomly initialised codec on the CPU, drawn from ``generator``
    (default: ``torch.Generator().manual_seed(0)``)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    model = SimWhisperCodec(cfg)
    transformer.init_transformer(model.acoustic_encoder, gen)
    sampling.init_sampler(model.downsample, gen)
    sampling.init_sampler(model.upsample, gen)
    transformer.init_transformer(model.acoustic_decoder, gen)
    vocos.init_vocos(model.vocos, gen)
    return model


def tokenize(model: SimWhisperCodec, wav: torch.Tensor, sample_lengths: torch.Tensor,
             compute_dtype: str = "float32", attn_impl: str = "dense", ffn_impl: str = "dense"
             ) -> Dict[str, torch.Tensor]:
    """wav (B, chunk_samples) + lengths -> {"zq": (B, Tc, D), "codes": (G, B, Tc) int32,
    "codes_lengths": (B,)}."""
    c = model.consts
    feats = mel.log_mel(c.mel, wav)  # f32 in every mode
    mel_lens = mel.mel_lengths(sample_lengths, c.mel.hop, c.mel.n_frames)
    feats = feats.to(_DTYPES[compute_dtype])
    enc, enc_len = model.acoustic_encoder(feats, mel_lens, attn_impl, ffn_impl)
    z, z_len = model.downsample(c.af, enc, enc_len)
    zq, codes = fsq.group_fsq_forward(c.fsq, z.to(torch.float32), z_len)
    return {"zq": zq, "codes": codes, "codes_lengths": z_len}


def detokenize(model: SimWhisperCodec, codes: torch.Tensor, code_lengths: torch.Tensor,
               code_frame_valid=None, compute_dtype: str = "float32",
               attn_impl: str = "dense", ffn_impl: str = "dense", vocos_impl=None
               ) -> Dict[str, torch.Tensor]:
    """codes (G, B, Tc) -> {"y": (B, Tc * 1280), "output_length": (B,)}.

    ``code_frame_valid``: the chunk width the reference would have processed
    (<= Tc), an int or a 0-d integer tensor on the codes' device (read there,
    as the JAX package traces it); drives the virtual right edge of the
    Vocos convs and the ISTFT.
    """
    cfg, c = model.cfg, model.consts
    zq = fsq.group_fsq_decode(c.fsq, codes, code_lengths).to(_DTYPES[compute_dtype])
    up, up_len = model.upsample(c.af, zq, code_lengths)
    dec, dec_len = model.acoustic_decoder(up, up_len, attn_impl, ffn_impl)
    frame_valid = None
    if code_frame_valid is not None:
        frame_valid = code_frame_valid * cfg.upsample.stack_factor * cfg.acoustic_decoder.stride_size
    audio, out_len = model.vocos(dec, dec_len, frame_valid, vocos_impl)
    return {"y": audio, "output_length": out_len}


def training_forward(model: SimWhisperCodec, mel_features: torch.Tensor, mel_lens: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """Training forward (reference model.py:112-165): mel (B, T_mel, n_mels)
    -> encoder -> frame-stack down -> FSQ (straight-through round) -> up ->
    decoder -> Vocos, all dense f32; run it under ``f32_precision("highest")``.
    Returns {"reconstructed_audio": (B, T_mel * hop), "audio_lengths": (B,),
    "codes": (G, B, T_code)}.  The encoder is frozen by the optimizer (it is
    left out of it), not here."""
    c = model.consts
    enc, enc_len = model.acoustic_encoder(mel_features, mel_lens)
    z, z_len = model.downsample(c.af, enc, enc_len)
    zq, codes = fsq.group_fsq_forward(c.fsq, z, z_len, ste=True)
    up, up_len = model.upsample(c.af, zq, z_len)
    dec, dec_len = model.acoustic_decoder(up, up_len)
    audio, out_len = model.vocos(dec, dec_len)
    return {"reconstructed_audio": audio, "audio_lengths": out_len, "codes": codes}


def fast_mode_settings() -> dict:
    """The fast serving configuration, in one place: bf16 compute, the pflash
    attention kernel, the fused LN-FFN kernel for the transformer FFNs and the
    Vocos chains, and the int8 kernel where a mode asks for int8."""
    return {
        "compute_dtype": "bfloat16",
        "attn_impl": "pflash",
        "ffn_impl": "fused",
        "vocos_impl": "fused",
        "int8_ffn_impl": "int8-fused",
        "int8_vocos_impl": "int8",
    }


MODES = ("parity", "fast", "fast-int8", "fast-int8-full")
FAST_VOCOS_IMPLS = ("fused", "fused-dw")
WIRES = ("float32", "pcm16")
PRECISIONS = ("highest", "default")


def mode_programs(mode: str, attn_impl: Optional[str] = None, vocos_impl: Optional[str] = None) -> tuple:
    """(tokenize kwargs, detokenize kwargs) of a serving mode.

    ``attn_impl``: ``dense``, ``pflash`` or ``flash`` (default: ``dense`` in
    parity, ``pflash`` otherwise), or the JAX package's spellings
    ``pflash:<block>`` (B1), ``packed[:bf16]`` and ``chunked[:<block_q>[:bf16]]``
    (``transformer.parse_attn_impl``).  ``vocos_impl``: ``fused`` (default) or
    ``fused-dw`` in ``fast``; parity runs the exact-GELU chain and takes
    None; in the int8 modes the int8 chain runs whatever is given, as the
    JAX package's ``int8_vocos`` does.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if attn_impl is not None:
        transformer.parse_attn_impl(attn_impl)  # raises ValueError on an unknown spelling
    if vocos_impl is not None and (vocos_impl not in FAST_VOCOS_IMPLS or mode == "parity"):
        raise ValueError(f"vocos_impl must be None or, outside parity mode, one of {FAST_VOCOS_IMPLS}; "
                         f"got {vocos_impl!r} in mode {mode!r}")
    if mode == "parity":
        kw = {"compute_dtype": "float32", "attn_impl": attn_impl or "dense", "ffn_impl": "dense"}
        return dict(kw), dict(kw, vocos_impl=None)
    fk = fast_mode_settings()
    base = {"compute_dtype": fk["compute_dtype"], "attn_impl": attn_impl or fk["attn_impl"]}
    int8 = mode in ("fast-int8", "fast-int8-full")
    tok = dict(base, ffn_impl=fk["int8_ffn_impl"] if mode == "fast-int8-full" else fk["ffn_impl"])
    detok = dict(base, ffn_impl=fk["int8_ffn_impl"] if int8 else fk["ffn_impl"],
                 vocos_impl=fk["int8_vocos_impl"] if int8 else vocos_impl or fk["vocos_impl"])
    return tok, detok


def quantize_for_mode(model: "SimWhisperCodec", mode: str) -> None:
    """Add the int8 weights that ``mode`` runs to ``model`` (idempotent):
    the decoder stack and the Vocos in ``fast-int8``, the encoder stack too
    in ``fast-int8-full``; nothing in the other modes."""
    if mode in ("fast-int8", "fast-int8-full"):
        quantize_stacked_ffn(model.acoustic_decoder.layers)
        if mode == "fast-int8-full":
            quantize_stacked_ffn(model.acoustic_encoder.layers)
        quantize_stacked_convnext(model.vocos.backbone.convnext)


def serving_program(model: "SimWhisperCodec", mode: str, direction: str, pool: aot.GraphPool,
                    attn_impl: Optional[str] = None, vocos_impl: Optional[str] = None,
                    capture: bool = True) -> aot.CapturedProgram:
    """``mode``'s ``tokenize`` or ``detokenize`` (``direction``) on ``model``
    as a ``CapturedProgram`` on ``pool``: the program ``AudioCodec`` serves
    and the bench times.  The int8 modes need ``quantize_for_mode`` first."""
    tok_kw, detok_kw = mode_programs(mode, attn_impl, vocos_impl)
    fn, kw = {"tokenize": (tokenize, tok_kw), "detokenize": (detokenize, detok_kw)}[direction]
    return aot.CapturedProgram(functools.partial(fn, model, **kw), direction, pool, capture=capture)


@contextlib.contextmanager
def f32_precision(precision: str = "highest"):
    """TF32 for float32 matmuls and cuDNN convolutions inside the block:
    off for ``highest`` (the counterpart of ``Precision.HIGHEST``), on for
    ``default``.  cuDNN's ``deterministic`` and ``benchmark`` flags keep
    their values; every flag is restored after the block."""
    allow = precision == "default"
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic, allow_tf32=allow):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises if CUDA is asked for and absent."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


class AudioCodec:
    """User-facing codec with the reference's API shape (chunked encode/decode)."""

    def __init__(self, cfg: CodecConfig, model: SimWhisperCodec, batch_size: int = 8,
                 mode: str = "parity", device=None, attn_impl: Optional[str] = None,
                 vocos_impl: Optional[str] = None, wire: str = "float32", precision: str = "highest",
                 data_parallel: bool = False, aot_dir: Optional[str] = None):
        """``model`` is moved to ``device`` (default ``cuda``); int8 modes add
        the quantised weights to it as non-persistent buffers.

        ``attn_impl`` and ``vocos_impl``: see ``mode_programs``; in parity
        mode ``pflash`` and ``flash`` run the f32 attention kernels.
        ``wire``: ``float32`` or ``pcm16`` (see the module docstring).
        ``precision``: ``highest`` (no TF32) or ``default`` (TF32 for the
        float32 matmuls and convolutions); parity mode takes the caller's,
        the fast modes always run ``default``, as the JAX package's do.
        ``data_parallel``: in an initialised ``torch.distributed`` group, each
        call pads its batch to a multiple of the world size, runs this rank's
        rows and all-gathers the result, so every rank returns the whole
        batch, as one process would (the JAX package's ``data`` mesh axis).
        ``aot_dir`` (or ``$SIMWHISPER_AOT_DIR``): where the kernel libraries
        are built and loaded on the card (``ops._cuda.use_aot_dir``).

        ``tokenize`` and ``detokenize`` run as ``utils.aot.CapturedProgram``s
        sharing one graph memory pool; a model sharded by
        ``parallel.mesh.shard_model`` (layers holding a ``model_group``)
        runs them eagerly, since its collectives cannot be captured."""
        if wire not in WIRES:
            raise ValueError(f"wire must be one of {WIRES}, got {wire!r}")
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.cfg = cfg
        self.mode = mode
        self.wire = wire
        self.precision = precision if mode == "parity" else "default"
        self.device = resolve_device(device)
        # transfer granularity of the int16 encode wire: the host pads only to
        # the next bucket, the device pads to the chunk
        self._wire_bucket = max(1, cfg.chunk_samples // 10)
        self.model = model.to(self.device).eval()
        quantize_for_mode(self.model, mode)
        self.batch_size = batch_size
        self._dist = dist_ctx.current() if data_parallel else dist_ctx.DistContext()
        self.input_sample_rate = cfg.input_sample_rate
        self.output_sample_rate = cfg.output_sample_rate
        self.max_audio_seconds = cfg.max_audio_seconds
        self.encoder_downsample_rate = cfg.encoder_downsample_rate
        self.decoder_upsample_rate = cfg.decoder_upsample_rate
        self.num_groups = cfg.quantizer.num_groups
        self.aot_dir = aot_dir
        if aot_dir is not None and self.device.type == "cuda":
            _cuda.use_aot_dir(aot_dir)
        sharded = any(getattr(m, "model_group", None) is not None for m in self.model.modules())
        if sharded:
            logger.info("the model is sharded over a model group: tokenize and detokenize run eagerly")
        pool = aot.GraphPool()
        self._tokenize, self._detokenize = (
            serving_program(self.model, mode, direction, pool, attn_impl, vocos_impl, capture=not sharded)
            for direction in ("tokenize", "detokenize"))

    @property
    def trace_counts(self) -> Dict[str, int]:
        """Programs per direction: input signatures seen, each captured once
        on the card (the JAX ``AudioCodec.trace_counts``)."""
        return {"tokenize": self._tokenize.count, "detokenize": self._detokenize.count}

    @property
    def dist_context(self) -> dist_ctx.DistContext:
        """The ranks this codec splits each batch over (a world of one unless ``data_parallel``)."""
        return self._dist

    # -- single-chunk paths --------------------------------------------------

    def _pad_batch_dim(self, b: int) -> int:
        """At least ``batch_size`` rows, rounded up to a multiple of the world size."""
        world = self._dist.world_size
        return -(-max(b, self.batch_size) // world) * world

    @torch.no_grad()
    def inference_tokenize(self, wav: np.ndarray, input_lengths: np.ndarray) -> dict:
        """wav (B, T <= chunk_samples) host array -> codes (device tensors).

        int16 input is PCM16: it ships as int16, padded on the host only to
        the next wire bucket, and is dequantised (x / 32768, exact in f32)
        and padded to the chunk on the device.  On the ``pcm16`` wire float
        input is first quantised to int16 on the host."""
        wav = np.asarray(wav)
        if self.wire == "pcm16" and wav.dtype != np.int16:
            wav = to_pcm16(wav)
        if wav.dtype != np.int16:
            wav = wav.astype(np.float32)
        b, t = wav.shape
        n = self.cfg.chunk_samples
        target = n
        if wav.dtype == np.int16:
            target = min(n, -(-min(t, n) // self._wire_bucket) * self._wire_bucket)
        wav = np.pad(wav, ((0, 0), (0, target - t))) if t < target else wav[:, :target]
        input_lengths = np.asarray(input_lengths)
        bp = self._pad_batch_dim(b)
        if bp != b:
            wav = np.pad(wav, ((0, bp - b), (0, 0)))
            input_lengths = np.pad(input_lengths, (0, bp - b))
        rows = self._dist.rows(bp)
        wav_t = torch.from_numpy(np.ascontiguousarray(wav[rows])).to(self.device)
        if wav_t.dtype == torch.int16:
            wav_t = F.pad(wav_t.to(torch.float32) * (1.0 / 32768.0), (0, n - target))
        len_t = torch.from_numpy(input_lengths[rows].astype(np.int64)).to(self.device)
        with f32_precision(self.precision):
            out = self._tokenize(wav_t, len_t)
        out = {k: dist_ctx.all_gather_rows(self._dist, v, 1 if k == "codes" else 0) for k, v in out.items()}
        if bp != b:  # drop batch-padding rows
            out = {"zq": out["zq"][:b], "codes": out["codes"][:, :b], "codes_lengths": out["codes_lengths"][:b]}
        return out

    @torch.no_grad()
    def inference_detokenize(self, codes: np.ndarray, codes_lengths: np.ndarray,
                             chunk_width: Optional[int] = None, out_samples: Optional[int] = None) -> dict:
        """codes (G, B, T <= code_frames) -> waveform (device tensors).

        On the ``pcm16`` wire the waveform is quantised to int16 on the
        device and cut there to its first ``out_samples`` samples."""
        g, b, t = codes.shape
        n = self.cfg.code_frames
        width = chunk_width if chunk_width is not None else t
        if t < n:
            codes = np.pad(codes, ((0, 0), (0, 0), (0, n - t)))
        codes_lengths = np.asarray(codes_lengths)
        bp = self._pad_batch_dim(b)
        if bp != b:
            codes = np.pad(codes, ((0, 0), (0, bp - b), (0, 0)))
            codes_lengths = np.pad(codes_lengths, (0, bp - b))
        rows = self._dist.rows(bp)
        codes_t = torch.from_numpy(np.ascontiguousarray(codes[:, rows], np.int32)).to(self.device)
        len_t = torch.from_numpy(codes_lengths[rows].astype(np.int64)).to(self.device)
        width_t = torch.full((), width, dtype=torch.int32, device=self.device)  # a fill, not a host copy
        with f32_precision(self.precision):
            out = self._detokenize(codes_t, len_t, width_t)
        out = {k: dist_ctx.all_gather_rows(self._dist, v) for k, v in out.items()}
        if self.wire == "pcm16":
            y = torch.clamp(out["y"].to(torch.float32) * 32768.0, -32768.0, 32767.0).to(torch.int16)
            out = dict(out, y=y[:, :out_samples] if out_samples is not None else y)
        if bp != b:
            out = {"y": out["y"][:b], "output_length": out["output_length"][:b]}
        return out

    # -- chunked streaming (reference model.py:244-373) ------------------------

    def encode(self, wav_list: List[np.ndarray], overlap_seconds: int = 10) -> dict:
        """List of 1-D waveforms (float, or int16 PCM read as int16 / 32768)
        -> {"codes_list": [(G, T_i) int32]}.  The batch ships as int16 on the
        ``pcm16`` wire or when every item is int16; otherwise as float32."""
        duration_seconds = self.max_audio_seconds - overlap_seconds
        chunk_size = self.max_audio_seconds * self.input_sample_rate
        duration_size = duration_seconds * self.input_sample_rate
        code_duration_length = duration_size // self.encoder_downsample_rate

        batch_size = len(wav_list)
        max_length = max(len(w) for w in wav_list)
        input_lengths = np.array([len(w) for w in wav_list], np.int64)
        wire16 = self.wire == "pcm16" or all(np.asarray(w).dtype == np.int16 for w in wav_list)
        wav_tensor = np.zeros((batch_size, max_length), np.int16 if wire16 else np.float32)
        for i, w in enumerate(wav_list):
            w = np.asarray(w).reshape(-1)
            if wire16 and w.dtype != np.int16:
                w = to_pcm16(w)
            elif not wire16 and w.dtype == np.int16:
                w = w.astype(np.float32) / 32768.0
            wav_tensor[i, : len(w)] = w

        max_chunks = (max_length + duration_size - 1) // duration_size
        chunks_out = []
        for chunk_idx in range(max_chunks):
            start = chunk_idx * duration_size
            end = min(start + chunk_size, max_length)
            chunk_lengths = np.clip(input_lengths - start, 0, end - start)
            if chunk_lengths.max() == 0:
                continue
            result = self.inference_tokenize(wav_tensor[:, start:end], chunk_lengths)
            codes = result["codes"].cpu().numpy()
            code_lens = result["codes_lengths"].cpu().numpy()
            valid = np.clip(code_lens, 0, code_duration_length)
            out = codes[:, :, :code_duration_length].copy()
            t_idx = np.arange(code_duration_length)
            out *= (t_idx[None, None, :] < valid[None, :, None]).astype(out.dtype)
            chunks_out.append(out)

        if chunks_out:
            codes_tensor = np.concatenate(chunks_out, axis=-1)
            codes_list = [codes_tensor[:, i, : input_lengths[i] // self.encoder_downsample_rate]
                          for i in range(batch_size)]
        else:
            codes_list = [np.zeros((self.num_groups, 0), np.int32) for _ in range(batch_size)]
        return {"codes_list": codes_list}

    def decode(self, codes_list: List[np.ndarray], overlap_seconds: int = 10) -> dict:
        """List of (G, T_i) code arrays -> {"syn_wav_list": [(T_i * 1280,)]}: f32
        waveforms, or int16 PCM on the ``pcm16`` wire."""
        duration_seconds = self.max_audio_seconds - overlap_seconds
        chunk_code_length = self.max_audio_seconds * self.input_sample_rate // self.encoder_downsample_rate
        duration_code_length = duration_seconds * self.input_sample_rate // self.encoder_downsample_rate
        duration_wav_length = duration_code_length * self.decoder_upsample_rate

        batch_size = len(codes_list)
        max_code_length = max(c.shape[-1] for c in codes_list)
        code_lengths = np.array([c.shape[-1] for c in codes_list], np.int64)
        codes_tensor = np.zeros((self.num_groups, batch_size, max_code_length), np.int32)
        for i, c in enumerate(codes_list):
            codes_tensor[:, i, : c.shape[-1]] = np.asarray(c)

        max_chunks = (max_code_length + duration_code_length - 1) // duration_code_length
        wav_chunks = []
        for chunk_idx in range(max_chunks):
            start = chunk_idx * duration_code_length
            end = min(start + chunk_code_length, max_code_length)
            chunk_code_lengths = np.clip(code_lengths - start, 0, end - start)
            if chunk_code_lengths.max() == 0:
                continue
            # only the first stride's worth of each chunk is kept
            result = self.inference_detokenize(codes_tensor[:, :, start:end], chunk_code_lengths,
                                               chunk_width=end - start, out_samples=duration_wav_length)
            y = result["y"][:, :duration_wav_length]
            wav = (y if y.dtype == torch.int16 else y.to(torch.float32)).cpu().numpy()
            wav_lens = result["output_length"].cpu().numpy()
            valid = np.clip(wav_lens, 0, duration_wav_length)
            t_idx = np.arange(wav.shape[1])
            wav_chunks.append(wav * (t_idx[None, :] < valid[:, None]).astype(wav.dtype))

        if wav_chunks:
            wav_tensor = np.concatenate(wav_chunks, axis=-1)
            syn_wav_list = [wav_tensor[i, : code_lengths[i] * self.decoder_upsample_rate]
                            for i in range(batch_size)]
        else:
            out_dtype = np.int16 if self.wire == "pcm16" else np.float32
            syn_wav_list = [np.zeros((0,), out_dtype) for _ in range(batch_size)]
        return {"syn_wav_list": syn_wav_list}

    @classmethod
    def load_from_checkpoint(cls, config_path: str, ckpt_path: str, **kwargs) -> "AudioCodec":
        """Build from a YAML config and a reference ``.pt`` state dict.  An
        Orbax params directory (the JAX package's native format) is refused:
        ``tools/orbax_to_pt.py`` converts it to a ``.pt``."""
        from simwhisper_codec_tpu_torch.utils.checkpoint import load_reference_checkpoint

        if os.path.isdir(ckpt_path):
            raise ValueError(f"{ckpt_path} is a directory (an Orbax checkpoint?); this loader reads a reference "
                             "'.pt' state dict: convert it with python tools/orbax_to_pt.py --config "
                             f"{config_path} --orbax_dir {ckpt_path} --out <file>.pt")
        logger.info("Loading model from %s and %s", config_path, ckpt_path)
        cfg = load_config(config_path)
        model = SimWhisperCodec(cfg)
        load_reference_checkpoint(model, ckpt_path)
        return cls(cfg, model, **kwargs)
