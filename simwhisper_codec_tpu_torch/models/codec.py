"""The full codec: weights, tokenize/detokenize, and the chunked ``AudioCodec``.

Counterpart of ``simwhisper_codec_tpu/models/codec.py`` (reference
``audiocodec/model.py``):

    wav (B, 480000) --mel--encoder--downsample--FSQ--> codes (8, B, 375)
    codes (8, B, 375) --FSQ^-1--upsample--decoder--Vocos--> wav (B, 480000)

``SimWhisperCodec`` holds the weights under the reference's state-dict keys
(``acoustic_encoder``, ``downsample``, ``upsample``, ``acoustic_decoder``,
``vocos``); its constants are non-persistent buffers.  ``AudioCodec`` keeps
the reference's chunk arithmetic (``ChunkGrid``: stride = 30 s - overlap,
each chunk's first stride kept, final ``length // 1280`` trim), pads every
batch to ``batch_size`` and passes the chunk width as a virtual right edge,
exactly as the JAX package does.  As that runs each direction as one
``jax.jit`` program per padded shape, ``AudioCodec`` runs ``tokenize`` and
``detokenize`` as ``utils/aot.py`` programs: on the card each signature is
captured once as a CUDA graph of the hand kernels and replayed after;
``trace_counts`` counts the signatures.  The chunk width reaches
``detokenize`` as a device scalar, so one graph serves every last width.

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
import dataclasses
import functools
import logging
import os
from typing import Dict, List, Optional, Sequence

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
from simwhisper_codec_tpu_torch.utils.profiling import annotate
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
def f32_precision(precision: str = "highest", deterministic: Optional[bool] = None):
    """TF32 for float32 matmuls and cuDNN convolutions inside the block:
    off for ``highest`` (the counterpart of ``Precision.HIGHEST``), on for
    ``default``.  ``deterministic``: cuDNN's deterministic flag inside the
    block (None keeps its value); the ``benchmark`` flag keeps its value;
    every flag is restored after the block."""
    allow = precision == "default"
    cudnn = torch.backends.cudnn
    det = cudnn.deterministic if deterministic is None else deterministic
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        with cudnn.flags(enabled=True, benchmark=cudnn.benchmark, deterministic=det, allow_tf32=allow):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def mode_deterministic(mode: str) -> Optional[bool]:
    """``f32_precision``'s ``deterministic`` for ``mode``'s programs: True in
    parity, whose waveforms must be the same from run to run (the decoder's
    f32 transposed convolutions are not, otherwise), as the JAX package's
    on XLA are; None (the caller's flag) in the fast modes."""
    return True if mode == "parity" else None


def model_groups_capturable(model: nn.Module) -> bool:
    """Whether ``model``'s programs can be captured: no layer holds a model
    group (``parallel.mesh.shard_model``), or every group is NCCL's, whose
    collectives a CUDA graph records; gloo's run on the host and cannot be."""
    import torch.distributed as dist

    groups = {id(g): g for m in model.modules() for g in [getattr(m, "model_group", None)] if g is not None}
    return all(isinstance(g, dist.ProcessGroup) and dist.get_backend(g) == "nccl" for g in groups.values())


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises if CUDA is asked for and absent."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


_STAGE_ALIGN = 64  # bytes: each array of a staging buffer starts on this boundary


class HostStaging:
    """The host memory a call's batch passes through on its way to the device and back.

    ``pack`` hands out uninitialised host arrays carved from one buffer, which
    is reused from call to call and grows to the largest batch seen;
    ``upload`` copies the packed bytes to the device in one copy; ``download``
    copies a device result into fresh host memory, waits for it, and returns
    it as an array that no later call overwrites.  On CUDA the memory is
    page-locked and both copies are asynchronous (``kind`` ``"pinned"``);
    elsewhere it is pageable and the copies are plain ones."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self.kind = "pinned" if self.pinned else "pageable"
        self._host = torch.empty(0, dtype=torch.uint8)
        self._layout: list = []
        self._size = 0
        self._read = None  # a CUDA event recorded after the last upload from ``_host``

    def pack(self, *specs) -> List[np.ndarray]:
        """One uninitialised host array for each ``(shape, torch dtype)`` of ``specs``."""
        self._layout, size = [], 0
        for shape, dtype in specs:
            nbytes = int(np.prod(shape)) * dtype.itemsize
            self._layout.append((size, nbytes, tuple(shape), dtype))
            size += -(-nbytes // _STAGE_ALIGN) * _STAGE_ALIGN
        if self._read is not None:
            self._read.synchronize()  # the last upload has read the buffer
        if self._host.numel() < size:
            self._host = torch.empty(size, dtype=torch.uint8, pin_memory=self.pinned)
        self._size = size
        return [self._host[o:o + n].view(dtype).view(shape).numpy() for o, n, shape, dtype in self._layout]

    def upload(self) -> List[torch.Tensor]:
        """The arrays of the last ``pack`` on the device, after one copy of the buffer."""
        dev = self._host[:self._size].to(self.device, non_blocking=self.pinned, copy=True)
        if self.pinned:
            self._read = torch.cuda.Event()
            self._read.record(torch.cuda.current_stream(self.device))
        return [dev[o:o + n].view(dtype).view(shape) for o, n, shape, dtype in self._layout]

    def download(self, t: torch.Tensor) -> np.ndarray:
        """``t`` in fresh host memory, after one wait for the device."""
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.pinned)
        host.copy_(t, non_blocking=self.pinned)
        if self.pinned:
            torch.cuda.current_stream(self.device).synchronize()
        return host.numpy()


@dataclasses.dataclass(frozen=True)
class ChunkGrid:
    """Where ``encode``, ``decode`` and the streaming sessions cut a batch:
    chunks of ``chunk`` samples every ``stride`` (30 s - overlap), each
    keeping its first ``kept`` code frames, written end to end; decode's
    chunks are ``chunk_codes`` frames every ``kept``.  A row's length applies
    once, in the trim to ``length // hop`` codes (``codes * up`` samples)
    after the download: ``tokenize`` gives ceil(ceil(n / 160) // 2 / 4) >=
    n // 1280 code frames and ``detokenize`` ``codes * up`` samples, which
    cover every kept position the trim keeps, except where the stride is not
    whole code frames (odd seconds): each chunk then loses half a frame and
    the trim keeps columns past a later chunk's ``codes_lengths``, which
    encode zeroes for those grids (``masked``), as the reference does."""

    chunk: int  # samples a chunk
    stride: int  # samples from one chunk's start to the next's
    chunk_codes: int  # code frames a chunk
    kept: int  # code frames each chunk keeps (decode's stride)
    hop: int  # input samples a code frame
    up: int  # output samples a code frame

    @classmethod
    def of(cls, cfg: CodecConfig, overlap_seconds: int) -> "ChunkGrid":
        sr, hop = cfg.input_sample_rate, cfg.encoder_downsample_rate
        chunk, stride = cfg.max_audio_seconds * sr, (cfg.max_audio_seconds - overlap_seconds) * sr
        return cls(chunk, stride, chunk // hop, stride // hop, hop, cfg.decoder_upsample_rate)

    @property
    def masked(self) -> bool:
        return self.stride % self.hop != 0

    def chunks(self, lengths: np.ndarray, codes: bool = False) -> tuple:
        """Chunk starts and ends over the longest of ``lengths`` (samples, or
        code frames for ``codes``), and each row's length in each chunk (K, B)."""
        size, step = (self.chunk_codes, self.kept) if codes else (self.chunk, self.stride)
        longest = int(lengths.max())
        starts = np.arange(0, longest, step)  # every chunk holds some of the longest row
        ends = np.minimum(starts + size, longest)
        return starts, ends, np.clip(lengths[None, :] - starts[:, None], 0, (ends - starts)[:, None])


def wire_waveform(y: torch.Tensor, wire: str, samples: Optional[int] = None) -> torch.Tensor:
    """Decoded waveforms (B, T), cut to their first ``samples``, in the
    ``wire``'s format: float32, or on ``pcm16`` int16 by ``to_pcm16``'s formula."""
    y = y[:, :samples]
    if wire == "pcm16":
        return torch.clamp(y.to(torch.float32) * 32768.0, -32768.0, 32767.0).to(torch.int16)
    return y.to(torch.float32)


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
        sharing one graph memory pool, in parity mode with cuDNN's
        deterministic algorithms (``mode_deterministic``); a model sharded
        by ``parallel.mesh.shard_model`` (layers holding a ``model_group``)
        is captured when its groups are NCCL's and runs them eagerly over
        gloo, whose collectives cannot be captured."""
        if wire not in WIRES:
            raise ValueError(f"wire must be one of {WIRES}, got {wire!r}")
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.cfg = cfg
        self.mode = mode
        self.wire = wire
        self.precision = precision if mode == "parity" else "default"
        self.deterministic = mode_deterministic(mode)
        self.device = resolve_device(device)
        # encode's waveforms and decode's codes each pass through host memory of their own
        self._wav_staging, self._code_staging = HostStaging(self.device), HostStaging(self.device)
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
        capture = model_groups_capturable(self.model)
        if not capture:
            logger.info("the model is sharded over a model group that is not NCCL's: tokenize and detokenize "
                        "run eagerly")
        pool = aot.GraphPool()
        self._tokenize, self._detokenize = (
            serving_program(self.model, mode, direction, pool, attn_impl, vocos_impl, capture=capture)
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
    def inference_tokenize(self, wav, input_lengths) -> dict:
        """wav (B, T <= chunk_samples) -> codes (device tensors).

        ``wav`` and ``input_lengths`` are host arrays, staged as ``encode``
        stages its batch (``_pack_waves``, one upload), or tensors on the
        codec's device (``encode`` passes slices of its uploaded batch).
        int16 input is PCM16: it ships as int16 and is dequantised (x / 32768,
        exact in f32) on the device.  The padding to the chunk and to the
        batch, and this rank's rows, are taken on the device."""
        with annotate("codec.tokenize.host", step="stage"):
            n = self.cfg.chunk_samples
            if not isinstance(wav, torch.Tensor):
                wav = np.asarray(wav)
                _, len_host = self._pack_waves(list(wav), min(wav.shape[1], n), (len(wav),))
                len_host[:] = input_lengths
                wav, input_lengths = self._wav_staging.upload()
            wav = wav[:, :n]
            b, t = wav.shape
            wav = wav.to(torch.float32) * (1.0 / 32768.0) if wav.dtype == torch.int16 else wav.to(torch.float32)
            bp = self._pad_batch_dim(b)
            rows = self._dist.rows(bp)
            wav_t = F.pad(wav, (0, n - t, 0, bp - b))[rows]
            len_t = F.pad(input_lengths.to(torch.int64), (0, bp - b))[rows]
        with annotate("codec.tokenize.program", rows=wav_t.shape[0], samples=wav_t.shape[1]) as attrs, \
                f32_precision(self.precision, self.deterministic):
            out = self._tokenize(wav_t, len_t)
            attrs["source"] = self._tokenize.source
        with annotate("codec.tokenize.host", step="unpack"):
            out = {k: dist_ctx.all_gather_rows(self._dist, v, 1 if k == "codes" else 0) for k, v in out.items()}
            if bp != b:  # drop batch-padding rows
                out = {"zq": out["zq"][:b], "codes": out["codes"][:, :b], "codes_lengths": out["codes_lengths"][:b]}
        return out

    @torch.no_grad()
    def inference_detokenize(self, codes, codes_lengths, chunk_width: Optional[int] = None,
                             out_samples: Optional[int] = None) -> dict:
        """codes (G, B, T <= code_frames) -> waveform (device tensors).

        ``codes`` and ``codes_lengths`` are host arrays, staged in one
        upload, or tensors on the codec's device (``decode`` passes slices of
        its uploaded batch); the padding to the chunk and to the batch is
        done on the device.  The waveform comes back in the wire's format,
        cut to its first ``out_samples`` samples (``wire_waveform``)."""
        with annotate("codec.detokenize.host", step="stage"):
            g, b, t = np.shape(codes)
            if not isinstance(codes, torch.Tensor):
                codes_host, len_host = self._code_staging.pack(((g, b, t), torch.int32), ((b,), torch.int64))
                codes_host[:], len_host[:] = codes, codes_lengths
                codes, codes_lengths = self._code_staging.upload()
            width = chunk_width if chunk_width is not None else t
            bp = self._pad_batch_dim(b)
            rows = self._dist.rows(bp)
            codes_t = F.pad(codes.to(torch.int32), (0, max(self.cfg.code_frames - t, 0), 0, bp - b))
            codes_t = codes_t[:, rows].contiguous()
            len_t = F.pad(codes_lengths.to(torch.int64), (0, bp - b))[rows]
            width_t = torch.full((), width, dtype=torch.int32, device=self.device)  # a fill, not a host copy
        with annotate("codec.detokenize.program", rows=codes_t.shape[1], frames=codes_t.shape[2]) as attrs, \
                f32_precision(self.precision, self.deterministic):
            out = self._detokenize(codes_t, len_t, width_t)
            attrs["source"] = self._detokenize.source
        with annotate("codec.detokenize.host", step="unpack"):
            out = {k: dist_ctx.all_gather_rows(self._dist, v) for k, v in out.items()}
            if bp != b:
                out = {"y": out["y"][:b], "output_length": out["output_length"][:b]}
            out["y"] = wire_waveform(out["y"], self.wire, out_samples)
        return out

    def _pack_waves(self, rows: Sequence[np.ndarray], width: int, lengths_shape: tuple) -> List[np.ndarray]:
        """1-D waveforms packed for ``_wav_staging.upload``, zero past each row: int16 on the ``pcm16``
        wire or when every row is int16 (float rows by ``to_pcm16``), else float32 (int16 rows as
        x / 32768); then an int64 array of ``lengths_shape``, left to the caller."""
        wire16 = self.wire == "pcm16" or all(w.dtype == np.int16 for w in rows)
        wav_host, lens_host = self._wav_staging.pack(
            ((len(rows), width), torch.int16 if wire16 else torch.float32), (lengths_shape, torch.int64))
        for out, w in zip(wav_host, rows):
            w = w[:width]
            if wire16 and w.dtype != np.int16:
                w = to_pcm16(w)
            if not wire16 and w.dtype == np.int16:
                np.divide(w, np.float32(32768.0), out=out[: len(w)], dtype=np.float32)
            else:
                out[: len(w)] = w
            out[len(w):] = 0
        return [wav_host, lens_host]

    # -- chunked streaming (reference model.py:244-373) ------------------------
    # A call's batch is packed once into reused host memory (page-locked on CUDA) with each chunk's
    # lengths and uploaded in one copy; its ``ChunkGrid`` chunks are padded and run on the device, each
    # chunk's kept columns copied to their place in one device tensor, and that is downloaded once,
    # after the last chunk, and cut to each row's length.  Nothing in the loop waits for the device.

    def encode(self, wav_list: List[np.ndarray], overlap_seconds: int = 10) -> dict:
        """List of 1-D waveforms (float, or int16 PCM read as int16 / 32768)
        -> {"codes_list": [(G, T_i) int32]}.  The batch ships as int16 on the
        ``pcm16`` wire or when every item is int16; otherwise as float32.

        One ``codec.encode`` span a call (attrs ``rows``, ``chunks``,
        ``staging``: ``pinned`` or ``pageable``, ``fetches``: device-to-host
        downloads, each one wait), tiled by ``codec.tokenize.host`` (``step``:
        pack / stage / unpack), ``codec.tokenize.program`` and
        ``codec.tokenize.fetch`` spans."""
        with annotate("codec.encode", rows=len(wav_list), staging=self._wav_staging.kind) as attrs:
            return self._encode(wav_list, ChunkGrid.of(self.cfg, overlap_seconds), attrs)

    def _encode(self, wav_list: List[np.ndarray], grid: ChunkGrid, attrs: dict) -> dict:
        with annotate("codec.tokenize.host", step="pack"):
            rows = [np.asarray(w).reshape(-1) for w in wav_list]
            lengths = np.array([len(w) for w in rows], np.int64)
            starts, ends, chunk_lengths = grid.chunks(lengths)
            _, lens_host = self._pack_waves(rows, int(lengths.max()), chunk_lengths.shape)
            lens_host[:] = chunk_lengths
        with annotate("codec.tokenize.host", step="stage"):
            wav_dev, lens_dev = self._wav_staging.upload()

        codes_dev, w = None, grid.kept
        for k, (start, end) in enumerate(zip(starts.tolist(), ends.tolist())):
            result = self.inference_tokenize(wav_dev[:, start:end], lens_dev[k])
            with annotate("codec.tokenize.host", step="unpack"):
                codes = result["codes"][:, :, :w]
                if codes_dev is None:
                    codes_dev = codes.new_empty((codes.shape[0], len(rows), len(starts) * w))
                if grid.masked:
                    codes = codes * (torch.arange(w, device=codes.device) < result["codes_lengths"][:, None]).int()
                codes_dev[:, :, k * w:(k + 1) * w] = codes
        attrs["chunks"] = len(starts)

        attrs["fetches"] = int(codes_dev is not None)  # none when every row is empty
        if codes_dev is not None:
            with annotate("codec.tokenize.fetch"):
                codes_host = self._wav_staging.download(codes_dev)
        with annotate("codec.tokenize.host", step="unpack"):
            if codes_dev is None:
                codes_host = np.zeros((self.num_groups, len(rows), 0), np.int32)
            return {"codes_list": [codes_host[:, i, : n // grid.hop] for i, n in enumerate(lengths)]}

    def decode(self, codes_list: List[np.ndarray], overlap_seconds: int = 10) -> dict:
        """List of (G, T_i) code arrays -> {"syn_wav_list": [(T_i * 1280,)]}: f32
        waveforms, or int16 PCM on the ``pcm16`` wire.

        One ``codec.decode`` span a call (attrs as ``encode``'s), tiled by
        ``codec.detokenize.host`` (``step``: pack / stage / unpack),
        ``codec.detokenize.program`` and ``codec.detokenize.fetch`` spans."""
        with annotate("codec.decode", rows=len(codes_list), staging=self._code_staging.kind) as attrs:
            return self._decode(codes_list, ChunkGrid.of(self.cfg, overlap_seconds), attrs)

    def _decode(self, codes_list: List[np.ndarray], grid: ChunkGrid, attrs: dict) -> dict:
        with annotate("codec.detokenize.host", step="pack"):
            batch_size = len(codes_list)
            lengths = np.array([c.shape[-1] for c in codes_list], np.int64)
            starts, ends, chunk_lengths = grid.chunks(lengths, codes=True)
            codes_host, lens_host = self._code_staging.pack(
                ((self.num_groups, batch_size, int(lengths.max())), torch.int32), (chunk_lengths.shape, torch.int64))
            for i, c in enumerate(codes_list):
                codes_host[:, i, : c.shape[-1]] = np.asarray(c)
                codes_host[:, i, c.shape[-1]:] = 0
            lens_host[:] = chunk_lengths
        with annotate("codec.detokenize.host", step="stage"):
            codes_dev, lens_dev = self._code_staging.upload()

        wav_dev, w = None, grid.kept * grid.up
        for k, (start, end) in enumerate(zip(starts.tolist(), ends.tolist())):
            y = self.inference_detokenize(codes_dev[:, :, start:end], lens_dev[k], chunk_width=end - start,
                                          out_samples=w)["y"]
            with annotate("codec.detokenize.host", step="unpack"):
                if wav_dev is None:
                    wav_dev = y.new_empty((batch_size, len(starts) * w))
                wav_dev[:, k * w:(k + 1) * w] = y
        attrs["chunks"] = len(starts)

        attrs["fetches"] = int(wav_dev is not None)  # none when every row is empty
        if wav_dev is not None:
            with annotate("codec.detokenize.fetch"):
                wav_host = self._code_staging.download(wav_dev)
        with annotate("codec.detokenize.host", step="unpack"):
            if wav_dev is None:
                wav_host = wire_waveform(torch.zeros((batch_size, 0)), self.wire).numpy()
            return {"syn_wav_list": [wav_host[i, : n * grid.up] for i, n in enumerate(lengths)]}

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
