"""SimWhisper-Codec on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of ``simwhisper_codec_tpu``: the same codec round
trip (log-mel -> encoder -> frame-stack down -> GroupFSQ -> codes -> FSQ^-1 ->
frame-stack up -> decoder -> Vocos -> ISTFT) with the same public layouts
(channels-last (B, T, C) activations, (G, B, T) int32 codes), and hand-written
CUDA C++ kernels (``csrc/``) for the attention core and the fused LN-FFN
chains of the fast serving modes; and the codec GAN trainer (``train/``,
``experiments/codec/``) with data parallelism over ``torch.distributed``
(``parallel/``).

This package imports ``torch`` and numpy only.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from simwhisper_codec_tpu_torch.config import CodecConfig, load_config  # noqa: F401


def load_codec(config_path: str, ckpt_path: str, **kwargs):
    """An ``AudioCodec`` from a YAML config and a reference ``.pt`` state dict
    (``AudioCodec.load_from_checkpoint``; ``kwargs`` go to ``AudioCodec``)."""
    from simwhisper_codec_tpu_torch.models.codec import AudioCodec

    return AudioCodec.load_from_checkpoint(config_path, ckpt_path, **kwargs)
