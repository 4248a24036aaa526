"""Shared set-up of the tests that hold the PyTorch port against the JAX package.

Both packages get the same weights (one JAX ``init_params`` tree, loaded
into the port through ``params_from_jax``) and the same numpy inputs.  The
port runs on the CPU, where each kernel wrapper runs its plain version.
"""

import jax
import numpy as np
import torch

from simwhisper_codec_tpu.models import codec as jcodec
from simwhisper_codec_tpu_torch.models import codec as tcodec
from simwhisper_codec_tpu_torch.utils.checkpoint import params_from_jax

from test_parallel import TINY  # 2 + 2 layers, width 64, full-rate chunks

HIGHEST = jax.lax.Precision.HIGHEST


def jax_params(seed: int = 0, cfg=TINY) -> dict:
    """JAX parameter tree with numpy leaves."""
    return jax.tree.map(np.asarray, jcodec.init_params(jax.random.PRNGKey(seed), cfg))


def port_model(params: dict, cfg=TINY) -> tcodec.SimWhisperCodec:
    model = tcodec.SimWhisperCodec(cfg)
    model.load_state_dict(params_from_jax(params))
    return model.eval()


def t(a, dtype=None) -> torch.Tensor:
    """numpy -> CPU tensor (a copy)."""
    out = torch.tensor(np.asarray(a))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """tensor or JAX array -> numpy."""
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
