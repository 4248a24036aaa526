"""Shared set-up of the tests that hold the PyTorch port against the JAX package.

Both packages get the same weights (one JAX ``init_params`` tree, loaded
into the port through ``params_from_jax``) and the same numpy inputs.  The
port runs on the CPU, where each kernel wrapper runs its plain version.
"""

import contextlib

import jax
import numpy as np
import torch

from simwhisper_codec_tpu.models import codec as jcodec
from simwhisper_codec_tpu_torch.models import codec as tcodec
from simwhisper_codec_tpu_torch.utils.checkpoint import params_from_jax

from test_parallel import TINY  # 2 + 2 layers, width 64, full-rate chunks

HIGHEST = jax.lax.Precision.HIGHEST


# Threads for the training tests' CPU work: the suite runs six workers on a
# few cores, and torch's default of one thread a core oversubscribes them
# (a GAN step at the full discriminator width slows ~25x).
TRAIN_THREADS = 2


@contextlib.contextmanager
def torch_threads(n: int = TRAIN_THREADS):
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def jax_params(seed: int = 0, cfg=TINY) -> dict:
    """JAX parameter tree with numpy leaves."""
    return jax.tree.map(np.asarray, jcodec.init_params(jax.random.PRNGKey(seed), cfg))


def informative_params(seed: int = 0) -> dict:
    """``jax_params(seed)`` with the latent projection (``downsample.to_latent``)
    scaled x30, to a unit-variance latent whose codes span the FSQ levels.
    At the raw init scale (latent std 0.033) every code is the zero level and
    the decoder sees only zeros: the training forward then carries no
    information from its input, and the log-spectral loss's gradient is
    dominated by f32 rounding at near-empty STFT bins (each package's f32
    gradient differs from a float64 run by up to 1.7e-3 there)."""
    p = jax_params(seed)
    p["downsample"]["to_latent"]["w"] = p["downsample"]["to_latent"]["w"] * 30.0
    return p


def _random_hifigan_tree(tree, rng: np.random.Generator) -> dict:
    """Random leaves for a JAX HiFi-GAN tree of ``jax.eval_shape`` structs:
    weight-normed v ~ N(0, 0.01^2) with g = ||v|| (1 + 0.1 N), spectral-normed
    w ~ N(0, 0.01^2) with unit random u / v_vec, biases ~ N(0, 0.01^2)."""
    if isinstance(tree, (list, tuple)):
        return [_random_hifigan_tree(x, rng) for x in tree]
    if "u" in tree:
        u, v = (rng.standard_normal(tree[k].shape) for k in ("u", "v_vec"))
        return {"w": (rng.standard_normal(tree["w"].shape) * 0.01).astype(np.float32),
                "b": (rng.standard_normal(tree["b"].shape) * 0.01).astype(np.float32),
                "u": (u / np.linalg.norm(u)).astype(np.float32), "v_vec": (v / np.linalg.norm(v)).astype(np.float32)}
    if "v" in tree:
        v = rng.standard_normal(tree["v"].shape) * 0.01
        axes = tuple(i for i, (a, b) in enumerate(zip(tree["v"].shape, tree["g"].shape)) if b == 1)
        g = np.sqrt(np.sum(v * v, axis=axes, keepdims=True)) * (1.0 + 0.1 * rng.standard_normal(tree["g"].shape))
        return {"v": v.astype(np.float32), "g": g.astype(np.float32),
                "b": (rng.standard_normal(tree["b"].shape) * 0.01).astype(np.float32)}
    return {k: _random_hifigan_tree(v, rng) for k, v in tree.items()}


def jax_discriminator_params(seed: int = 1) -> dict:
    """A JAX ``init_discriminator``-shaped tree with numpy leaves (filled from
    ``seed`` in numpy: the JAX init of the 70M-parameter tree takes ~20 s
    on the CPU)."""
    from simwhisper_codec_tpu.models import hifigan as hg

    shapes = jax.eval_shape(lambda: hg.init_discriminator(jax.random.PRNGKey(0)))
    return _random_hifigan_tree(shapes, np.random.default_rng(seed))


def jax_generator_params(cfg, seed: int = 2) -> dict:
    from simwhisper_codec_tpu.models import hifigan as hg

    shapes = jax.eval_shape(lambda: hg.init_generator(jax.random.PRNGKey(0), cfg))
    return _random_hifigan_tree(shapes, np.random.default_rng(seed))


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
