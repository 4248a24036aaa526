"""Orbax params directory (the JAX package's native format) -> reference-layout ``.pt``.

``tools/convert_checkpoint.py`` turns a reference ``SimWhisperCodec.pt`` into
an Orbax directory, which the JAX ``AudioCodec.load_from_checkpoint`` reads.
The PyTorch port reads ``.pt`` files only, so this tool goes the other way:
it restores the directory exactly as the JAX loader does (``load_orbax`` with
``init_params(PRNGKey(0), cfg)`` as the structure), maps the tree to the
port's state dict (``params_from_jax``) and writes ``{"model": state_dict}``,
which ``simwhisper_codec_tpu_torch``'s loader and the reference both read.

Usage:
  python tools/orbax_to_pt.py --config config/SimWhisperCodec.yaml \
      --orbax_dir weights/orbax --out weights/SimWhisperCodec.pt
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def convert(config: str, orbax_dir: str, out: str) -> int:
    """Restore ``orbax_dir``, write the ``.pt`` to ``out``; returns the number of tensors."""
    import jax
    import numpy as np
    import torch

    from simwhisper_codec_tpu.config import load_config as jax_load_config
    from simwhisper_codec_tpu.models.codec import init_params as jax_init_params
    from simwhisper_codec_tpu.utils.checkpoint import load_orbax
    from simwhisper_codec_tpu_torch.config import load_config
    from simwhisper_codec_tpu_torch.models.codec import SimWhisperCodec
    from simwhisper_codec_tpu_torch.utils.checkpoint import params_from_jax

    tree = load_orbax(orbax_dir, jax_init_params(jax.random.PRNGKey(0), jax_load_config(config)))
    model = SimWhisperCodec(load_config(config))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)), strict=True)
    state = model.state_dict()
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": state}, out)
    return len(state)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="config/SimWhisperCodec.yaml")
    p.add_argument("--orbax_dir", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    n = convert(args.config, args.orbax_dir, args.out)
    print(f"wrote {n} tensors to {args.out}")


if __name__ == "__main__":
    main()
