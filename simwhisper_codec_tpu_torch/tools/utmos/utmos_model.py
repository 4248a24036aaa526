"""UTMOS scorer backend (a thin shim over ``eval/utmos.py``).

Twin of the JAX package's ``tools/utmos/utmos_model.py``.  Reference:
``tools/utmos/utmos.py:35-245``, the UTMOS22-strong model: wav2vec2 SSL
tower + domain / judge embeddings -> BLSTM -> projection, per-frame scores
averaged and rescaled ``* 2 + 3``.  The reference needs fairseq and
pytorch-lightning to deserialise and run the checkpoint; ``eval/utmos.py``
runs the whole model in plain PyTorch and only ``torch.load``s the
``.ckpt``.

Run:  python -m simwhisper_codec_tpu_torch.tools.utmos.utmos_model --help
"""

from __future__ import annotations

import argparse

from simwhisper_codec_tpu_torch.eval.utmos import UTMOSConfig, UTMOSScorer, load_utmos_params  # noqa: F401

__all__ = ["UTMOSConfig", "UTMOSScorer", "load_utmos_params"]


if __name__ == "__main__":
    argparse.ArgumentParser(description=__doc__).parse_args()
