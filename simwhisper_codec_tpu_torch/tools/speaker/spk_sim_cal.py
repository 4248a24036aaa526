"""Speaker similarity: cosine similarity of speaker embeddings over paired dirs.

Twin of the JAX package's ``tools/speaker/spk_sim_cal.py`` (reference
``tools/speaker/spk_sim_cal.py:13-75`` + ``extract_spk_emb.py:38-94``):
embeds each (original, synthesized) pair with ``eval/speaker.py`` on the
device, 64 pairs a batched call (WavLM-large + ECAPA-TDNN from
``--ecapa_checkpoint``, or the random-weight fbank variant without one, for
pipeline smoke runs) and
prints the mean cosine; with ``--orig_emb_dir`` and ``--synth_emb_dir`` it
pairs cached ``<utt>.npy`` embeddings instead
(``python -m simwhisper_codec_tpu_torch.tools.speaker.extract_spk_emb``
writes them).  Runs on ``cuda`` unless ``--device cpu``.

Run:  python -m simwhisper_codec_tpu_torch.tools.speaker.spk_sim_cal \\
          --original_dir A --synthesized_dir B --ecapa_checkpoint wavlm_large_finetune.pth
"""

import argparse
from pathlib import Path

import numpy as np

from simwhisper_codec_tpu_torch.utils.audio_io import find_audio_files, load_audio


def load_extractor(checkpoint: str = None, feat_type: str = None, device: str = "cuda"):
    """ECAPA-TDNN extractor (``eval/speaker.py``), reference-matching.

    With ``checkpoint`` = the published ``wavlm_large_finetune.pth``, the
    full WavLM-large + ECAPA scorer behind the published SIM
    (``extract_spk_emb.py:14-25``); without one, a random-weight fbank
    variant for pipeline smoke tests.
    """
    from simwhisper_codec_tpu_torch.eval.speaker import SpeakerEmbedder

    if checkpoint:
        return SpeakerEmbedder.from_checkpoint(checkpoint, device=device)
    return SpeakerEmbedder(feat_type=feat_type or "fbank", device=device)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--original_dir", type=str, required=True)
    parser.add_argument("--synthesized_dir", type=str, required=True)
    parser.add_argument("--orig_emb_dir", type=str, default=None,
                        help="dir of precomputed <utt>.npy embeddings for originals")
    parser.add_argument("--synth_emb_dir", type=str, default=None)
    parser.add_argument("--ecapa_checkpoint", type=str, default=None,
                        help="wavlm_large_finetune.pth (torch) for the reference "
                             "WavLM-large ECAPA scorer")
    parser.add_argument("--device", type=str, default="cuda", help="torch device (cuda or cpu)")
    args = parser.parse_args(argv)
    from simwhisper_codec_tpu_torch.eval.speaker import PAIRS_PER_CALL, cosine

    if args.orig_emb_dir and args.synth_emb_dir:
        sims = []
        for orig_npy in sorted(Path(args.orig_emb_dir).glob("*.npy")):
            synth_npy = Path(args.synth_emb_dir) / orig_npy.name
            if synth_npy.exists():
                sims.append(cosine(np.load(orig_npy).reshape(-1), np.load(synth_npy).reshape(-1)))
        print(f"SIM mean over {len(sims)} pairs: {np.mean(sims):.4f}")
        return

    extractor = load_extractor(args.ecapa_checkpoint, device=args.device)
    files = list(zip(find_audio_files(args.original_dir), find_audio_files(args.synthesized_dir)))
    sims = []
    for i in range(0, len(files), PAIRS_PER_CALL):  # a batched call of both rows of each pair
        pairs = [(load_audio(o, 16000), load_audio(s, 16000)) for o, s in files[i:i + PAIRS_PER_CALL]]
        sims += extractor.similarities(pairs, 16000).tolist()
    print(f"SIM mean over {len(sims)} pairs: {np.mean(sims):.4f}")


if __name__ == "__main__":
    main()
