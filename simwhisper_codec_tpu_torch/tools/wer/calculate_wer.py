"""WER evaluation: transcribe reconstructed + original audio, report both WERs.

Twin of the JAX package's ``tools/wer/calculate_wer.py`` (reference
``tools/wer/calculate_wer.py:428-502``): collects ``*.trans.txt``
references (LibriSpeech layout), greedy-decodes each file with a HuBERT CTC
ASR (``eval/wer.py::CTCTranscriber`` on the device, f32, TF32 off),
normalizes, and aggregates WER with the edit-distance ``Calculator``.  The
model is a local ``HubertForCTC`` directory, read by its files.  Runs on
``cuda`` unless ``--device cpu``.

Run:  python -m simwhisper_codec_tpu_torch.tools.wer.calculate_wer \\
          --original_dir A --synthesized_dir B --model weights/hubert_ctc
"""

import argparse
import sys
from pathlib import Path

from simwhisper_codec_tpu_torch.eval.wer import Calculator, CTCTranscriber, have_asr
from simwhisper_codec_tpu_torch.utils.audio_io import find_audio_files, load_audio


def collect_transcripts(root: str) -> dict:
    """Read LibriSpeech-style ``*.trans.txt``: lines of '<utt_id> <text>'."""
    out = {}
    for trans in Path(root).rglob("*.trans.txt"):
        for line in trans.read_text().splitlines():
            parts = line.strip().split(" ", 1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--original_dir", type=str, required=True,
                        help="LibriSpeech-style dir with wavs + *.trans.txt")
    parser.add_argument("--synthesized_dir", type=str, required=True)
    parser.add_argument("--model", type=str, default="facebook/hubert-large-ls960-ft",
                        help="local HubertForCTC directory (hubert-large-ls960-ft layout)")
    parser.add_argument("--device", type=str, default="cuda", help="torch device (cuda or cpu)")
    args = parser.parse_args(argv)

    if not have_asr(args.model):
        print(
            f"ASR model {args.model} is not in the local HF cache and this "
            "environment has no network egress; WER evaluation requires the "
            "cached model. The edit-distance/normalization pipeline is "
            "available as simwhisper_codec_tpu_torch.eval.wer."
        )
        sys.exit(2)

    transcripts = collect_transcripts(args.original_dir)
    asr = CTCTranscriber(args.model, device=args.device)

    # one directory walk, stem -> path (first match wins, like sorted zip in
    # the reference harness); rescanning per utterance would be O(N^2) stats
    orig_by_stem = {}
    for p in find_audio_files(args.original_dir):
        orig_by_stem.setdefault(Path(p).stem, p)

    calc_rec, calc_orig = Calculator(), Calculator()
    for synth_path in find_audio_files(args.synthesized_dir):
        utt_id = Path(synth_path).stem
        if utt_id not in transcripts:
            continue
        ref_text = transcripts[utt_id]
        hyp_rec = asr.transcribe(load_audio(synth_path, 16000), 16000)
        # reference argument order: (transcription, ground truth) — the WER
        # denominator is the transcription token count (calculate_wer.py:339-343)
        calc_rec.calculate(utt_id, hyp_rec, ref_text)

        orig_path = orig_by_stem.get(utt_id)
        if orig_path is not None:
            hyp_orig = asr.transcribe(load_audio(orig_path, 16000), 16000)
            calc_orig.calculate(utt_id, hyp_orig, ref_text)

    print("reconstructed:", calc_rec.report())
    print("original:     ", calc_orig.report())
    print(f"delta WER: {100*(calc_rec.wer - calc_orig.wer):.2f}%")


if __name__ == "__main__":
    main()
