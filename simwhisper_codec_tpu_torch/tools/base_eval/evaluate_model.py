"""Directory-vs-directory objective evaluation (PESQ/STOI + native metrics).

Twin of the JAX package's ``tools/base_eval/evaluate_model.py`` (reference
``tools/base_eval/evaluate_model.py:74-163``): walks an original and a
synthesized directory, pairs files by sorted order, length-matches and
[-1, 1]-clips each pair, averages per metric.  Host numpy only
(``eval/evaluator.py`` on ``eval/metrics.py``; PESQ-WB/NB through the ITU
``pesq`` wrapper when installed, else the native P.862 of
``eval/pesq_native.py``); the JSON keys are the JAX tool's.

Run:  python -m simwhisper_codec_tpu_torch.tools.base_eval.evaluate_model \\
          --original_dir A --synthesized_dir B [--output_json out.json]
"""

import argparse
import json
from pathlib import Path

from simwhisper_codec_tpu_torch.eval import evaluator
from simwhisper_codec_tpu_torch.eval import metrics as M
from simwhisper_codec_tpu_torch.utils.audio_io import find_audio_files, load_audio


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--original_dir", type=str, required=True)
    parser.add_argument("--synthesized_dir", type=str, required=True)
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--output_json", type=str, default=None)
    args = parser.parse_args(argv)

    orig_files = find_audio_files(args.original_dir)
    synth_files = find_audio_files(args.synthesized_dir)
    if len(orig_files) != len(synth_files):
        print(
            f"warning: {len(orig_files)} original vs {len(synth_files)} synthesized files;"
            " pairing by sorted order over the common prefix"
        )
    pairs = list(zip(orig_files, synth_files))

    rows = []
    for orig_path, synth_path in pairs:
        ref = load_audio(orig_path, target_sample_rate=args.sample_rate)
        deg = load_audio(synth_path, target_sample_rate=args.sample_rate)
        rows.append(evaluator.pair_metrics(ref, deg, args.sample_rate))

    averages = evaluator.average_metrics(rows)
    averages["num_pairs"] = len(pairs)
    if not M.have_pesq():
        averages["pesq_note"] = "native P.862 implementation (no pip pesq installed)"
    print(json.dumps(averages, indent=2))
    if args.output_json:
        Path(args.output_json).write_text(json.dumps(averages, indent=2))


if __name__ == "__main__":
    main()
