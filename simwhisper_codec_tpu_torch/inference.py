"""Batch inference CLI: directory of audio -> codes -> reconstructed WAVs.

The PyTorch counterpart of the repository's ``inference.py`` (reference
``inference.py:9-67``): the same flags, the same chunked encode/decode round
trip and the same output naming (``<stem>.wav``, 16-bit PCM).  ``--device``
is a torch device (default ``cuda``); ``--precision default`` allows TF32
for the float32 matmuls and convolutions of parity mode (the counterpart of
``Precision.DEFAULT``; the fast modes always run it).  Inputs are WAV, FLAC
or MP3 files, read a batch at a time through the native loader
(``utils/native_loader.py``), as the JAX CLI reads them.  With
``--data_parallel`` under ``torchrun`` each rank runs its share of every
batch on its own GPU and rank 0 writes the outputs.

Run:  python -m simwhisper_codec_tpu_torch.inference --input_dir in --output_dir out
      torchrun --nproc_per_node N -m simwhisper_codec_tpu_torch.inference --data_parallel ...
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from simwhisper_codec_tpu_torch.models.codec import MODES, PRECISIONS, AudioCodec
from simwhisper_codec_tpu_torch.parallel import dist
from simwhisper_codec_tpu_torch.utils.audio_io import find_audio_files, save_audio, set_logging
from simwhisper_codec_tpu_torch.utils.native_loader import load_audio_batch


def main(argv=None) -> None:
    set_logging()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config_path", type=str, default="./config/SimWhisperCodec.yaml")
    parser.add_argument("--checkpoint_path", type=str, default="./weights/SimWhisperCodec.pt")
    parser.add_argument("--device", type=str, default="cuda", help="torch device (cuda, cuda:1, cpu)")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--input_dir", type=str, default="input_wavs")
    parser.add_argument("--output_dir", type=str, default="output_wavs")
    parser.add_argument("--overlap_seconds", type=int, default=10)
    parser.add_argument("--precision", type=str, default="highest", choices=PRECISIONS,
                        help="parity mode's float32 matmuls and convolutions: highest (no TF32) or default "
                             "(TF32); the fast modes always run default")
    parser.add_argument("--mode", type=str, default="parity", choices=MODES,
                        help="parity: f32 bit-exact codes; fast: bf16 serving path")
    parser.add_argument("--data_parallel", action="store_true",
                        help="split each batch over the ranks of torchrun's process group (one GPU each)")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    ctx = dist.init_from_env(device) if args.data_parallel else dist.DistContext()
    generator = AudioCodec.load_from_checkpoint(
        config_path=args.config_path, ckpt_path=args.checkpoint_path, batch_size=args.batch_size,
        precision=args.precision, mode=args.mode, device=dist.local_device(ctx, device),
        data_parallel=args.data_parallel,
    )
    audio_paths = find_audio_files(input_dir=args.input_dir)
    os.makedirs(args.output_dir, exist_ok=True)
    logging.info("Processing %d audio files, output to %s", len(audio_paths), args.output_dir)

    batch_size = args.batch_size
    for i in range(0, len(audio_paths), batch_size):
        batch_paths = audio_paths[i: i + batch_size]
        logging.info("Processing batch %d/%d, files: %s", i // batch_size + 1,
                     (len(audio_paths) + batch_size - 1) // batch_size, batch_paths)
        # WAV and FLAC decoded by the native thread pool, MP3 in Python; a
        # file that fails raises, as the reference's torchaudio.load would
        wav_list = load_audio_batch(batch_paths, target_sample_rate=generator.input_sample_rate)
        logging.info("Loaded %d files, lengths %s", len(wav_list), [len(w) for w in wav_list])

        codes_list = generator.encode(wav_list, overlap_seconds=args.overlap_seconds)["codes_list"]
        logging.info("Encoding done, code lengths: %s", [c.shape[-1] for c in codes_list])
        syn_wav_list = generator.decode(codes_list, overlap_seconds=args.overlap_seconds)["syn_wav_list"]
        logging.info("Decoding done, waveform lengths: %s", [len(w) for w in syn_wav_list])

        if ctx.rank != 0:
            continue
        for path, syn_wav in zip(batch_paths, syn_wav_list):
            output_path = os.path.join(args.output_dir, os.path.splitext(os.path.basename(path))[0] + ".wav")
            save_audio(output_path, syn_wav, sample_rate=generator.output_sample_rate)
            logging.info("Saved %s", output_path)

    logging.info("All audio processing completed")


if __name__ == "__main__":
    main()
