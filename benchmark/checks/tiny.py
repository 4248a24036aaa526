"""The published generator at narrow widths, and cell runs at that size on the CPU."""

import tempfile
import time

# the published generator at narrow widths (every stage, two layers a tower), for CPU runs
TINY_GP = {
    "input_sample_rate": 16000, "output_sample_rate": 16000, "mel_hop_length": 160,
    "encoder_downsample_rate": 1280, "decoder_upsample_rate": 1280,
    "feature_extractor": {"chunk_length": 30, "feature_size": 80, "sampling_rate": 16000, "hop_length": 160,
                          "n_fft": 400, "n_samples": 480000, "nb_max_frames": 3000, "padding_side": "right",
                          "padding_value": 0.0, "return_attention_mask": False},
    "acoustic_encoder": {"num_mel_bins": 80, "sampling_rate": 16000, "hop_length": 160, "stride_size": 2,
                         "kernel_size": 3, "d_model": 64, "scale_embedding": False, "max_audio_seconds": 30,
                         "encoder_layers": 2, "encoder_attention_heads": 4, "encoder_ffn_dim": 128,
                         "is_acoustic": True, "freeze": False},
    "downsample": {"in_dim": 64, "latent_dim": 32, "stack_factor": 4, "hidden_dim": 48},
    "quantizer": {"num_groups": 8, "num_levels_per_group": [8, 7, 6, 6], "eps": 0.001},
    "upsample": {"latent_dim": 32, "out_dim": 64, "stack_factor": 4, "hidden_dim": 48},
    "acoustic_decoder": {"num_mel_bins": 80, "sampling_rate": 16000, "hop_length": 160, "stride_size": 2,
                         "kernel_size": 3, "d_model": 64, "scale_embedding": False, "max_audio_seconds": 30,
                         "decoder_layers": 2, "decoder_attention_heads": 4, "decoder_ffn_dim": 128,
                         "activation_function": "gelu"},
    "vocos": {"input_channels": 80, "dim": 64, "intermediate_dim": 128, "num_layers": 3, "n_fft": 640,
              "hop_size": 160, "padding": "same"},
}


def tiny_run(workload: str, seed: int, seconds: float, device="cpu", **mix_changes):
    """A ``cell.Run`` of ``workload`` at the narrow widths, small batches, on ``device``."""
    import torch

    from benchmark import cell
    from benchmark.run import CACHE

    manifest = cell.load_manifest()
    wl = cell.workload_entry(manifest, workload)
    config = dict(cell.config_file(manifest, wl["config"]), generator_params=TINY_GP)
    mix = dict(cell.mix_file(wl["traffic"]))
    if mix["loop"] == "offline":
        mix.update(batch_size=2, length={"kind": "uniform", "min_s": 20, "max_s": 45})
    else:
        mix.update(rate_per_s=3.0, check_per_kind=2, grace_seconds=30,
                   server_flags=["--max_batch", "2", "--window_ms", "5", "--queue_depth", "64"])
    mix.update(mix_changes)
    return manifest, cell.Run(workload=workload, seed=seed, seconds=seconds, trace=False, wl=wl, config=config,
                              mix=mix, device=torch.device(device), tmpdir=tempfile.gettempdir(),
                              aot_dir=CACHE / "benchmark", t_start=time.time())
