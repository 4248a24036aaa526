"""DP x TP training dry run: the sharded step against the same step unsharded.

Twin of the JAX package's multichip dry run (``__graft_entry__.py``,
``_dryrun_multichip_impl`` / ``_dryrun_one_config``).  One process a rank:

    torchrun --nproc_per_node N -m simwhisper_codec_tpu_torch.parallel.dryrun --model_axis K [--device cpu]

(gloo on the CPU, NCCL on cards by default; ``--backend gloo`` lets ranks
share a card).  Two geometries: ``narrow`` (width 64, 4 heads) and
``production-geometry`` (768 / 12 heads / 3072, Vocos 512 x 4096, 2 layers
per tower).  For each: the loss and every gradient (the frozen encoder's
too) of one forward + backward with the parameters sharded by
``parallel/mesh.py``'s rules and the batch split over ``data``, gathered
whole, against the same forward + backward unsharded on the whole batch in
this process (the JAX dry run's batch of 8 x 104 mel frames); the
thresholds are the JAX check's (loss rtol 1e-4; per tensor max|d| /
max(max|ref|, 1e-4) < 2e-3; see ``dryrun_one_config`` for the cotangent
the gradients are held to them from).  The replicated parameters'
gradients must be equal on every model rank (the region functions make
them so; nothing reduces them over ``model``).  Then one full AdamW step
(``train/step.py``, frozen encoder) on the sharded model, gradients
averaged over ``data`` only.  Weights: ``informative_model``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from simwhisper_codec_tpu_torch.config import CodecConfig, DecoderConfig, EncoderConfig, SampleStackConfig, VocosConfig
from simwhisper_codec_tpu_torch.models.codec import SimWhisperCodec, f32_precision, init_params, training_forward
from simwhisper_codec_tpu_torch.parallel import dist as dist_ctx
from simwhisper_codec_tpu_torch.parallel import mesh as pmesh
from simwhisper_codec_tpu_torch.train import step as tstep

LOSS_RTOL = 1e-4
GRAD_TOL = 2e-3  # max|d| / max(max|ref|, 1e-4), per tensor
T_MEL = 104  # -> 52 encoder frames -> 13 code frames -> 104 mel frames -> 16640 samples
BATCH = 8  # the JAX dry run's batch on its 8-device mesh; splits over a data axis of 1, 2, 4 or 8


def narrow_config() -> CodecConfig:
    return CodecConfig(
        acoustic_encoder=EncoderConfig(d_model=64, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=128),
        acoustic_decoder=DecoderConfig(d_model=64, decoder_layers=2, decoder_attention_heads=4, decoder_ffn_dim=128),
        downsample=SampleStackConfig(in_dim=64, latent_dim=32, stack_factor=4, hidden_dim=48),
        upsample=SampleStackConfig(out_dim=64, latent_dim=32, stack_factor=4, hidden_dim=48),
        vocos=VocosConfig(input_channels=80, dim=64, intermediate_dim=128, num_layers=2),
    )


def production_config() -> CodecConfig:
    """The full widths at 2 layers per tower (the JAX dry run's cut)."""
    base = CodecConfig()
    return dataclasses.replace(
        base, acoustic_encoder=dataclasses.replace(base.acoustic_encoder, encoder_layers=2),
        acoustic_decoder=dataclasses.replace(base.acoustic_decoder, decoder_layers=2),
        vocos=dataclasses.replace(base.vocos, num_layers=2))


GEOMETRIES = {"narrow": narrow_config, "production-geometry": production_config}


def informative_model(cfg: CodecConfig, batch: Dict[str, torch.Tensor]) -> SimWhisperCodec:
    """``init_params`` (seed 0) with the latent projection scaled so that the
    latent of ``batch`` has unit standard deviation, so the codes span the
    FSQ levels (x27 at the narrow widths, x2.1 at the full ones).  At the raw
    init the codes are all or mostly the zero level and the decoder's input
    carries nothing of the batch."""
    model = init_params(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        enc, enc_len = model.acoustic_encoder(batch["mel"], batch["mel_lens"])
        z, _ = model.downsample(model.consts.af, enc, enc_len)
        model.downsample.to_latent.weight.mul_(1.0 / float(z.std()))
    return model


def make_batch(n: int, t_mel: int = T_MEL) -> Dict[str, torch.Tensor]:
    """The JAX dry run's batch: mel ~ N(0, 1) (seed 0), audio ~ N(0, 0.1^2) (seed 1), full lengths."""
    return {"mel": torch.from_numpy(np.random.default_rng(0).standard_normal((n, t_mel, 80)).astype(np.float32)),
            "mel_lens": torch.full((n,), t_mel, dtype=torch.int64),
            "audio": torch.from_numpy((np.random.default_rng(1).standard_normal((n, t_mel * 160)) * 0.1)
                                      .astype(np.float32)),
            "audio_lens": torch.full((n,), t_mel * 160, dtype=torch.int64)}


def _grads(model: SimWhisperCodec) -> Dict[str, torch.Tensor]:
    """Every parameter's gradient (a copy), then cleared."""
    out = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out


def loss_and_grads(model: SimWhisperCodec, batch: Dict[str, torch.Tensor], spec,
                   cotangent: Optional[torch.Tensor] = None) -> tuple:
    """The reconstruction loss, its gradient with respect to the
    reconstructed audio, every parameter's gradient (the encoder's too, as
    the JAX dry run's ``value_and_grad``), with ``cotangent`` every
    parameter's gradient for that audio cotangent in place of the loss's
    own (else None), and the audio; TF32 off.  The loss depends on the parameters through the audio alone,
    so the first gradients are the loss's."""
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    with f32_precision("highest"):
        audio = training_forward(model, batch["mel"], batch["mel_lens"])["reconstructed_audio"]
        loss = tstep.reconstruction_loss(audio, batch["audio"], batch["audio_lens"], spec)["loss"]
        own = torch.autograd.grad(loss, audio, retain_graph=True)[0]
        shared = None
        if cotangent is not None:
            audio.backward(cotangent, retain_graph=True)
            shared = _grads(model)
        audio.backward(own)
    return loss.detach(), own, _grads(model), shared, audio.detach()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _step_ms(state: tstep.TrainState, batch, spec, ctx, device) -> float:
    """Host ms of one ``train_step`` (it ends in a host read of the metrics)."""
    _sync(device)
    t0 = time.perf_counter()
    tstep.train_step(state, batch, spec, ctx)
    return (time.perf_counter() - t0) * 1e3


def _rel_errs(mesh: pmesh.Mesh, grads: dict, ref: dict) -> tuple:
    """(worst key, its max|d| / max(max|ref|, 1e-4), the gathered whole
    gradients) of a rank's gradients against the unsharded ones."""
    whole = {k: pmesh.unshard(mesh, k, g).cpu() for k, g in grads.items()}
    errs = {k: float((whole[k] - ref[k].cpu()).abs().max()) / max(float(ref[k].abs().max()), 1e-4) for k in ref}
    worst = max(errs, key=errs.get)
    return worst, errs[worst], whole


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.cpu() - want.cpu()).abs().max()) / max(float(want.abs().max()), 1e-30)


def _witness(model: SimWhisperCodec, batch: Dict[str, torch.Tensor], device: torch.device,
             ref_audio: torch.Tensor, ref_cot: torch.Tensor, ref_grads: dict) -> dict:
    """The unsharded step as a second f32 program (on a card: on the CPU;
    on the CPU: at one thread, or two where the process has one), against
    the first: the audio's, the audio cotangent's and the whole step's
    relative errors."""
    threads = torch.get_num_threads()
    if device.type == "cpu":
        torch.set_num_threads(1 if threads > 1 else 2)
    try:
        _, w_cot, w_grads, _, w_audio = loss_and_grads(copy.deepcopy(model).cpu(), batch,
                                                       tstep.make_spectral_consts())
    finally:
        torch.set_num_threads(threads)
    return {"witness": "the CPU" if device.type == "cuda" else f"{torch.get_num_threads()} vs "
                                                                 f"{1 if threads > 1 else 2} CPU threads",
            "witness_audio_rel_diff": _rel(w_audio, ref_audio), "witness_cotangent_rel_diff": _rel(w_cot, ref_cot),
            "witness_step_grad_rel_err": max(float((w_grads[k] - ref_grads[k].cpu()).abs().max())
                                             / max(float(ref_grads[k].abs().max()), 1e-4) for k in ref_grads)}


def dryrun_one_config(mesh: pmesh.Mesh, model: SimWhisperCodec, batch: Dict[str, torch.Tensor],
                      device: torch.device, label: str, keep_grads: bool = False,
                      cotangent: Optional[torch.Tensor] = None) -> dict:
    """The checks of one geometry on this rank; raises on a failed one.
    ``model`` is the whole (CPU) model, ``batch`` the whole batch.

    The gradients are compared twice.  Held to ``GRAD_TOL``: both models'
    backward passes from the same audio cotangent (the unsharded loss's
    gradient, this rank's rows), which compares what sharding changes, the
    model's forward and backward, and leaves out the loss's own
    conditioning: at the full widths the log-spectral term's near-empty
    bins turn the f32 reordering of the sums (1e-7 of the audio) into up to
    7e-3 of a gradient tensor, as much as the unsharded step moves by with
    the CPU's thread count alone.  Reported: each model's whole step, its
    own loss's gradients, beside the same comparison between two f32
    programs of the unsharded step (``witness``: on a card, the step on the
    CPU; on the CPU, at another thread count), which moves the audio
    cotangent and the whole step by as much.  ``cotangent`` (the whole
    batch's; e.g. the JAX package's) replaces the unsharded loss's as the
    shared one.  Returns the numbers, and with ``keep_grads`` the gathered
    whole gradients from the shared cotangent (CPU)."""
    spec = tstep.make_spectral_consts().to(device)
    n = batch["mel"].shape[0]
    full = {k: v.to(device) for k, v in batch.items()}
    rows = pmesh.batch_rows(mesh, n)
    part = {k: v[rows] for k, v in full.items()}
    ctx = mesh.data_context()
    params_of = lambda m: list(m.parameters())

    ref_model = copy.deepcopy(model).to(device)
    given = None if cotangent is None else cotangent.to(device)
    ref_loss, ref_cot, ref_grads, ref_shared, ref_audio = loss_and_grads(ref_model, full, spec, given)
    cot = ref_cot if given is None else given
    held = ref_grads if given is None else ref_shared
    shard = pmesh.shard_model(model, mesh).to(device)
    # each data rank's loss is the mean over its rows: its share of the
    # whole batch's cotangent, times the data size, averages back to it
    loss, own, grads, shared, audio = loss_and_grads(shard, part, spec, cot[rows] * mesh.data_size)
    audio_diff, cot_diff = _rel(audio, ref_audio[rows]), _rel(own, ref_cot[rows] * mesh.data_size)
    for g in (grads, shared):
        for k, p in zip(g, params_of(shard)):
            p.grad = g[k]
        dist_ctx.average_grads(ctx, params_of(shard))
    shard.zero_grad(set_to_none=True)
    loss = dist_ctx.average_metrics(ctx, {"loss": loss})["loss"]
    ref_loss = float(ref_loss)
    if not np.isfinite(loss) or abs(loss - ref_loss) > LOSS_RTOL * abs(ref_loss) + 1e-6:
        raise AssertionError(f"[{label}] sharded loss {loss} vs unsharded {ref_loss} (rtol {LOSS_RTOL})")

    # replicated leaves: equal on every model rank, by the region functions alone
    rep_diff = 0.0
    for g in (grads, shared):
        for k, t in g.items():
            if pmesh.param_sharding_rules(k) is None:
                rep_diff = max(rep_diff, float((t - pmesh.replicated(mesh, t)).abs().max()))
    worst, err, whole = _rel_errs(mesh, shared, held)
    step_worst, step_err, _ = _rel_errs(mesh, grads, ref_grads)
    if err >= GRAD_TOL:
        raise AssertionError(f"[{label}] sharded vs unsharded gradients: rel err {err:.3g} at {worst} "
                             f"(a wrong sharding gives O(0.1+) here)")
    if rep_diff != 0.0:
        raise AssertionError(f"[{label}] a replicated gradient differs between model ranks by {rep_diff:.3g}")

    # one full AdamW step on the sharded model (frozen encoder), timed against one process
    state = tstep.TrainState(shard, tstep.make_optimizer(shard))
    metrics = tstep.train_step(state, part, spec, ctx)
    if not np.isfinite(metrics["loss"]) or state.step != 1:
        raise AssertionError(f"[{label}] train step: {metrics}, step {state.step}")
    step_ms = _step_ms(state, part, spec, ctx, device)
    ref_state = tstep.TrainState(ref_model, tstep.make_optimizer(ref_model))
    tstep.train_step(ref_state, full, spec)
    ref_step_ms = _step_ms(ref_state, full, spec, None, device)
    out = {"label": label, "mesh": {"data": mesh.data_size, "model": mesh.model_size}, "batch": n,
           "loss": loss, "ref_loss": ref_loss, "grad_rel_err": err, "worst": worst, "n_grads": len(ref_grads),
           "step_grad_rel_err": step_err, "step_worst": step_worst, "audio_rel_diff": audio_diff,
           "cotangent_rel_diff": cot_diff, **_witness(model, batch, device, ref_audio, ref_cot, ref_grads), "replicated_max_diff": rep_diff,
           "step_loss": metrics["loss"], "step_ms": step_ms, "one_process_step_ms": ref_step_ms}
    if keep_grads:
        out["grads"] = whole
    return out


def run(mesh: pmesh.Mesh, device: torch.device, geometries=tuple(GEOMETRIES), log=print) -> list:
    """Every geometry's checks; returns their results."""
    results = []
    n = BATCH
    for label in geometries:
        batch = make_batch(n)
        res = dryrun_one_config(mesh, informative_model(GEOMETRIES[label](), batch), batch, device, label)
        log(f"dryrun [{label}] OK: mesh {res['mesh']} batch {n} loss {res['loss']:.6f} (unsharded "
            f"{res['ref_loss']:.6f}), grad rel err {res['grad_rel_err']:.2e} at {res['worst']} over {res['n_grads']} "
            f"tensors from one cotangent (whole step, report only: {res['step_grad_rel_err']:.2e} at "
            f"{res['step_worst']}, audio {res['audio_rel_diff']:.2e}, audio cotangent {res['cotangent_rel_diff']:.2e}; "
            f"a second f32 program of the unsharded step, {res['witness']}: whole step "
            f"{res['witness_step_grad_rel_err']:.2e}, audio {res['witness_audio_rel_diff']:.2e}, audio cotangent "
            f"{res['witness_cotangent_rel_diff']:.2e}), replicated grads equal across model ranks, AdamW step loss "
            f"{res['step_loss']:.6f}, step "
            f"{res['step_ms']:.1f} ms (one process, whole batch: {res['one_process_step_ms']:.1f} ms)")
        results.append(res)
    return results


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_axis", type=int, default=1, help="ranks of the model axis (tensor parallelism)")
    ap.add_argument("--device", default="cuda", help="cuda (a card a rank, by LOCAL_RANK) or cpu")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend (default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        from simwhisper_codec_tpu_torch.experiments.codec.train import set_determinism

        set_determinism()
    ctx = dist_ctx.init_from_env(device, args.backend)
    device = dist_ctx.local_device(ctx, device)
    mesh = pmesh.make_mesh(model_axis=args.model_axis)
    run(mesh, device, log=print if ctx.rank == 0 else (lambda msg: None))
    if ctx.grouped:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
