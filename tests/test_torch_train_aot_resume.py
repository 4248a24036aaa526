"""A state dict loaded into the port's captured training programs
(``utils/aot.py``'s ``StepProgram``), on the CPU at the ``--smoke`` widths:

(a) a checkpoint written before the rate was a tensor (a float rate, host
    step counts, ``capturable`` off) loads into the tensor rate, the
    optimizer's own ``capturable`` flag and its step counts, and continues
    bit for bit as a continuous run, on the CPU's optimizer and on the
    card's (``capturable``);
(b) a state dict loaded into a model or an optimizer a program has captured
    drops its graphs, and the next call warms up and captures again (a
    stand-in capture: the graph itself runs on the card only).
"""

import copy
import os
import tempfile

import numpy as np
import pytest
import torch

from simwhisper_codec_tpu_torch.train import codec_gan as tcg
from simwhisper_codec_tpu_torch.train import gan as tgan
from simwhisper_codec_tpu_torch.utils.checkpoint import load_training_state, save_training_state, state_digest

from test_torch_codec_gan import gan_batch
from test_torch_train_aot import (  # noqa: F401  (fixtures)
    LR,
    _threads,
    capturable_on_cpu,
    smoke_state,
    stand_in_capture,
    torch_gan_batch,
)


def as_written_before_tensor_rates(sd: dict) -> dict:
    """A training state as a trainer wrote it while the rate was a float: each
    group's rate the float it was made with, ``capturable`` off, the step
    counts f32 host tensors."""
    sd = copy.deepcopy(sd)
    for key in ("g_opt", "d_opt"):
        for group in sd[key]["param_groups"]:
            group["lr"], group["capturable"] = LR, False
        for st in sd[key]["state"].values():
            st["step"] = torch.tensor(float(st["step"]))
    return sd


@pytest.mark.parametrize("capturable", [False, True])
def test_a_checkpoint_with_a_float_rate_continues_exactly(capturable, capturable_on_cpu):
    steps = [torch_gan_batch(gan_batch(2, t_mel=16)), torch_gan_batch(gan_batch(5, t_mel=16))]
    mc = tgan.make_mel_loss_constants()
    state = smoke_state(capturable)
    continuous = [tcg.codec_gan_step(state, s, mc) for s in steps]
    state_first = smoke_state(capturable)
    first = tcg.codec_gan_step(state_first, steps[0], mc)
    old = as_written_before_tensor_rates(state_first.state_dict())
    assert isinstance(old["g_opt"]["param_groups"][0]["lr"], float)
    resumed = smoke_state(capturable)
    rates = [resumed.g_opt.param_groups[0]["lr"], resumed.d_opt.param_groups[0]["lr"]]
    # the full discriminator's state is ~0.85 GB: a directory removed at the end
    with tempfile.TemporaryDirectory() as tmp:
        save_training_state(os.path.join(tmp, "old.pt"), old)
        del old
        resumed.load_state_dict(load_training_state(os.path.join(tmp, "old.pt")))
    for opt, rate in zip((resumed.g_opt, resumed.d_opt), rates):
        group = opt.param_groups[0]
        assert group["lr"] is rate and float(rate) == float(np.float32(LR)) and group["capturable"] == capturable
        assert all(st["step"].dtype == torch.float32 and float(st["step"]) == 1.0 for st in opt.state.values())
    second = tcg.codec_gan_step(resumed, steps[1], mc)
    assert [first, second] == continuous
    assert state_digest(resumed.state_dict()) == state_digest(state.state_dict())


def test_a_load_drops_the_captured_graphs(stand_in_capture):
    state = smoke_state()
    mc = tgan.make_mel_loss_constants()
    b = torch_gan_batch(gan_batch(2, t_mel=16))
    program = tcg.codec_gan_program(state, mc)
    sources = []
    for _ in range(2):
        tcg.codec_gan_step(state, b, mc)
        sources.append(program.source)
    assert sources == ["captured", "replayed"] and program.count == 1
    sd = copy.deepcopy(state.state_dict())
    for load in (lambda: state.load_state_dict(sd), lambda: state.d_opt.load_state_dict(sd["d_opt"]),
                 lambda: state.model.load_state_dict(sd["model"]),
                 lambda: state.discriminator.load_state_dict(sd["discriminator"])):
        load()
        assert program.count == 0
        tcg.codec_gan_step(state, b, mc)
        assert program.source == "captured" and program.count == 1
    assert stand_in_capture == ["codec_gan_step"] * 5 and state.step == 6


