"""The port's compiled training programs (``utils/aot.py``'s ``StepProgram``
in ``train/gan.py`` and ``train/codec_gan.py``) on the CPU, where a program
runs its step eagerly and counts its signatures.

(a) the step bodies, the segment log-mel and the probe's forward read
    nothing on the host (the guard of ``tests/test_torch_aot.py``), with
    the optimizers on the card's arithmetic (``capturable``: step counts
    and bias corrections as tensors);
(b) one signature after a three-step ``--smoke`` run of the codec trainer;
(c) ``--aot_dir`` of the codec trainer reaches ``ops._cuda.use_aot_dir``;
(d) a step over a gloo group runs eagerly, logged, and equals the step
    without a group.
The steps against the JAX package's: ``test_torch_train_aot_codec.py`` and
``test_torch_train_aot_recipe.py``; loads into a captured state:
``test_torch_train_aot_resume.py``.  The capture itself runs on the card
only (``chip_smoke.py --check train-graph``).
"""

import importlib
import json
import logging
import os
import socket

import pytest
import torch

from simwhisper_codec_tpu_torch.experiments.codec import train as ttrain
from simwhisper_codec_tpu_torch.models import codec as tcodec
from simwhisper_codec_tpu_torch.models import hifigan as thg
from simwhisper_codec_tpu_torch.parallel import dist
from simwhisper_codec_tpu_torch.train import codec_gan as tcg
from simwhisper_codec_tpu_torch.train import gan as tgan
from simwhisper_codec_tpu_torch.utils import aot
from simwhisper_codec_tpu_torch.utils.checkpoint import state_digest

from test_torch_aot import HostReadGuard
from test_torch_codec_gan import gan_batch
from test_torch_hifigan import TCFG, audio
from torch_port import t, torch_threads

LR = 2e-4


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads():
        yield


@pytest.fixture
def capturable_on_cpu(monkeypatch):
    """Lets torch's AdamW run its ``capturable`` arithmetic on CPU tensors
    (torch asserts a CUDA device for it): the card's optimizer, here."""
    monkeypatch.setattr(importlib.import_module("torch.optim.adam"), "_get_capturable_supported_devices",
                        lambda supports_xla=True: ["cpu", "cuda"])


@pytest.fixture
def restore_determinism(monkeypatch):
    """The trainer's ``set_determinism`` sets process-wide flags: put them back."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", os.environ.get("CUBLAS_WORKSPACE_CONFIG", ""))
    flags = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    yield
    torch.use_deterministic_algorithms(flags[0])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[1:]


def codec_state(model, disc, capturable=None) -> tcg.CodecGanState:
    """``init_codec_gan_state``'s optimizers, ``capturable`` as given."""
    return tcg.CodecGanState(model, disc, tgan.adamw(tcg.trainable_parameters(model), LR, 0.8, 0.99,
                                                     capturable=capturable),
                             tgan.adamw(disc.parameters(), LR, 0.8, 0.99, capturable=capturable))


def torch_gan_batch(b: dict) -> dict:
    return {"mel": t(b["mel"]), "mel_lens": t(b["mel_lens"]).long(), "audio": t(b["audio"])}


def smoke_state(capturable=None) -> tcg.CodecGanState:
    """The trainer's ``--smoke`` codec (seed 0) and discriminator (seed 1)."""
    model = tcodec.init_params(ttrain.SMOKE, torch.Generator().manual_seed(0))
    disc = thg.init_hifigan(thg.Discriminator(), torch.Generator().manual_seed(1))
    return codec_state(model, disc, capturable)


def test_step_bodies_read_nothing_on_the_host(capturable_on_cpu):
    """After a warm-up step (the optimizers' state is made at their first
    step), the codec GAN body and the recipe body run under the guard, with
    the capturable optimizers the card runs; so do the trainer's segment
    log-mel and the probe's forward."""
    state = smoke_state(capturable=True)
    mc = tgan.make_mel_loss_constants()
    b = torch_gan_batch(gan_batch(2, t_mel=16))
    body = tcg.codec_gan_body(state, mc, None, 1.0, 10.0, 45.0)
    body(b["mel"], b["mel_lens"], b["audio"])
    with HostReadGuard():
        out = body(b["mel"], b["mel_lens"], b["audio"])
    assert set(out) == {"g_loss", "d_loss", "adv", "feat_match", "mel_l1"}
    assert all(v.dim() == 0 and torch.isfinite(v) for v in out.values())

    gen, disc = thg.Generator(TCFG), thg.init_hifigan(thg.Discriminator(), torch.Generator().manual_seed(1))
    thg.init_hifigan(gen, torch.Generator().manual_seed(2))
    gstate = tgan.GanTrainState(gen, disc, tgan.adamw(gen.parameters(), LR, 0.8, 0.99, capturable=True),
                                tgan.adamw(disc.parameters(), LR, 0.8, 0.99, capturable=True))
    gbody = tgan.gan_step_body(gstate, mc, None, 1.0, 10.0, 45.0)
    feats, wav = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(3)), t(audio())
    gbody(feats, wav)
    with HostReadGuard():
        assert set(gbody(feats, wav)) == {"d_loss", "d_real", "d_fake", "g_loss", "adv", "feat_match", "l1_spec"}

    seg, wav = ttrain.segment_mel(ttrain.SMOKE, 8000), t(audio(s=8000))
    with HostReadGuard():
        mel = ttrain.segment_log_mel(seg, wav)["mel"]
        y = ttrain.probe_forward(state.model, mel, torch.full((2,), mel.shape[1], dtype=torch.int64))["y"]
    assert mel.shape == (2, 50, 80) and y.shape[0] == 2 and y.shape[1] >= 8000  # the probe keeps 8000


def test_smoke_run_has_one_signature(tmp_path, monkeypatch, restore_determinism):
    """Three ``--smoke`` steps in process: one signature of the step program
    (and of the segment log-mel), each row logged as run eagerly."""
    seen = {}

    def spy(name, make):
        def wrapped(*args, **kwargs):
            seen[name] = make(*args, **kwargs)
            return seen[name]
        return wrapped

    monkeypatch.setattr(ttrain, "codec_gan_program", spy("step", ttrain.codec_gan_program))
    monkeypatch.setattr(ttrain.aot, "CapturedProgram", spy("mel", aot.CapturedProgram))
    monkeypatch.setattr(ttrain, "save_training_state", lambda path, sd: None)  # ~0.85 GB: the full discriminator
    ttrain.main(["--smoke", "--device", "cpu", "--steps", "3", "--log_every", "1", "--output_folder", str(tmp_path)])
    rows = [json.loads(line) for line in (tmp_path / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3] and {r["program"] for r in rows} == {"eager"}
    assert seen["step"].count == 1 and seen["step"].name == "codec_gan_step"
    assert seen["mel"].count == 1 and seen["mel"].name == "segment_log_mel"


def test_aot_dir_reaches_the_kernel_libraries(monkeypatch, tmp_path):
    class Stop(Exception):
        pass

    calls = []

    def use_aot_dir(path):
        calls.append(path)
        raise Stop

    monkeypatch.setattr(ttrain._cuda, "use_aot_dir", use_aot_dir)
    monkeypatch.setattr(ttrain, "set_determinism", lambda: None)
    assert ttrain.parse_args([])[1].aot_dir is None
    monkeypatch.setattr(ttrain, "resolve_device", lambda name: torch.device("cuda"))
    with pytest.raises(Stop):
        ttrain.main(["--smoke", "--aot_dir", str(tmp_path / "aot"), "--output_folder", str(tmp_path)])
    assert calls == [str(tmp_path / "aot")]
    # no kernel runs on the CPU: nothing to keep
    monkeypatch.setattr(ttrain, "resolve_device", lambda name: torch.device("cpu"))

    def seeded(seed):
        raise Stop

    monkeypatch.setattr(ttrain, "seed_everything", seeded)
    with pytest.raises(Stop):
        ttrain.main(["--smoke", "--aot_dir", str(tmp_path / "aot"), "--output_folder", str(tmp_path)])
    assert calls == [str(tmp_path / "aot")]


class StandInGraph:
    """A capture's stand-in on the CPU: its replay runs the step's body again."""

    def __init__(self, fn, args):
        self.fn, self.inputs, self.replays = fn, [a.clone() for a in args], 0

    def replay(self, args):
        self.replays += 1
        return self.fn(*args)


@pytest.fixture
def stand_in_capture(monkeypatch):
    """Programs on the CPU take the capture path: the warm-up step runs, then
    a stand-in graph is kept for the signature."""
    warmups = []

    def warm_and_capture(self, args):
        warmups.append(self.name)
        return self.fn(*args), StandInGraph(self.fn, args)

    monkeypatch.setattr(aot.CapturedProgram, "_captures", lambda self, args: self._capture)
    monkeypatch.setattr(aot.CapturedProgram, "_warm_and_capture", warm_and_capture)
    return warmups


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_gloo_group_runs_the_step_eagerly(caplog, stand_in_capture):
    """Over gloo (ranks sharing a card) the program is made with capture off,
    logged; at world size 1 its step equals the step without a group, bit
    for bit."""
    b = torch_gan_batch(gan_batch(2, t_mel=16))
    mc = tgan.make_mel_loss_constants()
    plain = smoke_state()
    want = tcg.codec_gan_step(plain, b, mc)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                                         world_size=1)
    try:
        ctx = dist.current()
        assert ctx.grouped and not dist.capturable(ctx)
        state = smoke_state()
        with caplog.at_level(logging.INFO, logger=tgan.__name__):
            got = tcg.codec_gan_step(state, b, mc, ctx)
        program = tcg.codec_gan_program(state, mc, ctx)
        assert "runs eagerly" in caplog.text and not program._capture
        assert program.source == "eager" and program.count == 1
        assert stand_in_capture == ["codec_gan_step"]  # the step without a group only
    finally:
        torch.distributed.destroy_process_group()
    assert got == want
    assert state_digest(state.state_dict()) == state_digest(plain.state_dict())
    assert dist.capturable(dist.DistContext())
