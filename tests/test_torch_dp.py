"""Data parallelism of the port over ``torch.distributed`` (gloo, two CPU
processes), mirroring ``tests/test_multiprocess_train.py`` and
``test_parallel.py::test_data_parallel_codec_matches_single``.

Each worker joins the group from a torchrun-style environment
(``parallel.dist.init_from_env``), then compares against a single-process
run over the full batch in the same process:
 - one ``train/step.py`` step on its half of a batch of 4: loss within rtol
   1e-4, every averaged gradient per tensor max|d| / max(|ref|, 1e-4) <=
   1.5e-3 (the JAX package's multichip tolerance);
 - ``AudioCodec(data_parallel=True)`` encode / decode of three utterances
   (a batch of 3 is padded to a multiple of the world size): codes equal,
   waveforms within 1e-5, as the JAX test holds them.
Weights: the port's ``init_params(TINY)`` with the latent projection scaled
to a unit-variance latent (see ``torch_port.informative_params``).
"""

import json
import os
import socket
import subprocess
import sys

from conftest import REPO_ROOT

WORKER = r"""
import copy, json, sys
import numpy as np
import torch

from simwhisper_codec_tpu_torch.experiments.codec.train import SMOKE as TINY  # test_parallel.TINY's widths
from simwhisper_codec_tpu_torch.models.codec import AudioCodec, init_params
from simwhisper_codec_tpu_torch.parallel import dist
from simwhisper_codec_tpu_torch.train import step as tstep

out_path = sys.argv[1]
ctx = dist.init_from_env(torch.device("cpu"))
assert ctx.grouped and ctx.world_size == 2, ctx

cfg = TINY
model = init_params(cfg, torch.Generator().manual_seed(0))
with torch.no_grad():
    model.downsample.to_latent.weight.mul_(30.0)

B, t_mel = 4, 104
rng_m, rng_a = np.random.default_rng(0), np.random.default_rng(1)
full = {"mel": torch.from_numpy(rng_m.standard_normal((B, t_mel, 80)).astype(np.float32)),
        "mel_lens": torch.full((B,), t_mel, dtype=torch.int64),
        "audio": torch.from_numpy((rng_a.standard_normal((B, t_mel * 160)) * 0.1).astype(np.float32)),
        "audio_lens": torch.full((B,), t_mel * 160, dtype=torch.int64)}
spec = tstep.make_spectral_consts()

ref_state = tstep.TrainState(copy.deepcopy(model), None)
ref_state.opt = tstep.make_optimizer(ref_state.model)
ref = tstep.train_step(ref_state, full, spec)
dp_state = tstep.TrainState(copy.deepcopy(model), None)
dp_state.opt = tstep.make_optimizer(dp_state.model)
rows = ctx.rows(B)
got = tstep.train_step(dp_state, {k: v[rows] for k, v in full.items()}, spec, ctx)
ref_grads = {k: p.grad for k, p in ref_state.model.named_parameters() if p.grad is not None}
worst, worst_key = 0.0, ""
for k, p in dp_state.model.named_parameters():
    if p.grad is None:
        continue
    err = float((p.grad - ref_grads[k]).abs().max()) / max(float(ref_grads[k].abs().max()), 1e-4)
    if err > worst:
        worst, worst_key = err, k
n_grads = sum(1 for p in dp_state.model.parameters() if p.grad is not None)

rng = np.random.default_rng(1)
wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (40000, 33000, 21000)]
single = AudioCodec(cfg, copy.deepcopy(model), device="cpu")
dpc = AudioCodec(cfg, copy.deepcopy(model), device="cpu", data_parallel=True)
enc_s = single.encode(wavs)["codes_list"]
enc_d = dpc.encode(wavs)["codes_list"]
dec_s = single.decode(enc_s)["syn_wav_list"]
dec_d = dpc.decode(enc_s)["syn_wav_list"]
codes_equal = all(np.array_equal(a, b) for a, b in zip(enc_s, enc_d))
wave_err = max(float(np.abs(a - b).max()) for a, b in zip(dec_s, dec_d))
shapes_equal = all(a.shape == b.shape for a, b in zip(dec_s, dec_d))
distinct = len(np.unique(np.concatenate([c.ravel() for c in enc_s])))

with open(out_path, "w") as f:
    json.dump({"ref_loss": ref["loss"], "dp_loss": got["loss"], "grad_rel_err": worst, "worst": worst_key,
               "n_grads": n_grads, "codes_equal": codes_equal, "wave_err": wave_err,
               "shapes_equal": shapes_equal, "distinct_codes": distinct}, f)
torch.distributed.destroy_process_group()
print("WORKER_OK", ctx.rank)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_dp_matches_single(tmp_path):
    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE="2", OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER, str(tmp_path / f"dp{rank}.json")], env=env,
                                      cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:  # each worker has its own time limit, so a hang fails the test
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {rank}" in out, f"rank {rank}:\n{out[-3000:]}"
    results = [json.loads((tmp_path / f"dp{rank}.json").read_text()) for rank in (0, 1)]
    for r in results:
        assert abs(r["dp_loss"] - r["ref_loss"]) <= 1e-4 * abs(r["ref_loss"]), r
        assert r["grad_rel_err"] <= 1.5e-3 and r["n_grads"] > 0, r
        assert r["codes_equal"] and r["shapes_equal"] and r["wave_err"] <= 1e-5, r
        assert r["distinct_codes"] > 1, r
    assert results[0]["dp_loss"] == results[1]["dp_loss"]
