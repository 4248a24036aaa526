"""Tensor parallelism of the port (``parallel/mesh.py``) against the JAX package.

Workers are gloo CPU processes from a torchrun-style environment, as in
``tests/test_torch_dp.py``, two torch threads each, at (2 data x 2 model)
and (1 x 4).  Weights: ``test_parallel.TINY`` on ``torch_port.informative_params``
(the latent projection x30, so the codes span the FSQ levels; each check
first asserts more than one value per code group).  Each worker shards the
model (int8 copies quantised whole first) and checks against:
 - the JAX ``tokenize`` (unsharded, and once under ``pmesh.shard_params`` on
   the 8-virtual-device mesh): parity-mode TP codes equal;
 - the JAX ``detokenize``: parity-mode TP waveforms within 3e-4, the
   tolerance ``tests/test_torch_codec.py`` holds the one-process port's
   detokenize to; the kernel paths (pflash + fused LN-FFN, int8, flash +
   whole-block Vocos, the chunked and packed impls; f32 through the plain
   versions, so B2/B3/B4's partial modes and B3's cross-rank row max run)
   against the one-process port's same path: codes equal, waveforms within
   the same 3e-4;
 - the JAX dry run's ``loss_and_grads`` on its narrow geometry (batch 8 x
   104 mel frames), taken apart by the chain rule (the loss's gradient with
   respect to the reconstructed audio, then the model's VJP of it): the
   sharded loss within rtol 1e-4, and every gradient of the sharded model's
   VJP of that same cotangent within 2e-3 of max|JAX| (floor 1e-4).  The
   shared cotangent leaves out the loss's own f32 conditioning, which moves
   the whole step's gradients by ~2e-3 between any two f32 programs at this
   batch (``parallel/dryrun.py``).
``param_sharding_rules`` is checked on every key of the codec's state dict
against the JAX package's rules.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from simwhisper_codec_tpu.models import codec as jcodec
from simwhisper_codec_tpu.parallel import mesh as jmesh
from simwhisper_codec_tpu.train import step as jstep
from simwhisper_codec_tpu_torch.models.codec import SimWhisperCodec
from simwhisper_codec_tpu_torch.parallel import mesh as pmesh
from simwhisper_codec_tpu_torch.utils.checkpoint import params_from_jax

from torch_port import TINY, informative_params, n, torch_threads

MESHES = {"2x2": 2, "1x4": 4}  # label -> model axis, over 4 ranks
B, N_VALID = 4, 32000
WAVE_TOL = 3e-4
GRAD_TOL = 2e-3

WORKER = r"""
import json, sys
import numpy as np
import torch

torch.set_num_threads(2)
from simwhisper_codec_tpu_torch.models import codec as tcodec
from simwhisper_codec_tpu_torch.ops.quant import quantize_stacked_convnext, quantize_stacked_ffn
from simwhisper_codec_tpu_torch.parallel import dist, dryrun, mesh as pmesh

state_path, inputs_path, out_dir, model_axis = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
ctx = dist.init_from_env(torch.device("cpu"))
mesh = pmesh.make_mesh(model_axis=model_axis)
cfg = dryrun.narrow_config()  # test_parallel.TINY's widths


def load():
    model = tcodec.SimWhisperCodec(cfg)
    model.load_state_dict(torch.load(state_path))
    return model.eval()


whole = load()
for layers in (whole.acoustic_encoder.layers, whole.acoustic_decoder.layers):
    quantize_stacked_ffn(layers)
quantize_stacked_convnext(whole.vocos.backbone.convnext)
shard = pmesh.shard_model(whole, mesh)
inputs = np.load(inputs_path)
wav, lens = torch.from_numpy(inputs["wav"]), torch.from_numpy(inputs["lens"])
rows = pmesh.batch_rows(mesh, wav.shape[0])
f32 = {"compute_dtype": "float32"}
RUNS = {
    "parity": ({}, {}),
    "pflash-fused": (dict(f32, attn_impl="pflash", ffn_impl="fused"), {"vocos_impl": "fused"}),
    "int8": (dict(f32, attn_impl="pflash", ffn_impl="int8-fused"), {"vocos_impl": "int8"}),
    "flash-dw": (dict(f32, attn_impl="flash", ffn_impl="fused"), {"vocos_impl": "fused-dw"}),
    "chunked": (dict(f32, attn_impl="chunked:96"), {}),
    "packed": (dict(f32, attn_impl="packed"), {}),
}


def round_trip(model, tok_kw, detok_kw, tp):
    gather = (lambda t, dim=0: pmesh.gather_rows(mesh, t, dim)) if tp else (lambda t, dim=0: t)
    r = rows if tp else slice(None)
    with torch.no_grad():
        tok = tcodec.tokenize(model, wav[r], lens[r], **tok_kw)
        codes, clen = gather(tok["codes"], 1), gather(tok["codes_lengths"])
        width = int(clen.max())
        y = gather(tcodec.detokenize(model, codes[:, r], clen[r], width, **tok_kw, **detok_kw)["y"])
    return codes, y, width


results = {}
for label, (tok_kw, detok_kw) in RUNS.items():
    codes, y, width = round_trip(shard, tok_kw, detok_kw, True)
    if label == "parity" and ctx.rank == 0:
        np.savez(f"{out_dir}/parity.npz", codes=codes.numpy(), y=y.numpy(), width=width)
    if ctx.rank == 0:
        ref_codes, ref_y, _ = round_trip(whole, tok_kw, detok_kw, False)
        keep = width * 1280
        results[label] = {"codes_equal": bool(torch.equal(codes, ref_codes)),
                          "wave_err": float((y - ref_y)[:, :keep].abs().max()),
                          "finite": bool(torch.isfinite(y).all()),
                          "values_per_group": [len(torch.unique(codes[g])) for g in range(codes.shape[0])]}

batch = dryrun.make_batch(dryrun.BATCH)
cotangent = torch.from_numpy(np.load(f"{out_dir}/../cotangent.npy"))
res = dryrun.dryrun_one_config(mesh, load(), batch, torch.device("cpu"), "narrow", keep_grads=True,
                               cotangent=cotangent)
if ctx.rank == 0:
    torch.save(res.pop("grads"), f"{out_dir}/grads.pt")
    results["dryrun"] = res
    with open(f"{out_dir}/results.json", "w") as f:
        json.dump(results, f)
torch.distributed.destroy_process_group()
print("WORKER_OK", ctx.rank)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(label: str, model_axis: int, state_path, inputs_path, out_dir) -> list:
    port = _free_port()
    procs = []
    for rank in range(4):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE="4", OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER, str(state_path), str(inputs_path), str(out_dir),
                                       str(model_axis)], env=env, cwd=REPO_ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(label: str, procs: list) -> None:
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
        assert p.returncode == 0 and f"WORKER_OK {rank}" in out, f"{label} rank {rank}:\n{out[-3000:]}"


def _wav():
    rng = np.random.default_rng(0)
    wav = np.zeros((B, TINY.chunk_samples), np.float32)
    wav[:, :N_VALID] = rng.standard_normal((B, N_VALID)) * 0.1
    return wav, np.array([N_VALID, N_VALID, 21000, 9000], np.int64)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' workers, run side by side while the JAX serving references compute."""
    tmp = tmp_path_factory.mktemp("tp")
    params = informative_params()
    state_path, inputs_path = tmp / "state.pt", tmp / "inputs.npz"
    torch.save(params_from_jax(params), state_path)
    wav, lens = _wav()
    np.savez(inputs_path, wav=wav, lens=lens)
    refs = _jax_dryrun(params)
    np.save(tmp / "cotangent.npy", refs.pop("cotangent"))
    procs = {}
    for label, axis in MESHES.items():
        (tmp / label).mkdir()
        procs[label] = _start(label, axis, state_path, inputs_path, tmp / label)
    try:
        refs.update(_jax_serving(params, wav, lens))
    finally:
        for label, ps in procs.items():
            _finish(label, ps)
    out = {}
    for label in MESHES:
        d = tmp / label
        out[label] = {"results": json.loads((d / "results.json").read_text()), "parity": dict(np.load(d / "parity.npz")),
                      "grads": torch.load(d / "grads.pt")}
    return refs, out


def _jax_dryrun(params) -> dict:
    """The JAX dry run's ``loss_and_grads`` (``__graft_entry__._dryrun_one_config``)
    on its batch, by the chain rule: the loss and its audio cotangent, then
    the training forward's VJP of that cotangent (= the loss's gradients)."""
    from simwhisper_codec_tpu_torch.parallel import dryrun

    consts = jcodec.CodecConstants(TINY)
    batch = {k: jnp.asarray(v.numpy().astype(np.int32) if k.endswith("lens") else v.numpy())
             for k, v in dryrun.make_batch(dryrun.BATCH).items()}
    spec = jstep.make_spectral_consts()
    audio_fn = lambda p: jcodec.training_forward(TINY, consts, p, batch["mel"], batch["mel_lens"])["reconstructed_audio"]
    loss_fn = lambda a: jstep.reconstruction_loss(TINY, a, batch["audio"], batch["audio_lens"], spec)["loss"]

    @jax.jit
    def loss_cot_grads(p):
        audio, vjp = jax.vjp(audio_fn, p)
        loss, cot = jax.value_and_grad(loss_fn)(audio)
        return loss, cot, vjp(cot)[0]

    loss, cot, grads = loss_cot_grads(params)
    return {"loss": float(loss), "cotangent": np.asarray(cot),
            "grads": params_from_jax(jax.tree.map(np.asarray, grads))}


def _jax_serving(params, wav, lens) -> dict:
    consts = jcodec.CodecConstants(TINY)
    tok = jcodec.tokenize(TINY, consts, params, jnp.asarray(wav), jnp.asarray(lens))
    codes, clen = np.asarray(tok["codes"]), np.asarray(tok["codes_lengths"])
    mesh = jmesh.make_mesh(8, model_axis=2)
    sharded = jax.jit(lambda p, w, l: jcodec.tokenize(TINY, consts, p, w, l))(
        jmesh.shard_params(params, mesh), jnp.asarray(np.repeat(wav, 2, 0)), jnp.asarray(np.repeat(lens, 2, 0)))
    width = int(clen.max())
    det = jcodec.detokenize(TINY, consts, params, jnp.asarray(codes), jnp.asarray(clen), jnp.int32(width))
    return {"codes": codes, "sharded_codes": np.asarray(sharded["codes"])[:, ::2], "y": np.asarray(det["y"]),
            "width": width}


@pytest.mark.parametrize("label", list(MESHES))
def test_tp_tokenize_codes_equal_jax(runs, label):
    refs, out = runs
    codes = out[label]["parity"]["codes"]
    assert all(len(np.unique(codes[g])) > 1 for g in range(codes.shape[0])), "a code group holds one value"
    np.testing.assert_array_equal(refs["sharded_codes"], refs["codes"])
    np.testing.assert_array_equal(codes, refs["codes"])


@pytest.mark.parametrize("label", list(MESHES))
def test_tp_detokenize_within_one_process_tolerance(runs, label):
    refs, out = runs
    par = out[label]["parity"]
    assert int(par["width"]) == refs["width"]
    keep = refs["width"] * 1280
    np.testing.assert_allclose(par["y"][:, :keep], refs["y"][:, :keep], atol=WAVE_TOL)
    for run, r in out[label]["results"].items():
        if run == "dryrun":
            continue
        assert r["codes_equal"] and r["finite"], (run, r)
        assert min(r["values_per_group"]) > 1, (run, r)
        assert r["wave_err"] <= WAVE_TOL, (run, r)


@pytest.mark.parametrize("label", list(MESHES))
def test_tp_dryrun_narrow_matches_jax(runs, label):
    refs, out = runs
    res, grads = out[label]["results"]["dryrun"], out[label]["grads"]
    assert res["mesh"] == {"data": 4 // MESHES[label], "model": MESHES[label]}
    assert res["grad_rel_err"] < GRAD_TOL and res["replicated_max_diff"] == 0.0, res
    assert abs(res["loss"] - refs["loss"]) <= 1e-4 * abs(refs["loss"]), (res["loss"], refs["loss"])
    assert set(grads) == set(refs["grads"])
    for k, want in refs["grads"].items():
        want = n(want)
        err = float(np.max(np.abs(n(grads[k]) - want))) / max(float(np.max(np.abs(want))), 1e-4)
        assert err < GRAD_TOL, (k, err)


def test_param_sharding_rules_cover_the_state_dict():
    """Every key of the codec's state dict (and the int8 copies): the port's
    sharded dim is the JAX rule's, seen through ``params_from_jax`` (a leaf
    that varies along its sharded axis only), except the column-parallel
    biases, which the port slices with their rows (JAX replicates every
    bias); the row-parallel biases stay whole in both."""
    tree = jax.tree.map(np.asarray, jcodec.init_params(jax.random.PRNGKey(0), TINY))

    def marker(path, leaf):
        spec = jmesh.param_sharding_rules(jmesh._path_to_str(path))
        axes = [i for i, a in enumerate(spec) if a == "model"]
        if not axes:
            return np.zeros(leaf.shape, np.float32)
        shape = [1] * leaf.ndim
        shape[axes[0]] = leaf.shape[axes[0]]
        return np.broadcast_to(np.arange(leaf.shape[axes[0]], dtype=np.float32).reshape(shape), leaf.shape).copy()

    marked = params_from_jax(jax.tree_util.tree_map_with_path(marker, tree))
    keys = SimWhisperCodec(TINY).state_dict().keys()
    assert set(marked) == set(keys)
    sharded = 0
    for key in keys:
        m = marked[key]
        varies = [d for d in range(m.dim()) if bool((m != m.select(d, 0).unsqueeze(d)).any())]
        jax_dim = varies[0] if varies else None
        assert len(varies) <= 1, key
        owner, leaf = key.split(".")[-2:]
        want = 0 if owner in pmesh.COLUMN_PARALLEL and leaf == "bias" else jax_dim
        assert pmesh.param_sharding_rules(key) == want, (key, pmesh.param_sharding_rules(key), jax_dim)
        sharded += want is not None
    layers = TINY.acoustic_encoder.encoder_layers + TINY.acoustic_decoder.decoder_layers
    assert sharded == layers * 9 + TINY.vocos.num_layers * 3  # q, k, v, out, fc1, fc2 weights + q, v, fc1 biases
    for name, dim in (("fc1_q", 0), ("fc1_s", 0), ("fc2_q", 1), ("fc2_s", None), ("pw1_q", 0), ("pw1_s", 0),
                      ("pw2_q", 1), ("pw2_s", None)):
        assert pmesh.param_sharding_rules(f"acoustic_decoder.layers.0.{name}") == dim, name


def test_make_mesh_and_shard_model_on_one_rank():
    """A world of one: the trivial mesh, ``shard_model`` returns the model
    itself, and the JAX message for a world the model axis does not divide."""
    mesh = pmesh.make_mesh()
    assert (mesh.data_size, mesh.model_size, mesh.model_group, mesh.data_group) == (1, 1, None, None)
    model = SimWhisperCodec(TINY)
    assert pmesh.shard_model(model, mesh) is model
    with pytest.raises(ValueError, match="not divisible by model_axis"):
        pmesh.make_mesh(6, model_axis=4)
    with torch_threads():
        half = pmesh.shard(torch.arange(12.0).reshape(3, 4), 1, pmesh.Mesh(1, 2, 0, 1))
    assert half.tolist() == [[2.0, 3.0], [6.0, 7.0], [10.0, 11.0]]
