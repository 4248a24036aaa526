#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``simwhisper_codec_tpu_torch``) on one GPU.

Phases, any failure exits non-zero:
  1. build the CUDA kernels of ``simwhisper_codec_tpu_torch/csrc`` with nvcc (sm_90a);
  2. hold each kernel against its plain PyTorch version at the main path's
     shapes (batch 8, bf16) and time kernel, plain version and, where one
     exists, a single PyTorch library call computing the same function;
  3. run full-width random weights (config/SimWhisperCodec.yaml, fixed seed)
     through ``AudioCodec.encode`` + ``decode`` in parity, fast and fast-int8,
     with launch counts read around each mode's run;
  4. start the port's HTTP server (fast-int8) and send it requests;
  5. print the kernel table, the GPU's name and power limit, and the result.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import http.client
import json
import socket
import subprocess
import sys
import time

import numpy as np

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12
H100_BYTES_PER_S = 3.35e12
UTTERANCE_SECONDS = (4.0, 17.0, 41.0)  # 41 s crosses the 20 s chunk stride twice


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, peak: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(torch, name, got, want, atol, rtol=1.6e-2) -> float:
    """Raise unless the kernel's output is finite and |got - want| <= atol + rtol |want|
    everywhere; returns the max |got - want|."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    excess = float((err - (atol + rtol * want.float().abs())).max())
    finite = bool(torch.isfinite(got).all())
    log(f"[kernel] {name}: max_abs_err={max_err:.4g} mean_abs_err={float(err.mean()):.3g} "
        f"(tolerance |d| <= {atol} + {rtol}*|plain|), worst excess={excess:.4g}, finite={finite}")
    if not finite or excess > 0:
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_err


def check_kernel(torch, name, kernel, plain, args, atol, rtol, flops, peak, nbytes, replaces, source,
                 library=None, iters=20):
    max_err = compare(torch, name, kernel(*args), plain(*args), atol, rtol)
    ms = time_ms(torch, lambda: kernel(*args), iters)
    plain_ms = time_ms(torch, lambda: plain(*args), max(2, iters // 4))
    lib_ms = time_ms(torch, library, iters) if library is not None else None
    b_ms, b_by = bound_ms(flops, peak, nbytes)
    log(f"[kernel] {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms}, "
        f"bound {b_ms:.4f} ms ({b_by}), flops={flops:.4g}, bytes={nbytes:.4g}")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": 0,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def kernel_phase(torch):
    from simwhisper_codec_tpu_torch.ops import flash_attention as fa
    from simwhisper_codec_tpu_torch.ops import fused_convnext as fc
    from simwhisper_codec_tpu_torch.ops.quant import quantize_weight

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype).to(dev)

    rows = []
    # B1: encoder/decoder attention core, B = 8, T = 1500, 12 heads of 64
    b, t, h, hd = 8, 1500, 12, 64
    d = h * hd
    qkv = randn(b, t, 3 * d)
    qkv[..., :d] *= hd ** -0.5  # q arrives pre-scaled
    lengths = torch.tensor([1500, 1500, 1211, 900, 640, 333, 17, 0], dtype=torch.int32, device=dev)
    kv = [int(n) if n > 0 else t for n in lengths.tolist()]
    flops = sum(4.0 * h * t * n * hd for n in kv)
    nbytes = qkv.numel() * 2 + b * t * d * 2 + lengths.numel() * 4
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, t, h, hd).transpose(1, 2) for i in range(3))
    key_mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=key_mask)
    rows.append(check_kernel(torch, "pflash_attention", fa.fused_qkv_attention, fa.fused_qkv_attention_plain,
                             (qkv, lengths, h), 1e-2, 1.6e-2, flops, H100_BF16_FLOPS, nbytes,
                             "simwhisper_codec_tpu/ops/flash_attention.py:162", "simwhisper_codec_tpu_torch/csrc/pflash.cu",
                             library=sdpa))

    # Tolerances: bf16 outputs are compared as |d| <= atol + 1.6e-2 |plain|
    # (1.6e-2 is two bf16 half-ulps).  For int8 the atol is wider: LN sums in
    # another order can flip one activation's int8 rounding, which moves h by
    # one quantisation step times a weight and so flips a few per cent of
    # that row's second-stage roundings (measured worst case 0.0156 on the
    # H100 at the transformer shape).
    # B2 and B3 at the transformer FFN shape (residual = x, gamma = 1) and the
    # Vocos ConvNeXt shape (residual != x, gamma = layer scale)
    for (m, c, inter, eps, vocos) in ((8 * 1500, 768, 3072, 1e-5, False), (8 * 3000, 512, 4096, 1e-6, True)):
        x = randn(m, c)
        res = randn(m, c) if vocos else x
        ln_w, ln_b = randn(c, scale=0.1) + 1.0, randn(c, scale=0.1)
        w1 = randn(inter, c, scale=c ** -0.5, dtype=torch.float32)
        w2 = randn(c, inter, scale=inter ** -0.5, dtype=torch.float32)
        b1, b2 = randn(inter, scale=0.02), randn(c, scale=0.02)
        gamma = randn(c, scale=0.01) + 1.0 / 24 if vocos else None
        w1b, w2b = w1.to(bf), w2.to(bf)
        act_bytes = (3 if vocos else 2) * m * c * 2
        ops = 4.0 * m * c * inter
        shape = f"{c}x{inter}"
        rows.append(check_kernel(torch, f"ln_ffn_bf16:{shape}", fc.fused_ln_ffn, fc.fused_ln_ffn_plain,
                                 (x, res, ln_w, ln_b, w1b, b1, w2b, b2, gamma, eps), 1e-2, 1.6e-2, ops,
                                 H100_BF16_FLOPS, act_bytes + 2 * c * inter * 2 + (2 * c + inter) * 2,
                                 "simwhisper_codec_tpu/ops/fused_convnext.py:38",
                                 "simwhisper_codec_tpu_torch/csrc/ln_ffn.cu", iters=10))
        w1q, s1 = quantize_weight(w1)
        w2q, s2 = quantize_weight(w2)
        rows.append(check_kernel(torch, f"ln_ffn_int8:{shape}", fc.fused_ln_ffn_int8, fc.fused_ln_ffn_int8_plain,
                                 (x, res, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, gamma, eps), 4e-2, 1.6e-2, ops,
                                 H100_INT8_OPS, act_bytes + 2 * c * inter + (inter + c) * 4 + (2 * c + inter) * 2,
                                 "simwhisper_codec_tpu/ops/fused_convnext.py:296",
                                 "simwhisper_codec_tpu_torch/csrc/ln_ffn_int8.cu", iters=10))
    check_other_shapes(torch, randn, fa, fc, quantize_weight)
    return rows


def check_other_shapes(torch, randn, fa, fc, quantize_weight):
    """The kernels' other instantiations (head dims 16/32/128, narrow C, ragged
    M) against their plain versions at small shapes; no timing."""
    dev = torch.device("cuda")
    agree = lambda name, got, want, atol: compare(torch, name, got, want, atol)
    lengths = torch.tensor([203, 77, 0], dtype=torch.int32, device=dev)
    for hd in (16, 32, 128):
        qkv = randn(3, 203, 3 * 4 * hd)
        args = (qkv, lengths, 4)
        agree(f"pflash_attention hd={hd}", fa.fused_qkv_attention(*args), fa.fused_qkv_attention_plain(*args), 1e-2)
    for c, inter in ((64, 128), (256, 192)):
        x, res = randn(301, c), randn(301, c)
        w1 = randn(inter * 2, c, scale=c ** -0.5, dtype=torch.float32)[:inter]
        w2 = randn(c, inter, scale=inter ** -0.5, dtype=torch.float32)
        vecs = (randn(c) + 1.0, randn(c, scale=0.1), randn(inter, scale=0.02), randn(c, scale=0.02), randn(c))
        args = (x, res, vecs[0], vecs[1], w1.to(torch.bfloat16), vecs[2], w2.to(torch.bfloat16), vecs[3], vecs[4], 1e-6)
        agree(f"ln_ffn_bf16:{c}x{inter}", fc.fused_ln_ffn(*args), fc.fused_ln_ffn_plain(*args), 1e-2)
        if inter % 64 == 0:
            (w1q, s1), (w2q, s2) = quantize_weight(w1.contiguous()), quantize_weight(w2)
            args = (x, res, vecs[0], vecs[1], w1q, s1, vecs[2], w2q, s2, vecs[3], vecs[4], 1e-6)
            agree(f"ln_ffn_int8:{c}x{inter}", fc.fused_ln_ffn_int8(*args), fc.fused_ln_ffn_int8_plain(*args), 4e-2)


def expected_launches(mode: str, cfg, n_tok: int, n_detok: int) -> dict:
    enc, dec, voc = cfg.acoustic_encoder, cfg.acoustic_decoder, cfg.vocos
    tshape = f"{enc.d_model}x{enc.encoder_ffn_dim}"
    vshape = f"{voc.dim}x{voc.intermediate_dim}"
    if mode == "parity":
        return {}
    want = {"pflash_attention": n_tok * enc.encoder_layers + n_detok * dec.decoder_layers}
    if mode == "fast":
        want[f"ln_ffn_bf16:{tshape}"] = n_tok * enc.encoder_layers + n_detok * dec.decoder_layers
        want[f"ln_ffn_bf16:{vshape}"] = n_detok * voc.num_layers
    else:
        want[f"ln_ffn_bf16:{tshape}"] = n_tok * enc.encoder_layers
        want[f"ln_ffn_int8:{tshape}"] = n_detok * dec.decoder_layers
        want[f"ln_ffn_int8:{vshape}"] = n_detok * voc.num_layers
    return want


def codec_phase(torch):
    from simwhisper_codec_tpu_torch.config import load_config
    from simwhisper_codec_tpu_torch.models.codec import AudioCodec, init_params
    from simwhisper_codec_tpu_torch.ops import _cuda

    cfg = load_config("config/SimWhisperCodec.yaml")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator().manual_seed(0))
    log(f"[codec] full-width random weights: {sum(p.numel() for p in model.parameters())} parameters, "
        f"init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    sr = cfg.input_sample_rate
    utts = [(rng.standard_normal(int(s * sr)) * 0.1).astype(np.float32) for s in UTTERANCE_SECONDS]
    batch = rng.standard_normal((8, cfg.chunk_samples)).astype(np.float32) * 0.1
    n_chunks = lambda n, stride: -(-n // stride)
    longest = max(len(u) for u in utts)
    n_tok = n_chunks(longest, (cfg.max_audio_seconds - 10) * sr)
    n_detok = n_chunks(longest // cfg.encoder_downsample_rate, (cfg.max_audio_seconds - 10) * sr // cfg.encoder_downsample_rate)

    results, codes_by_mode, launches_by_mode = {}, {}, {}
    for mode in ("parity", "fast", "fast-int8"):
        codec = AudioCodec(cfg, model, batch_size=8, mode=mode, device="cuda")
        codec.decode(codec.encode([utts[0][:sr]])["codes_list"])  # warm-up, not counted
        # stage times on one full batch of 8 x 30 s
        stage = {}
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok = codec.inference_tokenize(batch, np.full(8, cfg.chunk_samples))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            codec.inference_detokenize(tok["codes"].cpu().numpy(), tok["codes_lengths"].cpu().numpy())
            torch.cuda.synchronize()
            stage = {"tokenize_ms": (t1 - t0) * 1e3, "detokenize_ms": (time.perf_counter() - t1) * 1e3}
        # the main path: chunked encode + decode of the utterances
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = codec.encode(utts)["codes_list"]
        dec = codec.decode(enc)["syn_wav_list"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.launch_counts)
        for u, c, y in zip(utts, enc, dec):
            n = len(u) // cfg.encoder_downsample_rate
            assert c.shape == (cfg.quantizer.num_groups, n), (mode, c.shape)
            assert y.shape == (n * cfg.decoder_upsample_rate,), (mode, y.shape)
            assert np.isfinite(y).all(), f"{mode}: non-finite waveform"
        want = expected_launches(mode, cfg, n_tok, n_detok)
        assert launches == want, f"{mode}: launches {launches} != expected {want}"
        batch_rt = 8 * cfg.max_audio_seconds / ((stage["tokenize_ms"] + stage["detokenize_ms"]) / 1e3)
        results[mode] = {"round_trip_x_real_time": sum(UTTERANCE_SECONDS) / wall, "wall_s": wall,
                         "batch8_x_real_time": batch_rt, **stage, "launches": launches}
        codes_by_mode[mode] = enc
        launches_by_mode[mode] = launches
        log(f"[codec] {mode}: {json.dumps(results[mode])}")
    for a, b in zip(codes_by_mode["fast-int8"], codes_by_mode["fast"]):
        assert np.array_equal(a, b), "fast-int8 codes differ from fast codes"
    agree = float(np.mean(np.concatenate([(a == b).ravel() for a, b in
                                          zip(codes_by_mode["fast"], codes_by_mode["parity"])])))
    log(f"[codec] fast-int8 codes == fast codes; fast vs parity code agreement {agree:.4f}")
    return launches_by_mode


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def request(port, method, path, body=None, headers=None, timeout=300):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def serve_phase():
    port = free_port()
    proc = subprocess.Popen([sys.executable, "-m", "simwhisper_codec_tpu_torch.serve", "--port", str(port),
                             "--mode", "fast-int8", "--max_body_mb", "1"])
    try:
        deadline = time.time() + 300
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"server exited with {proc.returncode}")
            try:
                status, _, _ = request(port, "GET", "/healthz", timeout=5)
                if status == 200:
                    break
            except OSError:
                pass
            if time.time() > deadline:
                raise TimeoutError("server did not come up")
            time.sleep(1)
        wav = (np.random.default_rng(3).standard_normal(3 * 16000) * 0.1).astype(np.float32)
        status, hdr, body = request(port, "POST", "/encode", wav.tobytes())
        assert status == 200, (status, body[:200])
        shape = tuple(int(v) for v in hdr["X-Code-Shape"].split(","))
        assert shape == (8, len(wav) // 1280), shape
        codes = np.frombuffer(body, np.int32).reshape(shape)
        status, _, body = request(port, "POST", "/decode", codes.tobytes(), {"X-Code-Shape": f"{shape[0]},{shape[1]}"})
        out = np.frombuffer(body, np.float32)
        assert status == 200 and out.shape == (shape[1] * 1280,) and np.isfinite(out).all(), (status, out.shape)
        status, _, body = request(port, "POST", "/reconstruct", wav.tobytes())
        out2 = np.frombuffer(body, np.float32)
        assert status == 200 and out2.shape == out.shape and np.isfinite(out2).all(), (status, out2.shape)
        # a body over the 1 MiB cap is refused from its Content-Length alone,
        # so only the headers are sent (the server never reads the body)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.putrequest("POST", "/encode")
            conn.putheader("Content-Length", str(2 << 20))
            conn.endheaders()
            status = conn.getresponse().status
        finally:
            conn.close()
        assert status == 413, status
        status, _, body = request(port, "GET", "/healthz")
        health = json.loads(body)
        assert status == 200 and health["served"] >= 3, health
        log(f"[serve] /encode {shape}, /decode {out.shape}, /reconstruct {out2.shape}, 413 on a 2 MiB body, "
            f"/healthz {health}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from simwhisper_codec_tpu_torch.ops import _cuda

    log(f"[gpu] {gpu_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[build] kernels built in {_cuda.build_kernels():.1f} s")
    rows = kernel_phase(torch)
    launches = codec_phase(torch)
    for row in rows:  # launches on the serving default's path, else on fast mode's
        row["launches"] = launches["fast-int8"].get(row["name"]) or launches["fast"].get(row["name"], 0)
        row["launches_by_mode"] = {m: launches[m].get(row["name"], 0) for m in launches}
    serve_phase()
    print(gpu_line())  # name and power limit, as nvidia-smi prints them
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
