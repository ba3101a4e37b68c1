#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``vae_npvc_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU and ``nvcc``; imports no JAX. It builds the port's CUDA
kernels from ``vae_npvc_tpu_torch/csrc``, holds each against its plain
PyTorch version, holds the port's ``Converter`` against the committed JAX
golden fixture, then serves conversion requests over HTTP with the flagship
flat EMA VQ-VAE (``egs/vcc20/vae1/conf/train_vqvae.yaml`` widths, bf16,
seeded random weights), checks the kernels ran on that path, and holds the
served weights in fp32 at a full 512-frame batch on the card against the
same weights on the CPU. Each phase
prints one JSON line; any failure exits non-zero. The last lines are the
kernel summary, the card's name and power limit as ``nvidia-smi`` gives
them, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "torch_port_fixtures"

# model keys of egs/vcc20/vae1/conf/train_vqvae.yaml (the GPU host has no
# YAML parser; tests/test_torch_port_io.py checks this equals the file)
FLAGSHIP = {
    "model_type": "vae_npvc.model.vqvae",
    "y_dim": 128, "y_num": 117, "z_dim": 128, "z_num": 512,
    "use_ema": True, "beta": 0.01, "mu": 0.9, "jitter_p": 0.0,
    "encoder": {"in_channels": [80], "out_channels": [512], "kernel_size": 3,
                "downsample_scales": [1], "z_channels": 128,
                "dilation": False, "stack_kernel_size": 3, "stack_layers": 1,
                "stacks": [10], "use_weight_norm": True},
    "decoder": {"in_channels": [128], "out_channels": [512],
                "cond_channels": 128, "skip_channels": 128,
                "final_channels": 80, "kernel_size": 3,
                "upsample_scales": [1], "dilation": False,
                "stack_kernel_size": 3, "stacks": [10],
                "use_weight_norm": True},
    "compute_dtype": "bfloat16",
    "decode_bucket_size": 256,
    "decode_batch_size": 8,
}

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and fp32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# twice the H100's 50 MB L2: inputs cycled through this much come from HBM
L2_COLD_BYTES = 100 * 2 ** 20

K2_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 2 ** -6)}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def timed(torch, fn, arg_sets, iters=50, warmup=3):
    """``(device_ms, events_ms)`` of one ``fn(*args)`` call, averaged over
    ``iters`` back-to-back calls that cycle through ``arg_sets``.
    ``device_ms`` sums the durations of the kernels the call ran
    (torch.profiler); ``events_ms`` is the CUDA-event time between the first
    and last call, which also counts the gaps while the host issues launches
    (a small kernel is host-bound there). One argument set keeps the inputs
    hot in L2, as on the serving path; :func:`l2_cold` sets keep them cold."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    events_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / iters / 1e3, events_ms


def l2_cold(args, iters=53):
    """Copies of the tensors in ``args``, enough that more than
    ``L2_COLD_BYTES`` pass between two uses of one copy: each call of
    :func:`timed` then reads its inputs from HBM, as the bound assumes."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if hasattr(a, "numel"))
    n = min(iters, -(-L2_COLD_BYTES // nbytes))
    return [tuple(a.clone() if hasattr(a, "clone") else a for a in args)
            for _ in range(n)]


def vq_bound_ms(N, K, D):
    """Least time for the ids-only VQ: max(bytes, fp32 operations)."""
    byt = 4 * (N * D + K * D + N)
    ops = 2 * N * K * D
    return max(byt / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3, (
        "bytes" if byt / HBM_BYTES_PER_S > ops / FP32_OPS_PER_S
        else "operations")


def gn_bound_ms(B, T, C, itemsize, glu):
    """Least time for GroupNorm(+GLU): one read of x, one write of the
    output, ~8 fp32 operations per input element (+4 per GLU output)."""
    byt = B * T * C * itemsize + B * T * (C // 2 if glu else C) * itemsize \
        + 8 * C + 4 * B
    ops = 8 * B * T * C + (4 * B * T * C // 2 if glu else 0)
    return max(byt / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3, (
        "bytes" if byt / HBM_BYTES_PER_S > ops / FP32_OPS_PER_S
        else "operations")


# ------------------------------------------------------------------ phases
def phase_build(torch):
    from vae_npvc_tpu_torch.ops import _build

    t0 = time.monotonic()
    libs = _build.build_all()
    build_s = time.monotonic() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "build", "seconds": round(build_s, 3),
          "libraries": sorted(libs), "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def _vq_case(torch, N, stats, rng):
    from vae_npvc_tpu_torch.ops.vq_fused import vq_fused, vq_fused_plain

    dev = torch.device("cuda")
    K, D = 512, 128
    z = torch.tensor(rng.normal(size=(N, D)), dtype=torch.float32,
                     device=dev)
    emb = torch.tensor(rng.normal(size=(K, D)), dtype=torch.float32,
                       device=dev)
    got = vq_fused(z, emb, stats=stats)
    ref = vq_fused_plain(z, emb, stats=stats)
    torch.cuda.synchronize()
    d64 = (emb.double() ** 2).sum(1)[None] - 2 * z.double() @ emb.double().T
    top2 = torch.topk(d64, 2, dim=1, largest=False).values
    clear = (top2[:, 1] - top2[:, 0]) > 1e-5 * top2[:, 0].abs().clamp(min=1)
    check(torch.equal(got.idx[clear], ref.idx[clear]),
          f"vq_fused N={N}: ids differ from the plain version")
    rows = torch.arange(N, device=dev)
    # distance lost by the kernel's choice against the plain one (0 when
    # the ids agree; near ties may differ by rounding)
    err = (d64[rows, got.idx.long()] - d64[rows, ref.idx.long()]).abs().max()
    case = {"N": N, "K": K, "D": D, "mode": "stats" if stats else "ids",
            "near_ties": int((~clear).sum()),
            "ids_differ": int((got.idx != ref.idx).sum()),
            "max_abs_err": float(err)}
    if stats:
        same = got.idx == ref.idx
        check(torch.equal(got.z_q[same], ref.z_q[same]),
              f"vq_fused N={N}: z_q differs from the gathered codes")
        ids = got.idx.long()
        check(torch.equal(got.batch_elem,
                          torch.bincount(ids, minlength=K).float()),
              f"vq_fused N={N}: counts are not exact")
        exact = torch.zeros((K, D), dtype=torch.float64, device=dev) \
            .index_add_(0, ids, z.double())
        scale = torch.zeros((K, D), dtype=torch.float64, device=dev) \
            .index_add_(0, ids, z.double().abs())
        sum_err = (got.batch_sum.double() - exact).abs()
        check(bool((sum_err <= 1e-5 * scale + 1e-6).all()),
              f"vq_fused N={N}: sums beyond 1e-5 of sum|z|")
        case["sum_max_abs_err"] = float(sum_err.max())
    case["ms"], case["ms_events"] = timed(
        torch, lambda z, e: vq_fused(z, e, stats=stats), [(z, emb)])
    case["ms_l2_cold"], _ = timed(
        torch, lambda z, e: vq_fused(z, e, stats=stats), l2_cold((z, emb)))
    case["plain_ms"], case["plain_ms_events"] = timed(
        torch, lambda z, e: vq_fused_plain(z, e, stats=stats), [(z, emb)])
    case["library_ms"] = None
    if not stats:
        case["bound_ms"], case["bound_by"] = vq_bound_ms(N, K, D)
    return case


def _gn_case(torch, B, T, C, G, glu, masked, dtype, rng):
    """``masked``: False, True (lengths spread from T down to 1) or a list
    of lengths."""
    import torch.nn.functional as F

    from vae_npvc_tpu_torch.ops.groupnorm import (fused_group_norm,
                                                  group_norm_plain)

    dev = torch.device("cuda")
    x = torch.tensor(rng.normal(0.5, 2.0, size=(B, T, C)), device=dev) \
        .to(dtype)
    scale = torch.tensor(rng.normal(1.0, 0.2, size=C), dtype=torch.float32,
                         device=dev)
    bias = torch.tensor(rng.normal(0.0, 0.2, size=C), dtype=torch.float32,
                        device=dev)
    lengths = None
    if masked is True:
        masked = np.linspace(T, 1, B).round().astype(np.int32).tolist()
    if masked:
        lengths = torch.tensor(masked, dtype=torch.int32, device=dev)
    got = fused_group_norm(x, scale, bias, G, lengths=lengths, glu=glu)
    ref = group_norm_plain(x, scale, bias, G, lengths=lengths, glu=glu)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    atol, rtol = K2_TOL[name]
    err = (got.float() - ref.float()).abs()
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          "fused_group_norm: shape/dtype differ from the plain version")
    check(bool((err <= atol + rtol * ref.float().abs()).all()),
          f"fused_group_norm {B}x{T}x{C} G={G} glu={glu} masked={masked} "
          f"{name}: max err {float(err.max())} beyond atol {atol} rtol {rtol}")
    case = {"B": B, "T": T, "C": C, "G": G, "glu": glu, "masked": masked,
            "dtype": name, "max_abs_err": float(err.max()),
            "atol": atol, "rtol": rtol}
    args = (x, scale, bias, lengths)

    def kernel(x, s, b, n):
        return fused_group_norm(x, s, b, G, lengths=n, glu=glu)

    case["ms"], case["ms_events"] = timed(torch, kernel, [args])
    case["ms_l2_cold"], _ = timed(torch, kernel, l2_cold(args))
    case["plain_ms"], case["plain_ms_events"] = timed(
        torch, lambda x, s, b, n: group_norm_plain(x, s, b, G, lengths=n,
                                                   glu=glu), [args])
    case["library_ms"] = None
    if not masked and not glu:
        xt, s, b = x.transpose(1, 2), scale.to(dtype), bias.to(dtype)
        case["library_ms"], case["library_ms_events"] = timed(
            torch, lambda x, s, b: F.group_norm(x, G, s, b, 1e-5),
            [(xt, s, b)])
    case["bound_ms"], case["bound_by"] = gn_bound_ms(
        B, T, C, x.element_size(), glu)
    return case


def phase_kernels(torch):
    rng = np.random.default_rng(0)
    # ids mode at the serving path's row counts: B=8 x bucket 256, B=8 x
    # bucket 512 (its last codebook split is empty), one 256-frame request;
    # stats mode at the training shape and a ragged N
    vq = [_vq_case(torch, 8 * 256, False, rng),
          _vq_case(torch, 8 * 512, False, rng),
          _vq_case(torch, 256, False, rng),
          _vq_case(torch, 32768, True, rng),
          _vq_case(torch, 20011, True, rng)]
    gn = []
    for dtype in (torch.float32, torch.bfloat16):
        for masked in (False, True):
            for C, G, glu in ((512, 1, False), (1024, 2, True)):
                gn.append(_gn_case(torch, 8, 256, C, G, glu, masked, dtype,
                                   rng))
    # the 512-frame bucket: a full decoder batch and one encoder request
    gn.append(_gn_case(torch, 8, 512, 1024, 2, True, True, torch.bfloat16,
                       rng))
    gn.append(_gn_case(torch, 1, 512, 512, 1, False, [397], torch.bfloat16,
                       rng))
    emit({"phase": "kernels", "vq_fused": vq, "fused_group_norm": gn})
    return vq, gn


def phase_golden(torch):
    from vae_npvc_tpu_torch.infer.convert import Converter

    cfg = json.loads((FIXTURES / "golden_config.json").read_text())
    g = np.load(FIXTURES / "golden.npz")
    cv = Converter(cfg, device="cuda")
    cv.load_checkpoint(FIXTURES / "golden.msgpack")
    mel = cv.infer(g["feats"], g["tgts"], g["lengths"])
    with torch.inference_mode():
        ids = cv.model.encode(
            torch.as_tensor(g["feats"], device=cv.device),
            torch.as_tensor(g["lengths"], device=cv.device)).cpu().numpy()
    id_diff, mel_err = 0, 0.0
    for b, n in enumerate(g["lengths"]):
        id_diff += int((ids[b, :n] != g["ids"][b, :n]).sum())
        mel_err = max(mel_err, float(np.abs(mel[b, :n]
                                            - g["mel"][b, :n]).max()))
    check(id_diff == 0, f"golden: {id_diff} ids differ from JAX")
    check(mel_err <= 1e-4, f"golden: mel differs from JAX by {mel_err}")
    emit({"phase": "golden", "ids_differ": id_diff, "mel_max_abs_err": mel_err,
          "tolerance": 1e-4, "frames": int(g["lengths"].sum())})


def _random_checkpoint(torch, path, seed=0):
    """Seeded random flagship weights in the JAX checkpoint format, written
    by the port's msgpack writer. The codebook is a seeded normal at the
    scale of the encoder's output (a fresh EMA codebook is all zeros)."""
    from vae_npvc_tpu_torch.models import build_model
    from vae_npvc_tpu_torch.utils import msgpack_io
    from vae_npvc_tpu_torch.utils.bridge import to_jax_variables

    model = build_model(FLAGSHIP, device="cpu", dtype=torch.float32)
    model.init_random(seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        z = model.encoder(torch.tensor(rng.normal(size=(2, 64, 80)),
                                       dtype=torch.float32))
        q = model.quantizer
        q.emb.copy_(torch.tensor(rng.normal(size=q.emb.shape)) * z.std())
        q.emb_sum.copy_(q.emb)
        q.initted.fill_(True)
    v = to_jax_variables(model.state_dict())
    payload = {"model": v["params"], "ema": {"ema": v["ema"]},
               "optimizer": {}, "iteration": 0, "wn_axis_format": 2}
    Path(path).write_bytes(msgpack_io.msgpack_serialize(payload))


def _speechlike(n, fs, seed):
    """Harmonic tone with a moving pitch plus noise, int16-safe scale."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.7 * t + seed)
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = sum(np.sin(k * phase) / k for k in range(1, 8))
    return (0.2 * x / np.abs(x).max() + 0.01 * rng.normal(size=n)) \
        .astype(np.float32)


def phase_serve(torch):
    from scipy.io import wavfile

    from vae_npvc_tpu_torch.bin.serve import serve
    from vae_npvc_tpu_torch.ops.groupnorm import fused_group_norm
    from vae_npvc_tpu_torch.ops.vq_fused import vq_fused
    from vae_npvc_tpu_torch.serve import ConversionEngine

    fs, shift, D = 24000, 256, 80
    stats = np.zeros((2, D + 1), np.float64)   # log-mel-like CMVN stats
    stats[0, :-1] = -3.0 * 1000
    stats[0, -1] = 1000
    stats[1, :-1] = (1.0 + 3.0 ** 2) * 1000
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "flagship.msgpack"
        _random_checkpoint(torch, ckpt)
        engine = ConversionEngine(FLAGSHIP, ckpt, stats, vocoder="gl",
                                  device="cuda")
    httpd = None
    thread = None
    try:
        t0 = time.monotonic()
        engine.warmup(2)
        warm_s = time.monotonic() - t0
        httpd = serve(engine, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        durations = np.linspace(1.0, 4.0, 10)
        wavs = [_speechlike(int(d * fs), fs, i)
                for i, d in enumerate(durations)]

        def post(i):
            buf = io.BytesIO()
            wavfile.write(buf, fs, (wavs[i] * 32767).astype(np.int16))
            req = urllib.request.Request(
                f"{base}/convert?target={(7 * i) % 117}",
                data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                sr, out = wavfile.read(io.BytesIO(r.read()))
            return sr, out

        calls0, items0 = engine.batcher.calls, engine.batcher.items
        vq_fused.launches = 0
        fused_group_norm.launches = 0
        t0 = time.monotonic()
        with ThreadPoolExecutor(8) as ex:
            results = list(ex.map(post, range(len(wavs))))
        wall_s = time.monotonic() - t0
        launches = {"vq_fused": vq_fused.launches,
                    "fused_group_norm": fused_group_norm.launches}
        calls = engine.batcher.calls - calls0
        items = engine.batcher.items - items0
        for i, (sr, out) in enumerate(results):
            T_true = 1 + wavs[i].size // shift
            check(sr == fs, f"request {i}: sample rate {sr}")
            check(out.shape == (T_true * shift,),
                  f"request {i}: {out.shape} samples, want {T_true * shift}")
            check(bool(np.all(np.isfinite(out.astype(np.float32)))),
                  f"request {i}: non-finite audio")
            check(np.abs(out).max() > 0, f"request {i}: silent output")
        with urllib.request.urlopen(f"{base}/health", timeout=30) as r:
            check(json.loads(r.read())["status"] == "ok", "health")
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            check(b"vae_npvc_requests" in r.read(), "metrics")
        snap = engine.stats_snapshot()
        check(launches["vq_fused"] > 0 and launches["fused_group_norm"] > 0,
              f"the serving path did not launch every kernel: {launches}")
        # ten requests give a median and a maximum, not a tail percentile
        emit({"phase": "serve", "requests": len(results),
              "seconds_per_request_min_max": [float(durations[0]),
                                              float(durations[-1])],
              "warmup_s": warm_s, "wall_s": wall_s,
              "requests_per_s": len(results) / wall_s,
              "latency_ms_p50": snap["latency_ms_p50"],
              "latency_ms_max": float(np.max(engine.latency_ms)),
              "mean_batch": items / max(calls, 1), "infer_calls": calls,
              "launches": launches})
        phase_profile(torch, engine, wavs[-1])
        phase_wide_fp32(torch, engine.converter.model.state_dict())
        return launches
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=30)
        engine.close()


def _kernel_class(name):
    n = name.lower()
    for key, cls in (("::gn_", "fused_group_norm"), ("::vq_", "vq_fused"),
                     ("fft", "fft"), ("memcpy", "memcpy"),
                     ("fprop", "conv"), ("conv", "conv"),
                     ("nchwtonhwc", "layout"), ("nhwctonchw", "layout"),
                     ("gemm", "matmul"), ("cutlass", "matmul"),
                     ("col2im", "overlap_add"), ("reduce_kernel", "reduce"),
                     ("elementwise", "elementwise")):
        if key in n:
            return cls
    return "other"


def _profiled(torch, fn):
    """Device time by kernel class, host wall time and the device's idle
    share over one call of ``fn`` (one stream: kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class, by_name, n = {}, {}, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n += 1
        ms = e.time_range.elapsed_us() / 1e3
        c = _kernel_class(e.name)
        by_class[c] = by_class.get(c, 0.0) + ms
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + ms
    busy = sum(by_class.values())

    def top(d, k):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:k])

    return {"wall_ms": wall_ms, "device_ms": busy, "device_events": n,
            "idle_share": (1 - busy / wall_ms) if n else None,
            "device_ms_by_class": top(by_class, 10),
            "top_kernels_ms": top(by_name, 8)}


def phase_profile(torch, engine, wav):
    """Where the time goes: one batched model call at the first bucket
    (B=8, T=256) and one whole 4 s request (front-end, model, Griffin-Lim)
    run directly on the engine."""
    feats = np.random.default_rng(1).normal(size=(8, 256, 80)) \
        .astype(np.float32)
    tgts = np.arange(8, dtype=np.int32)
    lengths = np.full((8,), 256, np.int32)
    engine.converter.infer(feats, tgts, lengths)
    emit({"phase": "profile",
          "infer_b8_t256": _profiled(
              torch, lambda: engine.converter.infer(feats, tgts, lengths)),
          "request_4s_gl": _profiled(
              torch, lambda: engine.convert(wav, engine.fs, 0))})


WIDE_MEL_TOL = 1e-4   # max |mel_gpu - mel_cpu| over the peak |mel_cpu|


def phase_wide_fp32(torch, state):
    """The served model's weights at full width in fp32, through
    ``Converter.infer`` on the card and on the CPU: one B=8 batch in the
    512-frame bucket shaped as the batcher pads it (mixed lengths, the last
    two rows repeating the first as the power-of-two padding of six requests
    does). Ids must agree wherever the top-2 distance gap is clear; the mel
    within ``WIDE_MEL_TOL`` of the peak on every row whose ids all agree."""
    from vae_npvc_tpu_torch.infer.convert import Converter

    cfg = dict(FLAGSHIP, compute_dtype="float32")
    B, T, D = 8, 512, cfg["encoder"]["in_channels"][0]
    rng = np.random.default_rng(2)
    lengths = np.array([512, 300, 511, 257, 1, 450, 512, 512], np.int32)
    feats = rng.normal(size=(B, T, D)).astype(np.float32)
    feats[np.arange(T)[None] >= lengths[:, None]] = 0.0
    feats[6:] = feats[0]
    tgts = np.array([0, 5, 116, 33, 7, 64, 0, 0], np.int32)
    runs = {}
    for dev in ("cuda", "cpu"):
        cv = Converter(cfg, device=dev)
        cv.model.load_state_dict(state)
        with torch.inference_mode():
            x = torch.as_tensor(feats, device=cv.device)
            n = torch.as_tensor(lengths, device=cv.device)
            ids = cv.model.encode(x, n).cpu().numpy()
            z = cv.model.encoder(x, n).double().cpu() if dev == "cpu" \
                else None
        runs[dev] = (ids, cv.infer(feats, tgts, lengths), z)
    (ids_d, mel_d, _), (ids_c, mel_c, z) = runs["cuda"], runs["cpu"]
    emb = state["quantizer.emb"].double().cpu()
    dist = (emb ** 2).sum(1)[None] - 2 * z.reshape(-1, z.shape[-1]) @ emb.T
    top2 = torch.topk(dist, 2, dim=1, largest=False).values
    clear = ((top2[:, 1] - top2[:, 0])
             > 1e-5 * top2[:, 0].abs().clamp(min=1)).numpy().reshape(B, T)
    valid = np.arange(T)[None] < lengths[:, None]
    differ = (ids_d != ids_c) & valid
    rows = [b for b in range(B) if not differ[b].any()]
    peak = float(np.abs(mel_c[valid]).max())
    err = max(float(np.abs(mel_d[b, :n] - mel_c[b, :n]).max())
              for b, n in enumerate(lengths) if b in rows) if rows else None
    emit({"phase": "wide_fp32", "B": B, "T": T, "lengths": lengths.tolist(),
          "frames": int(valid.sum()), "near_ties": int((~clear & valid).sum()),
          "ids_differ_clear": int((differ & clear).sum()),
          "ids_differ_near_tie": int((differ & ~clear).sum()),
          "rows_compared": len(rows), "mel_peak": peak,
          "mel_max_abs_err": err,
          "mel_tolerance": WIDE_MEL_TOL * peak})
    check(not (differ & clear).any(),
          f"wide_fp32: {int((differ & clear).sum())} ids differ from the CPU "
          "away from near ties")
    check(len(rows) >= B // 2, f"wide_fp32: only {len(rows)} rows agree")
    check(np.isfinite(mel_d).all() and err <= WIDE_MEL_TOL * peak,
          f"wide_fp32: mel differs from the CPU by {err} (peak {peak})")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import vae_npvc_tpu_torch  # noqa: F401 — fails outside the repo

    from vae_npvc_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    smi = phase_build(torch)
    vq, gn = phase_kernels(torch)
    phase_golden(torch)
    launches = phase_serve(torch)

    vq_main = vq[0]
    gn_main = next(c for c in gn if (c["T"], c["C"]) == (256, 1024)
                   and c["masked"] and c["dtype"] == "bfloat16")
    emit({"kernels": [
        {"name": "vq_fused", "route": "cuda",
         "source": "vae_npvc_tpu_torch/csrc/vq.cu",
         "replaces": "vae_npvc_tpu/ops/vq_pallas.py:105",
         "launches": launches["vq_fused"],
         "max_abs_err": vq_main["max_abs_err"], "ms": vq_main["ms"],
         "ms_l2_cold": vq_main["ms_l2_cold"],
         "plain_ms": vq_main["plain_ms"], "bound_ms": vq_main["bound_ms"],
         "bound_by": vq_main["bound_by"], "library_ms": None},
        {"name": "fused_group_norm", "route": "cuda",
         "source": "vae_npvc_tpu_torch/csrc/groupnorm.cu",
         "replaces": "vae_npvc_tpu/ops/groupnorm_pallas.py:200",
         "launches": launches["fused_group_norm"],
         "max_abs_err": gn_main["max_abs_err"], "ms": gn_main["ms"],
         "ms_l2_cold": gn_main["ms_l2_cold"],
         "plain_ms": gn_main["plain_ms"], "bound_ms": gn_main["bound_ms"],
         "bound_by": gn_main["bound_by"], "library_ms": None},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
