#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``vae_npvc_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU and ``nvcc``; imports no JAX. It builds the port's CUDA
kernels from ``vae_npvc_tpu_torch/csrc``, holds each against its plain
PyTorch version (and the attention kernels in fp32 at T = 3,072 against
float64), holds the port's ``Converter`` against the committed JAX
golden fixture, then serves conversion requests over HTTP with the flagship
flat EMA VQ-VAE (``egs/vcc20/vae1/conf/train_vqvae.yaml`` widths, bf16,
seeded random weights), checks the kernels ran on that path, and holds the
served weights in fp32 at a full 512-frame batch on the card against the
same weights on the CPU. On the same engine, ``/stream``
(``serve/streaming.py``): eight requests of 2-10 s from four clients as
ragged chunked-transfer bodies, exact and chunked (``?chunk=128&
lookahead=128``), one at 16 kHz, the exact stream of a mel-only engine
against ``/convert?mel=1`` (K1 ids and mel bit for bit) and the Griffin-Lim
stream against ``/convert``, launches per ``infer`` counted (``stream``).
Then the training path: every parameter gradient
of the full-width model in fp32 on the card against the CPU
(``grad_fp32``), the port's ``Trainer`` against the committed JAX training
fixture (``train_golden``), and some twenty optimizer steps of the recipe's
model at its step shape (B = 128, T = 256, bf16) through ``Trainer`` on a
synthetic corpus staged on the device (``train``: the first step eager,
the second captured as a CUDA graph, the rest replayed), with the three
kernels' wrapper calls of the steps that call them and the kernels of a
replayed step against an eager one's, read on the device. Then the
token->mel synthesizer: the
port against the committed JAX fixture of a small transformer model
(``tts_golden``), and the recipe's transformer synthesizer
(``egs/aishell3/vc2/conf/train_token_tts_transformer.yaml`` widths, fp32,
seeded random weights) decoding eight utterances through ``bin/decode_tts``
and training for ten steps at B = 32 on a synthetic token-mel corpus
(``tts``), with the attention kernels' launches counted per ``infer`` and
per step. Then the hierarchical VQ-VAE of
``egs/vcc20/vae2/conf/train_vqvae2.yaml`` (``HIER``): the port against the
committed JAX fixture of a small vqvae2 (``hier_golden``), every gradient
at full width in fp32 against the CPU (``hier_grad_fp32``), sixteen bf16
optimizer steps at B = 96, T = 256 on a synthetic corpus staged on the
device with the launch counts per step that calls the wrappers and a
replayed step's kernels against an eager one's (``hier_train``), a
``ConversionEngine`` on the trained checkpoint answering eight requests
(``hier_serve``), and vqvae2a / vqvae2b at test width against the CPU
(``hier_small``). The trained flagship and vqvae2 checkpoints go through
``bin/export_checkpoint`` to the reference toolkit's ``.pt`` and back
through ``bin/convert_checkpoint`` (trees bit for bit; the converted
flagship serves the same ids and mel, one ``/stream`` request:
``ckpt_bridge``). Then the recipes' offline path (``offline``): on a
synthetic corpus of 18 utterances of 1-10 s, ``make_fbank``, CMVN and
speaker ids, ``bin/decode`` over trials with the flagship flat model and
its ``--all-targets`` sweep with the trained hierarchy, de-normalization
and Griffin-Lim, with the port's decode and sweep held against the
committed JAX decode fixture and padded batches against unpadded runs in
fp32. Then stage 8 (``bundle``): ``bin/export_serving`` of the flagship at
``--max_frames 2048`` (fp32 and int8 params), the bundle converting the
offline trials with the live path's K1/K2 launches, ids and mel,
``bin/bundle_check`` against the stage-5 decode, a bucket exported on the
CPU and moved to the card, the trained hierarchy as a bundle and a
``ConversionEngine(bundle=...)`` answering HTTP requests. Then the
AISHELL-3 recipe at the widths of its ``train_vqvae.yaml`` (``bnf``): front
end, CMVN, speaker ids and the seeded train/valid split of 16 utterances
at 44.1 kHz, a few ``bin/train`` steps, ``bin/extract_bnf -k csid
--durations`` with its launches per batch, and ``run_tts.sh`` stages 0-2
(``bin/train_tts`` with the conv synthesizer, ``bin/decode_tts`` on the
tokens). Then the native Parallel WaveGAN vocoder of
``egs/vcc20/vae1/conf/train_jpwg.yaml`` (``PWG``, fp32, no kernel of its
own): the port's ``PwgTrainer`` against the committed JAX fixture
(``voc_golden``), every gradient at full width against the CPU
(``voc_grad_fp32``), sixteen steps at B = 8 x 24,576 samples on a synthetic
corpus staged on the device (``voc_train``), a ``ConversionEngine`` with
``vocoder="jpwg"`` answering eight requests (``voc_serve``, the flat
model's K1/K2 launches counted), a streaming session on that engine
against one-shot synthesis (``voc_stream``) and ``jpwg_decode_scp`` over
sixteen utterances (``voc_offline``). Last, stage 7 of the vae1 recipe, the
objective evaluation: the port's CTC recognizer and character LSTM LM
against the committed JAX fixture (``eval_golden``), ``bin/eval_asr`` with a
width-192 transformer recognizer (4 heads of 48), beam 10 and the neural
LM on a synthetic character corpus, with the attention kernels' launches
counted and every K4/K5 call of one training step held against the plain
versions (``eval_asr``), ``bin/eval_similarity`` with the x-vector TDNN,
PLDA and cosine (``eval_sim``), the mel-proxy MCD and the recipe's
``RESULT`` line (``eval``). Then the last model families the recipes
name: the Tacotron2 synthesizer against its committed JAX fixture
(``tac2_golden``) and at the full width of
``egs/aishell3/vc2/conf/train_token_tts_tacotron2.yaml`` (``TAC2``, fp32,
27.5 M parameters): ``bin/train_tts`` steps at B = 32, L = 192, T = 768
and ``bin/decode_tts`` free-running 768 frames (``tac2``; no kernel of the
port on this path); the WGAN-GP trainer against its fixture
(``gan_golden``) and at the width of
``egs/vcc20/vae1/conf/train_vqvae_gan.yaml`` (``GAN``): ``bin/train``
through the three phases with ``pre_iter`` cut to 2, K1/K2/K3 counted per
critic step and per generator step, the checkpoint through ``bin/decode``
and one HTTP ``/convert`` (``gan``); the Gaussian VAE against its fixture
(``vae_golden``) and at the width of ``egs/vcc20/vae1/conf/train_vae.yaml``
(``VAE``): ``bin/train`` steps with K2/K3 counted, ``bin/decode`` and an
``--all-targets`` sweep (``vae``). Then the rest of the training path
(``trainer_rest``): on a Kaldi dir of 256 utterances of 1-10 s written as
compressed CM arks, ``bin/train`` with the flagship at B = 128, T = 256,
bf16: ``device_resident_sampling: iid`` for 16 steps with
``--profile_dir`` (K1/K2/K3 launches per step that calls the wrappers, one
capture and 15 replays, the trace's kernels, every crop drawn on the card,
gathered again from the staged corpus, against the Python reads from
disk) and a run
resumed from ``iter.8`` drawing the same windows; the host loader with the
native C++ ark loader through ``prefetch_to_device`` for 8 steps (every
native batch against the Python reads), the loader's frames/s; and
``bin/doctor --config --bundle --json`` on the stage-8 bundle, its model
probe's K1/K2 launches. Last, the parallel slice (``parallel``): the
flagship's data-parallel step over NCCL at world size 1 (B = 128, bf16, 16
steps alternating with the plain trainer's: losses bit for bit, K1/K2/K3
and one gradient collective a step, both profiled), then two ranks sharing
the card over gloo (collectives through host memory) against one process:
the DP step at B = 16 in fp32 (``dp2``, candidates injected), a 1 x 2
model-axis mesh with a checkpoint round trip (``tp``), one utterance of
8,192 frames split over the ranks in fp32 and bf16 with K2's split
entry points counted (``seq``), the flagship decoder stack as a two-stage
pipeline of four microbatches with its gradients (``pp``) and the vocoder
trainer across the adversary's start (``pwg_dp``); a data-parallel engine
over HTTP against the plain one and two replicas on one card
(``dp_serve``); ``bin/train`` under torchrun's environment, resumed once
(``train_cli``); K2's split entry points timed at a rank's row. Each phase
prints one JSON line; any failure exits non-zero. The last lines are the kernel summary, the card's
name and power limit as ``nvidia-smi`` gives them, and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import collections
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
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

# keys of egs/aishell3/vc2/conf/train_token_tts_transformer.yaml
# (tests/test_torch_port_tts_cli.py checks this equals the file)
TTS = {
    "trainer_type": "vae_npvc.trainer.basic",
    "model_type": "vae_npvc.model.token_tts",
    "max_iter": 200000, "iters_per_checkpoint": 10000, "iters_per_log": 500,
    "seed": 777, "batch_size": 32, "optim_type": "Adam",
    "learning_rate": 0.001, "max_grad_norm": 10, "lr_scheduler": "StepLR",
    "lr_param": {"step_size": 50000, "gamma": 0.5},
    "token_num": 128, "token_dim": 256, "y_num": 1172, "y_dim": 256,
    "mel_dim": 160, "block_type": "transformer", "adim": 384, "aheads": 4,
    "elayers": 6, "dlayers": 6, "eunits": 1536, "dunits": 1536,
    "dur_weight": 0.1, "max_tokens": 192, "max_frames": 768,
    "postnet_layers": 3, "variance_predictor": True, "var_weight": 0.1,
    "use_spk_embed": False, "spk_embed_dim": 64,
}
TTS_STEPS, TTS_BF16_STEPS, TTS_DECODE_UTTS = 10, 6, 8

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32
# operations/s outside the tensor cores, bf16 and TF32 operations/s in them
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
# twice the H100's 50 MB L2: inputs cycled through this much come from HBM
L2_COLD_BYTES = 100 * 2 ** 20
# L2-cold timing: calls run back to back (enough that the last L2-full of
# output write-backs, which falls after the run, is a few per cent of the
# traffic), queued behind a spin of this many cycles (~20 ms at 1.98 GHz)
COLD_ITERS = 128
SPIN_CYCLES = 40_000_000

K2_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 2 ** -6)}
# the GroupNorm backward against its plain version, relative to each
# output's peak: fp32 differs by summation order only (dx 2e-5; the
# parameter sums run over up to 32,768 frames: 1e-4); a bf16 dx may also
# land one bf16 ulp (2^-7 relative) from the plain version's
K3_TOL_DX, K3_TOL_PARAM, K3_TOL_BF16_ULP = 2e-5, 1e-4, 2 ** -7
# the attention kernels against their plain versions, relative to each
# output's peak: fp32 differs by summation order only (forward 2e-5,
# gradients 3e-5); bf16 may land one bf16 ulp (2^-7 relative) from the plain
# version's, plus 2^-8 of the peak where values cancel
K4_TOL, K5_TOL, ATTN_TOL_BF16 = 2e-5, 3e-5, (2 ** -7, 2 ** -8)

# training keys of egs/vcc20/vae1/conf/train_vqvae.yaml
TRAIN = {
    "trainer_type": "vae_npvc.trainer.basic", "seed": 777,
    "batch_size": 128, "crop_length": 256, "optim_type": "Adam",
    "learning_rate": 0.001, "max_grad_norm": 10, "lr_scheduler": "StepLR",
    "lr_param": {"step_size": 100000, "gamma": 0.5},
    "steps_per_call": 8, "device_resident": True,
}
TRAIN_STEPS = 20

# egs/vcc20/vae2/conf/train_vqvae2.yaml, every key (the GPU host has no
# YAML parser; tests/test_torch_port_hier_train.py checks this equals the
# file): the hierarchical VQ-VAE of the vae2 recipe
HIER = {
    "trainer_type": "vae_npvc.trainer.basic",
    "dataset_type": "vae_npvc.dataset.utt2mel_spk",
    "model_type": "vae_npvc.model.vqvae2",
    "max_iter": 1000000, "iters_per_checkpoint": 20000, "iters_per_log": 1000,
    "steps_per_call": 8, "device_resident": True, "seed": 777, "num_jobs": 8,
    "prefetch_factor": 2, "batch_size": 96, "crop_length": 256,
    "optim_type": "Adam", "learning_rate": 0.001, "max_grad_norm": 10,
    "lr_scheduler": "StepLR", "lr_param": {"step_size": 100000, "gamma": 0.5},
    "levels": 3, "y_dim": 128, "y_num": 117, "beta": 0.01, "use_gst": True,
    "gst_scale_penalty": 0.0, "use_ema": False, "jitter_p": 0.0,
    "encoder.0": {"in_channels": [80], "out_channels": [512],
                  "kernel_size": 3, "downsample_scales": [1],
                  "z_channels": 128, "dilation": False,
                  "stack_kernel_size": 3, "stack_layers": 1, "stacks": [6],
                  "use_weight_norm": True},
    "encoder.1": {"in_channels": [512, 512], "out_channels": [512, 512],
                  "kernel_size": 3, "downsample_scales": [2, 2],
                  "z_channels": 128, "dilation": False,
                  "stack_kernel_size": 3, "stack_layers": 1,
                  "stacks": [3, 3], "use_weight_norm": True},
    "encoder.2": {"in_channels": [512, 512], "out_channels": [512, 512],
                  "kernel_size": 3, "downsample_scales": [4, 4],
                  "z_channels": 128, "dilation": False,
                  "stack_kernel_size": 3, "stack_layers": 1,
                  "stacks": [3, 3], "use_weight_norm": True},
    "quantizer.0": {"z_dim": 128, "z_num": 512, "normalize": True},
    "quantizer.1": {"z_dim": 128, "z_num": 512, "normalize": True},
    "quantizer.2": {"ref_embed_dim": 128, "gst_tokens": 10,
                    "gst_token_dim": 128, "gst_heads": 4},
    "decoder.0": {"in_channels": [384], "out_channels": [512],
                  "cond_channels": 128, "skip_channels": 128,
                  "final_channels": 80, "kernel_size": 3,
                  "upsample_scales": [1], "dilation": False,
                  "stack_kernel_size": 3, "stacks": [10],
                  "use_weight_norm": True},
    "decoder.1": {"in_channels": [128], "out_channels": [512],
                  "cond_channels": 256, "skip_channels": 128,
                  "final_channels": 128, "kernel_size": 3,
                  "upsample_scales": [1], "dilation": False,
                  "stack_kernel_size": 3, "stacks": [6],
                  "use_weight_norm": True},
    "decoder.2": {"in_channels": [128], "out_channels": [512],
                  "cond_channels": 128, "skip_channels": 128,
                  "final_channels": 128, "kernel_size": 3,
                  "upsample_scales": [1], "dilation": False,
                  "stack_kernel_size": 3, "stacks": [6],
                  "use_weight_norm": True},
    "compute_dtype": "bfloat16", "use_native_loader": True,
    "decode_bucket_size": 256, "decode_batch_size": 8,
}
HIER_STEPS, HIER_REQUESTS = 16, 8
# per training step of the recipe's model: K1 once per VQ level (ids mode,
# N = 96 x 64 and 96 x 256), K2/K3 once per GroupNorm (18 in the encoders,
# 22 in the decoders); per infer K1 twice and K2 40 times
HIER_STEP_LAUNCHES = {"vq_fused": 2, "fused_group_norm": 40,
                      "fused_group_norm_backward": 40}
HIER_INFER_LAUNCHES = {"vq_fused": 2, "fused_group_norm": 40}


def _small_layer(kind, cin, ds_or_us=1, **kw):
    """A test-width encoder or decoder arch dict of the hierarchies."""
    if kind == "enc":
        arch = {"in_channels": [cin], "out_channels": [16], "kernel_size": 3,
                "downsample_scales": [ds_or_us], "z_channels": 8,
                "dilation": False, "stack_kernel_size": 3, "stack_layers": 1,
                "stacks": [1], "use_weight_norm": True}
    else:
        arch = {"in_channels": [cin], "out_channels": [16],
                "cond_channels": 8, "skip_channels": 8, "final_channels": 8,
                "kernel_size": 3, "upsample_scales": [ds_or_us],
                "dilation": False, "stack_kernel_size": 3, "stacks": [1],
                "use_weight_norm": True}
    arch.update(kw)
    return arch


_Q8 = {"z_dim": 8, "z_num": 16, "normalize": True}
_GST8 = {"ref_embed_dim": 8, "gst_tokens": 4, "gst_token_dim": 8,
         "gst_heads": 2}
# vqvae2a (per-level speakers, decode-then-upsample) and vqvae2b (GST top,
# fusion decoder) at test width, plain normalized codebooks, fp32
HIER_SMALL = {
    "vqvae2a": {
        "model_type": "vae_npvc.model.vqvae2a", "levels": 3, "y_dim": 8,
        "y_num": 4, "beta": 0.01, "use_gst": False, "use_ema": False,
        "pooling_last": False, "upsample_last": True, "use_embeds": True,
        "encoder.0": _small_layer("enc", 10),
        "encoder.1": _small_layer("enc", 16, 2),
        "encoder.2": _small_layer("enc", 16, 4),
        "decoder.2": _small_layer("dec", 8),
        "decoder.1": _small_layer("dec", 16),
        "decoder.0": _small_layer("dec", 16, final_channels=10),
        "quantizer.0": _Q8, "quantizer.1": _Q8, "quantizer.2": _Q8},
    "vqvae2b": {
        "model_type": "vae_npvc.model.vqvae2b", "levels": 3, "y_dim": 8,
        "y_num": 4, "beta": 0.01, "use_gst": True, "use_ema": False,
        "pooling_last": True,
        "encoder.0": _small_layer("enc", 10),
        "encoder.1": _small_layer("enc", 16, 2),
        "encoder.2": _small_layer("enc", 16, 4),
        "decoder.0": _small_layer("dec", 8), "decoder.1": _small_layer("dec", 8),
        "decoder.2": _small_layer("dec", 8),
        "final_decoder": _small_layer("dec", 24, cond_channels=0,
                                      final_channels=10),
        "quantizer.0": _Q8, "quantizer.1": _Q8, "quantizer.2": _GST8},
}


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also gets the run's elapsed seconds."""
    if "phase" in obj:
        obj = dict(obj, smoke_elapsed_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


# spin kernels launched at the start of a profiler window, before the calls
# it measures, and left out of its events: late in the smoke (after the
# parallel phase's NCCL and two-rank runs) the H100's profiler drops the
# first kernels of a window (10 of 50 split calls; a one-call window came
# back empty, and L2-hot sums read a quarter of their fresh-process value)
PROFILER_PAD = 64


def _profiler_pad(torch):
    for _ in range(PROFILER_PAD):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _kernel_events(torch, prof):
    """The device kernels of a profiler window, without the pad's spins."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.name]


def timed(torch, fn, arg_sets, iters=50, warmup=3, names=None,
          by_name=None):
    """``(device_ms, events_ms)`` of one ``fn(*args)`` call, averaged over
    ``iters`` calls that cycle through ``arg_sets``.

    One argument set keeps the inputs hot in L2, as on the serving path:
    ``device_ms`` sums the durations of the kernels the call ran
    (torch.profiler); ``events_ms`` is the CUDA-event time between the
    first and last call, which also counts the gaps while the host issues
    launches (a small kernel is host-bound there).

    :func:`l2_cold` sets keep the inputs cold, and each call's outputs are
    held until more than ``L2_COLD_BYTES`` have been written after them,
    so that every call writes to memory that is not in L2 (the caching
    allocator would otherwise hand each call the block the last one freed,
    still in L2). At least ``COLD_ITERS`` calls are queued behind a spin
    kernel, so that the device runs them back to back, and both times are
    the CUDA-event time of that run per call: kernels and the device's own
    gaps between them. Paced by the host, a small kernel leaves the device
    idle between launches, the L2 writes its dirty lines back then, and
    the kernels' durations miss the output writes (on an H100 80GB HBM3
    the split apply read 0.0038 ms against its 0.0050 ms bound that
    way). Queued, the
    write-backs fall inside the run, all but the last L2-full of them.

    A list given as ``names`` receives the names of the device kernels the
    profiled calls ran, a dict given as ``by_name`` their device ms per call
    by name (kernel durations, from calls the host paces, L2-cold too). A
    profiling window that comes back without device events is
    taken again, up to three times, and then fails."""
    from torch.profiler import ProfilerActivity, profile

    cold = len(arg_sets) > 1
    held, held_bytes = collections.deque(), [0]

    def call(i):
        out = fn(*arg_sets[i % len(arg_sets)])
        if cold:
            n = _out_bytes(out)
            held.append((out, n))
            held_bytes[0] += n
            while held_bytes[0] - held[0][1] > L2_COLD_BYTES:
                held_bytes[0] -= held.popleft()[1]

    for i in range(warmup):
        call(i)
    torch.cuda.synchronize()
    if cold:
        events_ms = _queued_ms(torch, call, max(iters, COLD_ITERS))
        if names is None and by_name is None:
            return events_ms, events_ms
    else:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            call(i)
        end.record()
        torch.cuda.synchronize()
        events_ms = start.elapsed_time(end) / iters
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _profiler_pad(torch)
            for i in range(iters):
                call(i)
            torch.cuda.synchronize()
        device = _kernel_events(torch, prof)
        if device:
            break
    check(bool(device), "timed: the profiler recorded no device kernels")
    if names is not None:
        names.extend(sorted({e.name for e in device}))
    if by_name is not None:
        for e in device:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / iters / 1e3)
    us = sum(e.time_range.elapsed_us() for e in device)
    return (events_ms if cold else us / iters / 1e3), events_ms


def _queued_ms(torch, call, iters):
    """CUDA-event ms per ``call(i)`` over ``iters`` calls that the host
    queues while a spin kernel holds the stream, so that the device runs
    them back to back. A spin that ends before the host has queued every
    call is taken again four times longer, up to three times, and then
    fails."""
    cycles = SPIN_CYCLES
    for _ in range(3):
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            call(i)
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 4
    check(False, f"timed: {iters} calls were not queued within a spin of "
          f"{cycles // 4} cycles")


def _out_bytes(out):
    """Bytes of the tensors in a call's output (a tensor or a tuple)."""
    if isinstance(out, (tuple, list)):
        return sum(_out_bytes(o) for o in out)
    return out.numel() * out.element_size() if hasattr(out, "numel") else 0


def l2_cold(args, iters=53):
    """Copies of the tensors in ``args``, enough that more than
    ``L2_COLD_BYTES`` pass between two uses of one copy (at least two
    copies): each call of :func:`timed` then reads its inputs from HBM and
    writes its outputs there, as the bound assumes."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if hasattr(a, "numel"))
    n = min(iters, max(2, -(-L2_COLD_BYTES // nbytes)))
    return [tuple(a.clone() if hasattr(a, "clone") else a for a in args)
            for _ in range(n)]


def _bound(byt, ops, ops_per_s=FP32_OPS_PER_S):
    t_bytes, t_ops = byt / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, (
        "bytes" if t_bytes > t_ops else "operations")


def attn_bound_ms(H, T, d, itemsize, valid, backward=False, fma=False):
    """Least time for the masked attention: max(bytes, operations).
    ``valid`` lists each batch row's valid keys; masked keys need no work
    and their k and v rows are never read. Forward: q read and o and the
    log-sum-exp written for all T rows, k and v read for the valid keys,
    two products of 2*T*keys*d operations per head. Backward: q, o, dO and
    the log-sum-exp read and dq, dk, dv written for all T rows, k and v read
    for the valid keys, five such products. bf16 runs at the tensor cores'
    bf16 rate; fp32 as 3xTF32, three TF32 products for each, or with ``fma``
    at the fp32 FMA rate (the bound of an fp32 kernel without tensor
    cores)."""
    B = len(valid)
    n = B * H * T * d
    kv = 2 * H * d * sum(valid)
    pairs = H * T * d * sum(valid)
    if backward:
        byt, ops = (6 * n + kv) * itemsize + 4 * B * H * T, 10 * pairs
    else:
        byt, ops = (2 * n + kv) * itemsize + 4 * B * H * T, 4 * pairs
    if itemsize == 2:
        return _bound(byt, ops, BF16_OPS_PER_S)
    if fma:
        return _bound(byt, ops, FP32_OPS_PER_S)
    return _bound(byt, 3 * ops, TF32_OPS_PER_S)


def vq_bound_ms(N, K, D, stats=False, fma=False):
    """Least time for the fused VQ: max(bytes, operations). The ids mode
    reads z and the codebook and writes the ids; the statistics mode also
    writes z_q, the per-code sums and the counts. The 2*N*K*D products run
    as three TF32 products on the tensor cores, or with ``fma`` at the fp32
    FMA rate (the bound of v1, which kept them in FMA)."""
    byt = 4 * (N * D + K * D + N)
    if stats:
        byt += 4 * (N * D + K * D + K)
    if fma:
        return _bound(byt, 2 * N * K * D, FP32_OPS_PER_S)
    return _bound(byt, 3 * 2 * N * K * D, TF32_OPS_PER_S)


def _valid_frames(B, T, lengths):
    """Frames that GroupNorm reads: lengths clamped to [0, T], or all."""
    if not lengths:
        return B * T
    return sum(min(max(int(n), 0), T) for n in lengths)


def gnb_bound_ms(B, T, C, itemsize, glu, lengths=None):
    """Least time for the GroupNorm(+GLU) backward: one read of x and of
    the cotangent over the valid frames (dx is zero beyond them whatever
    they hold), one write of dx over all T, scale and bias read and the
    parameter gradients written, ~20 fp32 operations per valid element."""
    n = _valid_frames(B, T, lengths) * C
    byt = (n + (n // 2 if glu else n)) * itemsize + B * T * C * itemsize \
        + 16 * C
    return _bound(byt, 20 * n)


def gn_bound_ms(B, T, C, itemsize, glu, lengths=None):
    """Least time for GroupNorm(+GLU): one read of x over the valid frames
    (the output is zero beyond them whatever they hold), one write of the
    output over all T, ~8 fp32 operations per valid input element (+4 per
    GLU output)."""
    n = _valid_frames(B, T, lengths) * C
    byt = n * itemsize + B * T * (C // 2 if glu else C) * itemsize \
        + 8 * C + 4 * B
    ops = 8 * n + (4 * n // 2 if glu else 0)
    return _bound(byt, ops)


def _channels_first(t):
    """The same values as a (B, T, C) view of (B, C, T) memory, the layout
    ``WNConv1d`` hands GroupNorm (``F.conv1d(...).transpose(1, 2)``)."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def _layout(t):
    return "channels-last" if t.stride(2) == 1 else "channels-first"


def _only_groupnorm_kernels(names, what):
    """Check that the profiled calls ran kernels of csrc/groupnorm.cu and
    nothing else (no copy); returns the names."""
    check(bool(names) and all("gn_" in n for n in names),
          f"{what}: the call ran kernels outside groupnorm.cu: {names}")
    return names


# ------------------------------------------------------------------ phases
def phase_build(torch):
    from vae_npvc_tpu_torch.data import native_loader
    from vae_npvc_tpu_torch.ops import _build

    t0 = time.monotonic()
    with ThreadPoolExecutor(1) as ex:
        # the host loader's g++ build beside the kernels' nvcc builds
        loader = ex.submit(native_loader.build)
        libs = _build.build_all()
        loader = loader.result()
    build_s = time.monotonic() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "build", "seconds": round(build_s, 3),
          "libraries": sorted(libs), "native_loader": loader.name,
          "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def _vq_inputs(N, K, D, rng, kind):
    """numpy z (N, D) and codebook (K, D) of a K1 case: ``random``;
    ``unit``, random rows and codes scaled to unit norm (the normalized
    plain codebooks' search, where distances differ only in 2 z.e);
    ``near_tie``, rows within a few ulps of the midpoint of a code and its
    nearest other code; ``duplicate``, a codebook whose second half repeats
    its first (and whose last row repeats row 0) with rows near the
    repeated codes (exact ties: the lowest index wins)."""
    emb = rng.normal(size=(K, D)).astype(np.float32)
    if kind == "random":
        return rng.normal(size=(N, D)).astype(np.float32), emb
    if kind == "unit":
        z = rng.normal(size=(N, D))
        return ((z / np.linalg.norm(z, axis=1, keepdims=True))
                .astype(np.float32),
                (emb / np.linalg.norm(emb, axis=1, keepdims=True))
                .astype(np.float32))
    if kind == "duplicate":
        emb[K // 2:] = emb[:K - K // 2]
        emb[K - 1] = emb[0]
        a = rng.integers(0, K, size=N)
        a[::7] = 0
        return (emb[a] + 0.05 * rng.normal(size=(N, D))).astype(
            np.float32), emb
    e64 = emb.astype(np.float64)
    d = (e64 ** 2).sum(1)[:, None] + (e64 ** 2).sum(1)[None] \
        - 2 * e64 @ e64.T
    np.fill_diagonal(d, np.inf)
    a = rng.integers(0, K, size=N)
    mid = ((e64[a] + e64[d[a].argmin(1)]) / 2).astype(np.float32)
    ulps = rng.integers(-3, 4, size=(N, D)).astype(np.float32)
    return (mid + ulps * np.spacing(np.abs(mid))).astype(np.float32), emb


def _vq_case(torch, N, stats, rng, K=512, D=128, kind="random"):
    """One K1 case: ids against the plain version off the 1e-5 near-tie
    band, every choice within the kernel's margin (a bound on fp32
    rounding) of the fp64 best, duplicates to the lowest index, z_q the
    code rows, exact counts, sums within 1e-5 of sum|z|, two runs
    bit-equal, one kernel launched for ids and at most two for stats; its
    times by kernel name, the plain time, the bounds and the SGEMM + argmin
    yardstick."""
    from vae_npvc_tpu_torch.ops.vq_fused import vq_fused, vq_fused_plain

    dev = torch.device("cuda")
    zn, en = _vq_inputs(N, K, D, rng, kind)
    z = torch.tensor(zn, device=dev)
    emb = torch.tensor(en, device=dev)
    what = f"vq_fused N={N} K={K} D={D} {kind}"
    got = vq_fused(z, emb, stats=stats)
    rescored, all_codes = vq_fused.rescored.sum(1).tolist()
    again = vq_fused(z, emb, stats=stats)
    ref = vq_fused_plain(z, emb, stats=stats)
    torch.cuda.synchronize()
    check(all((a is None and b is None) or torch.equal(a, b)
              for a, b in zip(got, again)), f"{what}: reruns differ")
    e64 = emb.double()
    d64 = (e64 ** 2).sum(1)[None] - 2 * z.double() @ e64.T
    top2 = torch.topk(d64, 2, dim=1, largest=False).values
    clear = (top2[:, 1] - top2[:, 0]) > 1e-5 * top2[:, 0].abs().clamp(min=1)
    check(torch.equal(got.idx[clear], ref.idx[clear]),
          f"{what}: ids differ from the plain version")
    rows = torch.arange(N, device=dev)
    emax = float(e64.norm(dim=1).max())
    margin = 2.0 ** -20 * ((D + 8) * z.double().norm(dim=1) * emax
                           + emax ** 2)
    lost = d64[rows, got.idx.long()] - top2[:, 0]
    check(bool((lost <= margin).all()),
          f"{what}: a choice loses {float(lost.max())} against the fp64 "
          "best, beyond fp32 rounding")
    if kind == "duplicate":
        check(int(got.idx.max()) < K - K // 2,
              f"{what}: a repeated code did not go to the lowest index")
    # distance lost by the kernel's choice against the plain one (0 when
    # the ids agree; near ties may differ by rounding)
    err = (d64[rows, got.idx.long()] - d64[rows, ref.idx.long()]).abs().max()
    case = {"N": N, "K": K, "D": D, "kind": kind,
            "mode": "stats" if stats else "ids",
            "near_ties": int((~clear).sum()),
            "ids_differ": int((got.idx != ref.idx).sum()),
            "rescored_rows": rescored, "rescored_all_codes": all_codes,
            "max_abs_err": float(err), "max_loss_vs_fp64": float(lost.max())}
    if stats:
        check(torch.equal(got.z_q, emb[got.idx.long()]),
              f"{what}: z_q differs from the gathered codes")
        ids = got.idx.long()
        check(torch.equal(got.batch_elem,
                          torch.bincount(ids, minlength=K).float()),
              f"{what}: counts are not exact")
        exact = torch.zeros((K, D), dtype=torch.float64, device=dev) \
            .index_add_(0, ids, z.double())
        scale = torch.zeros((K, D), dtype=torch.float64, device=dev) \
            .index_add_(0, ids, z.double().abs())
        sum_err = (got.batch_sum.double() - exact).abs()
        check(bool((sum_err <= 1e-5 * scale + 1e-6).all()),
              f"{what}: sums beyond 1e-5 of sum|z|")
        case["sum_max_abs_err"] = float(sum_err.max())
    names, by_kernel = [], {}
    case["ms"], case["ms_events"] = timed(
        torch, lambda z, e: vq_fused(z, e, stats=stats), [(z, emb)],
        names=names)
    case["ms_l2_cold"], _ = timed(
        torch, lambda z, e: vq_fused(z, e, stats=stats), l2_cold((z, emb)),
        by_name=by_kernel)
    case["kernels"] = names
    case["ms_l2_cold_by_kernel"] = by_kernel
    check(all("vq_" in n for n in names) and len(names) == (2 if stats
                                                            else 1),
          f"{what}: a call ran {names}, not one kernel (ids) or two "
          "(stats) of vq.cu")
    case["plain_ms"], case["plain_ms_events"] = timed(
        torch, lambda z, e: vq_fused_plain(z, e, stats=stats), [(z, emb)])
    # not a library call of the same function (two calls, no statistics):
    # cuBLAS's fp32 SGEMM (TF32 off) plus an argmin
    case["sgemm_argmin_ms"], _ = timed(
        torch, lambda z, e, e2: torch.argmin(torch.addmm(e2, z, e.T,
                                                         alpha=-2), 1),
        [(a, b, (b * b).sum(1)) for a, b in l2_cold((z, emb))])
    case["library_ms"] = None
    case["bound_ms"], case["bound_by"] = vq_bound_ms(N, K, D, stats)
    case["fma_bound_ms"], _ = vq_bound_ms(N, K, D, stats, fma=True)
    return case


def _gn_case(torch, B, T, C, G, glu, masked, dtype, rng, cf=False):
    """``masked``: False, True (lengths spread from T down to 1) or a list
    of lengths; ``cf``: x as a channels-first view, as the model hands it
    over."""
    import torch.nn.functional as F

    from vae_npvc_tpu_torch.ops.groupnorm import (fused_group_norm,
                                                  group_norm_plain, plan)

    dev = torch.device("cuda")
    x = torch.tensor(rng.normal(0.5, 2.0, size=(B, T, C)), device=dev) \
        .to(dtype)
    if cf:
        x = _channels_first(x)
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
    again = fused_group_norm(x, scale, bias, G, lengths=lengths, glu=glu)
    ref = group_norm_plain(x, scale, bias, G, lengths=lengths, glu=glu)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    what = (f"fused_group_norm {B}x{T}x{C} G={G} glu={glu} masked={masked} "
            f"{name} {_layout(x)}")
    atol, rtol = K2_TOL[name]
    err = (got.float() - ref.float()).abs()
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{what}: shape/dtype differ from the plain version")
    check(bool((err <= atol + rtol * ref.float().abs()).all()),
          f"{what}: max err {float(err.max())} beyond atol {atol} rtol {rtol}")
    check(_layout(got) == _layout(x), f"{what}: output not in x's order")
    check(torch.equal(got, again), f"{what}: two runs differ in their bits")
    if lengths is not None:
        pad = torch.arange(T, device=dev)[None] >= lengths[:, None]
        check(bool((got[pad] == 0).all()), f"{what}: output beyond lengths")
    case = {"B": B, "T": T, "C": C, "G": G, "glu": glu, "masked": masked,
            "dtype": name, "layout": _layout(x), "plan": plan(x, glu),
            "max_abs_err": float(err.max()), "atol": atol, "rtol": rtol,
            "bit_equal_runs": True}
    args = (x, scale, bias, lengths)

    def kernel(x, s, b, n):
        return fused_group_norm(x, s, b, G, lengths=n, glu=glu)

    names = []
    case["ms"], case["ms_events"] = timed(torch, kernel, [args], names=names)
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
        B, T, C, x.element_size(), glu, masked)
    case["kernels_run"] = _only_groupnorm_kernels(names, what)
    return case


def _gnb_case(torch, B, T, C, G, glu, masked, dtype, rng, iters=50,
              cf=False):
    """The GroupNorm(+GLU) backward kernel against its plain version;
    ``masked`` as in :func:`_gn_case`. The cotangent is a channels-first
    view, as a convolution's backward hands it over; with ``cf`` x is
    one too, as the model's forward saved it."""
    import torch.nn.functional as F

    from vae_npvc_tpu_torch.ops.groupnorm import (fused_group_norm_backward,
                                                  group_norm_backward_plain,
                                                  plan)

    dev = torch.device("cuda")
    Cout = C // 2 if glu else C
    x = torch.tensor(rng.normal(0.5, 2.0, size=(B, T, C)), device=dev) \
        .to(dtype)
    scale = torch.tensor(rng.normal(1.0, 0.2, size=C), dtype=torch.float32,
                         device=dev)
    bias = torch.tensor(rng.normal(0.0, 0.2, size=C), dtype=torch.float32,
                        device=dev)
    if cf:
        x = _channels_first(x)
    g = torch.tensor(rng.normal(size=(B, Cout, T)), device=dev).to(dtype) \
        .transpose(1, 2)
    lengths = None
    if masked is True:
        masked = np.linspace(T, 1, B).round().astype(np.int32).tolist()
    if masked:
        lengths = torch.tensor(masked, dtype=torch.int32, device=dev)
    got = fused_group_norm_backward(x, scale, bias, g, G, lengths=lengths,
                                    glu=glu)
    again = fused_group_norm_backward(x, scale, bias, g, G, lengths=lengths,
                                      glu=glu)
    ref = group_norm_backward_plain(x, scale, bias, g, G, lengths=lengths,
                                    glu=glu)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    what = (f"fused_group_norm_backward {B}x{T}x{C} G={G} glu={glu} "
            f"masked={masked} {name} {_layout(x)}")
    errs = {}
    for key, a, b in zip(("dx", "dscale", "dbias"), got, ref):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{what}: {key} shape/dtype differ from the plain version")
        a, b = a.float(), b.float()
        peak = float(b.abs().max()) or 1.0
        if key == "dx":
            tol = K3_TOL_DX * peak
            if dtype == torch.bfloat16:
                tol = 1e-4 * peak + K3_TOL_BF16_ULP * b.abs()
        else:
            tol = K3_TOL_PARAM * peak
        err = (a - b).abs()
        check(bool((err <= tol).all()),
              f"{what}: {key} max err {float(err.max())} (peak {peak})")
        errs[key] = float(err.max()) / peak
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{what}: two runs differ in their bits")
    if lengths is not None:
        pad = torch.arange(T, device=dev)[None] >= lengths[:, None]
        check(bool((got[0][pad] == 0).all()), f"{what}: dx beyond lengths")
    check(_layout(got[0]) == _layout(x), f"{what}: dx not in x's order")
    case = {"B": B, "T": T, "C": C, "G": G, "glu": glu, "masked": masked,
            "dtype": name, "layout": _layout(x),
            "plan": plan(x, glu, backward=True),
            "max_abs_err": float((got[0].float()
                                  - ref[0].float()).abs().max()),
            "err_over_peak": errs, "bit_equal_runs": True}
    args = (x, scale, bias, g, lengths)

    def kernel(x, s, b, g, n):
        return fused_group_norm_backward(x, s, b, g, G, lengths=n, glu=glu)

    names = []
    case["ms"], case["ms_events"] = timed(torch, kernel, [args], iters,
                                          names=names)
    case["ms_l2_cold"], _ = timed(torch, kernel, l2_cold(args), iters)
    case["plain_ms"], case["plain_ms_events"] = timed(
        torch, lambda x, s, b, g, n: group_norm_backward_plain(
            x, s, b, g, G, lengths=n, glu=glu), [args], iters)
    case["library_ms"] = None
    if not masked and not glu:
        # autograd's backward of F.group_norm on the same values
        xt = x.transpose(1, 2).contiguous().requires_grad_(True)
        s = scale.to(dtype).requires_grad_(True)
        b = bias.to(dtype).requires_grad_(True)
        y = F.group_norm(xt, G, s, b, 1e-5)
        gt = g.transpose(1, 2).contiguous()
        case["library_ms"], case["library_ms_events"] = timed(
            torch, lambda: torch.autograd.grad(y, (xt, s, b), gt,
                                               retain_graph=True), [()],
            iters)
    case["bound_ms"], case["bound_by"] = gnb_bound_ms(
        B, T, C, x.element_size(), glu, masked)
    case["kernels_run"] = _only_groupnorm_kernels(names, what)
    return case


def _attn_case(torch, B, H, T, d, lengths, dtype, rng, q_scale=1.0,
               iters=20, backward=True):
    """The attention forward and backward kernels against their plain
    versions. q, k, v and the cotangent are (B, H, T, d) views of (B, T,
    H*d) tensors, as ``MultiHeadedAttention`` hands them over; ``lengths``
    is None, a list, or "ragged" (valid keys from T/3 to T, the first row
    full). The library yardstick is one ``scaled_dot_product_attention``
    call with the same boolean key mask, and its autograd backward.
    ``backward=False`` checks and times the forward only (a shape only
    inference reaches)."""
    import torch.nn.functional as F

    from vae_npvc_tpu_torch.ops.attention import (attention_backward_plain,
                                                  attention_plain,
                                                  fused_attention,
                                                  fused_attention_backward)

    dev = torch.device("cuda")
    q, k, v, do = (
        (torch.tensor(rng.normal(size=(B, T, H * d)), dtype=torch.float32,
                      device=dev) * s).to(dtype).reshape(B, T, H, d)
        .transpose(1, 2) for s in (q_scale, 1.0, 1.0, 1.0))
    if isinstance(lengths, str):
        lengths = [T] + rng.integers(T // 3, T + 1, size=B - 1).tolist()
    n = (torch.tensor(lengths, dtype=torch.int32, device=dev)
         if lengths else None)
    valid = [min(max(x, 1), T) for x in lengths] if lengths else [T] * B
    scale = 1.0 / math.sqrt(d)
    qg, kg, vg = (t.detach().requires_grad_(backward) for t in (q, k, v))
    o = fused_attention(qg, kg, vg, n)
    got = torch.autograd.grad(o, (qg, kg, vg), do) if backward else ()
    o2 = fused_attention(qg, kg, vg, n)
    again = torch.autograd.grad(o2, (qg, kg, vg), do) if backward else ()
    ref_o, ref_lse = attention_plain(q, k, v, n, scale)
    ref = (attention_backward_plain(q, k, v, ref_o, ref_lse, do, n, scale)
           if backward else ())
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    what = f"fused_attention ({B}, {H}, {T}, {d}) lengths={lengths} {name}"
    if q_scale != 1.0:
        what += f" q*{q_scale:g}"
    errs = {}
    for key, a, b, tol in (("o", o.detach(), ref_o, K4_TOL),) + tuple(
            zip(("dq", "dk", "dv"), got, ref, [K5_TOL] * 3)):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{what}: {key} shape/dtype differ from the plain version")
        a, b = a.float(), b.float()
        check(bool(torch.isfinite(a).all()), f"{what}: {key} not finite")
        peak = float(b.abs().max()) or 1.0
        limit = tol * peak if dtype == torch.float32 else \
            ATTN_TOL_BF16[0] * b.abs() + ATTN_TOL_BF16[1] * peak
        err = (a - b).abs()
        # with one-hot softmax rows (q scaled by 1e16) dP - D is rounding
        # noise times 1e16: those gradients are held to be finite only
        check(bool((err <= limit).all()) or (q_scale != 1.0 and key != "o"),
              f"{what}: {key} max err {float(err.max())} (peak {peak})")
        errs[key] = float(err.max()) / peak
    check(torch.equal(o, o2) and all(torch.equal(a, b)
                                     for a, b in zip(got, again)),
          f"{what}: two runs differ in their bits")
    if n is not None and backward:
        pad = (torch.arange(T, device=dev)[None] >= n.clamp(min=1)[:, None])[
            :, None, :, None]
        check(bool((got[1].masked_select(pad) == 0).all())
              and bool((got[2].masked_select(pad) == 0).all()),
              f"{what}: dk/dv beyond lengths")
    case = {"B": B, "H": H, "T": T, "d": d, "lengths": lengths,
            "valid_keys": sum(valid), "dtype": name, "q_scale": q_scale,
            "max_abs_err": float((o.detach().float()
                                  - ref_o.float()).abs().max()),
            "err_over_peak": errs, "bit_equal_runs": True}
    fwd_args = (q, k, v, n)

    def fwd(q, k, v, n):
        return fused_attention(q, k, v, n)

    case["ms"], case["ms_events"] = timed(torch, fwd, [fwd_args], iters)
    case["ms_l2_cold"], _ = timed(torch, fwd, l2_cold(fwd_args), iters)
    case["plain_ms"], _ = timed(
        torch, lambda q, k, v, n: attention_plain(q, k, v, n, scale),
        [fwd_args], iters)
    # the library's call on the same values, timed as a yardstick only
    mask = None
    if n is not None:
        mask = (torch.arange(T, device=dev)[None] < n.clamp(min=1)[:, None])[
            :, None, None, :]
    case["library_ms"], _ = timed(
        torch, lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), [(q, k, v)], iters)
    item = q.element_size()
    case["bound_ms"], case["bound_by"] = attn_bound_ms(H, T, d, item, valid)
    if dtype == torch.float32:
        case["fma_bound_ms"], _ = attn_bound_ms(H, T, d, item, valid,
                                                fma=True)
    if not backward:
        return case
    case["bwd_max_abs_err"] = max(float((a.float() - b.float()).abs().max())
                                  for a, b in zip(got, ref))
    bwd_args = (q, k, v, o.detach(), ref_lse, do, n)

    def bwd(q, k, v, o, lse, do, n):
        return fused_attention_backward(q, k, v, o, lse, do, n)

    case["bwd_ms"], case["bwd_ms_events"] = timed(torch, bwd, [bwd_args],
                                                  iters)
    case["bwd_ms_l2_cold"], _ = timed(torch, bwd, l2_cold(bwd_args), iters)
    case["bwd_plain_ms"], _ = timed(
        torch, lambda q, k, v, o, lse, do, n: attention_backward_plain(
            q, k, v, o, lse, do, n, scale), [bwd_args], iters)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
    case["bwd_library_ms"], _ = timed(
        torch, lambda: torch.autograd.grad(ol, (ql, kl, vl), do,
                                           retain_graph=True), [()], iters)
    case["bwd_bound_ms"], case["bwd_bound_by"] = attn_bound_ms(
        H, T, d, item, valid, backward=True)
    if dtype == torch.float32:
        case["bwd_fma_bound_ms"], _ = attn_bound_ms(H, T, d, item, valid,
                                                    backward=True, fma=True)
    return case


ATTN_LONG = (4, 4, 3072)      # B, H, T of the long-row fp32 case


def _attn_long(torch, d, rng):
    """K4 and K5 in fp32 at ``ATTN_LONG`` (every key valid) against the same
    formulas in float64: the largest error over each output's peak, held
    to ``K4_TOL`` (o) and ``K5_TOL`` (dq, dk, dv)."""
    from vae_npvc_tpu_torch.ops.attention import fused_attention

    B, H, T = ATTN_LONG
    dev = torch.device("cuda")
    q, k, v, do = (torch.tensor(rng.normal(size=(B, T, H * d)),
                                dtype=torch.float32, device=dev)
                   .reshape(B, T, H, d).transpose(1, 2) for _ in range(4))
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = fused_attention(qg, kg, vg)
    got = (o.detach(),) + torch.autograd.grad(o, (qg, kg, vg), do)
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = d ** -0.5
    p = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    o64 = p @ v
    ds = p * (do @ v.transpose(-1, -2) - (do * o64).sum(-1, keepdim=True))
    exact = (o64, ds @ k * scale, ds.transpose(-1, -2) @ q * scale,
             p.transpose(-1, -2) @ do)
    case = {"B": B, "H": H, "T": T, "d": d}
    for name, a, e, tol in zip(("o", "dq", "dk", "dv"), got, exact,
                               (K4_TOL, K5_TOL, K5_TOL, K5_TOL)):
        case[name] = float((a.double() - e).abs().max() / e.abs().max())
        check(case[name] <= tol, f"attention fp32 at T = {T}, d = {d}: "
              f"{name} {case[name]} of the float64 peak (limit {tol})")
    return case


def phase_kernels(torch):
    rng = np.random.default_rng(0)
    # ids mode at the serving path's row counts: B=8 x bucket 256, B=8 x
    # bucket 512, one 256-frame request; stats mode at the training shape
    # and a ragged N
    vq = [_vq_case(torch, 8 * 256, False, rng),
          _vq_case(torch, 8 * 512, False, rng),
          _vq_case(torch, 256, False, rng),
          _vq_case(torch, 32768, True, rng),
          _vq_case(torch, 20011, True, rng)]
    # constructed near ties and repeated codes at both modes' shapes, and
    # the recipes' other codebooks (egs/*/*/conf/*.yaml) at the training
    # shape
    for kind in ("near_tie", "duplicate"):
        vq.append(_vq_case(torch, 8 * 256, False, rng, kind=kind))
        vq.append(_vq_case(torch, 32768, True, rng, kind=kind))
    for K, D in ((128, 128), (64, 32)):
        vq.append(_vq_case(torch, 32768, True, rng, K=K, D=D))
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
    # the training step's shapes: B = 128, T = 256, unmasked
    gn.append(_gn_case(torch, 128, 256, 512, 1, False, False, torch.bfloat16,
                       rng))
    gn.append(_gn_case(torch, 128, 256, 1024, 2, True, False, torch.bfloat16,
                       rng))
    gnb = []
    for dtype in (torch.float32, torch.bfloat16):
        gnb.append(_gnb_case(torch, 128, 256, 512, 1, False, False, dtype,
                             rng, iters=20))
        gnb.append(_gnb_case(torch, 128, 256, 1024, 2, True, False, dtype,
                             rng, iters=20))
        gnb.append(_gnb_case(torch, 8, 512, 1024, 2, True,
                             [512, 300, 511, 257, 1, 450, 0, 512], dtype,
                             rng))
        gnb.append(_gnb_case(torch, 1, 512, 512, 1, False, [397], dtype, rng))
    gnb.append(_gnb_case(torch, 3, 77, 96, 3, False, [77, 5, 40],
                         torch.float32, rng))       # ragged T, odd widths
    # the training step's shapes in the layout the convolutions hand over:
    # x (and the cotangent) channels-first, read in place
    for dtype in (torch.float32, torch.bfloat16):
        for C, G, glu in ((512, 1, False), (1024, 2, True)):
            gn.append(_gn_case(torch, 128, 256, C, G, glu, False, dtype, rng,
                               cf=True))
            gnb.append(_gnb_case(torch, 128, 256, C, G, glu, False, dtype,
                                 rng, iters=20, cf=True))
    # serving's decoder batch in the model's layout
    gn.append(_gn_case(torch, 8, 256, 1024, 2, True, True, torch.bfloat16,
                       rng, cf=True))
    # a row too long for a thread-block cluster: the streaming path
    gn.append(_gn_case(torch, 2, 4096, 1024, 2, True, [4096, 2500],
                       torch.bfloat16, rng, cf=True))
    gnb.append(_gnb_case(torch, 2, 4096, 1024, 2, True, [4096, 2500],
                         torch.bfloat16, rng, iters=20, cf=True))
    check(gn[-1]["plan"] == 0 and gnb[-1]["plan"] == 0,
          "the 4096-frame rows did not take the streaming path")
    # the vae2 recipe's hierarchy (HIER): K1 ids mode on unit-norm rows and
    # codes at the training step's two VQ levels (96 x 64, 96 x 256 rows);
    # the strided levels' short GroupNorm rows, channels-first as the
    # strided convs hand them over: the encoders' G = 1 norms at T = 128,
    # 64, 16 and 4 and decoder 2's GLU at T = 64, masked serving rows down
    # to one valid frame, and fp32 rows of 4 frames
    for N in (96 * 64, 96 * 256):
        vq.append(_vq_case(torch, N, False, rng, kind="unit"))
    for T in (128, 64, 16, 4):
        gn.append(_gn_case(torch, 96, T, 512, 1, False, False,
                           torch.bfloat16, rng, cf=True))
        gnb.append(_gnb_case(torch, 96, T, 512, 1, False, False,
                             torch.bfloat16, rng, iters=20, cf=True))
    gn.append(_gn_case(torch, 96, 64, 1024, 2, True, False, torch.bfloat16,
                       rng, cf=True))
    gnb.append(_gnb_case(torch, 96, 64, 1024, 2, True, False, torch.bfloat16,
                         rng, iters=20, cf=True))
    for T in (16, 4):
        gn.append(_gn_case(torch, 8, T, 512, 1, False, True, torch.bfloat16,
                           rng, cf=True))
    gn.append(_gn_case(torch, 8, 4, 512, 1, False, [4, 1, 2, 1, 3, 4, 1, 2],
                       torch.float32, rng, cf=True))
    gnb.append(_gnb_case(torch, 96, 4, 512, 1, False, False, torch.float32,
                         rng, cf=True))
    gnb.append(_gnb_case(torch, 8, 4, 1024, 2, True, [4, 1, 2, 1, 3, 4, 1, 2],
                         torch.float32, rng, cf=True))
    # the offline decode's long buckets (the offline phase's corpus,
    # channels-first): the 1,024-frame bucket's decoder rows (B = 4 of
    # 769-938 frames) and the 768-frame bucket's encoder rows (B = 5 of
    # 544-713), in bf16 (the flagship decode) and fp32 (its fp32 checks),
    # and the flat sweep's B = 1 encode of the longest utterance; the
    # throughput decode's full batch of 8 at 1,024 frames in bf16
    for dtype in (torch.float32, torch.bfloat16):
        gn.append(_gn_case(torch, 4, 1024, 1024, 2, True,
                           [938, 882, 825, 769], dtype, rng, cf=True))
        gn.append(_gn_case(torch, 5, 768, 512, 1, False,
                           [713, 703, 656, 600, 544], dtype, rng, cf=True))
        gn.append(_gn_case(torch, 1, 1024, 512, 1, False, [938], dtype, rng,
                           cf=True))
    gn.append(_gn_case(torch, 8, 1024, 1024, 2, True,
                       [938, 882, 825, 769] * 2, torch.bfloat16, rng,
                       cf=True))
    # the synthesizer's shapes: encoder and decoder of a training batch
    # (B = 32, ragged lengths), one decoded utterance, and odd sizes
    attn = []
    for dtype in (torch.float32, torch.bfloat16):
        attn.append(_attn_case(torch, 32, 4, 192, 96, "ragged", dtype, rng,
                               iters=10))
        attn.append(_attn_case(torch, 32, 4, 768, 96, "ragged", dtype, rng,
                               iters=10))
        attn.append(_attn_case(torch, 1, 4, 768, 96, None, dtype, rng))
        attn.append(_attn_case(torch, 1, 4, 192, 96, [150], dtype, rng))
        attn.append(_attn_case(torch, 1, 4, 100, 96, [77], dtype, rng))
        attn.append(_attn_case(torch, 3, 1, 257, 48, [257, 1, 130], dtype,
                               rng))
    for dtype in (torch.float32, torch.bfloat16):
        attn.append(_attn_case(torch, 2, 2, 96, 32, [96, 1], dtype, rng,
                               q_scale=1e16))
    # head dims that are not multiples of 16 (zero-padded in shared memory),
    # and a small grid (B*H*ceil(T/64) = 72 blocks of 64 on 132 SMs)
    attn.append(_attn_case(torch, 2, 2, 64, 8, [64, 1], torch.bfloat16, rng))
    attn.append(_attn_case(torch, 2, 3, 100, 40, [100, 33], torch.bfloat16,
                           rng))
    attn.append(_attn_case(torch, 3, 4, 384, 64, [384, 200, 1],
                           torch.bfloat16, rng))
    # the CTC recognizer's (eval phases, fp32, 4 heads of 48): a training
    # batch (B = 16, T' = 600, ragged) and a transcribe batch at the longest
    # 256-frame bucket (T' = 1,536) of one utterance, 15 rows of length 1
    # (inference: the forward only)
    attn.append(_attn_case(torch, 16, 4, 600, 48, "ragged", torch.float32,
                           rng, iters=10))
    attn.append(_attn_case(torch, 16, 4, 1536, 48, [1496] + [1] * 15,
                           torch.float32, rng, iters=10, backward=False))
    # fp32 at T = 3,072 against float64: the error of the sums over 48 key
    # (query) tiles
    attn_long = [_attn_long(torch, d, rng) for d in (48, 96)]
    emit({"phase": "kernels", "vq_fused": vq, "fused_group_norm": gn,
          "fused_group_norm_backward": gnb, "fused_attention": attn,
          "fused_attention_long_fp32_vs_f64": attn_long})
    return vq, gn, gnb, attn, attn_long


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


def _cmvn_stats(D=80):
    """Log-mel-like CMVN stats (mean -3, variance 1, count 1,000)."""
    stats = np.zeros((2, D + 1), np.float64)
    stats[0, :-1] = -3.0 * 1000
    stats[0, -1] = 1000
    stats[1, :-1] = (1.0 + 3.0 ** 2) * 1000
    return stats


def phase_serve(torch, root):
    """Ten ``/convert`` requests to the flagship engine (Griffin-Lim), one
    batch and one request profiled, the served weights in fp32 against the
    CPU, then :func:`phase_stream` on the same engine. Returns the K1/K2
    launches of the ten requests and the stream phase's summary."""
    from scipy.io import wavfile

    from vae_npvc_tpu_torch.ops.groupnorm import fused_group_norm
    from vae_npvc_tpu_torch.ops.vq_fused import vq_fused
    from vae_npvc_tpu_torch.serve import ConversionEngine

    fs, shift = 24000, 256
    stats = _cmvn_stats()
    root.mkdir(parents=True, exist_ok=True)
    ckpt = root / "flagship.msgpack"
    _random_checkpoint(torch, ckpt)
    engine = ConversionEngine(FLAGSHIP, ckpt, stats, vocoder="gl",
                              device="cuda")
    httpd = None
    try:
        t0 = time.monotonic()
        engine.warmup(2)
        warm_s = time.monotonic() - t0
        httpd, thread, _ = _serving(engine)
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
        # ten requests give a median and a maximum, not a tail percentile;
        # the engine's histogram gives the median within one bucket (12 %)
        # of the exact one, the maximum exactly
        emit({"phase": "serve", "requests": len(results),
              "seconds_per_request_min_max": [float(durations[0]),
                                              float(durations[-1])],
              "warmup_s": warm_s, "wall_s": wall_s,
              "requests_per_s": len(results) / wall_s,
              "latency_ms_p50": snap["latency_ms_p50"],
              "latency_ms_max": snap["latency_ms_max"],
              "latency_from": "engine histogram since warm-up, p50 within "
                              "one 12 % bucket",
              "mean_batch": items / max(calls, 1), "infer_calls": calls,
              "launches": launches})
        phase_profile(torch, engine, wavs[-1])
        phase_wide_fp32(torch, engine.converter.model.state_dict())
        stream = phase_stream(torch, engine, httpd.server_address[1], ckpt,
                              stats)
        return launches, stream
    finally:
        if httpd is not None:
            _stop(httpd, thread)
        engine.close()


# /stream on the flagship engine: eight requests of 2-10 s from four clients
# as ragged chunked-transfer bodies of raw PCM (i16 and f32), one at 16 kHz
# (resampled at finish), in exact mode and in the chunked mode of
# docs/SERVING.md's recommended row (?chunk=128&lookahead=128)
STREAM_SECONDS = np.linspace(2.0, 10.0, 8)
STREAM_RATES = [24000, 24000, 24000, 16000, 24000, 24000, 24000, 24000]
STREAM_CHUNK, STREAM_LOOKAHEAD, STREAM_CLIENTS = 128, 128, 4
STREAM_EXACT_CHECKS = (0, 3, 7)     # one at a time on the mel-only engine


def _stream_body(x, fmt, seed):
    """Raw PCM of ``x`` in ragged pieces (1 byte to 16 KiB, so pieces
    split samples), and the float32 signal the server decodes from it."""
    if fmt == "i16":
        pcm = np.clip(np.round(x * 32767), -32768, 32767).astype("<i2")
        raw, decoded = pcm.tobytes(), pcm.astype(np.float32) * (1 / 32768.0)
    else:
        raw, decoded = x.astype("<f4").tobytes(), x.astype(np.float32)
    rng = np.random.default_rng(seed)
    pieces, i = [], 0
    while i < len(raw):
        n = int(rng.choice([1, 7, 333, 1024, 4801, 16384]))
        pieces.append(raw[i:i + n])
        i += n
    return pieces, decoded


def _post_stream(port, query, pieces, timeout=600):
    """POST ``/stream?query`` with a chunked-transfer body: ``(status,
    content type, body, s to the first audio byte after the WAV header or
    None, s to the whole answer)``, timed from the request's start."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", f"/stream?{query}", body=iter(pieces))
        resp = conn.getresponse()
        ctype = resp.getheader("Content-Type")
        first = None
        if ctype == "audio/wav":
            body = resp.read(46)          # the 44-byte header, one sample
            first = time.perf_counter() - t0
            body += resp.read()
        else:
            body = resp.read()
        return resp.status, ctype, body, first, time.perf_counter() - t0
    finally:
        conn.close()


def _post_convert(port, query, signal, sr):
    """POST ``/convert?query`` with ``signal`` as a float32 WAV (the server
    decodes the same samples as from a stream body)."""
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, sr, signal.astype(np.float32))
    req = urllib.request.Request(f"http://127.0.0.1:{port}/convert?{query}",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read()


def _serving(engine):
    """``(httpd, thread, port)``: ``engine`` on an ephemeral port."""
    from vae_npvc_tpu_torch.bin.serve import serve

    httpd = serve(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, httpd.server_address[1]


def _stop(httpd, thread):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    check(not thread.is_alive(), "an HTTP server thread did not stop")


def phase_stream(torch, engine, port, ckpt, stats):
    """``/stream`` (``serve/streaming.py``) on the serve phase's flagship
    engine (Griffin-Lim, bf16) and on a mel-only engine of the same
    checkpoint. One request at a time: the mel-only engine's exact stream
    against ``/convert?mel=1`` of the same samples (mel bit for bit, K1 ids
    equal) and the Griffin-Lim stream's PCM against ``/convert``'s. Then
    the eight requests from four clients, exact and chunked, with the K1/K2
    launches against the batcher's ``infer`` calls and the items against
    one per exact request and ceil(T / C) per chunked one; the time to the
    first audio byte and to the whole answer. Returns the launches and
    calls of both runs."""
    from scipy.io import wavfile

    from vae_npvc_tpu_torch.data import features
    from vae_npvc_tpu_torch.serve import ConversionEngine

    fs, shift = engine.fs, engine.n_shift
    n = len(STREAM_SECONDS)
    fmts = ["i16" if i % 2 == 0 else "f32" for i in range(n)]
    bodies = [_stream_body(_speechlike(int(d * r), r, 70 + i), fmts[i],
                           170 + i)
              for i, (d, r) in enumerate(zip(STREAM_SECONDS, STREAM_RATES))]
    frames = [features.num_frames(
        features.resample(b[1], r, fs).size, shift)
        for b, r in zip(bodies, STREAM_RATES)]

    def query(i, mode=""):
        return (f"target={(5 * i) % 117}&sr={STREAM_RATES[i]}"
                f"&format={fmts[i]}{mode}")

    chunked = f"&chunk={STREAM_CHUNK}&lookahead={STREAM_LOOKAHEAD}"
    mel_engine = ConversionEngine(FLAGSHIP, ckpt, stats, vocoder="none",
                                  device="cuda")
    httpd, thread, mel_port = _serving(mel_engine)
    exact = []
    try:
        for i in STREAM_EXACT_CHECKS:
            want, want_ids = _k1_ids(lambda: np.load(io.BytesIO(
                _post_convert(mel_port, f"target={(5 * i) % 117}&mel=1",
                              bodies[i][1], STREAM_RATES[i]))))
            (status, ctype, body, _, total), ids = _k1_ids(
                lambda: _post_stream(mel_port, query(i), bodies[i][0]))
            check(status == 200 and ctype == "application/octet-stream",
                  f"stream: mel-only request {i}: {status} {ctype}")
            got = np.load(io.BytesIO(body))
            check(got.shape == want.shape == (frames[i], 80),
                  f"stream: request {i}: {got.shape}, /convert "
                  f"{want.shape}, {frames[i]} frames")
            check(len(ids) == len(want_ids) == 1
                  and torch.equal(ids[0], want_ids[0]),
                  f"stream: request {i}: K1 ids differ from /convert's")
            check(np.array_equal(got, want), f"stream: request {i}: mel "
                  f"differs from /convert?mel=1 by "
                  f"{float(np.abs(got - want).max())}")
            exact.append({"request": i, "frames": frames[i],
                          "sr": STREAM_RATES[i], "format": fmts[i],
                          "mel_bit_equal": True, "k1_ids_equal": True,
                          "s": total})
        # the chunked mode's deviation from exact conversion (statistics
        # over prefix + lookahead frames only)
        i = STREAM_EXACT_CHECKS[-1]
        status, _, body, _, _ = _post_stream(mel_port, query(i, chunked),
                                             bodies[i][0])
        approx = np.load(io.BytesIO(body))
        want = np.load(io.BytesIO(_post_convert(
            mel_port, f"target={(5 * i) % 117}&mel=1", bodies[i][1],
            STREAM_RATES[i])))
        check(status == 200 and approx.shape == want.shape
              and bool(np.isfinite(approx).all()),
              f"stream: chunked mel-only request: {approx.shape}")
        chunked_dev = float(np.sqrt(np.mean((approx - want) ** 2))
                            / np.sqrt(np.mean(want ** 2)))
        check(chunked_dev < 1.0, f"stream: chunked deviation {chunked_dev}")
        tail = STREAM_CHUNK // 2     # the last chunk sees the utterance
        tail_err = float(np.abs(approx[-tail:] - want[-tail:]).max())
    finally:
        _stop(httpd, thread)
        mel_engine.close()

    # Griffin-Lim: the streamed PCM against /convert's wav
    i = 1
    _, want = wavfile.read(io.BytesIO(_post_convert(
        port, f"target={(5 * i) % 117}", bodies[i][1], STREAM_RATES[i])))
    status, ctype, body, _, _ = _post_stream(port, query(i), bodies[i][0])
    got = np.frombuffer(body[44:], "<i2")
    check(status == 200 and ctype == "audio/wav" and body[:4] == b"RIFF"
          and np.array_equal(got, want),
          f"stream: Griffin-Lim PCM differs from /convert's "
          f"({got.shape} vs {want.shape})")

    def run(mode):
        calls0, items0 = engine.batcher.calls, engine.batcher.items
        _zero_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(STREAM_CLIENTS) as ex:
            res = list(ex.map(lambda i: _post_stream(
                port, query(i, mode), bodies[i][0]), range(n)))
        wall = time.perf_counter() - t0
        launches = _read_counts()
        calls = engine.batcher.calls - calls0
        items = engine.batcher.items - items0
        for i, (status, ctype, body, _, _) in enumerate(res):
            pcm = np.frombuffer(body[44:], "<i2")
            check(status == 200 and ctype == "audio/wav"
                  and body[:4] == b"RIFF", f"stream: request {i}: {status}")
            check(pcm.size == frames[i] * shift and np.abs(pcm).max() > 0,
                  f"stream: request {i}: {pcm.size} samples, want "
                  f"{frames[i] * shift}, or silent")
        check({k: launches[k] for k in FLAT_LAUNCHES}
              == {k: v * calls for k, v in FLAT_LAUNCHES.items()},
              f"stream{mode}: launches {launches} over {calls} infer calls")
        first = [r[3] for r in res]
        total = [r[4] for r in res]
        return {"wall_s": wall, "infer_calls": calls, "infer_items": items,
                "launches": launches,
                "first_audio_byte_s": first, "total_s": total,
                "first_audio_byte_s_median": float(np.median(first)),
                "total_s_median": float(np.median(total)),
                "total_s_max": float(np.max(total)),
                "audio_s_per_wall_s": float(sum(
                    f * shift for f in frames) / fs / wall)}

    run("")                                   # warm the shapes
    exact_run = run("")
    check(exact_run["infer_items"] == n,
          f"stream: {exact_run['infer_items']} infer items for {n} exact "
          "requests")
    chunked_run = run(chunked)
    want_items = sum(-(-T // STREAM_CHUNK) for T in frames)
    check(chunked_run["infer_items"] == want_items,
          f"stream: {chunked_run['infer_items']} infer items in chunked "
          f"mode, want sum(ceil(T / C)) = {want_items}")
    emit({"phase": "stream", "requests": n, "clients": STREAM_CLIENTS,
          "seconds": [float(d) for d in STREAM_SECONDS],
          "rates": STREAM_RATES, "formats": fmts, "frames": frames,
          "exact_checks": exact,
          "chunk": STREAM_CHUNK, "lookahead": STREAM_LOOKAHEAD,
          "chunked_mel_rms_dev_over_rms": chunked_dev,
          "chunked_last_rows_max_abs_err": tail_err,
          "griffin_lim_pcm_equal_convert": True,
          "exact": exact_run, "chunked": chunked_run,
          "chunked_items_want": want_items})
    return {"exact": exact_run, "chunked": chunked_run}


def phase_voc_stream(torch, engine):
    """A ``StreamingSession`` on the ``jpwg`` engine of ``voc_serve``: a
    6.5 s utterance fed in ragged pieces, its chunks (``bucket_frames``
    frames, a halo of the receptive field) against the engine's one-shot
    synthesis on the same canvas and noise within ``VOC_TOL`` of the peak;
    the time to the first chunk against the time to the whole; the same
    request over HTTP ``/stream``, PCM within one LSB of the session's."""
    from vae_npvc_tpu_torch.serve import StreamingSession

    fs, hop = engine.fs, engine._voc.hop
    x = _speechlike(int(6.5 * fs), fs, 77)
    pieces, decoded = _stream_body(x, "f32", 78)
    t0 = time.perf_counter()
    want, _ = engine.convert(decoded, fs, 11)
    one_shot_s = time.perf_counter() - t0
    calls0 = engine.batcher.calls
    _zero_counts()
    session = StreamingSession(engine, 11, fs)
    ends = np.cumsum([len(p) for p in pieces]) // 4    # the pieces' samples
    for a, b in zip(np.r_[0, ends[:-1]], ends):
        session.feed(decoded[a:b])
    t0 = time.perf_counter()
    chunks, first = [], None
    for off, w in session.finish():
        if first is None:
            first = time.perf_counter() - t0
        chunks.append((off, w))
    whole = time.perf_counter() - t0
    launches = _read_counts()
    calls = engine.batcher.calls - calls0
    step = engine.bucket_frames * hop
    check([off for off, _ in chunks] == [k * step
                                         for k in range(len(chunks))]
          and len(chunks) > 1, f"voc_stream: chunk offsets "
          f"{[off for off, _ in chunks]}")
    got = np.concatenate([w for _, w in chunks])
    err = float(np.abs(got - want).max()) if got.shape == want.shape \
        else float("inf")
    peak = float(np.abs(want).max())
    check(err <= VOC_TOL * peak, f"voc_stream: streamed wav {got.shape} "
          f"differs from one-shot {want.shape} by {err} (peak {peak})")
    check({k: launches[k] for k in FLAT_LAUNCHES}
          == {k: v * calls for k, v in FLAT_LAUNCHES.items()},
          f"voc_stream: launches {launches} over {calls} infer calls")
    httpd, thread, port = _serving(engine)
    try:
        status, ctype, body, http_first, http_total = _post_stream(
            port, f"target=11&sr={fs}&format=f32", pieces)
    finally:
        _stop(httpd, thread)
    pcm = np.frombuffer(body[44:], "<i2").astype(np.int32)
    mine = (np.clip(got, -1.0, 1.0) * 32767.0).astype(np.int16)
    check(status == 200 and ctype == "audio/wav" and pcm.shape == mine.shape
          and int(np.abs(pcm - mine).max()) <= 1,
          f"voc_stream: HTTP /stream PCM {pcm.shape} against the session's")
    emit({"phase": "voc_stream", "seconds": 6.5,
          "frames": int(got.size // hop), "chunks": len(chunks),
          "chunk_frames": engine.bucket_frames,
          "halo_frames": engine._voc.halo,
          "first_chunk_s": first, "whole_s": whole,
          "one_shot_convert_s": one_shot_s,
          "http_first_audio_byte_s": http_first, "http_total_s": http_total,
          "max_abs_err_vs_one_shot": err, "peak": peak,
          "tol_of_peak": VOC_TOL, "infer_calls": calls,
          "launches": launches})
    return launches, calls


def phase_ckpt_bridge(torch, flat_ckpt, hier_ckpt, root):
    """The reference-PyTorch checkpoint bridge at full width: the ``train``
    phase's flagship checkpoint and the ``hier`` phase's vqvae2 checkpoint
    through ``bin/export_checkpoint`` and back through
    ``bin/convert_checkpoint`` (model and EMA trees bit for bit); a
    ``ConversionEngine`` on the converted flagship against one on the
    original (K1 ids and mel equal) and one ``/stream`` request served from
    it. Returns the K1/K2 launches and the ``infer`` calls."""
    from vae_npvc_tpu_torch.bin import convert_checkpoint, export_checkpoint
    from vae_npvc_tpu_torch.serve import ConversionEngine
    from vae_npvc_tpu_torch.utils import msgpack_io

    root.mkdir(parents=True, exist_ok=True)
    trees = {}
    for name, ck, cfg in (("flagship", flat_ckpt, dict(FLAGSHIP, **TRAIN)),
                          ("vqvae2", hier_ckpt, HIER)):
        conf = root / f"{name}.json"
        conf.write_text(json.dumps(cfg))
        pt, back = root / f"{name}.pt", root / f"{name}.msgpack"
        t0 = time.perf_counter()
        _quiet(export_checkpoint.main,
               [str(ck), "-c", str(conf), "-o", str(pt)])
        export_s = time.perf_counter() - t0
        state = torch.load(pt, map_location="cpu", weights_only=True)
        t0 = time.perf_counter()
        _quiet(convert_checkpoint.main,
               [str(pt), str(back), "-c", str(conf)])
        convert_s = time.perf_counter() - t0
        a = msgpack_io.msgpack_restore(ck.read_bytes())
        b = msgpack_io.msgpack_restore(back.read_bytes())
        check(a["iteration"] == b["iteration"] == state["iteration"],
              f"ckpt_bridge: {name}: iterations {a['iteration']}, "
              f"{b['iteration']}")
        n_leaves = 0
        for part in ("model", "ema"):
            la, lb = _leaves(a.get(part, {})), _leaves(b.get(part, {}))
            check(la.keys() == lb.keys(), f"ckpt_bridge: {name} {part}: "
                  f"keys {sorted(la.keys() ^ lb.keys())[:5]}")
            for k, v in la.items():
                check(v.dtype == lb[k].dtype and np.array_equal(v, lb[k]),
                      f"ckpt_bridge: {name} {part}/{k} changed")
            n_leaves += len(la)
        init = [k for k in state["model"] if k.endswith(".emb_init")]
        check(all(state["model"][k].dtype == torch.bool for k in init),
              f"ckpt_bridge: {name}: emb_init not bool")
        trees[name] = {"state_dict_entries": len(state["model"]),
                       "leaves_equal": n_leaves, "emb_init": len(init),
                       "pt_mb": pt.stat().st_size / 1e6,
                       "export_s": export_s, "convert_s": convert_s}

    stats = _cmvn_stats()
    fs = 24000
    x = _speechlike(int(5.2 * fs), fs, 88)
    orig = ConversionEngine(FLAGSHIP, flat_ckpt, stats, vocoder="none",
                            device="cuda")
    conv = ConversionEngine(FLAGSHIP, root / "flagship.msgpack", stats,
                            vocoder="none", device="cuda")
    try:
        _zero_counts()
        want, want_ids = _k1_ids(
            lambda: orig.convert(x, fs, 17, return_mel=True)[0])
        got, ids = _k1_ids(lambda: conv.convert(x, fs, 17, return_mel=True)[0])
        check(len(ids) == len(want_ids) == 1
              and torch.equal(ids[0], want_ids[0])
              and np.array_equal(got, want),
              "ckpt_bridge: the converted flagship's ids or mel differ")
        httpd, thread, port = _serving(conv)
        try:
            pieces, _ = _stream_body(x, "f32", 89)
            status, _, body, _, stream_s = _post_stream(
                port, f"target=17&sr={fs}&format=f32", pieces)
        finally:
            _stop(httpd, thread)
        streamed = np.load(io.BytesIO(body))
        check(status == 200 and np.array_equal(streamed, got),
              "ckpt_bridge: /stream on the converted checkpoint differs "
              "from its /convert mel")
        launches = _read_counts()
        calls = orig.batcher.calls + conv.batcher.calls
        check({k: launches[k] for k in FLAT_LAUNCHES}
              == {k: v * calls for k, v in FLAT_LAUNCHES.items()},
              f"ckpt_bridge: launches {launches} over {calls} infer calls")
    finally:
        orig.close()
        conv.close()
    emit({"phase": "ckpt_bridge", "checkpoints": trees,
          "converted_flagship_ids_and_mel_equal": True,
          "stream_request_s": stream_s, "infer_calls": calls,
          "launches": launches})
    return launches, calls


def _kernel_class(name):
    """Class of a device kernel by its name. The streaming path's
    statistics kernel ``gn_stream_stats`` is shared by the GroupNorm
    forward and backward and counts as the forward's here;
    ``device_ms_by_operator`` splits the two by the autograd Function that
    launched them."""
    n = name.lower()
    for key, cls in (("::attn_fwd", "fused_attention"),
                     ("::attn_bwd", "fused_attention_backward"),
                     ("::gn_bwd", "fused_group_norm_backward"),
                     ("::gn_", "fused_group_norm"), ("::vq_", "vq_fused"),
                     ("nccl", "nccl"), ("fft", "fft"), ("memcpy", "memcpy"),
                     ("fprop", "conv"), ("dgrad", "conv"), ("wgrad", "conv"),
                     ("conv", "conv"),
                     ("nchwtonhwc", "layout"), ("nhwctonchw", "layout"),
                     ("gemm", "matmul"), ("cutlass", "matmul"),
                     ("col2im", "overlap_add"), ("reduce_kernel", "reduce"),
                     ("elementwise", "elementwise")):
        if key in n:
            return cls
    return "other"


def _profiled(torch, fn, by_operator=True):
    """Device time by kernel class, host wall time and the device's idle
    share over one call of ``fn`` (one stream: kernels do not overlap).
    ``by_operator=False`` traces the device only (no host events to sort
    through: a call of tens of thousands of launches)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if by_operator else [])
    with profile(activities=activities) as prof:
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
    # device time by the PyTorch operator that launched the kernels
    by_op, host_op, copies = {}, {}, None
    if by_operator:
        averages = prof.key_averages()
        by_op = {a.key: a.self_device_time_total / 1e3 for a in averages
                 if a.self_device_time_total > 0
                 and a.device_type != torch.autograd.DeviceType.CUDA}
        host_op = {a.key: a.self_cpu_time_total / 1e3 for a in averages
                   if a.device_type != torch.autograd.DeviceType.CUDA}
        copies = sum(a.count for a in averages if a.key == "aten::copy_")

    def top(d, k):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:k])

    return {"wall_ms": wall_ms, "device_ms": busy, "device_events": n,
            "idle_share": (1 - busy / wall_ms) if n else None,
            "device_ms_by_class": top(by_class, 10),
            "top_kernels_ms": top(by_name, 8),
            "device_ms_by_operator": top(by_op, 12),
            "host_ms_by_operator": top(host_op, 12),
            "aten_copy_calls": copies}


STEP_KERNEL_CLASSES = ("vq_fused", "fused_group_norm",
                       "fused_group_norm_backward")


def _step_kernels(torch, step):
    """The device kernels of K1, K2 and K3 (:func:`_kernel_class`) one call
    of ``step()`` ran, by class, read from a torch.profiler window after
    ``PROFILER_PAD`` spin kernels: a step replayed from a CUDA graph calls
    no wrapper, so its kernels are counted on the device."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _profiler_pad(torch)
        step()
        torch.cuda.synchronize()
    counts = collections.Counter(_kernel_class(e.name)
                                 for e in _kernel_events(torch, prof))
    return {k: counts[k] for k in STEP_KERNEL_CLASSES}


def _replayed_kernels(torch, tr, step, what):
    """:func:`_step_kernels` of a step run eager and of one replayed from
    ``tr``'s CUDA graph (eager too where the trainer takes no graph), which
    must be equal: the replay runs the hand-written kernels the eager
    step's wrappers launch. A pair of windows that differ is taken again,
    up to three times (the profiler may drop a window's first kernels),
    and then fails. Returns the last pair."""
    from vae_npvc_tpu_torch.train.trainer import Trainer

    for _ in range(3):
        with Trainer.eager_steps():
            eager = _step_kernels(torch, step)
        r0 = Trainer.graph_replays
        replayed = _step_kernels(torch, step)
        check((Trainer.graph_replays > r0) == tr._graphed(),
              f"{what}: {Trainer.graph_replays - r0} steps replayed")
        if all(eager.values()) and replayed == eager:
            break
    check(all(eager.values()) and replayed == eager,
          f"{what}: kernels of a replayed step {replayed}, of an eager step "
          f"{eager}")
    return {"eager": eager, "replayed": replayed}


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


GRAD_TOL = 2e-3   # max |grad_gpu - grad_cpu| over each gradient's peak


def _set_codebook(torch, model, seed):
    """A seeded normal codebook at the scale of the encoder's output (a
    fresh EMA codebook is all zeros and would be drawn from the batch)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        z = model.encoder(torch.tensor(
            rng.normal(size=(2, 64, 80)), dtype=torch.float32,
            device=model.quantizer.emb.device).to(model.dtype))
        q = model.quantizer
        emb = torch.tensor(rng.normal(size=q.emb.shape), dtype=torch.float32,
                           device=q.emb.device) * z.float().std()
        q.set_state((torch.ones_like(q.initted), emb, emb,
                     torch.ones_like(q.emb_elem)))


def phase_grad_fp32(torch):
    """The full-width model in fp32 at B = 4, T = 256: the training loss and
    every parameter gradient on the card (fused VQ in its statistics mode,
    GroupNorm forward and backward kernels) against the same weights on
    the CPU (plain versions), within ``GRAD_TOL`` of each gradient's peak."""
    from vae_npvc_tpu_torch.models import build_model
    from vae_npvc_tpu_torch.ops.groupnorm import (fused_group_norm,
                                                  fused_group_norm_backward)
    from vae_npvc_tpu_torch.ops.vq_fused import vq_fused

    cfg = dict(FLAGSHIP, compute_dtype="float32")
    rng = np.random.default_rng(3)
    B, T, D = 4, 256, cfg["encoder"]["in_channels"][0]
    t = np.linspace(0, 1, T)[None, :, None]
    feats = (np.sin(2 * np.pi * (rng.uniform(1, 4, (B, 1, D)) * t
                                 + rng.uniform(0, 1, (B, 1, D))))
             + 0.3 * rng.normal(size=(B, T, D))).astype(np.float32)
    spks = np.array([0, 5, 116, 33], np.int64)
    cpu = build_model(cfg, device="cpu").init_random(0)
    _set_codebook(torch, cpu, 0)
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    counts0 = (vq_fused.launches, fused_group_norm.launches,
               fused_group_norm_backward.launches)
    runs = {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        dev = next(model.parameters()).device
        gen = torch.Generator(device=dev).manual_seed(0)
        _, loss, detail = model(torch.as_tensor(feats, device=dev),
                                torch.as_tensor(spks, device=dev), True,
                                gen=gen)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        with torch.no_grad():
            ids = model.encode(torch.as_tensor(feats, device=dev)).cpu()
        runs[name] = (float(loss.detach()), [g.cpu() for g in grads], ids,
                      {k: float(v.detach()) for k, v in detail.items()})
    launched = (vq_fused.launches - counts0[0],
                fused_group_norm.launches - counts0[1],
                fused_group_norm_backward.launches - counts0[2])
    (loss_d, grads_d, ids_d, det_d), (loss_c, grads_c, ids_c, det_c) = \
        runs["cuda"], runs["cpu"]
    worst, worst_name = 0.0, None
    for (name, _), a, b in zip(cpu.named_parameters(), grads_d, grads_c):
        check(bool(torch.isfinite(a).all()), f"grad_fp32: {name} not finite")
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
        if rel > worst:
            worst, worst_name = rel, name
    emit({"phase": "grad_fp32", "B": B, "T": T, "parameters": len(grads_c),
          "loss_gpu": loss_d, "loss_cpu": loss_c,
          "ids_differ": int((ids_d != ids_c).sum()),
          "worst_grad_err_over_peak": worst, "worst_grad": worst_name,
          "tolerance": GRAD_TOL, "used_curr_gpu": det_d["used_curr"],
          "used_curr_cpu": det_c["used_curr"],
          "launches_vq_gn_gnbwd": list(launched)})
    # one training forward (statistics mode, 20 norms, 20 backward) + one
    # encode (ids mode, the encoder's 10 norms)
    check(launched == (2, 30, 20), f"grad_fp32: launches {launched}")
    check(abs(loss_d - loss_c) <= 1e-4 * abs(loss_c),
          f"grad_fp32: loss {loss_d} on the card, {loss_c} on the CPU")
    check(worst <= GRAD_TOL,
          f"grad_fp32: gradient of {worst_name} differs by {worst} of its "
          "peak")


GOLDEN_LOSS_RTOL = 1e-4           # per-step Total, VQ loss, X like, grad_norm
GOLDEN_STATE_TOL = (2e-5, 1e-3)   # final state: atol, rtol per leaf


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def phase_train_golden(torch):
    """The port's ``Trainer`` on the card, from the committed JAX checkpoint
    over the fixture's batches: JAX's per-step losses and gradient norm,
    then its final parameters, EMA state and Adam moments (fp32; every code
    stays alive, so no step uses a random draw)."""
    from vae_npvc_tpu_torch.train import build_trainer
    from vae_npvc_tpu_torch.utils import msgpack_io

    cfg = json.loads((FIXTURES / "train_golden_config.json").read_text())
    g = np.load(FIXTURES / "train_golden.npz")
    steps = len(g["detail/Total"])
    tr = build_trainer(cfg, device="cuda")
    tr.load_checkpoint(FIXTURES / "train_golden.msgpack")
    worst = {}
    for i in range(steps):
        detail = tr.train_step((g[f"feats_{i}"], g[f"spks_{i}"]))
        for k in ("Total", "VQ loss", "X like", "grad_norm"):
            want = float(g["detail/" + k][i])
            rel = abs(float(detail[k]) - want) / max(abs(want), 1e-12)
            worst[k] = max(worst.get(k, 0.0), rel)
            check(rel <= GOLDEN_LOSS_RTOL,
                  f"train_golden: step {i + 1} {k} {float(detail[k])}, JAX "
                  f"{want}")
        check(float(detail["usage"]) == cfg["z_num"]
              and float(detail["skipped_nonfinite"]) == 0.0,
              f"train_golden: step {i + 1} usage/skip differ from JAX")
    with tempfile.TemporaryDirectory() as tmp:
        tr.save_checkpoint(Path(tmp) / "final")
        got = _leaves(msgpack_io.msgpack_restore(
            (Path(tmp) / "final").read_bytes()))
    want = _leaves(msgpack_io.msgpack_restore(
        (FIXTURES / "train_golden_final.msgpack").read_bytes()))
    check(set(got) == set(want), "train_golden: checkpoint trees differ")
    atol, rtol = GOLDEN_STATE_TOL
    state_err = 0.0
    for k in want:
        a, b = got[k].astype(np.float64), want[k].astype(np.float64)
        check(a.shape == b.shape, f"train_golden: {k} shape {a.shape}")
        err = np.abs(a - b)
        state_err = max(state_err, float(err.max()) if err.size else 0.0)
        check(bool(np.all(err <= atol + rtol * np.abs(b))),
              f"train_golden: {k} differs from JAX by {float(err.max())}")
    emit({"phase": "train_golden", "steps": steps,
          "worst_rel_err": worst, "loss_rtol": GOLDEN_LOSS_RTOL,
          "state_leaves": len(want), "state_max_abs_err": state_err,
          "state_atol_rtol": list(GOLDEN_STATE_TOL)})


def _synthetic_corpus(root, n_utts, seed, frames=None,
                      compression_method=None):
    """A Kaldi data dir of smooth mel-like utterances (a few slow
    sinusoids per band on a speaker-dependent offset, plus noise), written
    with the port's ark writer; ``frames`` gives each utterance's length
    (default: 280-519 frames drawn from the seed)."""
    from vae_npvc_tpu_torch.data import kaldi_io

    rng = np.random.default_rng(seed)
    D = FLAGSHIP["encoder"]["in_channels"][0]
    band = np.linspace(0, 1, D)[None, :]
    spk_offset = rng.normal(0, 0.5, size=(FLAGSHIP["y_num"], D))
    lens, spks = [], []
    with kaldi_io.ArkWriter(root / "feats.ark", root / "feats.scp",
                            compression_method) as w:
        for i in range(n_utts):
            n = int(rng.integers(280, 520)) if frames is None \
                else int(frames[i])
            spk = int(rng.integers(0, FLAGSHIP["y_num"]))
            t = np.arange(n)[:, None] / 100.0
            mel = sum(rng.uniform(0.3, 1.0)
                      * np.sin(2 * np.pi * (rng.uniform(0.5, 4.0) * t
                                            + rng.uniform(0.5, 3.0) * band
                                            + rng.uniform()))
                      for _ in range(4))
            mel = mel + spk_offset[spk] + 0.1 * rng.normal(size=(n, D))
            w.write(f"utt{i:04d}", mel.astype(np.float32))
            lens.append(n)
            spks.append(spk)
    (root / "utt2num_frames").write_text(
        "".join(f"utt{i:04d} {n}\n" for i, n in enumerate(lens)))
    (root / "utt2spk_id").write_text(
        "".join(f"utt{i:04d} {s}\n" for i, s in enumerate(spks)))


def phase_train(torch, keep):
    """The recipe's model at full width, bf16, B = 128, T = 256 through
    ``Trainer`` on a synthetic corpus staged on the device: the lazy
    codebook init and ``TRAIN_STEPS`` optimizer steps in the recipe's
    chunks of 8 (the first eager, the second captured as a CUDA graph, the
    rest replayed), with the kernels' launch counts of the steps that call
    the wrappers, a save/load round trip, one profiled step and the
    K1/K2/K3 kernels of a replayed step against an eager one's. The
    checkpoint is copied to ``keep``. Returns the launch counts of the
    run."""
    from vae_npvc_tpu_torch.data.dataset import (UttMelSpkDataset,
                                                 batch_iterator,
                                                 index_iterator)
    from vae_npvc_tpu_torch.ops.groupnorm import (fused_group_norm,
                                                  fused_group_norm_backward)
    from vae_npvc_tpu_torch.ops.vq_fused import vq_fused
    from vae_npvc_tpu_torch.train import build_trainer
    from vae_npvc_tpu_torch.train.trainer import Trainer

    cfg = dict(FLAGSHIP, **TRAIN)
    B, T = cfg["batch_size"], cfg["crop_length"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        _synthetic_corpus(root, 256, seed=4)
        dataset = UttMelSpkDataset(root, cfg)
        tr = build_trainer(cfg, device="cuda")
        tr.init_state()
        staged = tr.stage_dataset(dataset, B)
        pairs = index_iterator(dataset, B, shuffle=True, drop_last=True,
                               seed=cfg["seed"])

        def chunk(k):
            got = [next(pairs) for _ in range(k)]
            return (np.stack([p[0] for p in got]),
                    np.stack([p[1] for p in got]))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        vq_fused.launches = 0
        fused_group_norm.launches = 0
        fused_group_norm_backward.launches = 0
        # one fixed batch, scored after the first chunk (which holds the
        # lazy codebook init) and after the last: the steps' own losses come
        # from different batches and move by several units from one step to
        # the next, so the fixed batch is checked beside them
        held = [next(batch_iterator(dataset, B, shuffle=False,
                                    drop_last=True, num_workers=0,
                                    epochs=1))]
        held_x_like = []
        details, times, done = [], [], 0
        c0, r0 = Trainer.graph_captures, Trainer.graph_replays
        while done < TRAIN_STEPS:
            k = min(cfg["steps_per_call"], TRAIN_STEPS - done)
            idx, starts = chunk(k)
            t0 = time.perf_counter()
            details.append(tr.train_steps_indices(idx, starts))
            torch.cuda.synchronize()
            times.append(((time.perf_counter() - t0) * 1e3, k))
            done += k
            if done == k or done == TRAIN_STEPS:
                # the scoring pass is no training step: its launches are
                # kept out of the per-step counts
                counts = (vq_fused.launches, fused_group_norm.launches)
                held_x_like.append(tr.valid(held)["X like"][0])
                vq_fused.launches, fused_group_norm.launches = counts
        launches = {"vq_fused": vq_fused.launches,
                    "fused_group_norm": fused_group_norm.launches,
                    "fused_group_norm_backward":
                        fused_group_norm_backward.launches}
        graphs = (Trainer.graph_captures - c0, Trainer.graph_replays - r0)
        peak_bytes = torch.cuda.max_memory_allocated()
        detail = {k: torch.cat([d[k] for d in details]).float().cpu().numpy()
                  for k in details[0]}
        check(tr.iteration == TRAIN_STEPS, f"train: {tr.iteration} steps")
        for k, v in detail.items():
            check(bool(np.all(np.isfinite(v))), f"train: {k} not finite: {v}")
        check(float(detail["skipped_nonfinite"].sum()) == 0.0,
              f"train: steps skipped: {detail['skipped_nonfinite']}")
        first, last = detail["X like"][:4].mean(), detail["X like"][-4:].mean()
        check(last < first, f"train: X like {first} -> {last} did not fall")
        check(held_x_like[1] < held_x_like[0],
              f"train: X like of a fixed batch {held_x_like[0]} -> "
              f"{held_x_like[1]} did not fall")
        per_step = {"vq_fused": 1, "fused_group_norm": 20,
                    "fused_group_norm_backward": 20}
        # the first step runs eager, the second is captured and every later
        # one replayed; the wrappers count the eager steps' and the
        # capture's calls
        check(graphs == ((1, TRAIN_STEPS - 1) if tr._graphed() else (0, 0)),
              f"train: captures, replays {graphs}")
        called = TRAIN_STEPS - graphs[1] + graphs[0]
        check(launches == {k: v * called for k, v in per_step.items()},
              f"train: launches {launches} over {called} steps that called "
              "the wrappers")

        # save -> load into a second trainer -> the same next step
        ckpt = root / f"iter.{TRAIN_STEPS}"
        tr.save_checkpoint(ckpt)
        Path(keep).write_bytes(ckpt.read_bytes())
        other = build_trainer(cfg, device="cuda")
        check(other.load_checkpoint(ckpt) == TRAIN_STEPS, "train: iteration")
        other.stage_dataset(dataset, B)
        idx, starts = chunk(1)
        a = float(tr.train_steps_indices(idx, starts)["Total"][0])
        b = float(other.train_steps_indices(idx, starts)["Total"][0])
        check(math.isfinite(a) and abs(a - b) <= 1e-6 * abs(a),
              f"train: next step {a}, after save/load {b}")
        del other
        idx, starts = chunk(1)
        profile = _profiled(
            torch, lambda: tr.train_steps_indices(idx, starts))
        kernels = _replayed_kernels(
            torch, tr, lambda: tr.train_steps_indices(*chunk(1)), "train")
    # steady state: the chunks after the first (which holds the lazy init
    # and cuDNN's algorithm selection)
    steady_ms = sum(ms for ms, _ in times[1:]) / sum(k for _, k in times[1:])
    emit({"phase": "train", "steps": TRAIN_STEPS, "B": B, "T": T,
          "dtype": cfg["compute_dtype"], "utterances": len(dataset),
          "staged_bytes": staged, "parameters": int(tr.flat.numel()),
          "chunk_ms": [round(ms, 3) for ms, _ in times],
          "ms_per_step": steady_ms,
          "frames_per_s": B * T / steady_ms * 1e3,
          "peak_memory_bytes": peak_bytes,
          "x_like_first4": float(first), "x_like_last4": float(last),
          "held_batch_x_like_after_first_chunk_and_last": held_x_like,
          "total": [float(v) for v in detail["Total"]],
          "grad_norm_first_last": [float(detail["grad_norm"][0]),
                                   float(detail["grad_norm"][-1])],
          "usage_first_last": [float(detail["usage"][0]),
                               float(detail["usage"][-1])],
          "launches": launches, "launches_per_step": per_step,
          "graph_captures_replays": list(graphs),
          "kernels_of_one_step": kernels,
          "next_step_total": a, "next_step_total_after_load": b,
          "one_step_profile": profile})
    return launches


def _tts_free_leaf(key):
    """Parameters whose gradient is zero in exact arithmetic (the key
    projection's bias, which shifts every score of a softmax row alike, and
    the direction-only ``v`` of a weight-normalized conv with one input
    channel): Adam turns their rounding-noise gradients into steps of the
    size of the learning rate, in a direction that differs between
    frameworks, and the loss does not see them."""
    return key.startswith("model/") and key.endswith(
        ("mha/linear_k/bias", "pitch_proj/v", "energy_proj/v"))


def phase_tts_golden(torch):
    """The port on the card against the committed JAX fixture of a small
    transformer synthesizer: ``infer`` from the JAX checkpoint (attention
    forward kernel), then six ``Trainer`` steps (forward and backward
    kernels) against JAX's per-step losses and gradient norm and its final
    parameters and Adam moments."""
    from vae_npvc_tpu_torch.ops.attention import (fused_attention,
                                                  fused_attention_backward)
    from vae_npvc_tpu_torch.train import build_trainer
    from vae_npvc_tpu_torch.utils import msgpack_io

    cfg = json.loads((FIXTURES / "tts_golden_config.json").read_text())
    g = np.load(FIXTURES / "tts_golden.npz")
    names = ("tokens", "durations", "mels", "spks", "tok_lens", "mel_lens")
    steps = len(g["detail/Total"])
    tr = build_trainer(cfg, device="cuda")
    tr.load_checkpoint(FIXTURES / "tts_golden.msgpack")
    counts0 = (fused_attention.launches, fused_attention_backward.launches)
    with torch.no_grad():
        mel, lens = tr.model.infer(*(
            torch.as_tensor(g[f"{k}_0"], device=tr.device)
            for k in ("tokens", "spks", "tok_lens")))
    mel, lens = mel.cpu().numpy(), lens.cpu().numpy()
    check(lens.tolist() == g["infer/mel_lens"].tolist(),
          f"tts_golden: mel_lens {lens.tolist()}, JAX "
          f"{g['infer/mel_lens'].tolist()}")
    mel_err = float(np.abs(mel - g["infer/mel"]).max())
    check(mel_err <= 1e-4, f"tts_golden: mel differs from JAX by {mel_err}")
    worst = {}
    for i in range(steps):
        detail = tr.train_step(tuple(g[f"{k}_{i}"] for k in names))
        for k in ("Total", "X like", "X pre like", "DUR loss", "PITCH loss",
                  "ENERGY loss", "grad_norm"):
            want = float(g["detail/" + k][i])
            rel = abs(float(detail[k]) - want) / max(abs(want), 1e-12)
            worst[k] = max(worst.get(k, 0.0), rel)
            check(rel <= GOLDEN_LOSS_RTOL,
                  f"tts_golden: step {i + 1} {k} {float(detail[k])}, JAX "
                  f"{want}")
        check(float(detail["skipped_nonfinite"]) == 0.0,
              f"tts_golden: step {i + 1} skipped")
    blocks = cfg["elayers"] + cfg["dlayers"]
    launched = (fused_attention.launches - counts0[0],
                fused_attention_backward.launches - counts0[1])
    check(launched == (blocks * (1 + steps), blocks * steps),
          f"tts_golden: launches {launched}")
    with tempfile.TemporaryDirectory() as tmp:
        tr.save_checkpoint(Path(tmp) / "final")
        got = _leaves(msgpack_io.msgpack_restore(
            (Path(tmp) / "final").read_bytes()))
    want = _leaves(msgpack_io.msgpack_restore(
        (FIXTURES / "tts_golden_final.msgpack").read_bytes()))
    check(set(got) == set(want), "tts_golden: checkpoint trees differ")
    atol, rtol = GOLDEN_STATE_TOL
    reach = 2 * steps * cfg["learning_rate"]
    state_err = 0.0
    for k in want:
        a, b = got[k].astype(np.float64), want[k].astype(np.float64)
        check(a.shape == b.shape, f"tts_golden: {k} shape {a.shape}")
        err = np.abs(a - b)
        if _tts_free_leaf(k):
            check(bool(np.all(err <= reach)), f"tts_golden: {k} beyond the "
                  f"reach of {steps} steps")
            continue
        state_err = max(state_err, float(err.max()) if err.size else 0.0)
        check(bool(np.all(err <= atol + rtol * np.abs(b))),
              f"tts_golden: {k} differs from JAX by {float(err.max())}")
    emit({"phase": "tts_golden", "steps": steps, "mel_max_abs_err": mel_err,
          "mel_tolerance": 1e-4, "mel_lens": lens.tolist(),
          "worst_rel_err": worst, "loss_rtol": GOLDEN_LOSS_RTOL,
          "state_leaves": len(want), "state_max_abs_err": state_err,
          "state_atol_rtol": list(GOLDEN_STATE_TOL),
          "launches_fwd_bwd": list(launched)})


def _token_mel_corpus(root, n_utts, seed):
    """A token-mel directory at the recipe's sizes: up to 192 tokens of 1-6
    frames each (at most 768 frames), mels that are a fixed pattern per
    token plus a speaker offset and noise, so they can be learned."""
    from vae_npvc_tpu_torch.data.token_mel import write_token_mel_dir

    rng = np.random.default_rng(seed)
    D, L, T = TTS["mel_dim"], TTS["max_tokens"], TTS["max_frames"]
    pattern = rng.normal(0, 1.0, size=(TTS["token_num"], D))
    spk_offset = rng.normal(0, 0.3, size=(TTS["y_num"], D))
    items = []
    for i in range(n_utts):
        n = L if i % 4 == 0 else int(rng.integers(L // 3, L + 1))
        toks = rng.integers(0, TTS["token_num"], size=n)
        durs = rng.integers(1, 7, size=n)
        while durs.sum() > T:
            durs[int(np.argmax(durs))] -= 1
        spk = int(rng.integers(0, TTS["y_num"]))
        mel = np.repeat(pattern[toks], durs, axis=0) + spk_offset[spk] \
            + 0.1 * rng.normal(size=(int(durs.sum()), D))
        items.append((f"utt{i:04d}", toks, durs, mel.astype(np.float32), spk))
    write_token_mel_dir(root, items)
    return items


def phase_tts(torch):
    """The recipe's transformer synthesizer at full width, fp32, seeded
    random weights, on a synthetic token-mel corpus: ``bin/decode_tts``
    over eight utterances (B = 1, L = 192, T = 768; one utterance held
    against the CPU), then ``TTS_STEPS`` optimizer steps at B = 32 from
    ``TokenMelDataset`` batches through ``Trainer``, a save/load round trip,
    one profiled step, and a few steps in bf16 and one profiled. Returns
    the attention kernels' launch counts of the decode and of the fp32
    steps."""
    from vae_npvc_tpu_torch.bin import decode_tts
    from vae_npvc_tpu_torch.data import kaldi_io
    from vae_npvc_tpu_torch.data.token_mel import (TokenMelDataset,
                                                   parse_token_line)
    from vae_npvc_tpu_torch.ops.attention import (fused_attention,
                                                  fused_attention_backward)
    from vae_npvc_tpu_torch.train import build_trainer

    cfg = dict(TTS)
    B, L, T = cfg["batch_size"], cfg["max_tokens"], cfg["max_frames"]
    blocks = cfg["elayers"] + cfg["dlayers"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        _token_mel_corpus(root / "train", 2 * B, seed=5)
        dataset = TokenMelDataset(root / "train", cfg)
        conf = root / "conf.json"
        conf.write_text(json.dumps(cfg))
        tr = build_trainer(cfg, device="cuda")
        tr.init_state()
        with torch.no_grad():    # predicted durations of about three frames
            tr.model.dur_1.b.fill_(1.3)
        tr.save_checkpoint(root / "iter.0")

        # ------------------------------------------------------- decode
        lines = kaldi_io.load_dict_data(root / "train" / "tokens.txt")
        utts = list(lines)[:TTS_DECODE_UTTS]
        (root / "text").write_text(
            "".join(f"{u} {lines[u]}\n" for u in utts))
        args = ["-c", str(conf), "--checkpoint", str(root / "iter.0"),
                "--tokens", str(root / "text"), "--spk", "3"]
        decode_tts.main(args + ["--output-dir", str(root / "warm")])
        torch.cuda.synchronize()
        fused_attention.launches = 0
        fused_attention_backward.launches = 0
        t0 = time.perf_counter()
        decode_tts.main(args + ["--output-dir", str(root / "dec")])
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / len(utts)
        decode_launches = (fused_attention.launches,
                           fused_attention_backward.launches)
        check(decode_launches == (blocks * len(utts), 0),
              f"tts: decode launches {decode_launches}")
        scp = kaldi_io.load_dict_data(root / "dec" / "feats.scp")
        check(list(scp) == utts, f"tts: decoded {list(scp)}")
        frames = []
        for u in utts:
            m = kaldi_io.load_mat(scp[u])
            check(m.ndim == 2 and m.shape[1] == cfg["mel_dim"]
                  and 0 < m.shape[0] <= T and bool(np.isfinite(m).all()),
                  f"tts: decoded {u} has shape {m.shape}")
            frames.append(int(m.shape[0]))
        # the first utterance on the CPU (plain attention) from the same file
        cpu = decode_tts.load_model(cfg, root / "iter.0", "cpu")
        toks = parse_token_line(lines[utts[0]])[:L]
        pad = np.zeros((1, L), np.int32)
        pad[0, :len(toks)] = toks
        with torch.inference_mode():
            ref, ref_len = cpu.infer(
                torch.from_numpy(pad), torch.tensor([3], dtype=torch.int32),
                torch.tensor([len(toks)], dtype=torch.int32))
        ref = ref[0, :int(ref_len[0])].numpy()
        got = kaldi_io.load_mat(scp[utts[0]])
        check(got.shape == ref.shape,
              f"tts: decoded {got.shape} frames, the CPU {ref.shape}")
        peak = float(np.abs(ref).max())
        decode_err = float(np.abs(got - ref).max())
        check(decode_err <= 1e-3 * peak,
              f"tts: decoded mel differs from the CPU by {decode_err} "
              f"(peak {peak})")
        gpu_model = decode_tts.load_model(cfg, root / "iter.0", "cuda")
        ids = (torch.as_tensor(pad, device="cuda"),
               torch.tensor([3], dtype=torch.int32, device="cuda"),
               torch.tensor([len(toks)], dtype=torch.int32, device="cuda"))

        def one_infer():
            with torch.inference_mode():
                gpu_model.infer(*ids)

        one_infer()
        infer_profile = _profiled(torch, one_infer)
        del gpu_model, cpu

        # ------------------------------------------------------ training
        batches = dataset.batches(B, shuffle=True, seed=cfg["seed"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_attention.launches = 0
        fused_attention_backward.launches = 0
        details, times = [], []
        for _ in range(TTS_STEPS):
            batch = next(batches)
            t0 = time.perf_counter()
            details.append(tr.train_step(batch))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        train_launches = (fused_attention.launches,
                          fused_attention_backward.launches)
        peak_bytes = torch.cuda.max_memory_allocated()
        detail = {k: torch.stack([d[k] for d in details]).float().cpu()
                  .numpy() for k in details[0]}
        check(tr.iteration == TTS_STEPS, f"tts: {tr.iteration} steps")
        for k, v in detail.items():
            check(bool(np.all(np.isfinite(v))), f"tts: {k} not finite: {v}")
        check(float(detail["skipped_nonfinite"].sum()) == 0.0,
              f"tts: steps skipped: {detail['skipped_nonfinite']}")
        first, last = detail["X like"][:3].mean(), detail["X like"][-3:].mean()
        check(last < first, f"tts: X like {first} -> {last} did not fall")
        check(train_launches == (blocks * TTS_STEPS, blocks * TTS_STEPS),
              f"tts: launches {train_launches} over {TTS_STEPS} steps")

        ckpt = root / f"iter.{TTS_STEPS}"
        tr.save_checkpoint(ckpt)
        other = build_trainer(cfg, device="cuda")
        check(other.load_checkpoint(ckpt) == TTS_STEPS, "tts: iteration")
        batch = next(batches)
        a = float(tr.train_step(batch)["Total"])
        b = float(other.train_step(batch)["Total"])
        check(math.isfinite(a) and abs(a - b) <= 1e-6 * abs(a),
              f"tts: next step {a}, after save/load {b}")
        del other
        batch = next(batches)
        profile = _profiled(torch, lambda: tr.train_step(batch))

        # ------------------------------------------------ a few bf16 steps
        cfg16 = dict(cfg, compute_dtype="bfloat16")
        tr16 = build_trainer(cfg16, device="cuda")
        tr16.init_state()
        f0, b0 = fused_attention.launches, fused_attention_backward.launches
        times16, total16 = [], []
        for _ in range(TTS_BF16_STEPS):
            batch = next(batches)
            t0 = time.perf_counter()
            d16 = tr16.train_step(batch)
            torch.cuda.synchronize()
            times16.append((time.perf_counter() - t0) * 1e3)
            total16.append(float(d16["Total"]))
            check(math.isfinite(total16[-1])
                  and float(d16["skipped_nonfinite"]) == 0.0,
                  f"tts: bf16 step {total16}")
        check((fused_attention.launches - f0,
               fused_attention_backward.launches - b0)
              == (blocks * TTS_BF16_STEPS,) * 2, "tts: bf16 launches")
        batch = next(batches)
        profile16 = _profiled(torch, lambda: tr16.train_step(batch))
    steady = float(np.mean(times[2:]))
    emit({"phase": "tts", "config": "train_token_tts_transformer.yaml",
          "dtype": "float32", "parameters": int(tr.flat.numel()),
          "utterances": len(dataset),
          "decode": {"utterances": len(utts), "B": 1, "L": L, "T": T,
                     "ms_per_utterance": decode_ms, "frames": frames,
                     "launches": decode_launches[0],
                     "launches_per_infer": blocks,
                     "mel_max_abs_err_vs_cpu": decode_err, "mel_peak": peak,
                     "one_infer_profile": infer_profile},
          "train": {"steps": TTS_STEPS, "B": B, "L": L, "T": T,
                    "step_ms": [round(t, 3) for t in times],
                    "ms_per_step": steady,
                    "frames_per_s": B * T / steady * 1e3,
                    "peak_memory_bytes": peak_bytes,
                    "x_like_first3": float(first),
                    "x_like_last3": float(last),
                    "total": [float(v) for v in detail["Total"]],
                    "grad_norm_first_last": [float(detail["grad_norm"][0]),
                                             float(detail["grad_norm"][-1])],
                    "launches_fwd_bwd": list(train_launches),
                    "launches_per_step": [blocks, blocks],
                    "next_step_total": a, "next_step_total_after_load": b,
                    "one_step_profile": profile},
          "train_bf16": {"steps": TTS_BF16_STEPS,
                         "step_ms": [round(t, 3) for t in times16],
                         "ms_per_step": float(np.mean(times16[1:])),
                         "total": total16,
                         "one_step_profile": profile16}})
    return {"fused_attention": decode_launches[0] + train_launches[0],
            "fused_attention_backward": train_launches[1]}


def phase_hier_golden(torch):
    """The port on the card against the committed JAX fixture of a small
    vqvae2 in the recipe's form (tests/test_torch_port_hier_train.py), in
    fp32: the evaluation batch's valid-mode losses, ``encode`` ids (equal)
    and style and ``infer`` mel (1e-4 of the peak) from the JAX checkpoint,
    then six ``Trainer`` steps against JAX's per-step losses and gradient
    norm and its final parameters and Adam moments."""
    from vae_npvc_tpu_torch.models.vqvae import Encoder
    from vae_npvc_tpu_torch.train import build_trainer
    from vae_npvc_tpu_torch.utils import msgpack_io

    cfg = json.loads((FIXTURES / "hier_golden_config.json").read_text())
    g = np.load(FIXTURES / "hier_golden.npz")
    steps = len(g["detail/Total"])
    tr = build_trainer(cfg, device="cuda")
    tr.load_checkpoint(FIXTURES / "hier_golden.msgpack")
    x, y, n = (torch.as_tensor(g[k], device=tr.device)
               for k in ("eval/feats", "eval/spks", "eval/lengths"))
    with torch.no_grad():
        _, _, fwd = tr.model(x, y, False)
        ids, style = tr.model.encode(x, n)
        mel = tr.model.infer(x, y, n).cpu().numpy()
    worst = {}

    def held(what, got, want):
        rel = abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)
        worst[what] = max(worst.get(what, 0.0), rel)
        check(rel <= GOLDEN_LOSS_RTOL,
              f"hier_golden: {what} {float(got)}, JAX {float(want)}")

    for k in (f for f in g.files if f.startswith("fwd/")):
        held(k, fwd[k[4:]], g[k])
    # ids are compared over each level's real frames (coarse -> fine:
    # level 1, then level 0)
    lengths = g["eval/lengths"]
    len_levels = [lengths]
    for i in range(cfg["levels"]):
        len_levels.append(Encoder.out_lengths(cfg[f"encoder.{i}"],
                                              len_levels[-1]))
    id_diff = 0
    for j, lvl in enumerate((1, 0)):
        got, want = ids[j].cpu().numpy(), g[f"eval/ids_{j}"]
        for b, m in enumerate(len_levels[lvl + 1]):
            id_diff += int((got[b, :m] != want[b, :m]).sum())
    check(id_diff == 0, f"hier_golden: {id_diff} ids differ from JAX")
    style_err = float(np.abs(style.cpu().numpy() - g["eval/style"]).max())
    style_peak = float(np.abs(g["eval/style"]).max())
    check(style_err <= 1e-4 * style_peak,
          f"hier_golden: style differs from JAX by {style_err}")
    valid = np.arange(mel.shape[1])[None] < lengths[:, None]
    mel_peak = float(np.abs(g["eval/mel"][valid]).max())
    mel_err = float(np.abs(mel[valid] - g["eval/mel"][valid]).max())
    check(mel_err <= 1e-4 * mel_peak,
          f"hier_golden: mel differs from JAX by {mel_err} (peak "
          f"{mel_peak})")
    keys = [k[len("detail/"):] for k in g.files if k.startswith("detail/")]
    for i in range(steps):
        detail = tr.train_step((g[f"feats_{i}"], g[f"spks_{i}"]))
        for k in keys:
            if k == "skipped_nonfinite":
                check(float(detail[k]) == 0.0,
                      f"hier_golden: step {i + 1} skipped")
            else:
                held(k, detail[k], g["detail/" + k][i])
    with tempfile.TemporaryDirectory() as tmp:
        tr.save_checkpoint(Path(tmp) / "final")
        got = _leaves(msgpack_io.msgpack_restore(
            (Path(tmp) / "final").read_bytes()))
    want = _leaves(msgpack_io.msgpack_restore(
        (FIXTURES / "hier_golden_final.msgpack").read_bytes()))
    check(set(got) == set(want), "hier_golden: checkpoint trees differ")
    atol, rtol = GOLDEN_STATE_TOL
    reach = 2 * steps * cfg["learning_rate"]
    state_err = 0.0
    for k in want:
        a, b = got[k].astype(np.float64), want[k].astype(np.float64)
        check(a.shape == b.shape, f"hier_golden: {k} shape {a.shape}")
        err = np.abs(a - b)
        if _tts_free_leaf(k):     # the GST's key-projection bias
            check(bool(np.all(err <= reach)), f"hier_golden: {k} beyond "
                  f"the reach of {steps} steps")
            continue
        state_err = max(state_err, float(err.max()) if err.size else 0.0)
        check(bool(np.all(err <= atol + rtol * np.abs(b))),
              f"hier_golden: {k} differs from JAX by {float(err.max())}")
    emit({"phase": "hier_golden", "steps": steps, "ids_differ": id_diff,
          "style_max_abs_err": style_err, "mel_max_abs_err": mel_err,
          "mel_peak": mel_peak, "tolerance_of_peak": 1e-4,
          "worst_rel_err": worst, "loss_rtol": GOLDEN_LOSS_RTOL,
          "state_leaves": len(want), "state_max_abs_err": state_err,
          "state_atol_rtol": list(GOLDEN_STATE_TOL)})


def _counters():
    from vae_npvc_tpu_torch.ops.groupnorm import (fused_group_norm,
                                                  fused_group_norm_backward)
    from vae_npvc_tpu_torch.ops.vq_fused import vq_fused

    return {"vq_fused": vq_fused, "fused_group_norm": fused_group_norm,
            "fused_group_norm_backward": fused_group_norm_backward}


def _zero_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {k: fn.launches for k, fn in _counters().items()}


def _shared_kinks(torch, masks=None):
    """A ``TorchFunctionMode`` around every ``relu`` / ``leaky_relu``: without
    ``masks`` it records each input's sign pattern (in call order); with
    the masks of such a run it applies them, ``x * (1 if mask else
    slope)``, and counts the elements whose own sign differs
    (``.flips``). Two runs of one model on two devices then take every
    kink the same way: an input within rounding of zero otherwise opens
    on one device and not the other, and the gradient behind it differs
    by (1 - slope) of its value there."""
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    class SharedKinks(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.record = masks is None
            self.masks = [] if masks is None else masks
            self.i, self.flips = 0, 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func not in (F.relu, F.leaky_relu, torch.relu):
                return func(*args, **kwargs)
            x = args[0]
            if self.record:
                self.masks.append((x > 0).detach().cpu())
                return func(*args, **kwargs)
            slope = 0.0
            if func is F.leaky_relu:
                slope = args[1] if len(args) > 1 else kwargs.get(
                    "negative_slope", 0.01)
            m = self.masks[self.i].to(x.device)
            self.i += 1
            self.flips += int(((x > 0) != m).sum())
            return x * torch.where(m, 1.0, slope).to(x.dtype)

    return SharedKinks()


def _hier_grad_fp32(torch):
    """The recipe's vqvae2 at full width in fp32 at B = 2, T = 256: the
    training loss and every parameter gradient on the card (K1 ids mode,
    K2, K3) against the same weights on the CPU (plain versions), within
    ``GRAD_TOL`` of each gradient's peak; the GST's key-projection bias,
    zero in exact arithmetic, within 1e-6 of the largest gradient. The
    card takes every ReLU kink as the CPU did (:func:`_shared_kinks`;
    the elements whose own sign differed are reported): one leaky-ReLU
    input within rounding of zero, in a model with ~10^7 of them, moved a
    stack's gradients by 1 % of their peak."""
    from vae_npvc_tpu_torch.models import build_model

    cfg = dict(HIER, compute_dtype="float32")
    rng = np.random.default_rng(6)
    B, T, D = 2, 256, cfg["encoder.0"]["in_channels"][0]
    t = np.linspace(0, 1, T)[None, :, None]
    feats = (np.sin(2 * np.pi * (rng.uniform(1, 4, (B, 1, D)) * t
                                 + rng.uniform(0, 1, (B, 1, D))))
             + 0.3 * rng.normal(size=(B, T, D))).astype(np.float32)
    spks = np.array([0, 116], np.int64)
    cpu = build_model(cfg, device="cpu").init_random(0)
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    n_params = sum(p.numel() for p in cpu.parameters())
    runs = {}
    kinks = _shared_kinks(torch)
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        dev = next(model.parameters()).device
        x = torch.as_tensor(feats, device=dev)
        _zero_counts()
        if name == "cuda":
            kinks = _shared_kinks(torch, kinks.masks)
        with kinks:
            _, loss, detail = model(x, torch.as_tensor(spks, device=dev),
                                    True)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        with torch.no_grad():
            ids, _ = model.encode(x)
        runs[name] = (float(loss.detach()), [g.cpu() for g in grads],
                      [i.cpu() for i in ids])
    launched = _read_counts()
    (loss_d, grads_d, ids_d), (loss_c, grads_c, ids_c) = runs["cuda"], \
        runs["cpu"]
    top = max(float(g.abs().max()) for g in grads_c)
    worst, worst_name = 0.0, None
    for (name, _), a, b in zip(cpu.named_parameters(), grads_d, grads_c):
        check(bool(torch.isfinite(a).all()), f"hier: grad {name} not finite")
        if name == "gst.mha.linear_k.bias":
            check(float(a.abs().max()) <= 1e-6 * top,
                  f"hier: grad {name} {float(a.abs().max())}")
            continue
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
        if rel > worst:
            worst, worst_name = rel, name
    ids_differ = sum(int((a != b).sum()) for a, b in zip(ids_d, ids_c))
    out = {"B": B, "T": T, "parameters": n_params,
           "parameter_tensors": len(grads_c), "relu_inputs": sum(
               m.numel() for m in kinks.masks),
           "relu_sign_flips_on_the_card": kinks.flips, "loss_gpu": loss_d,
           "loss_cpu": loss_c, "ids_differ": ids_differ,
           "worst_grad_err_over_peak": worst, "worst_grad": worst_name,
           "tolerance": GRAD_TOL, "launches": launched}
    emit({"phase": "hier_grad_fp32", **out})
    # one training forward and backward (K1 twice, 40 norms, 40 backward)
    # and one encode (K1 twice, the encoders' 18 norms and decoders 2 and
    # 1's twelve)
    check(launched == {"vq_fused": 4, "fused_group_norm": 70,
                       "fused_group_norm_backward": 40},
          f"hier: grad_fp32 launches {launched}")
    check(abs(loss_d - loss_c) <= 1e-4 * abs(loss_c),
          f"hier: loss {loss_d} on the card, {loss_c} on the CPU")
    check(worst <= GRAD_TOL,
          f"hier: gradient of {worst_name} differs by {worst} of its peak")
    return n_params


def _k1_call(torch, z, emb, idx, rescored):
    """One K1 call's record: rows re-scored in exact fp32 (and over every
    code), near ties (top-2 fp64 distances within 1e-5 relative) and ids
    that differ from the plain version off them."""
    from vae_npvc_tpu_torch.ops.vq_fused import nearest_code_plain

    ref = nearest_code_plain(z, emb)
    e64 = emb.double()
    d64 = (e64 ** 2).sum(1)[None] - 2 * z.double() @ e64.T
    top2 = torch.topk(d64, 2, dim=1, largest=False).values
    clear = (top2[:, 1] - top2[:, 0]) > 1e-5 * top2[:, 0].abs().clamp(min=1)
    return {"N": int(z.shape[0]), "rescored_rows": rescored[0],
            "rescored_all_codes": rescored[1],
            "near_ties": int((~clear).sum()),
            "ids_differ_clear": int(((idx != ref) & clear).sum()),
            "ids_differ_near_tie": int(((idx != ref) & ~clear).sum())}


def _record_k1_calls(torch, calls):
    """A stand-in for ``ops.vq.nearest_code`` that records each K1 call
    (:func:`_k1_call`) in ``calls``."""
    from vae_npvc_tpu_torch.ops.vq_fused import nearest_code, vq_fused

    def recording(z, emb):
        idx = nearest_code(z, emb)
        calls.append(_k1_call(torch, z, emb, idx,
                              vq_fused.rescored.sum(1).tolist()))
        return idx

    return recording


def _hier_train(torch, root):
    """``HIER_STEPS`` bf16 optimizer steps of the recipe's model at B = 96,
    T = 256 through ``Trainer`` on a synthetic corpus staged on the device
    (two calls of ``steps_per_call: 8``), with the launch counts per step, a
    fixed batch's ``X like`` before and after, one more step with every K1
    call recorded, a save/load round trip and one profiled step. Returns
    (launches of the counted steps, checkpoint path)."""
    from vae_npvc_tpu_torch.data.dataset import (UttMelSpkDataset,
                                                 batch_iterator,
                                                 index_iterator)
    from vae_npvc_tpu_torch.ops import vq as vq_ops
    from vae_npvc_tpu_torch.train import build_trainer
    from vae_npvc_tpu_torch.train.trainer import Trainer

    cfg = dict(HIER)
    B, T = cfg["batch_size"], cfg["crop_length"]
    _synthetic_corpus(root, 256, seed=7)
    dataset = UttMelSpkDataset(root, cfg)
    tr = build_trainer(cfg, device="cuda")
    tr.init_state()
    staged = tr.stage_dataset(dataset, B)
    pairs = index_iterator(dataset, B, shuffle=True, drop_last=True,
                           seed=cfg["seed"])

    def chunk(k):
        got = [next(pairs) for _ in range(k)]
        return (np.stack([p[0] for p in got]), np.stack([p[1] for p in got]))

    held = [next(batch_iterator(dataset, B, shuffle=False, drop_last=True,
                                num_workers=0, epochs=1))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    held_x_like, details, times, done = [], [], [], 0
    c0, r0 = Trainer.graph_captures, Trainer.graph_replays
    while done < HIER_STEPS:
        k = min(cfg["steps_per_call"], HIER_STEPS - done)
        idx, starts = chunk(k)
        t0 = time.perf_counter()
        details.append(tr.train_steps_indices(idx, starts))
        torch.cuda.synchronize()
        times.append(((time.perf_counter() - t0) * 1e3, k))
        done += k
        if done == k or done == HIER_STEPS:
            # the scoring pass is no training step: its launches are kept
            # out of the per-step counts
            counts = _read_counts()
            held_x_like.append(tr.valid(held)["X like"][0])
            for name, fn in _counters().items():
                fn.launches = counts[name]
    launches = _read_counts()
    graphs = (Trainer.graph_captures - c0, Trainer.graph_replays - r0)
    peak_bytes = torch.cuda.max_memory_allocated()
    detail = {k: torch.cat([d[k] for d in details]).float().cpu().numpy()
              for k in details[0]}
    check(tr.iteration == HIER_STEPS, f"hier: {tr.iteration} steps")
    for k, v in detail.items():
        check(bool(np.all(np.isfinite(v))), f"hier: {k} not finite: {v}")
    check(float(detail["skipped_nonfinite"].sum()) == 0.0,
          f"hier: steps skipped: {detail['skipped_nonfinite']}")
    check(held_x_like[1] < held_x_like[0],
          f"hier: X like of a fixed batch {held_x_like[0]} -> "
          f"{held_x_like[1]} did not fall")
    # the first step eager, the second captured, the rest replayed: the
    # wrappers count the eager step's and the capture's calls
    check(graphs == ((1, HIER_STEPS - 1) if tr._graphed() else (0, 0)),
          f"hier: captures, replays {graphs}")
    called = HIER_STEPS - graphs[1] + graphs[0]
    check(launches == {k: v * called
                       for k, v in HIER_STEP_LAUNCHES.items()},
          f"hier: launches {launches} over {called} steps that called the "
          "wrappers")

    # one more step with every K1 call recorded (not counted or timed),
    # eager: a step replayed from the trainer's CUDA graph calls no wrapper
    calls = []
    original = vq_ops.nearest_code
    vq_ops.nearest_code = _record_k1_calls(torch, calls)
    try:
        with Trainer.eager_steps():
            tr.train_steps_indices(*chunk(1))
    finally:
        vq_ops.nearest_code = original
    check([c["N"] for c in calls] == [B * T // 4, B * T],
          f"hier: K1 calls {[c['N'] for c in calls]}")
    check(all(c["ids_differ_clear"] == 0 for c in calls),
          f"hier: K1 ids differ from the plain version off near ties: "
          f"{calls}")

    # save -> load into a second trainer -> the same next step
    ckpt = root / f"iter.{tr.iteration}"
    tr.save_checkpoint(ckpt)
    other = build_trainer(cfg, device="cuda")
    check(other.load_checkpoint(ckpt) == tr.iteration, "hier: iteration")
    other.stage_dataset(dataset, B)
    idx, starts = chunk(1)
    a = float(other.train_steps_indices(idx, starts)["Total"][0])
    b = float(tr.train_steps_indices(idx, starts)["Total"][0])
    check(math.isfinite(a) and abs(a - b) <= 1e-6 * abs(a),
          f"hier: next step {b}, after save/load {a}")
    del other
    idx, starts = chunk(1)
    profile = _profiled(torch, lambda: tr.train_steps_indices(idx, starts))
    kernels = _replayed_kernels(
        torch, tr, lambda: tr.train_steps_indices(*chunk(1)), "hier")
    steady_ms = sum(ms for ms, _ in times[1:]) / sum(k for _, k in times[1:])
    emit({"phase": "hier_train", "config": "train_vqvae2.yaml",
          "steps": HIER_STEPS, "B": B, "T": T,
          "dtype": cfg["compute_dtype"], "utterances": len(dataset),
          "staged_bytes": staged, "parameters": int(tr.flat.numel()),
          "chunk_ms": [round(ms, 3) for ms, _ in times],
          "ms_per_step": steady_ms, "frames_per_s": B * T / steady_ms * 1e3,
          "peak_memory_bytes": peak_bytes,
          "held_batch_x_like_after_first_chunk_and_last": held_x_like,
          "total": [float(v) for v in detail["Total"]],
          "x_like": [float(v) for v in detail["X like"]],
          "gst_in_rms_first_last": [float(detail["gst_in_rms"][0]),
                                    float(detail["gst_in_rms"][-1])],
          "grad_norm_first_last": [float(detail["grad_norm"][0]),
                                   float(detail["grad_norm"][-1])],
          "launches": launches, "launches_per_step": HIER_STEP_LAUNCHES,
          "graph_captures_replays": list(graphs),
          "kernels_of_one_step": kernels,
          "k1_calls_of_one_step": calls,
          "next_step_total": b, "next_step_total_after_load": a,
          "one_step_profile": profile})
    return launches, calls, ckpt


def _hier_serve(torch, ckpt):
    """A ``ConversionEngine`` on the trained checkpoint answering
    ``HIER_REQUESTS`` requests of 1-4 s from four threads (Griffin-Lim),
    the launches of one ``infer`` and one profiled ``infer`` of a B = 8,
    T = 256 batch. Returns the launches of one ``infer``."""
    from vae_npvc_tpu_torch.serve import ConversionEngine

    fs, shift, D = 24000, 256, 80
    stats = _cmvn_stats()
    engine = ConversionEngine(HIER, ckpt, stats, vocoder="gl", device="cuda")
    try:
        t0 = time.monotonic()
        engine.warmup(2)
        warm_s = time.monotonic() - t0
        durations = np.linspace(1.0, 4.0, HIER_REQUESTS)
        wavs = [_speechlike(int(d * fs), fs, 20 + i)
                for i, d in enumerate(durations)]

        def one(i):
            t = time.monotonic()
            out, sr = engine.convert(wavs[i], fs, (5 * i) % 117)
            return out, sr, (time.monotonic() - t) * 1e3

        calls0 = engine.batcher.calls
        _zero_counts()
        t0 = time.monotonic()
        with ThreadPoolExecutor(4) as ex:
            results = list(ex.map(one, range(len(wavs))))
        wall_s = time.monotonic() - t0
        launches = _read_counts()
        calls = engine.batcher.calls - calls0
        for i, (out, sr, _) in enumerate(results):
            T_true = 1 + wavs[i].size // shift
            check(sr == fs and out.shape == (T_true * shift,),
                  f"hier: request {i} gave {out.shape} at {sr} Hz")
            check(bool(np.all(np.isfinite(out))) and np.abs(out).max() > 0,
                  f"hier: request {i} not finite or silent")
        check(launches["vq_fused"] == HIER_INFER_LAUNCHES["vq_fused"] * calls
              and launches["fused_group_norm"]
              == HIER_INFER_LAUNCHES["fused_group_norm"] * calls,
              f"hier: serving launches {launches} over {calls} infer calls")
        feats = np.random.default_rng(8).normal(size=(8, 256, D)) \
            .astype(np.float32)
        tgts = np.arange(8, dtype=np.int32)
        lengths = np.array([256, 200, 256, 64, 100, 256, 180, 90], np.int32)
        engine.converter.infer(feats, tgts, lengths)
        _zero_counts()
        mel = engine.converter.infer(feats, tgts, lengths)
        per_infer = _read_counts()
        # the same batch's K1 calls recorded (padded rows are zero rows,
        # every code equally near after the normalization)
        from vae_npvc_tpu_torch.ops import vq as vq_ops

        k1_calls = []
        original = vq_ops.nearest_code
        vq_ops.nearest_code = _record_k1_calls(torch, k1_calls)
        try:
            engine.converter.infer(feats, tgts, lengths)
        finally:
            vq_ops.nearest_code = original
        check(all(c["ids_differ_clear"] == 0 for c in k1_calls),
              f"hier: K1 ids of an infer differ from the plain version off "
              f"near ties: {k1_calls}")
        check(bool(np.isfinite(mel).all()), "hier: infer not finite")
        check({k: per_infer[k] for k in HIER_INFER_LAUNCHES}
              == HIER_INFER_LAUNCHES, f"hier: one infer launched "
              f"{per_infer}")
        profile = _profiled(
            torch, lambda: engine.converter.infer(feats, tgts, lengths))
        lat = [r[2] for r in results]
        emit({"phase": "hier_serve", "requests": len(results),
              "threads": 4, "seconds_per_request_min_max":
                  [float(durations[0]), float(durations[-1])],
              "warmup_s": warm_s, "wall_s": wall_s,
              "requests_per_s": len(results) / wall_s,
              "latency_ms_median": float(np.median(lat)),
              "latency_ms_max": float(np.max(lat)), "infer_calls": calls,
              "launches": launches, "launches_per_infer": per_infer,
              "k1_calls_of_one_infer": k1_calls,
              "infer_b8_t256_profile": profile})
        return per_infer
    finally:
        engine.close()


def _hier_small(torch, root):
    """vqvae2a and vqvae2b at test width in fp32: one ``Trainer`` step and
    one masked ``infer`` on the card against the CPU from the same
    checkpoint."""
    from vae_npvc_tpu_torch.train import build_trainer

    out = {}
    rng = np.random.default_rng(9)
    batch = (rng.normal(size=(4, 32, 10)).astype(np.float32),
             np.array([0, 3, 1, 2], np.int32))
    x = rng.normal(size=(3, 32, 10)).astype(np.float32)
    lengths = np.array([32, 21, 9], np.int32)
    x[np.arange(32)[None] >= lengths[:, None]] = 0.0
    y = np.array([3, 0, 2], np.int32)
    for name, arch in HIER_SMALL.items():
        cfg = dict(arch, compute_dtype="float32", seed=3, optim_type="Adam",
                   learning_rate=1e-3, max_grad_norm=1.0)
        cpu = build_trainer(cfg, device="cpu")
        cpu.init_state()
        ckpt = root / f"{name}.ckpt"
        cpu.save_checkpoint(ckpt)
        gpu = build_trainer(cfg, device="cuda")
        gpu.load_checkpoint(ckpt)
        _zero_counts()
        dg = gpu.train_step(batch)
        launched = _read_counts()
        dc = cpu.train_step(batch)
        rel = {k: abs(float(dg[k]) - float(dc[k])) / max(abs(float(dc[k])),
                                                         1e-12)
               for k in ("Total", "X like", "VQ loss", "grad_norm")}
        a, b = gpu.flat.cpu().double(), cpu.flat.double()
        state_err = float((a - b).abs().max())
        mels = []
        for tr in (gpu, cpu):
            with torch.no_grad():
                mels.append(tr.model.infer(*(
                    torch.as_tensor(v, device=tr.device)
                    for v in (x, y, lengths))).cpu().numpy())
        valid = np.arange(32)[None] < lengths[:, None]
        peak = float(np.abs(mels[1][valid]).max())
        mel_err = float(np.abs(mels[0][valid] - mels[1][valid]).max())
        out[name] = {"rel_err": rel, "params_max_abs_err": state_err,
                     "mel_max_abs_err": mel_err, "mel_peak": peak,
                     "launches_one_step": launched}
        check(all(v <= GOLDEN_LOSS_RTOL for v in rel.values()),
              f"hier: {name} step on the card differs from the CPU: {rel}")
        atol, rtol = GOLDEN_STATE_TOL
        check(bool(((a - b).abs() <= atol + rtol * b.abs()).all()),
              f"hier: {name} parameters after a step differ by {state_err}")
        check(mel_err <= 1e-4 * peak,
              f"hier: {name} mel differs from the CPU by {mel_err}")
        check(all(v > 0 for v in launched.values()),
              f"hier: {name} step launched {launched}")
    emit({"phase": "hier_small", "cases": out})


def phase_hier(torch, root):
    """The vae2 recipe's hierarchical VQ-VAE (``HIER``) at full width with
    seeded random weights: gradients in fp32 against the CPU, bf16
    training, serving from the trained checkpoint; then vqvae2a and
    vqvae2b at test width against the CPU. Returns the launch counts of the
    training run and of one ``infer``, the K1 calls of one step and the
    trained checkpoint (in ``root``)."""
    n_params = _hier_grad_fp32(torch)
    print(f"hier: train_vqvae2.yaml has {n_params:,} parameters", flush=True)
    train_launches, k1_calls, ckpt = _hier_train(torch, root)
    infer_launches = _hier_serve(torch, ckpt)
    _hier_small(torch, root)
    return train_launches, infer_launches, k1_calls, ckpt


# stages 1-6 of egs/vcc20/vae1/run.sh (fbank settings :13-18, 64 Griffin-Lim
# iterations :43) on a synthetic corpus: 16 utterances of 1-10 s at 24 kHz
# over 4 speakers and 2 at 16 kHz that make_fbank resamples; frames run
# from 94 to 938, so the decode's buckets are 256, 512, 768 and 1,024
OFFLINE_FEATURE = {"fs": 24000, "n_fft": 1024, "n_shift": 256, "n_mels": 80,
                   "fmin": 80.0, "fmax": 7600.0}
OFFLINE_UTTS = ([(float(d), 24000) for d in np.linspace(1.0, 10.0, 16)]
                + [(2.5, 16000), (7.5, 16000)])
OFFLINE_GL_ITERS = 64
OFFLINE_TOL = 1e-4
# decode throughput: the dump's utterances 8 times each (144 utterances,
# 18 full batches of 8), decoded 3 times after one warm-up
OFFLINE_COPIES, OFFLINE_REPEATS = 8, 3
# K1 and K2 launches per call, counted from the code: a flat decode batch
# (one infer) 1 and 20, and so does a flat sweep utterance (1 and 10 for
# the encode at B = 1, 10 for the decode at B = K); a hierarchy sweep batch
# encodes once (K1 2; K2 30: 18 encoder norms and the 12 of the upper
# levels' decoders the encode runs) and runs the final decoder per target
# (K2 10)
FLAT_LAUNCHES = {"vq_fused": 1, "fused_group_norm": 20}
HIER_ENCODE_LAUNCHES = {"vq_fused": 2, "fused_group_norm": 30}
HIER_DECODE_LAUNCHES = {"vq_fused": 0, "fused_group_norm": 10}


def _offline_corpus(root, utts=OFFLINE_UTTS):
    """A Kaldi data dir (``wav.scp``, ``utt2spk``, ``spk2utt``) of ``utts``
    (``(seconds, fs)`` pairs) written as int16 wavs; utterance i is speaker
    i % 4."""
    from scipy.io import wavfile

    wav = root / "wav"
    wav.mkdir(parents=True)
    utt2spk = {}
    for i, (sec, fs) in enumerate(utts):
        utt, spk = f"utt{i:02d}", f"spk{i % 4}"
        x = _speechlike(int(round(sec * fs)), fs, 100 + i)
        wavfile.write(wav / f"{utt}.wav", fs, (x * 32767).astype(np.int16))
        utt2spk[utt] = spk
    data = root / "data"
    data.mkdir()
    (data / "wav.scp").write_text("".join(
        f"{u} {wav}/{u}.wav\n" for u in utt2spk))
    (data / "utt2spk").write_text("".join(
        f"{u} {s}\n" for u, s in utt2spk.items()))
    (data / "spk2utt").write_text("".join(
        f"spk{s} " + " ".join(u for u, v in utt2spk.items()
                              if v == f"spk{s}") + "\n" for s in range(4)))
    return data, utt2spk


def _replicated(dump, root, copies):
    """A decode dir of every utterance of ``dump`` ``copies`` times, keyed
    ``<utt>-<copy>``, each with the utterance's trials target."""
    from vae_npvc_tpu_torch.data import kaldi_io

    root.mkdir()
    scp = kaldi_io.load_dict_data(dump / "feats.scp")
    trials = {p[0]: p[1:] for p in kaldi_io.load_list_data(dump / "trials")}
    (root / "feats.scp").write_text("".join(
        f"{u}-{c} {rx}\n" for u, rx in scp.items() for c in range(copies)))
    (root / "trials").write_text("".join(
        f"{u}-{c} {' '.join(trials[u])}\n" for u in scp
        for c in range(copies)))
    (root / "spk2spk_id").write_text((dump / "spk2spk_id").read_text())
    return root


def _max_err(a_items, b_items):
    """Largest |a - b| over matched ``read_outputs`` lists (keys, order and
    shapes checked)."""
    check([k for k, _ in a_items] == [k for k, _ in b_items],
          f"offline: keys {[k for k, _ in a_items]} vs "
          f"{[k for k, _ in b_items]}")
    err = 0.0
    for (k, a), (_, b) in zip(a_items, b_items):
        check(a.shape == b.shape, f"offline: {k} {a.shape} vs {b.shape}")
        err = max(err, float(np.abs(a.astype(np.float64) - b).max()))
    return err


def _offline_golden(torch, root):
    """The port's Converter on the card in fp32, with the committed golden
    checkpoints, over the seeded decode dir: decode and sweep against the
    committed JAX fixture (same keys in the same order, equal lengths, mel
    within 1e-4)."""
    from vae_npvc_tpu_torch.infer.convert import Converter
    from vae_npvc_tpu_torch.utils import offline_fixture as fx

    g = np.load(FIXTURES / "offline_golden.npz")
    errs = {}
    for model, name in fx.OFFLINE_MODELS.items():
        cfg = fx.offline_config(FIXTURES, name)
        dim = (cfg.get("encoder") or cfg["encoder.0"])["in_channels"][0]
        d = fx.offline_decode_dir(root / f"golden_{model}", dim)
        cv = Converter(cfg, device="cuda")
        cv.load_checkpoint(FIXTURES / f"{name}.msgpack")
        cv.decode(d, d / "decode", compress=False)
        cv.sweep(d, d / "sweep", fx.OFFLINE_TARGETS, compress=False)
        for mode in ("decode", "sweep"):
            err = _max_err(fx.read_outputs(d / mode),
                           fx.unpack_outputs(g, f"{model}/{mode}"))
            check(err <= OFFLINE_TOL, f"offline: {model} {mode} differs "
                  f"from the JAX fixture by {err}")
            errs[f"{model}_{mode}"] = err
    return errs


def _batches(frames, bucket, batch, min_frames=1):
    """Batches a bucketed decode of utterances of ``frames`` runs (fixed
    grid of ``bucket``, chunks of ``batch``)."""
    counts = {}
    for T in frames:
        T_pad = max(-(-T // bucket) * bucket, min_frames)
        counts[T_pad] = counts.get(T_pad, 0) + 1
    return sum(-(-n // batch) for n in counts.values())


def _recording(torch, k1, k2):
    """Patches that record every K1 call of the flat model's EMA search and
    of the plain codebooks' search in ``k1`` (:func:`_k1_call`: the ids
    against the plain version), and every K2 call in ``k2`` by shape, dtype,
    GLU and plan, with its output held against the plain version at
    ``K2_TOL``; returns the undo function."""
    from vae_npvc_tpu_torch.ops import groupnorm as gn_ops
    from vae_npvc_tpu_torch.ops import vq as vq_ops
    from vae_npvc_tpu_torch.ops.vq_fused import vq_fused as k1_fn

    saved = (vq_ops.vq_fused, vq_ops.nearest_code, gn_ops._forward)
    fused, _, forward = saved

    def vq_rec(z, emb, *, stats=True):
        out = fused(z, emb, stats=stats)
        k1.append(_k1_call(torch, z, emb, out.idx,
                           k1_fn.rescored.sum(1).tolist()))
        return out

    def gn_rec(x, scale, bias, num_groups, eps, lengths, glu):
        out = forward(x, scale, bias, num_groups, eps, lengths, glu)
        ref = gn_ops.group_norm_plain(x, scale, bias, num_groups, eps,
                                      lengths, glu).float()
        dtype = str(x.dtype).split(".")[-1]
        atol, rtol = K2_TOL[dtype]
        err = (out.float() - ref).abs()
        key = (tuple(x.shape), dtype, bool(glu), gn_ops.plan(x, glu))
        calls, worst, beyond = k2.get(key, (0, 0.0, 0))
        k2[key] = (calls + 1, max(worst, float(err.max())),
                   beyond + int((err > atol + rtol * ref.abs()).sum()))
        return out

    vq_ops.vq_fused = vq_rec
    vq_ops.nearest_code = _record_k1_calls(torch, k1)
    gn_ops._forward = gn_rec

    def undo():
        vq_ops.vq_fused, vq_ops.nearest_code, gn_ops._forward = saved
    return undo


def _check_recorded(k1, k2, what):
    """K1's ids equal the plain version's off near ties and every K2 output
    is within ``K2_TOL`` of the plain version in the recorded run."""
    check(all(c["ids_differ_clear"] == 0 for c in k1),
          f"offline: {what}: K1 ids differ from the plain version off near "
          f"ties: {[c for c in k1 if c['ids_differ_clear']]}")
    bad = {k: v for k, v in k2.items() if v[2]}
    check(not bad, f"offline: {what}: K2 beyond K2_TOL of the plain version "
          f"(shape, dtype, glu, plan): (calls, max err, elements) {bad}")


def _plans(k2):
    return [{"shape": list(s), "dtype": d, "glu": g, "plan": p, "calls": n,
             "max_abs_err_vs_plain": e}
            for (s, d, g, p), (n, e, _) in sorted(k2.items())]


def phase_offline(torch, hier_ckpt, root):
    """The VCC2020 recipes' offline stages through the port's CLIs on the
    card: ``make_fbank`` and ``apply_cmvn compute`` (stage 1),
    ``make_spk_id`` and ``apply_cmvn apply`` (stage 2), ``bin/decode`` over
    trials with the flagship flat model (bf16, seeded weights) and its
    ``--all-targets`` sweep to two targets with the trained ``HIER``
    checkpoint (stage 5), ``apply_cmvn apply --reverse`` and
    ``convert_fbank`` (stage 6); the JAX decode fixture on the card in fp32;
    masked batching and the flat sweep against per-utterance runs at full
    width in fp32; launch counts, K2 plans and K1 rows re-scored of the
    decode and the sweep; one profiled decode batch. Writes under ``root``;
    the returned ``paths`` (the stage-2 dump with its trials, the flagship's
    config and checkpoint, the stage-5 decode) feed the ``bundle`` phase."""
    from scipy.io import wavfile

    from vae_npvc_tpu_torch.bin import apply_cmvn, convert_fbank, decode
    from vae_npvc_tpu_torch.bin.make_fbank import make_fbank
    from vae_npvc_tpu_torch.bin.make_spk_id import make_spk_id
    from vae_npvc_tpu_torch.data import kaldi_io
    from vae_npvc_tpu_torch.infer.convert import Converter
    from vae_npvc_tpu_torch.utils import offline_fixture as fx

    stage_s = {}

    def stage(name, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        stage_s[name] = time.perf_counter() - t0
        return out

    root.mkdir(parents=True, exist_ok=True)
    golden_err = _offline_golden(torch, root)
    data, utt2spk = _offline_corpus(root)

    # stages 1-2: front end, CMVN stats, speaker ids, normalized dump
    fb, dump = root / "fbank", root / "dump"
    n = stage("make_fbank", make_fbank, data, fb, device="cuda",
              **OFFLINE_FEATURE)
    check(n == len(OFFLINE_UTTS), f"offline: make_fbank wrote {n}")
    make_fbank(data, root / "fbank_cpu", device="cpu", **OFFLINE_FEATURE)
    cpu = dict(kaldi_io.read_ark(root / "fbank_cpu" / "feats_raw.ark"))
    fbank_err = 0.0
    for utt, m in kaldi_io.read_ark(fb / "feats_raw.ark"):
        check(m.shape == cpu[utt].shape, f"offline: {utt} {m.shape}")
        fbank_err = max(fbank_err, float(np.abs(m - cpu[utt]).max()))
    check(fbank_err <= 1e-3, f"offline: make_fbank on the card differs "
          f"from the CPU by {fbank_err}")
    cmvn_ark = root / "cmvn.ark"
    stage("apply_cmvn_compute", apply_cmvn.main,
          ["compute", f"scp:{fb}/feats.scp", str(cmvn_ark)])
    stage("make_spk_id", make_spk_id, fb)
    stage("apply_cmvn_apply", apply_cmvn.main,
          ["apply", str(cmvn_ark), f"scp:{fb}/feats.scp", str(dump)])
    apply_cmvn.main(["apply", "--reverse", str(cmvn_ark),
                     f"scp:{dump}/feats.scp", str(root / "back")])
    back = dict(kaldi_io.read_ark(root / "back" / "feats_cmvn.ark"))
    cmvn_err = max(float(np.abs(back[u] - m).max())
                   for u, m in kaldi_io.read_ark(fb / "feats_raw.ark"))
    check(cmvn_err <= 1e-5, f"offline: reverse(apply(x)) differs from x "
          f"by {cmvn_err}")
    spk2spk_id = kaldi_io.load_dict_data(fb / "spk2spk_id")
    (dump / "spk2spk_id").write_text((fb / "spk2spk_id").read_text())
    target = {u: f"spk{(int(s[3:]) + 1) % 4}" for u, s in utt2spk.items()}
    (dump / "trials").write_text("".join(
        f"{u} {t}\n" for u, t in target.items()))
    frames = {u: int(v) for u, v in kaldi_io.load_dict_data(
        dump / "utt2num_frames").items()}
    n_frames = sum(frames.values())

    # stage 5, flat: bin/decode over trials (bf16, compressed output)
    flat_ckpt, flat_conf = root / "flat.msgpack", root / "flat.json"
    _random_checkpoint(torch, flat_ckpt)
    flat_conf.write_text(json.dumps(FLAGSHIP))
    args = ["-c", str(flat_conf), "--checkpoint", str(flat_ckpt),
            "--decode-dir", str(dump)]
    _zero_counts()
    n = stage("decode_flat", decode.main,
              args + ["--output-dir", str(root / "dec")])
    flat_launches = _read_counts()
    batches = _batches(frames.values(), FLAGSHIP["decode_bucket_size"],
                       FLAGSHIP["decode_batch_size"])
    check(n == len(frames), f"offline: decode wrote {n}")
    check({k: flat_launches[k] for k in FLAT_LAUNCHES}
          == {k: v * batches for k, v in FLAT_LAUNCHES.items()},
          f"offline: flat decode of {batches} batches launched "
          f"{flat_launches}")

    # the same decode on a built converter: compression against the
    # uncompressed output, every K1/K2 call held against the plain
    # versions
    cv = Converter(FLAGSHIP, device="cuda")
    cv.load_checkpoint(flat_ckpt)
    cv.decode(dump, root / "dec_raw", compress=False)
    raw = fx.read_outputs(root / "dec_raw")
    compressed = fx.read_outputs(root / "dec")
    _max_err(compressed, raw)
    for (k, a), (_, b) in zip(compressed, raw):
        check(bool(np.isfinite(b).all()), f"offline: {k} not finite")
        step = fx.compression_step(b)
        check(bool(np.all(np.abs(a - b) <= step[None])),
              f"offline: compressed {k} beyond one step of the "
              f"uncompressed output")
    jobs = [(u, rx, frames[u]) for u, rx in
            kaldi_io.load_dict_data(dump / "feats.scp").items()]
    # throughput: every utterance OFFLINE_COPIES times under keys of its
    # own, so each batch holds decode_batch_size rows
    rep = _replicated(dump, root / "rep", OFFLINE_COPIES)
    rep_jobs = [(u, rx, frames[u.rsplit("-", 1)[0]]) for u, rx in
                kaldi_io.load_dict_data(rep / "feats.scp").items()]
    rep_chunks = list(cv._chunks(rep_jobs))
    check(all(len(c) == FLAGSHIP["decode_batch_size"]
              for _, c in rep_chunks),
          f"offline: throughput batches of "
          f"{[len(c) for _, c in rep_chunks]}")
    k1_flat, k2_flat = [], {}
    undo = _recording(torch, k1_flat, k2_flat)
    try:
        cv.decode(dump, root / "rec", compress=False)
        cv.decode(rep, root / "rep_out", compress=False)
    finally:
        undo()
    _check_recorded(k1_flat, k2_flat, "flat decode")
    rep_s = []
    for _ in range(OFFLINE_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cv.decode(rep, root / "rep_out", compress=False)
        torch.cuda.synchronize()
        rep_s.append(time.perf_counter() - t0)
    T_pad, chunk = rep_chunks[-1]
    feats, lengths = cv._load(chunk, T_pad)
    tgts = np.array([int(spk2spk_id[target[j[0].rsplit("-", 1)[0]]])
                     for j in chunk], np.int32)
    profile = _profiled(torch, lambda: cv.infer(feats, tgts, lengths))
    del cv

    # masked batching and the encode-once sweep at full width in fp32,
    # every K1/K2 call of these runs held against the plain versions
    cv32 = Converter(dict(FLAGSHIP, compute_dtype="float32"),
                     device="cuda")
    cv32.load_checkpoint(flat_ckpt)
    k1_32, k2_32 = [], {}
    undo = _recording(torch, k1_32, k2_32)
    try:
        cv32.decode(dump, root / "dec32", compress=False)
        dec32 = dict(fx.read_outputs(root / "dec32"))
        masked_err = 0.0
        for utt, rx in kaldi_io.load_dict_data(
                dump / "feats.scp").items():
            x = kaldi_io.load_mat(rx)[None]
            one = cv32.infer(x, [int(spk2spk_id[target[utt]])],
                             [x.shape[1]])[0]
            masked_err = max(masked_err,
                             float(np.abs(one - dec32[utt]).max()))
        same = root / "same"
        same.mkdir()
        for f in ("feats.scp", "spk2spk_id"):
            (same / f).write_text((dump / f).read_text())
        (same / "trials").write_text("".join(f"{u} spk1\n"
                                             for u in frames))
        cv32.decode(same, root / "same_out", compress=False)
        _zero_counts()
        cv32.sweep(dump, root / "sweep32", ["spk1"], compress=False)
        flat_sweep_launches = _read_counts()
    finally:
        undo()
    _check_recorded(k1_32, k2_32, "flat fp32 decode and sweep")
    check(masked_err <= OFFLINE_TOL, f"offline: a bucketed batch differs "
          f"from unpadded runs by {masked_err}")
    check({k: flat_sweep_launches[k] for k in FLAT_LAUNCHES}
          == {k: v * len(frames) for k, v in FLAT_LAUNCHES.items()},
          f"offline: flat sweep of {len(frames)} utterances launched "
          f"{flat_sweep_launches}")
    swept = dict(fx.read_outputs(root / "sweep32"))
    sweep_err = max(float(np.abs(swept[f"{u}__spk1"] - m).max())
                    for u, m in fx.read_outputs(root / "same_out"))
    check(sweep_err <= OFFLINE_TOL, f"offline: the flat sweep differs "
          f"from decode by {sweep_err}")
    # reported, not held to a tolerance: a frame whose code flips
    # between bf16 and fp32 changes the output by the codes' distance
    peak32 = max(float(np.abs(m).max()) for m in dec32.values())
    bf16_err = max(float(np.abs(m - dec32[k]).max())
                   for k, m in raw) / peak32
    del cv32

    # stage 5, hierarchy: bin/decode --all-targets to two targets
    hier_conf = root / "hier.json"
    hier_conf.write_text(json.dumps(HIER))
    _zero_counts()
    n = stage("sweep_hier", decode.main,
              ["-c", str(hier_conf), "--checkpoint", str(hier_ckpt),
               "--decode-dir", str(dump), "--output-dir",
               str(root / "hsweep"), "--all-targets", "spk1,spk2"])
    hier_launches = _read_counts()
    cvh = Converter(HIER, device="cuda")
    hier_batches = _batches(frames.values(), HIER["decode_bucket_size"],
                            HIER["decode_batch_size"], cvh.min_frames)
    want = {k: hier_batches * (HIER_ENCODE_LAUNCHES[k]
                               + 2 * HIER_DECODE_LAUNCHES[k])
            for k in HIER_ENCODE_LAUNCHES}
    check(n == 2 * len(frames), f"offline: hier sweep wrote {n}")
    check({k: hier_launches[k] for k in want} == want,
          f"offline: hier sweep of {hier_batches} batches launched "
          f"{hier_launches}, want {want}")
    for k, m in fx.read_outputs(root / "hsweep"):
        check(bool(np.isfinite(m).all()), f"offline: {k} not finite")
        check(m.shape == (frames[k.split("__")[0]], 80),
              f"offline: {k} {m.shape}")
    cvh.load_checkpoint(hier_ckpt)
    k1_hier, k2_hier = [], {}
    undo = _recording(torch, k1_hier, k2_hier)
    try:
        cvh.sweep(dump, root / "hrec", ["spk1"], compress=False)
    finally:
        undo()
    _check_recorded(k1_hier, k2_hier, "hier sweep")
    # one hierarchy infer of the longest bucket: K1 re-scores its
    # padded (zero) rows over every code
    hT, hchunk = list(cvh._chunks(jobs))[-1]
    hfeats, hlengths = cvh._load(hchunk, hT)
    htgts = np.ones((len(hchunk),), np.int32)
    cvh.infer(hfeats, htgts, hlengths)
    hier_profile = _profiled(
        torch, lambda: cvh.infer(hfeats, htgts, hlengths))
    del cvh

    # the hierarchy in fp32: its encode-once sweep against decode to the
    # same target, and each bucketed batch against the utterance alone
    # (padded to the least length its levels take)
    cvh32 = Converter(dict(HIER, compute_dtype="float32"), device="cuda")
    cvh32.load_checkpoint(hier_ckpt)
    k1_h32, k2_h32 = [], {}
    undo = _recording(torch, k1_h32, k2_h32)
    try:
        cvh32.decode(same, root / "hsame", compress=False)
        cvh32.sweep(dump, root / "hsweep32", ["spk1"], compress=False)
        hdec = dict(fx.read_outputs(root / "hsame"))
        hier_masked_err = 0.0
        mf = cvh32.min_frames
        for utt, rx in kaldi_io.load_dict_data(
                dump / "feats.scp").items():
            x = kaldi_io.load_mat(rx)
            T = x.shape[0]
            xp = np.zeros((1, max(-(-T // mf) * mf, mf), x.shape[1]),
                          np.float32)
            xp[0, :T] = x
            one = cvh32.infer(xp, [int(spk2spk_id["spk1"])], [T])[0, :T]
            hier_masked_err = max(hier_masked_err,
                                  float(np.abs(one - hdec[utt]).max()))
    finally:
        undo()
    _check_recorded(k1_h32, k2_h32, "hier fp32 decode and sweep")
    hswept = dict(fx.read_outputs(root / "hsweep32"))
    hier_sweep_err = max(float(np.abs(hswept[f"{u}__spk1"] - m).max())
                         for u, m in hdec.items())
    check(hier_masked_err <= OFFLINE_TOL, f"offline: a hierarchy batch "
          f"differs from unpadded runs by {hier_masked_err}")
    check(hier_sweep_err <= OFFLINE_TOL, f"offline: the hierarchy sweep "
          f"differs from decode by {hier_sweep_err}")
    del cvh32

    # stage 6: de-normalize, Griffin-Lim
    denorm = root / "denorm"
    stage("apply_cmvn_reverse", apply_cmvn.main,
          ["apply", "--reverse", str(cmvn_ark),
           f"scp:{root}/dec/feats.scp", str(denorm)])
    n = stage("convert_fbank", convert_fbank.convert_fbank,
              denorm / "feats.scp", denorm / "wav",
              n_iter=OFFLINE_GL_ITERS, device="cuda", **OFFLINE_FEATURE)
    check(n == len(frames), f"offline: convert_fbank wrote {n}")
    peak = int(0.95 * 32767)
    for utt, T in frames.items():
        sr, w = wavfile.read(denorm / "wav" / f"{utt}.wav")
        check(sr == OFFLINE_FEATURE["fs"]
              and w.shape == (T * OFFLINE_FEATURE["n_shift"],),
              f"offline: {utt}.wav {w.shape} at {sr} Hz, {T} frames")
        check(int(np.abs(w.astype(np.int32)).max()) == peak,
              f"offline: {utt}.wav peak {np.abs(w).max()}")

    emit({"phase": "offline", "utterances": len(frames),
          "seconds_min_max": [OFFLINE_UTTS[0][0], OFFLINE_UTTS[15][0]],
          "frames": n_frames, "frames_min_max": [min(frames.values()),
                                                 max(frames.values())],
          "stage_s": stage_s,
          "throughput_decode": {
              "utterances": len(rep_jobs), "batches": len(rep_chunks),
              "batch": FLAGSHIP["decode_batch_size"],
              "frames": OFFLINE_COPIES * n_frames, "repeats_s": rep_s,
              "utts_per_s": len(rep_jobs) * len(rep_s) / sum(rep_s),
              "frames_per_s": (OFFLINE_COPIES * n_frames * len(rep_s)
                               / sum(rep_s))},
          "decode_batches": batches, "hier_sweep_batches": hier_batches,
          "jax_fixture_max_abs_err": golden_err, "tolerance": OFFLINE_TOL,
          "fbank_card_vs_cpu_max_abs_err": fbank_err,
          "cmvn_round_trip_max_abs_err": cmvn_err,
          "masked_batch_vs_unpadded_fp32": masked_err,
          "flat_sweep_vs_decode_fp32": sweep_err,
          "bf16_decode_vs_fp32_over_peak": bf16_err,
          "hier_masked_batch_vs_unpadded_fp32": hier_masked_err,
          "hier_sweep_vs_decode_fp32": hier_sweep_err,
          "k2_vs_plain_in_path": {
              "calls": sum(v[0] for d in (k2_flat, k2_32, k2_hier, k2_h32)
                           for v in d.values()),
              "shapes": sum(len(d) for d in (k2_flat, k2_32, k2_hier,
                                              k2_h32))},
          "k1_vs_plain_in_path": {
              "calls": sum(len(c) for c in (k1_flat, k1_32, k1_hier, k1_h32)),
              "ids_differ_near_tie": sum(
                  e["ids_differ_near_tie"] for c in (k1_flat, k1_32, k1_hier,
                                                      k1_h32) for e in c)},
          "launches_flat_decode": flat_launches,
          "launches_flat_sweep_fp32": flat_sweep_launches,
          "launches_hier_sweep": hier_launches,
          "launches_per_call": {"flat_decode_batch_or_sweep_utterance":
                                FLAT_LAUNCHES,
                                "hier_encode": HIER_ENCODE_LAUNCHES,
                                "hier_decode_per_target":
                                    HIER_DECODE_LAUNCHES},
          "k2_plans_flat_decode": _plans(k2_flat),
          "k2_plans_flat_fp32": _plans(k2_32),
          "k2_plans_hier_sweep": _plans(k2_hier),
          "k2_plans_hier_fp32": _plans(k2_h32),
          "k1_calls_flat_decode": k1_flat, "k1_calls_hier_sweep": k1_hier,
          "decode_batch_profile": dict(profile, B=len(chunk), T=T_pad),
          "hier_infer_profile": dict(hier_profile, B=len(hchunk), T=hT)})
    return {"flat_decode": flat_launches, "hier_sweep": hier_launches,
            "paths": {"root": root, "dump": dump, "flat_conf": flat_conf,
                      "flat_ckpt": flat_ckpt, "decode": root / "dec"},
            "decode_batches": batches, "hier_sweep_batches": hier_batches,
            "k2_plans": _plans(k2_flat) + _plans(k2_32) + _plans(k2_hier)
            + _plans(k2_h32),
            "k1_hier": k1_hier}


BUNDLE_MAX_FRAMES = 2048      # egs/vcc20/vae1/run.sh stage 8
BUNDLE_REQUESTS = 8


def _files_bytes(path):
    return {f.name: f.stat().st_size for f in sorted(Path(path).iterdir())}


def _k1_ids(fn):
    """``(fn(), ids)``: the ids of every K1 ids-mode launch of the call, as
    the registered operator's CUDA implementation returns them."""
    from vae_npvc_tpu_torch.ops import vq_fused as mod

    original, ids = mod.vq_fused, []

    def recording(z, emb, *, stats=True):
        out = original(z, emb, stats=stats)
        ids.append(out.idx.clone())
        return out

    # the wrapper counts its launches on the module's ``vq_fused``
    recording.launches = original.launches
    mod.vq_fused = recording
    try:
        result = fn()
    finally:
        mod.vq_fused = original
        original.launches = recording.launches
        original.rescored = getattr(recording, "rescored", original.rescored)
    return result, ids


def _k2_layouts(fn):
    """``(fn(), layouts)``: the memory order of x at each K2 launch of the
    call (``channels-last`` or ``channels-first``)."""
    from vae_npvc_tpu_torch.ops import groupnorm as gn_ops

    original, layouts = gn_ops._forward, []

    def recording(x, *args):
        layouts.append(_layout(x))
        return original(x, *args)

    gn_ops._forward = recording
    try:
        result = fn()
    finally:
        gn_ops._forward = original
    return result, layouts


def _padded_batches(bundle, items):
    """The full-size ``(x, y, lengths)`` batches ``ServingBundle.convert``
    hands its programs for ``items``, and the calls it makes."""
    calls = []
    infer = bundle.infer

    def record(feats, tgts, lengths):
        calls.append((np.asarray(feats), np.asarray(tgts),
                      np.asarray(lengths)))
        return infer(feats, tgts, lengths)

    bundle.infer = record
    try:
        outs = bundle.convert(items)
    finally:
        bundle.infer = infer
    B, K, D = bundle.batch_size, bundle.n_targets, bundle.feat_dim
    batches = []
    for feats, tgts, lengths in calls:
        b, T, _ = feats.shape
        x = np.zeros((B, bundle.pick_bucket(T), D), np.float32)
        x[:b, :T] = feats
        y = np.zeros((B, K), np.int32)
        y[:b] = tgts[:, [min(j, tgts.shape[1] - 1) for j in range(K)]]
        n = np.ones((B,), np.int32)
        n[:b] = lengths
        batches.append((x, y, n))
    return outs, batches


def phase_bundle(torch, off, hier_ckpt):
    """Recipe stage 8 on the card: ``bin/export_serving`` of the flagship
    (bf16, seeded weights) at ``--max_frames 2048`` with the speaker map,
    fp32 and int8 params (each export a process of its own, run together); ``ServingBundle.convert`` of the offline phase's
    trials with K1/K2 launches per ``infer`` and ids and mel against the
    live ``Converter.infer`` on the same batches (bf16, and one fp32
    bucket); ``bin/bundle_check`` against the stage-5 arks; a bucket
    exported on the CPU moved to the card; the trained ``HIER`` checkpoint
    as a bundle; a ``ConversionEngine(bundle=...)`` answering HTTP
    ``/convert``; ``infer`` of a B = 8, T = 256 batch profiled beside the
    live path's."""
    import contextlib

    from scipy.io import wavfile

    from vae_npvc_tpu_torch.bin import bundle_check
    from vae_npvc_tpu_torch.data import kaldi_io
    from vae_npvc_tpu_torch.infer.convert import Converter
    from vae_npvc_tpu_torch.infer.export_serving import ServingBundle
    from vae_npvc_tpu_torch.serve import ConversionEngine

    root, dump = off["root"], off["dump"]
    spk = str(dump / "spk2spk_id")
    common = ["-m", str(off["flat_ckpt"]), "--spk2spk_id", spk]
    export_s, sizes, step_s = {}, {}, {}
    t_step = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        step_s[name] = now - t_step[0]
        t_step[0] = now

    # every export through the CLI, as the recipe runs it; the five run as
    # concurrent single-threaded processes (tracing is host work)
    conf32 = root / "flat_fp32.json"
    conf32.write_text(json.dumps(dict(FLAGSHIP, compute_dtype="float32")))
    hier_conf = root / "hier_bundle.json"
    hier_conf.write_text(json.dumps(HIER))
    max_frames = ["--max_frames", str(BUNDLE_MAX_FRAMES)]
    flat = ["-c", str(off["flat_conf"])] + common
    jobs = {"fp32": flat + max_frames,
            "int8": flat + max_frames + ["--quantize", "int8"],
            "fp32_compute": ["-c", str(conf32)] + common
            + ["--buckets", "256"],
            "cpu": flat + ["--buckets", "256", "--device", "cpu"],
            "hier": ["-c", str(hier_conf), "-m", str(hier_ckpt),
                     "--buckets", "256"]}
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")

    def export(name):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "vae_npvc_tpu_torch.bin.export_serving",
             "-o", str(root / f"bundle_{name}")] + jobs[name], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        return name, time.perf_counter() - t0, proc

    with ThreadPoolExecutor(len(jobs)) as ex:
        for name, seconds, proc in ex.map(export, jobs):
            log = proc.stdout.decode(errors="replace")
            check(proc.returncode == 0,
                  f"bundle: export {name} failed:\n{log[-3000:]}")
            print(log.strip().splitlines()[-1], flush=True)
            export_s[name] = seconds
            sizes[name] = _files_bytes(root / f"bundle_{name}")
    meta = json.loads((root / "bundle_fp32" / "bundle.json").read_text())
    want_buckets = list(range(FLAGSHIP["decode_bucket_size"],
                              BUNDLE_MAX_FRAMES + 1,
                              FLAGSHIP["decode_bucket_size"]))
    check(meta["buckets"] == want_buckets and meta["batch_size"] == 8
          and meta["device"] == "cuda" and meta["exporter"] == "torch.export",
          f"bundle: metadata {meta}")
    params = sizes["fp32"]["params.msgpack"]
    for name, files in sizes.items():
        pt2 = [v for k, v in files.items() if k.endswith(".pt2")]
        check(max(pt2) < params / 4, f"bundle: {name} programs of {pt2} "
              f"bytes beside {params} bytes of params hold weights")
        for path in sorted((root / f"bundle_{name}").glob("*.pt2"))[:1]:
            program = torch.export.load(str(path))
            check(not program.state_dict and program.example_inputs is None
                  and all(c.numel() <= 1
                          for c in program.constants.values()),
                  f"bundle: {path.name} of {name} holds weights")

    # the offline phase's trials through the bundle, against the live path
    feats_scp = kaldi_io.load_dict_data(dump / "feats.scp")
    trials = kaldi_io.load_list_data(dump / "trials")
    items = [(kaldi_io.load_mat(feats_scp[t[0]]), t[1:]) for t in trials]
    step("exports")
    bundle = ServingBundle(root / "bundle_fp32")
    bundle.convert(items)                       # loads the programs
    step("load_and_first_convert")
    _zero_counts()
    outs, batches = _padded_batches(bundle, items)
    counts = _read_counts()
    calls = len(batches)
    check({k: counts[k] for k in FLAT_LAUNCHES}
          == {k: v * calls for k, v in FLAT_LAUNCHES.items()},
          f"bundle: {calls} infer calls launched {counts}")
    for (feat, _), out in zip(items, outs):
        check(out.shape == feat.shape and bool(np.isfinite(out).all()),
              f"bundle: converted {out.shape} for {feat.shape}")
    live = Converter(FLAGSHIP, device="cuda")
    live.load_checkpoint(off["flat_ckpt"])
    mel_err, ids_equal = 0.0, True
    for x, y, n in batches:
        got, got_ids = _k1_ids(lambda: bundle.infer(x, y, n))
        want, want_ids = _k1_ids(lambda: live.infer(x, y, n))
        ids_equal &= (len(got_ids) == len(want_ids)
                      == FLAT_LAUNCHES["vq_fused"]) and all(
            torch.equal(a, b) for a, b in zip(got_ids, want_ids))
        mel_err = max(mel_err, float(np.abs(got - want).max()))
    check(ids_equal, "bundle: K1 ids differ from the live Converter.infer")
    live32 = Converter(dict(FLAGSHIP, compute_dtype="float32"),
                       device="cuda")
    live32.load_checkpoint(off["flat_ckpt"])
    b32 = ServingBundle(root / "bundle_fp32_compute")
    x, y, n = next(b for b in batches if b[0].shape[1] == 256)
    got32, ids32 = _k1_ids(lambda: b32.infer(x, y, n))
    want32, wids32 = _k1_ids(lambda: live32.infer(x, y, n))
    mel32_err = float(np.abs(got32 - want32).max())
    check(len(ids32) == len(wids32) == 1
          and all(torch.equal(a, b) for a, b in zip(ids32, wids32))
          and mel32_err <= OFFLINE_TOL * float(np.abs(want32).max()),
          f"bundle: fp32 program against the live fp32 infer: {mel32_err}")
    step("against_live")
    # int8 params: the weight rounding's effect on the first bucket's
    # trials, reported
    first = [i for i, (f, _) in enumerate(items)
             if f.shape[0] <= meta["buckets"][0]]
    outs8 = ServingBundle(root / "bundle_int8").convert(
        [items[i] for i in first])
    peak = max(float(np.abs(outs[i]).max()) for i in first)
    int8_err = max(float(np.abs(a - outs[i]).max())
                   for a, i in zip(outs8, first))
    # a bucket exported on the CPU, moved to the card as it loads; the
    # memory order of each K2 input, in both programs
    cpu = ServingBundle(root / "bundle_cpu")
    _zero_counts()
    (moved, moved_ids), moved_layouts = _k2_layouts(
        lambda: _k1_ids(lambda: cpu.infer(x, y, n)))
    moved_counts = _read_counts()
    (card, card_ids), card_layouts = _k2_layouts(
        lambda: _k1_ids(lambda: bundle.infer(x, y, n)))
    moved_err = float(np.abs(moved - card).max())
    check(moved_counts["vq_fused"] > 0
          and moved_counts["fused_group_norm"] > 0,
          f"bundle: the CPU-exported program launched {moved_counts}")
    check(len(moved_ids) == len(card_ids) == 1 and all(
        torch.equal(a, b) for a, b in zip(moved_ids, card_ids))
        and moved_err <= OFFLINE_TOL * float(np.abs(card).max()),
        f"bundle: the CPU-exported program differs from the card's by "
        f"{moved_err}")

    step("int8_and_cpu_exported")
    # recipe stage 8's check against the stage-5 decode
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            bundle_check.main(["--bundle", str(root / "bundle_fp32"),
                               "--decode_dir", str(dump), "--offline_scp",
                               str(off["decode"] / "feats.scp")])
    finally:
        check_line = log.getvalue().strip()
        print(check_line, flush=True)
    check(check_line.startswith("bundle_check PASS"),
          f"bundle: {check_line}")

    step("bundle_check")
    # the trained hierarchy as a bundle
    hb = ServingBundle(root / "bundle_hier")
    hlive = Converter(HIER, device="cuda")
    hlive.load_checkpoint(hier_ckpt)
    _zero_counts()
    hgot = hb.infer(x, y, n)
    hier_counts = _read_counts()
    hier_err = float(np.abs(hgot - hlive.infer(x, y, n)).max())
    check({k: hier_counts[k] for k in HIER_INFER_LAUNCHES}
          == HIER_INFER_LAUNCHES and bool(np.isfinite(hgot).all()),
          f"bundle: hierarchy infer launched {hier_counts}")

    step("hierarchy")
    # where the time goes: one B = 8, T = 256 batch, bundle and live in
    # turns
    profiles = {"bundle": [], "live": []}
    for who in ("bundle", "live", "live", "bundle"):
        fn = bundle.infer if who == "bundle" else live.infer
        profiles[who].append(_profiled(torch, lambda: fn(x, y, n)))

    # recipe serving through the bundle: HTTP /convert
    fs, shift = 24000, 256
    stats = _cmvn_stats()
    engine = ConversionEngine(None, None, stats, bundle=root / "bundle_fp32",
                              vocoder="gl", device="cuda")
    httpd = None
    try:
        engine.warmup(2)
        httpd, thread, _ = _serving(engine)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        durations = np.linspace(1.0, 4.0, BUNDLE_REQUESTS)
        wavs = [_speechlike(int(d * fs), fs, 40 + i)
                for i, d in enumerate(durations)]
        names = sorted(engine.speakers())

        def post(i):
            buf = io.BytesIO()
            wavfile.write(buf, fs, (wavs[i] * 32767).astype(np.int16))
            req = urllib.request.Request(
                f"{base}/convert?target={names[i % len(names)]}",
                data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                return wavfile.read(io.BytesIO(r.read()))

        calls0 = engine.batcher.calls
        _zero_counts()
        t0 = time.monotonic()
        with ThreadPoolExecutor(4) as ex:
            results = list(ex.map(post, range(len(wavs))))
        http_s = time.monotonic() - t0
        http_counts = _read_counts()
        http_calls = engine.batcher.calls - calls0
        for i, (sr, out) in enumerate(results):
            check(sr == fs and out.shape == ((1 + wavs[i].size // shift)
                                             * shift,)
                  and np.abs(out).max() > 0,
                  f"bundle: request {i} gave {out.shape} at {sr} Hz")
        check({k: http_counts[k] for k in FLAT_LAUNCHES}
              == {k: v * http_calls for k, v in FLAT_LAUNCHES.items()},
              f"bundle: {http_calls} served infer calls launched "
              f"{http_counts}")
    finally:
        if httpd is not None:
            _stop(httpd, thread)
        engine.close()

    step("profiles_and_http")
    per_infer = {k: counts[k] // calls for k in FLAT_LAUNCHES}
    emit({"phase": "bundle", "buckets": meta["buckets"], "step_s": step_s,
          "batch": meta["batch_size"], "export_s": export_s,
          "export_concurrent": list(jobs),
          "bytes": sizes, "trials": len(items), "infer_calls": calls,
          "launches": counts, "launches_per_infer": per_infer,
          "live_launches_per_infer": FLAT_LAUNCHES,
          "ids_equal_live": ids_equal,
          "bf16_mel_vs_live_max_abs_err": mel_err,
          "fp32_mel_vs_live_max_abs_err": mel32_err,
          "int8_params_vs_fp32_over_peak": int8_err / peak,
          "cpu_exported_on_card_launches": moved_counts,
          "cpu_exported_vs_card_exported_max_abs_err": moved_err,
          "k2_layouts_cpu_exported": moved_layouts,
          "k2_layouts_card_exported": card_layouts,
          "bundle_check": check_line,
          "hier_launches_per_infer": hier_counts,
          "hier_vs_live_max_abs_err": hier_err,
          "http_requests": len(results), "http_wall_s": http_s,
          "http_requests_per_s": len(results) / http_s,
          "http_infer_calls": http_calls,
          "infer_b8_t256_profile": profiles})
    return {"launches": counts, "per_infer": per_infer}


# the model keys of egs/aishell3/vc2/conf/train_vqvae.yaml, the AISHELL-3
# recipe's VQ-VAE (tests/test_torch_port_io.py checks this equals the file)
AISHELL = {
    "model_type": "vae_npvc.model.vqvae",
    "y_dim": 128, "y_num": 1172, "z_dim": 128, "z_num": 128,
    "use_ema": True, "beta": 0.01, "mu": 0.9, "jitter_p": 0.12,
    "encoder": {"in_channels": [160], "out_channels": [512],
                "kernel_size": 3, "downsample_scales": [1],
                "z_channels": 128, "dilation": False,
                "stack_kernel_size": 3, "stack_layers": 1, "stacks": [10],
                "use_weight_norm": True},
    "decoder": {"in_channels": [128], "out_channels": [512],
                "cond_channels": 128, "skip_channels": 128,
                "final_channels": 160, "kernel_size": 3,
                "upsample_scales": [1], "dilation": False,
                "stack_kernel_size": 3, "stacks": [10],
                "use_weight_norm": True},
    "compute_dtype": "bfloat16",
    "decode_bucket_size": 256,
    "decode_batch_size": 8,
}
# its training keys; batch_size is cut from 128 to 8 (the corpus holds 14
# training utterances and bin/train drops partial batches) and the run to
# BNF_TRAIN_STEPS steps
AISHELL_TRAIN = {
    "trainer_type": "vae_npvc.trainer.basic", "seed": 777, "batch_size": 8,
    "crop_length": 256, "optim_type": "Adam", "learning_rate": 0.001,
    "max_grad_norm": 10, "lr_scheduler": "StepLR",
    "lr_param": {"step_size": 100000, "gamma": 0.5},
}
BNF_TRAIN_STEPS = 8
# every key of egs/aishell3/vc2/conf/train_token_tts.yaml (the conv
# synthesizer run_tts.sh trains by default; tests/test_torch_port_io.py
# checks this equals the file)
TOKEN_TTS = {
    "trainer_type": "vae_npvc.trainer.basic",
    "model_type": "vae_npvc.model.token_tts",
    "max_iter": 200000, "iters_per_checkpoint": 10000, "iters_per_log": 500,
    "seed": 777, "batch_size": 32, "optim_type": "Adam",
    "learning_rate": 0.001, "max_grad_norm": 10, "lr_scheduler": "StepLR",
    "lr_param": {"step_size": 50000, "gamma": 0.5},
    "token_num": 128, "token_dim": 256, "y_num": 1172, "y_dim": 256,
    "mel_dim": 160, "hidden": 512, "enc_stacks": 6, "dec_stacks": 6,
    "dur_weight": 0.1, "max_tokens": 192, "max_frames": 768,
    "postnet_layers": 3, "variance_predictor": True, "var_weight": 0.1,
    "use_spk_embed": False, "spk_embed_dim": 64,
}
# run_tts.sh stage 1 for a few steps: batch_size cut from 32 to at most 4
# (the corpus's utterances whose tokens and frames fit max_tokens and
# max_frames; how many do depends on the trained codebook)
TOKEN_TTS_STEPS, TOKEN_TTS_BATCH = 4, 4
# egs/aishell3/vc2/run_vae.sh's front end; 16 utterances of 1-10 s
AISHELL_FEATURE = {"fs": 44100, "n_fft": 2048, "n_shift": 550,
                   "n_mels": 160}
BNF_UTTS = [(float(d), 44100) for d in np.linspace(1.0, 10.0, 16)]
BNF_LAUNCHES = {"vq_fused": 1, "fused_group_norm": 10}   # per batch
BNF_REPEATS = 3


def phase_bnf(torch, root):
    """The AISHELL-3 recipe's stages on the card at the widths of its
    ``train_vqvae.yaml``: ``make_fbank``, CMVN, ``make_spk_id`` and
    ``subset_data_into_tr_cv --seed 777`` (``run_vae.sh`` stages 1-2), a
    few seeded steps of ``bin/train`` (stage 3), ``bin/extract_bnf -k csid
    --durations`` with K1/K2 launches per batch and its throughput (stage
    4), then ``run_tts.sh`` stages 0-2: the token-mel dir and its symbol
    list, ``bin/train_tts`` with ``train_token_tts.yaml`` (conv blocks: K2
    and K3 run) and ``bin/decode_tts`` on the extracted tokens."""
    import shutil

    from vae_npvc_tpu_torch.bin import (apply_cmvn, decode_tts, extract_bnf,
                                        subset_data_into_tr_cv, train,
                                        train_tts)
    from vae_npvc_tpu_torch.bin.make_fbank import make_fbank
    from vae_npvc_tpu_torch.bin.make_spk_id import make_spk_id
    from vae_npvc_tpu_torch.data import kaldi_io
    from vae_npvc_tpu_torch.data.token_mel import (TokenMelDataset,
                                                    parse_token_line)

    root.mkdir(parents=True)
    stage_s = {}

    def stage(name, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        stage_s[name] = time.perf_counter() - t0
        return out

    # run_vae.sh stages 1-2
    data, _ = _offline_corpus(root, BNF_UTTS)
    fb, dump = root / "fbank", root / "dump"
    n = stage("make_fbank", make_fbank, data, fb, device="cuda",
              **AISHELL_FEATURE)
    check(n == len(BNF_UTTS), f"bnf: make_fbank wrote {n}")
    cmvn = root / "cmvn.ark"
    apply_cmvn.main(["compute", f"scp:{fb}/feats.scp", str(cmvn)])
    make_spk_id(fb)
    apply_cmvn.main(["apply", str(cmvn), f"scp:{fb}/feats.scp",
                     str(dump / "all")])
    for f in ("utt2num_frames", "utt2spk_id", "utt2spk", "spk2spk_id"):
        shutil.copy(fb / f, dump / "all" / f)
    (dump / "all" / "wav.scp").touch()
    n_train, n_dev = len(BNF_UTTS) - 2, 2
    subset_data_into_tr_cv.main([str(dump / "all"), str(dump / "train"),
                                 str(dump / "dev"), "-nt", str(n_train),
                                 "-nv", str(n_dev), "--seed", "777"])
    ids = kaldi_io.load_dict_data(dump / "all" / "utt2spk_id")
    for x in ("train", "dev"):
        utts = kaldi_io.load_dict_data(dump / x / "utt2spk")
        kaldi_io.save_dict_data(dump / x / "utt2spk_id",
                                {u: ids[u] for u in utts})
        shutil.copy(dump / "all" / "spk2spk_id", dump / x / "spk2spk_id")
    check(len(kaldi_io.load_dict_data(dump / "train" / "feats.scp"))
          == n_train, "bnf: the train split")

    # stage 3: a few seeded steps of bin/train
    conf = root / "train_vqvae.json"
    conf.write_text(json.dumps(dict(
        AISHELL, **AISHELL_TRAIN, max_iter=BNF_TRAIN_STEPS,
        iters_per_log=BNF_TRAIN_STEPS // 2,
        iters_per_checkpoint=BNF_TRAIN_STEPS)))
    exp = root / "exp"
    stage("train", _quiet, train.main,
          ["-c", str(conf), "--train_dir", str(dump / "train"),
           "--valid_dir", str(dump / "dev"), "--output_dir", str(exp)])
    ckpt = exp / "model.loss.best"
    check(ckpt.is_file(), "bnf: bin/train wrote no model.loss.best")

    # stage 4: VQ-token extraction
    frames = {u: int(v) for u, v in kaldi_io.load_dict_data(
        dump / "all" / "utt2num_frames").items()}
    batches = _batches(frames.values(), AISHELL["decode_bucket_size"],
                       AISHELL["decode_batch_size"])
    args = [f"scp:{dump}/all/feats.scp", str(exp / "vq_tokens.txt"),
            "-c", str(conf), "-m", str(ckpt), "-k", "csid", "--durations",
            str(exp / "vq_durations.txt")]
    _zero_counts()
    n = stage("extract_bnf", _quiet, extract_bnf.main, args)[0]
    counts = _read_counts()
    check(n == len(frames), f"bnf: extract_bnf wrote {n}")
    check({k: counts[k] for k in BNF_LAUNCHES}
          == {k: v * batches for k, v in BNF_LAUNCHES.items()},
          f"bnf: {batches} batches launched {counts}")
    tokens = kaldi_io.load_dict_data(exp / "vq_tokens.txt")
    durs = kaldi_io.load_dict_data(exp / "vq_durations.txt")
    n_tokens = 0
    for u, T in frames.items():
        t = parse_token_line(tokens[u])
        d = np.asarray(durs[u].split(), np.int64)
        check(len(t) == len(d) and int(d.sum()) == T and len(t) > 0
              and int(t.min()) >= 0 and int(t.max()) < AISHELL["z_num"]
              and bool(np.all(t[1:] != t[:-1])),
              f"bnf: {u}: {len(t)} tokens, durations summing to "
              f"{int(d.sum())} of {T} frames")
        n_tokens += len(t)
    repeat_s = []
    for _ in range(BNF_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _quiet(extract_bnf.main, args)
        torch.cuda.synchronize()
        repeat_s.append(time.perf_counter() - t0)
    check(kaldi_io.load_dict_data(exp / "vq_tokens.txt") == tokens,
          "bnf: a second extraction gave other tokens")

    # run_tts.sh stage 0: the token-mel dir and its symbol list
    tts = root / "data" / "tts"
    tts.mkdir(parents=True)
    shutil.copy(exp / "vq_tokens.txt", tts / "tokens.txt")
    shutil.copy(exp / "vq_durations.txt", tts / "durations.txt")
    for f in ("feats.scp", "utt2spk_id", "utt2num_frames"):
        shutil.copy(dump / "all" / f, tts / f)
    shutil.copy(tts / "tokens.txt", tts / "text")
    subprocess.run([sys.executable, str(
        ROOT / "egs/aishell3/vc2/local/generate_nlsymbols.py"), "-n",
        str(AISHELL["z_num"]), "-o", str(tts / "nlsyms.txt")], check=True,
        capture_output=True)
    check(len((tts / "nlsyms.txt").read_text().split())
          == TOKEN_TTS["token_num"], "bnf: nlsyms.txt")
    # stages 1-2: a few steps of the conv synthesizer, then synthesis
    usable = len(TokenMelDataset(tts, TOKEN_TTS))
    tts_batch = min(TOKEN_TTS_BATCH, usable)
    tconf = root / "train_token_tts.json"
    tconf.write_text(json.dumps(dict(
        TOKEN_TTS, max_iter=TOKEN_TTS_STEPS, batch_size=tts_batch,
        iters_per_log=TOKEN_TTS_STEPS, iters_per_checkpoint=TOKEN_TTS_STEPS)))
    texp = root / "exp" / "token_tts"
    _zero_counts()
    stage("train_tts", _quiet, train_tts.main,
          ["-c", str(tconf), "--train_dir", str(tts), "--output_dir",
           str(texp)])
    tts_counts = _read_counts()
    check(all(tts_counts[k] > 0 for k in ("fused_group_norm",
                                          "fused_group_norm_backward")),
          f"bnf: the conv synthesizer's steps launched {tts_counts}")
    stage("decode_tts", _quiet, decode_tts.main,
          ["-c", str(tconf), "--checkpoint", str(texp / "model.loss.best"),
           "--tokens", str(tts / "tokens.txt"), "--spk",
           str(tts / "utt2spk_id"), "--output-dir", str(texp / "decode")])
    mels = dict((k, kaldi_io.load_mat(rx)) for k, rx in
                kaldi_io.load_dict_data(texp / "decode" / "feats.scp").items())
    check(len(mels) == len(frames) and all(
        m.shape[1] == TOKEN_TTS["mel_dim"] and bool(np.isfinite(m).all())
        for m in mels.values()), f"bnf: decode_tts wrote {len(mels)} mels")

    total = sum(frames.values())
    emit({"phase": "bnf", "config": "egs/aishell3/vc2/conf/train_vqvae.yaml",
          "utterances": len(frames), "frames": total,
          "seconds_min_max": [BNF_UTTS[0][0], BNF_UTTS[-1][0]],
          "split": [n_train, n_dev], "train_steps": BNF_TRAIN_STEPS,
          "extract_batches": batches, "launches_extract": counts,
          "launches_per_batch": BNF_LAUNCHES, "tokens": n_tokens,
          "extract_repeats_s": repeat_s,
          "extract_utts_per_s": len(frames) * len(repeat_s) / sum(repeat_s),
          "extract_frames_per_s": total * len(repeat_s) / sum(repeat_s),
          "tts_usable_utterances": usable, "tts_batch": tts_batch,
          "tts_steps": TOKEN_TTS_STEPS, "launches_train_tts": tts_counts,
          "tts_decoded": len(mels), "stage_s": stage_s})
    return {"launches": counts, "batches": batches}


# the vocoder keys of egs/vcc20/vae1/conf/train_jpwg.yaml (the GPU host has
# no YAML parser; tests/test_torch_port_io.py checks this equals the file)
PWG = {
    "fs": 24000, "n_fft": 1024, "n_shift": 256, "n_mels": 80, "fmin": 80,
    "fmax": 7600, "layers": 30, "stacks": 3, "residual_channels": 64,
    "gate_channels": 128, "skip_channels": 64, "kernel_size": 3,
    "upsample_scales": [4, 4, 4, 4], "disc_layers": 10, "disc_channels": 64,
    "seed": 777, "batch_size": 8, "batch_max_frames": 96,
    "max_iter": 400000, "iters_per_checkpoint": 50000, "iters_per_log": 500,
    "lambda_adv": 4.0, "discriminator_train_start_steps": 100000,
    "generator_param": {"optim_type": "RAdam", "learning_rate": 0.0001,
                        "lr_scheduler": {"step_size": 200000,
                                         "gamma": 0.5}},
    "discriminator_param": {"optim_type": "RAdam", "learning_rate": 0.00005,
                            "lr_scheduler": {"step_size": 200000,
                                             "gamma": 0.5}},
    "steps_per_call": 8, "device_resident": "auto",
}
# voc_train: the adversary from step 8 of 16, so both halves of the GAN
# schedule run (a schedule value; every width and shape is the recipe's)
VOC_TRAIN = dict(PWG, discriminator_train_start_steps=8)
VOC_STEPS, VOC_K = 16, 8
VOC_UTTS = 32                       # the voc_train corpus, 2-6 s each
VOC_REQUESTS = 8
VOC_OFFLINE_SECONDS = np.linspace(1.0, 10.0, 16)
VOC_REPEATS = 3
VOC_TOL = 1e-5                      # of the peak: same weights, same noise
# G's RAdam moments, of the network's largest |mu| (resp. |nu|): the
# log-magnitude gradient at the seeded DC-level output carries each FFT's
# rounding (tests/test_torch_port_pwg_train.py)
VOC_G_MOMENT_TOL = 2e-2
VOC_G_MOMENT_LEAF_TOL = 0.1         # of each leaf's own peak
# the card's whole-loss generator gradient against the same loss in float64,
# of each leaf's peak (ill-conditioned at the seeded init: voc_grad_fp32)
VOC_WHOLE_GRAD_TOL = 0.1


def _pwg_free_leaf(name):
    """The ``in`` conv's direction ``v``: one input channel and kernel 1,
    so the weight norm keeps only its sign and its exact gradient is 0."""
    return name == "in.v"


def _voc_state_against(got, want, what):
    """Two vocoder states' leaves as voc_golden holds them: every leaf
    within GOLDEN_STATE_TOL but G's RAdam moments, which are held within
    VOC_G_MOMENT_TOL of their largest and VOC_G_MOMENT_LEAF_TOL of each
    leaf's peak. Returns ``(largest other error, G's moment errors of the
    largest, their relative L2, the worst leaf of each)``."""
    check(set(got) == set(want), f"{what}: checkpoint trees differ")
    atol, rtol = GOLDEN_STATE_TOL
    state_err = 0.0
    moments = {"mu": ([], []), "nu": ([], [])}
    g_leaf = {"mu": (0.0, None), "nu": (0.0, None)}
    for k in want:
        a, b = got[k].astype(np.float64), want[k].astype(np.float64)
        check(a.shape == b.shape, f"{what}: {k} shape {a.shape}")
        kind = k.split("/")[3] if k.startswith("optimizer_G/1/0/") else None
        if kind in moments:
            moments[kind][0].append(a.ravel())
            moments[kind][1].append(b.ravel())
            leaf = k.split("/", 4)[4]
            if not _pwg_free_leaf(leaf.replace("/", ".")):
                err = float(np.abs(a - b).max())
                r = err / float(np.abs(b).max()) if err else 0.0
                if r > g_leaf[kind][0]:
                    g_leaf[kind] = (r, leaf)
            continue
        if not b.size:
            continue
        err = np.abs(a - b)
        state_err = max(state_err, float(err.max()))
        check(bool(np.all(err <= atol + rtol * np.abs(b))),
              f"{what}: {k} differs by {float(err.max())}")
    g_moment, g_moment_l2 = {}, {}
    for kind, (a, b) in moments.items():
        a, b = np.concatenate(a), np.concatenate(b)
        g_moment[kind] = float(np.abs(a - b).max() / np.abs(b).max())
        g_moment_l2[kind] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        check(g_moment[kind] <= VOC_G_MOMENT_TOL, f"{what}: G's {kind} "
              f"differs by {g_moment[kind]} of its largest")
        check(g_leaf[kind][0] <= VOC_G_MOMENT_LEAF_TOL, f"{what}: G's "
              f"{kind} of {g_leaf[kind][1]} differs by {g_leaf[kind][0]} "
              "of the leaf's peak")
    return state_err, g_moment, g_moment_l2, g_leaf


def phase_voc_golden(torch):
    """The port's ``PwgTrainer`` on the card against the committed JAX
    fixture (tests/test_torch_port_pwg_train.py) in fp32: six steps across
    ``discriminator_train_start_steps`` from the same state with JAX's
    noise (per-step losses), the final parameters and RAdam moments, and
    the generator's output at JAX's final state."""
    from vae_npvc_tpu_torch.train.pwg import PwgTrainer
    from vae_npvc_tpu_torch.utils import msgpack_io

    cfg = json.loads((FIXTURES / "pwg_golden_config.json").read_text())
    g = np.load(FIXTURES / "pwg_golden.npz")
    steps = len(g["detail/Total"])
    tr = PwgTrainer(cfg, device="cuda")
    tr.load_checkpoint(FIXTURES / "pwg_golden.msgpack")
    worst = {}
    for i in range(steps):
        detail = tr.train_step((g[f"wav_{i}"], g[f"mel_{i}"]), g[f"z_{i}"])
        for k, v in detail.items():
            want = float(g["detail/" + k][i])
            rel = abs(float(v) - want) / max(abs(want), 1e-12)
            worst[k] = max(worst.get(k, 0.0), rel)
            check(rel <= GOLDEN_LOSS_RTOL, f"voc_golden: step {i + 1} {k} "
                  f"{float(v)}, JAX {want}")
    with tempfile.TemporaryDirectory() as tmp:
        tr.save_checkpoint(Path(tmp) / "final")
        got = _leaves(msgpack_io.msgpack_restore(
            (Path(tmp) / "final").read_bytes()))
    want = _leaves(msgpack_io.msgpack_restore(
        (FIXTURES / "pwg_golden_final.msgpack").read_bytes()))
    state_err, g_moment, g_moment_l2, g_leaf = _voc_state_against(
        got, want, "voc_golden")
    final = PwgTrainer(cfg, device="cuda")
    final.load_checkpoint(FIXTURES / "pwg_golden_final.msgpack")
    wav = final.synthesize(g["eval/mel"], g["eval/z"])
    ref = g["eval/wav"][..., 0]
    peak = float(np.abs(ref).max())
    wav_err = float(np.abs(wav - ref).max())
    check(wav.shape == ref.shape and wav_err <= VOC_TOL * peak,
          f"voc_golden: generator output differs from JAX by {wav_err} "
          f"(peak {peak})")
    emit({"phase": "voc_golden", "steps": steps,
          "d_start": cfg["discriminator_train_start_steps"],
          "worst_rel_err": worst, "loss_rtol": GOLDEN_LOSS_RTOL,
          "state_leaves": len(want), "state_max_abs_err": state_err,
          "state_atol_rtol": list(GOLDEN_STATE_TOL),
          "g_moment_err_of_largest": g_moment,
          "g_moment_rel_l2": g_moment_l2,
          "g_moment_tol_of_largest": VOC_G_MOMENT_TOL,
          "g_moment_worst_leaf": g_leaf,
          "g_moment_tol_of_leaf_peak": VOC_G_MOMENT_LEAF_TOL,
          "wav_max_abs_err": wav_err, "wav_peak": peak,
          "tolerance_of_peak": VOC_TOL})


def phase_voc_grad_fp32(torch):
    """Every generator and discriminator gradient of the recipe's vocoder
    at full width in fp32 on the card against the same weights and inputs
    on the CPU (B = 2, 32 frames = 8,192 samples), within ``GRAD_TOL`` of
    each gradient's peak. The generator's gradients are its backward of one
    cotangent (the CPU's gradient of the whole loss, STFT and adversarial,
    at its output); the loss's own input gradient is held on a prediction
    with a speech-like spectrum. At the seeded initialization the
    generator's output is a DC level with ~0.5 % variation, where the
    log-magnitude gradient 1/|X| carries each FFT's rounding: the whole
    loss's gradient there, autograd end to end, is held against the same
    loss in float64 on the CPU (trunk and STFT loss; fp32 parameters and
    waveform) within ``VOC_WHOLE_GRAD_TOL`` of each leaf's peak (but
    ``in.v``); the CPU's fp32 against both is reported."""
    from vae_npvc_tpu_torch.data.features import logmelspectrogram
    from vae_npvc_tpu_torch.models.pwg import PWGDiscriminator, PWGGenerator
    from vae_npvc_tpu_torch.ops.stft_loss import (DEFAULT_RESOLUTIONS,
                                                  multi_stft_loss,
                                                  single_stft_loss)

    cfg = dict(PWG, compute_dtype="float32")
    B, T, hop = 2, 32, 256
    S = T * hop
    wav = np.stack([_speechlike(S, 24000, 70 + b) for b in range(B)])
    mel = logmelspectrogram(torch.from_numpy(wav), fs=24000, n_fft=1024,
                            n_shift=256, n_mels=80, fmin=80,
                            fmax=7600)[:, :T].numpy()
    z = np.random.default_rng(4).normal(size=(B, S, 1)).astype(np.float32)
    nets = {}
    for dev in ("cpu", "cuda"):
        gen = PWGGenerator(cfg).init_random(777).to(dev)
        disc = PWGDiscriminator(cfg).init_random(778).to(dev)
        nets[dev] = (gen, disc)

    def loss_terms(wav_hat, target, disc):
        sc, mag = multi_stft_loss(wav_hat, target)
        adv = torch.mean((disc(wav_hat[..., None]) - 1.0) ** 2)
        return sc + mag + 4.0 * adv

    # the CPU's cotangent of the whole loss at the generator's output
    gen_c, disc_c = nets["cpu"]
    wav_c = torch.from_numpy(wav)
    hat_c = gen_c(torch.from_numpy(z), torch.from_numpy(mel))[..., 0]
    leaf = hat_c.detach().clone().requires_grad_()
    ct = torch.autograd.grad(loss_terms(leaf, wav_c, disc_c), leaf)[0]
    results, worst = {}, {}
    for dev, (gen, disc) in nets.items():
        t = lambda a: torch.as_tensor(a, device=dev)      # noqa: E731
        hat = gen(t(z), t(mel))[..., 0]
        g_grads = torch.autograd.grad(hat, list(gen.parameters()), t(ct))
        d_loss = (torch.mean((disc(t(wav)[..., None]) - 1.0) ** 2)
                  + torch.mean(disc(t(hat_c.detach())[..., None]) ** 2))
        d_grads = torch.autograd.grad(d_loss, list(disc.parameters()))
        # the loss's input gradient on a speech-like prediction
        pred = (t(wav) + 0.05 * t(z[..., 0])).requires_grad_()
        in_grad = torch.autograd.grad(loss_terms(pred, t(wav), disc), pred)[0]
        # the whole loss's generator gradient, autograd end to end
        e2e = torch.autograd.grad(
            loss_terms(gen(t(z), t(mel))[..., 0], t(wav), disc),
            list(gen.parameters()))
        results[dev] = ([x.cpu() for x in g_grads],
                        [x.cpu() for x in d_grads], in_grad.cpu(),
                        [x.cpu() for x in e2e], d_loss.item(),
                        hat.detach().cpu())

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)

    gc, dc, ic, ec, dlc, hc = results["cpu"]
    gd, dd, idv, ed, dld, hd = results["cuda"]
    g_peak = max(float(x.abs().max()) for x in gc)
    for kind, names, got, want in (
            ("generator", [n for n, _ in gen_c.named_parameters()], gd, gc),
            ("discriminator", [n for n, _ in disc_c.named_parameters()],
             dd, dc)):
        w, wn = 0.0, None
        for name, a, b in zip(names, got, want):
            check(bool(torch.isfinite(a).all()),
                  f"voc_grad_fp32: {kind} {name} not finite")
            r = (float((a - b).abs().max()) / g_peak
                 if _pwg_free_leaf(name) else rel(a, b))
            if r > w:
                w, wn = r, name
        worst[kind] = (w, wn)
        check(w <= GRAD_TOL, f"voc_grad_fp32: {kind} gradient of {wn} "
              f"differs by {w} of its peak")
    in_err = rel(idv, ic)
    check(in_err <= GRAD_TOL, f"voc_grad_fp32: the loss's input gradient "
          f"differs by {in_err} of its peak")
    out_err = rel(hd, hc)
    check(out_err <= VOC_TOL, f"voc_grad_fp32: generator output differs "
          f"by {out_err} of its peak")
    check(abs(dld - dlc) <= 1e-5 * abs(dlc), f"voc_grad_fp32: D loss "
          f"{dld} on the card, {dlc} on the CPU")
    # the whole loss in float64 on the CPU, on the CPU nets' parameters
    gen64 = PWGGenerator(cfg, dtype=torch.float64)
    disc64 = PWGDiscriminator(cfg, dtype=torch.float64)
    gen64.load_state_dict(gen_c.state_dict())
    disc64.load_state_dict(disc_c.state_dict())
    hat64 = gen64(torch.from_numpy(z), torch.from_numpy(mel))[..., 0]
    stft64 = sum(sum(single_stft_loss(hat64.double(), wav_c.double(), *r))
                 for r in DEFAULT_RESOLUTIONS) / len(DEFAULT_RESOLUTIONS)
    loss64 = stft64 + 4.0 * torch.mean((disc64(hat64[..., None]) - 1.0) ** 2)
    e64 = torch.autograd.grad(loss64, list(gen64.parameters()))
    names = [n for n, _ in gen_c.named_parameters()]
    e2e = {}
    for key, got, want in (("card_vs_cpu", ed, ec), ("card_vs_float64", ed,
                                                     e64),
                           ("cpu_vs_float64", ec, e64)):
        e2e[key] = max((rel(a, b.float()), n) for n, a, b in zip(
            names, got, want) if not _pwg_free_leaf(n) and b.abs().max() > 0)
    check(e2e["card_vs_float64"][0] <= VOC_WHOLE_GRAD_TOL, f"voc_grad_fp32: "
          f"the whole loss's gradient of {e2e['card_vs_float64'][1]} differs "
          f"from float64 by {e2e['card_vs_float64'][0]} of its peak")
    emit({"phase": "voc_grad_fp32", "B": B, "samples": S,
          "generator_parameters": len(gc),
          "discriminator_parameters": len(dc),
          "output_err_of_peak": out_err, "output_std": float(hc.std()),
          "output_mean": float(hc.mean()),
          "worst_generator_grad": worst["generator"],
          "worst_discriminator_grad": worst["discriminator"],
          "loss_input_grad_err_speechlike": in_err,
          "d_loss_gpu": dld, "d_loss_cpu": dlc, "tolerance": GRAD_TOL,
          "whole_loss_generator_grad_err_of_leaf_peak": e2e,
          "whole_loss_tolerance_card_vs_float64": VOC_WHOLE_GRAD_TOL})


def _voc_corpus(root, n, seed):
    """A ``wav.scp`` of ``n`` speech-like int16 wavs of 2-6 s at 24 kHz."""
    from scipy.io import wavfile

    wav = root / "wav"
    wav.mkdir(parents=True)
    lines = []
    for i, sec in enumerate(np.linspace(2.0, 6.0, n)):
        x = _speechlike(int(sec * 24000), 24000, seed + i)
        wavfile.write(wav / f"v{i:03d}.wav", 24000,
                      (x * 32767).astype(np.int16))
        lines.append(f"v{i:03d} {wav}/v{i:03d}.wav\n")
    (root / "wav.scp").write_text("".join(lines))
    return root


def phase_voc_train(torch, root):
    """The recipe's vocoder (``VOC_TRAIN``: full width, fp32, B = 8 x 96
    frames = 24,576 samples) for ``VOC_STEPS`` steps through
    ``train_steps_device`` (K = 8) on a synthetic 24 kHz corpus staged on
    the device, the adversary from step 8: ms per step of each half,
    samples/s, peak memory, one profiled adversarial step, a save/load
    round trip. Returns the checkpoint path."""
    from vae_npvc_tpu_torch.data.wav_mel import WavMelDataset
    from vae_npvc_tpu_torch.train.pwg import PwgTrainer

    t0 = time.perf_counter()
    ds = WavMelDataset(_voc_corpus(root / "voc_corpus", VOC_UTTS, 300),
                       VOC_TRAIN)
    load_s = time.perf_counter() - t0
    tr = PwgTrainer(VOC_TRAIN, device="cuda")
    tr.init_state()
    staged = tr.stage_dataset(ds, VOC_TRAIN["batch_size"])
    d0 = tr.D.flat.clone()
    calls, details = [], []
    for c in range(VOC_STEPS // VOC_K):
        if c == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        details.append(tr.train_steps_device(VOC_K))
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t) * 1e3 / VOC_K)
        if c == 0:
            check(torch.equal(tr.D.flat, d0), "voc_train: D moved before "
                  "discriminator_train_start_steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(not torch.equal(tr.D.flat, d0), "voc_train: D never moved")
    losses = {k: torch.cat([d[k] for d in details]).cpu().numpy()
              for k in details[0]}
    for k, v in losses.items():
        check(v.shape == (VOC_STEPS,) and bool(np.isfinite(v).all()),
              f"voc_train: {k} {v}")
    profile = _profiled(torch, lambda: tr.train_steps_device(1))
    ckpt = root / "voc_model.final"
    tr.save_checkpoint(ckpt)
    back = PwgTrainer(VOC_TRAIN, device="cuda")
    back.load_checkpoint(ckpt)
    back.save_checkpoint(root / "voc_again")
    check((root / "voc_again").read_bytes() == ckpt.read_bytes(),
          "voc_train: save/load round trip changed the checkpoint")
    check(back.iteration == VOC_STEPS + 1, "voc_train: iteration")
    samples = VOC_TRAIN["batch_size"] * VOC_TRAIN["batch_max_frames"] \
        * VOC_TRAIN["n_shift"]
    emit({"phase": "voc_train", "steps": VOC_STEPS, "steps_per_call": VOC_K,
          "batch": VOC_TRAIN["batch_size"], "samples_per_step": samples,
          "corpus_utterances": VOC_UTTS, "corpus_load_s": load_s,
          "staged_bytes": staged,
          "ms_per_step_calls": calls,
          "ms_per_step_generator_only_incl_first": calls[0],
          "ms_per_step_adversarial": calls[1],
          "samples_per_s_adversarial": samples / (calls[1] / 1e3),
          "peak_memory_gb": peak_gb,
          "losses_first_last": {k: [float(v[0]), float(v[-1])]
                                for k, v in losses.items()},
          "adversarial_step_profile": profile,
          "checkpoint_mb": ckpt.stat().st_size / 1e6})
    return ckpt


def _voc_config_file(root):
    path = root / "voc.json"
    path.write_text(json.dumps(VOC_TRAIN))
    return path


def phase_voc_serve(torch, root, voc_ckpt):
    """A ``ConversionEngine(vocoder="jpwg")`` with the flagship flat model
    (bf16, seeded weights) and ``voc_train``'s vocoder answering
    ``VOC_REQUESTS`` requests of 1-4 s from four threads; one 512-frame
    synthesis profiled; the served wav against the generator run directly
    on the same canvas and noise; then :func:`phase_voc_stream` on the same
    engine. Returns the K1/K2 launches and ``infer`` calls of the requests
    and of the stream phase."""
    from vae_npvc_tpu_torch.serve import ConversionEngine

    fs, shift, D = 24000, 256, 80
    ckpt = root / "voc_flat.ckpt"
    _random_checkpoint(torch, ckpt, seed=3)
    stats = _cmvn_stats()
    engine = ConversionEngine(FLAGSHIP, ckpt, stats, vocoder="jpwg",
                              voc_config=_voc_config_file(root),
                              voc_checkpoint=voc_ckpt, seed=5,
                              device="cuda")
    try:
        t0 = time.monotonic()
        engine.warmup(2)
        warm_s = time.monotonic() - t0
        durations = np.linspace(1.0, 4.0, VOC_REQUESTS)
        wavs = [_speechlike(int(d * fs), fs, 40 + i)
                for i, d in enumerate(durations)]

        def one(i):
            t = time.monotonic()
            out, sr = engine.convert(wavs[i], fs, (7 * i) % 117)
            return out, sr, (time.monotonic() - t) * 1e3

        calls0 = engine.batcher.calls
        _zero_counts()
        t0 = time.monotonic()
        with ThreadPoolExecutor(4) as ex:
            results = list(ex.map(one, range(len(wavs))))
        wall_s = time.monotonic() - t0
        launches = _read_counts()
        calls = engine.batcher.calls - calls0
        for i, (out, sr, _) in enumerate(results):
            T_true = 1 + wavs[i].size // shift
            check(sr == fs and out.shape == (T_true * shift,),
                  f"voc_serve: request {i} gave {out.shape} at {sr} Hz")
            check(bool(np.all(np.isfinite(out))) and np.abs(out).max() > 0,
                  f"voc_serve: request {i} not finite or silent")
        per_infer = {k: launches[k] / max(calls, 1)
                     for k in FLAT_LAUNCHES}
        check({k: launches[k] for k in FLAT_LAUNCHES}
              == {k: v * calls for k, v in FLAT_LAUNCHES.items()},
              f"voc_serve: launches {launches} over {calls} infer calls")
        # the served wav against the generator on the same canvas and noise
        wav = wavs[-1]
        out, _ = engine.convert(wav, fs, 9)
        mel, _ = engine.convert(wav, fs, 9, return_mel=True)
        T_pad = engine._pick_pad(mel.shape[0])
        canvas = engine._silence_canvas(mel, T_pad)
        z = engine._voc.noise(T_pad, engine.seed)
        with torch.inference_mode():
            direct = engine._voc.gen(
                z[None], torch.as_tensor(canvas[None], device="cuda"))
        direct = direct[0, :mel.shape[0] * shift, 0].cpu().numpy()
        served_err = float(np.abs(out - direct).max())
        served_peak = float(np.abs(direct).max())
        check(out.shape == direct.shape
              and served_err <= VOC_TOL * served_peak,
              f"voc_serve: served wav differs from the generator by "
              f"{served_err} (peak {served_peak})")
        canvas512 = engine._silence_canvas(
            np.random.default_rng(2).normal(size=(512, D)).astype(
                np.float32) - 3.0, 512)
        engine._voc.synthesize(canvas512, 0)
        profile = _profiled(
            torch, lambda: engine._voc.synthesize(canvas512, 0))
        lat = [r[2] for r in results]
        emit({"phase": "voc_serve", "requests": len(results), "threads": 4,
              "seconds_per_request_min_max":
                  [float(durations[0]), float(durations[-1])],
              "warmup_s": warm_s, "wall_s": wall_s,
              "requests_per_s": len(results) / wall_s,
              "audio_s_per_wall_s": float(durations.sum()) / wall_s,
              "latency_ms_median": float(np.median(lat)),
              "latency_ms_max": float(np.max(lat)), "infer_calls": calls,
              "launches": launches, "launches_per_infer": per_infer,
              "launches_per_request": {k: launches[k] / len(results)
                                       for k in FLAT_LAUNCHES},
              "served_wav_err": served_err, "served_wav_peak": served_peak,
              "synthesis_512_frames_profile": profile})
        return (launches, calls), phase_voc_stream(torch, engine)
    finally:
        engine.close()


def phase_voc_offline(torch, root, voc_ckpt):
    """``jpwg_decode_scp`` (recipe stage 6, ``voc=JPWG``) over a feats.scp
    of 16 utterances of 1-10 s (log-mel of speech-like wavs): one warm-up
    decode, ``VOC_REPEATS`` timed; every wav ``frames * 256`` samples; a
    long utterance through chunked synthesis against its full-length pass
    on the same noise; a ``chunk_frames`` decode of the corpus."""
    from vae_npvc_tpu_torch.data import features, kaldi_io
    from vae_npvc_tpu_torch.infer import vocoder

    d = root / "voc_denorm"
    d.mkdir()
    frames = {}
    with kaldi_io.ArkWriter(d / "feats.ark", d / "feats.scp") as w:
        for i, sec in enumerate(VOC_OFFLINE_SECONDS):
            x = _speechlike(int(round(sec * 24000)), 24000, 500 + i)
            mel = features.logmelspectrogram(
                torch.as_tensor(x[None], device="cuda"), fs=24000,
                n_fft=1024, n_shift=256, n_mels=80, fmin=80,
                fmax=7600)[0].cpu().numpy()
            w.write(f"d{i:02d}", mel)
            frames[f"d{i:02d}"] = mel.shape[0]
    cfg = _voc_config_file(root)
    scp, out = d / "feats.scp", root / "voc_wav"
    n = vocoder.jpwg_decode_scp(scp, out, cfg, voc_ckpt,
                                device="cuda")                # warm-up
    check(n == len(frames), f"voc_offline: decode wrote {n}")
    times = []
    for _ in range(VOC_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vocoder.jpwg_decode_scp(scp, out, cfg, voc_ckpt, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    for u, T in frames.items():
        with wave.open(str(out / f"{u}.wav")) as wv:
            check(wv.getnframes() == T * 256 and wv.getframerate() == 24000,
                  f"voc_offline: {u} has {wv.getnframes()} samples, "
                  f"{T} frames")
    # chunked synthesis of the longest utterance against its full pass
    gen = vocoder.load_generator(cfg, voc_ckpt, 80, device="cuda")
    u = max(frames, key=frames.get)
    mel = kaldi_io.load_mat(kaldi_io.read_scp(scp)[u])
    z = vocoder.decode_noise(0, 0, (mel.shape[0] * 256, 1), "cuda")
    halo = vocoder.jpwg_receptive_frames(VOC_TRAIN)
    with torch.inference_mode():
        full = gen(z[None], torch.as_tensor(mel[None], device="cuda"))[
            0, :, 0].cpu().numpy()
    chunked = vocoder.jpwg_synthesize_chunked(gen, mel, z, chunk_frames=200,
                                              halo_frames=halo, hop=256)
    chunk_err = float(np.abs(chunked - full).max())
    chunk_peak = float(np.abs(full).max())
    check(chunk_err <= VOC_TOL * chunk_peak, f"voc_offline: chunked "
          f"synthesis differs from the full pass by {chunk_err}")
    n = vocoder.jpwg_decode_scp(scp, root / "voc_wav_chunked", cfg,
                                voc_ckpt, chunk_frames=256, device="cuda")
    n_long = sum(T > 256 for T in frames.values())
    for u, T in frames.items():
        with wave.open(str(root / "voc_wav_chunked" / f"{u}.wav")) as wv:
            check(wv.getnframes() == T * 256, f"voc_offline: chunked {u}")
    audio_s = sum(frames.values()) * 256 / 24000
    # each utterance is synthesized on its 64-frame bucket
    synth = sum(-(-T // 64) * 64 * 256 for T in frames.values())
    per = float(np.mean(times))
    emit({"phase": "voc_offline", "utterances": len(frames),
          "frames": int(sum(frames.values())), "audio_s": audio_s,
          "decode_s": times, "utterances_per_s": len(frames) / per,
          "audio_s_per_wall_s": audio_s / per,
          "batch_size": 8, "bucket_frames": 64,
          "synthesized_samples": synth,
          "audio_samples": int(sum(frames.values())) * 256,
          "chunked_utterance_frames": int(mel.shape[0]),
          "chunk_frames": 200, "halo_frames": halo,
          "chunk_max_abs_err": chunk_err, "chunk_peak": chunk_peak,
          "chunked_decode_long_utterances": n_long, "chunked_decode_n": n})


def phase_voc(torch, root):
    """The vocoder slice: golden, gradients, training, serving, streaming,
    offline. Returns the flat model's launches and ``infer`` calls in
    serving and in the stream phase."""
    phase_voc_golden(torch)
    phase_voc_grad_fp32(torch)
    ckpt = phase_voc_train(torch, root)
    serve = phase_voc_serve(torch, root, ckpt)
    phase_voc_offline(torch, root, ckpt)
    return serve


# ------------------------------------------------------------ evaluation
# stage 7 of egs/vcc20/vae1/run.sh at the recipe's widths: the CTC proxy of
# bin/eval_asr (width 192, 3 blocks, 4 heads of 48, FFN 768, B = 16,
# max_frames 1,200; --arch transformer; transcribe buckets of 256 frames,
# B = 16, up to 3,000 frames), conf/ob_eval/decode_asr.yaml (beam 10,
# lm-weight 0.6, lm-type neural: embed 64, hidden 256, 2 layers, batch 32,
# max_len 128) and the x-vector TDNN of bin/eval_similarity (width 128,
# frame5 384, emb 64, batch 64, crop 200). The steps are cut from the
# recipe's 3,000 / 600 / 1,000.
EVAL_ASR_STEPS, EVAL_LM_STEPS, EVAL_SIM_STEPS = 150, 100, 20
EVAL_CHARS = "abcdefghijklmnopqrstuvwxyz '"
EVAL_MEL, EVAL_CORPUS_SEED = 80, 7
EVAL_TRAIN_UTTS, EVAL_TEST_UTTS = 64, 8
# characters per utterance at 8 frames each: training utterances of
# 160-1,192 frames (T' up to 600), test utterances up to 2,992 (T' 1,496)
EVAL_TRAIN_CHARS, EVAL_TEST_CHARS = (20, 150), (25, 375)
EVAL_SPEAKERS, EVAL_SIM_UTTS, EVAL_SIM_CONVERTED = 8, 64, 16
EVAL_PROFILE_STEPS = 10
# the timed beam-search pass after the CLI's own runs over the first half of
# the test set (all 8 would add ~10 s to the smoke)
EVAL_BEAM_UTTS = 4


def _attn_fns():
    from vae_npvc_tpu_torch.ops.attention import (fused_attention,
                                                  fused_attention_backward)
    return fused_attention, fused_attention_backward


def _zero_attn():
    for fn in _attn_fns():
        fn.launches = 0


def _attn_launches():
    fwd, bwd = _attn_fns()
    return {"fused_attention": fwd.launches,
            "fused_attention_backward": bwd.launches}


def _transcribe_batches(scp, bucket, batch, max_frames=3000):
    """Batches ``CTCRecognizer.transcribe_scp`` runs over ``scp`` and its
    longest padded length."""
    from vae_npvc_tpu_torch.data import kaldi_io

    per = {}
    for rx in kaldi_io.read_scp(scp).values():
        n = min(kaldi_io.matrix_header(rx)[0], max_frames)
        T = -(-n // bucket) * bucket
        per[T] = per.get(T, 0) + 1
    return sum(-(-c // batch) for c in per.values()), max(per)


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: (result, lines)."""
    import contextlib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def phase_eval_golden(torch, root):
    """The port's recognizer and LM on the card against the committed JAX
    fixture (``utils/eval_fixture.fixture_run`` / ``check_fixture``): a
    width-32 transformer (4 heads of 8) trained from the fixture's numpy
    parameters, its greedy and beam (neural LM) transcripts, the LM's
    losses and log-probabilities; 3 K4 + 3 K5 launches per step and 3 K4
    per transcribe batch."""
    from vae_npvc_tpu_torch.utils import eval_fixture as ef

    _zero_attn()
    t0 = time.perf_counter()
    (got, _), _ = _quiet(ef.fixture_run, root, "cuda")
    wall = time.perf_counter() - t0
    launches = _attn_launches()
    errs = ef.check_fixture(got, FIXTURES)
    nb, _ = _transcribe_batches(root / "feats.scp", ef.EVAL_DECODE["bucket"],
                                ef.EVAL_DECODE["batch_size"])
    want = {"fused_attention": 3 * ef.EVAL_STEPS + 2 * 3 * nb,
            "fused_attention_backward": 3 * ef.EVAL_STEPS}
    check(launches == want, f"eval_golden: attention launches {launches}, "
          f"expected {want}")
    emit({"phase": "eval_golden", "steps": ef.EVAL_STEPS,
          "transcribe_batches": 2 * nb, "launches": launches,
          "wall_s": wall, **errs, "transcripts_equal": True})


def _record_attention(torch, calls):
    """Patches that hold every K4 and K5 call against the plain versions
    (``K4_TOL``/``K5_TOL`` of each output's peak) and record it in
    ``calls``; returns the undo function."""
    from vae_npvc_tpu_torch.ops import attention as ops

    fwd, bwd = ops._forward, ops.fused_attention_backward

    def err(a, b):
        peak = float(b.float().abs().max()) or 1.0
        return float((a.float() - b.float()).abs().max()) / peak

    def lengths_of(n, T):
        return None if n is None else n.clamp(1, T).tolist()

    def fwd_rec(q, k, v, lengths, scale):
        o, lse = fwd(q, k, v, lengths, scale)
        ref_o, _ = ops.attention_plain(q, k, v, lengths, scale)
        calls.append({"kernel": "K4", "shape": list(q.shape),
                      "lengths": lengths_of(lengths, q.shape[2]),
                      "err_over_peak": err(o, ref_o)})
        return o, lse

    def bwd_rec(q, k, v, o, lse, do, lengths=None, *, scale=None):
        got = bwd(q, k, v, o, lse, do, lengths, scale=scale)
        ref = ops.attention_backward_plain(q, k, v, o, lse, do, lengths,
                                           scale)
        calls.append({"kernel": "K5", "shape": list(q.shape),
                      "lengths": lengths_of(lengths, q.shape[2]),
                      "err_over_peak": max(err(a, b)
                                           for a, b in zip(got, ref))})
        return got

    # the kernel wrapper counts its launches on the module-level name
    bwd_rec.launches = bwd.launches
    ops._forward, ops.fused_attention_backward = fwd_rec, bwd_rec

    def undo():
        bwd.launches = bwd_rec.launches
        ops._forward, ops.fused_attention_backward = fwd, bwd
    return undo


def _eval_corpora(root):
    """The ASR train and test dirs (one set of character templates: the
    same seed), a speaker corpus and its converted utterances, the
    similarity trials and config."""
    from vae_npvc_tpu_torch.utils.eval_fixture import (char_corpus,
                                                       speaker_corpus)

    texts = char_corpus(root / "asr_train", EVAL_TRAIN_UTTS,
                        EVAL_CORPUS_SEED, alphabet=EVAL_CHARS, dim=EVAL_MEL,
                        chars=EVAL_TRAIN_CHARS)
    char_corpus(root / "asr_test", EVAL_TEST_UTTS, EVAL_CORPUS_SEED,
                alphabet=EVAL_CHARS, dim=EVAL_MEL, chars=EVAL_TEST_CHARS)
    speaker_corpus(root / "sim_train", EVAL_SPEAKERS, EVAL_SIM_UTTS,
                   EVAL_CORPUS_SEED, dim=EVAL_MEL, frames=(150, 600))
    speaker_corpus(root / "sim_conv", EVAL_SPEAKERS, EVAL_SIM_CONVERTED,
                   EVAL_CORPUS_SEED, dim=EVAL_MEL, frames=(150, 600),
                   prefix="c")
    (root / "trials").write_text("".join(
        f"c{i:02d} spk{i % EVAL_SPEAKERS}\n"
        for i in range(EVAL_SIM_CONVERTED)))
    (root / "sim.json").write_text(json.dumps({"crop_length": 200}))
    return texts


def _timed_steps(torch, step, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def phase_eval_asr(torch, root):
    """``bin/eval_asr`` at the recipe's width on the card (transformer,
    ``EVAL_ASR_STEPS`` steps, beam 10 with the neural LM), its K4/K5
    launches counted; then one training step with every K4/K5 call held
    against the plain versions, a profiled step, a transcribe batch at the
    longest bucket, the beam search's cost and the LM's step. Returns the
    CER/WER line's numbers, the launches and the transcribe batches."""
    from vae_npvc_tpu_torch.bin import eval_asr
    from vae_npvc_tpu_torch.data import kaldi_io
    from vae_npvc_tpu_torch.eval.asr import CTCRecognizer, CTCTrainer
    from vae_npvc_tpu_torch.eval.neural_lm import CharLstmLM

    train, test = root / "asr_train", root / "asr_test"
    nb, longest = _transcribe_batches(test / "feats.scp", 256, 16)
    args = ["--train_dir", str(train), "--eval_scp", str(test / "feats.scp"),
            "--ref_text", str(test / "text"), "--output_dir",
            str(root / "asr_result"), "--arch", "transformer",
            "--steps", str(EVAL_ASR_STEPS), "--beam_size", "10",
            "--lm_weight", "0.6", "--lm_type", "neural",
            "--lm_steps", str(EVAL_LM_STEPS),
            "--lm_ckpt", str(root / "char_lm.msgpack"),
            "--recognizer_ckpt", str(root / "ctc_proxy.msgpack")]
    _zero_attn()
    t0 = time.perf_counter()
    (cer, wer), lines = _quiet(eval_asr.main, args)
    cli_s = time.perf_counter() - t0
    launches = _attn_launches()
    want = {"fused_attention": 3 * EVAL_ASR_STEPS + 3 * nb,
            "fused_attention_backward": 3 * EVAL_ASR_STEPS}
    check(launches == want, f"eval_asr: attention launches {launches}, "
          f"expected {want} ({nb} transcribe batches)")
    check(lines[-1].startswith("CER: ") and math.isfinite(cer)
          and math.isfinite(wer), f"eval_asr: last line {lines[-1]!r}")

    # one step with every K4/K5 call held against the plain versions
    trainer = CTCTrainer(train, width=192, arch="transformer",
                         device="cuda", seed=1)
    trainer.step()
    calls = []
    undo = _record_attention(torch, calls)
    try:
        loss = float(trainer.step())
    finally:
        undo()
    check([c["kernel"] for c in calls] == ["K4"] * 3 + ["K5"] * 3,
          f"eval_asr: one step made the calls {[c['kernel'] for c in calls]}")
    shape = [trainer.batch_size, 4, (trainer.T_max + 1) // 2, 48]
    for c in calls:
        tol = K4_TOL if c["kernel"] == "K4" else K5_TOL
        check(c["err_over_peak"] <= tol and c["shape"] == shape,
              f"eval_asr: {c['kernel']} call {c['shape']} err "
              f"{c['err_over_peak']} over tolerance {tol}")
    check(math.isfinite(loss), "eval_asr: non-finite loss")
    step_ms = _timed_steps(torch, trainer.step, 5)
    step_prof = _profiled(torch, trainer.step)

    # a transcribe batch at the longest bucket, the rows past the first
    # padded to length 1 as transcribe_scp pads them
    rec = CTCRecognizer.load(root / "ctc_proxy.msgpack")
    x = np.zeros((16, longest, EVAL_MEL), np.float32)
    x[0] = np.random.default_rng(3).normal(size=(longest, EVAL_MEL))
    lens = np.ones((16,), np.int32)
    lens[0] = longest
    rec.logits(x, lens)[0].cpu()
    batch_prof = _profiled(torch, lambda: rec.logits(x, lens)[0].cpu())

    # the beam search with the neural LM over the test set, LM steps counted
    lm = CharLstmLM.load(root / "char_lm.msgpack")
    n_steps = [0]
    step = lm._step

    def counted(*a):
        n_steps[0] += 1
        return step(*a)
    lm._step = counted
    scp = kaldi_io.read_scp(test / "feats.scp")
    n_frames = {u: kaldi_io.matrix_header(rx)[0] for u, rx in scp.items()}
    beam_utts = list(scp)[:EVAL_BEAM_UTTS]
    (root / "beam.scp").write_text("".join(f"{u} {scp[u]}\n"
                                           for u in beam_utts))
    frames = sum((min(n_frames[u], 3000) + 1) // 2 for u in beam_utts)
    t0 = time.perf_counter()
    hyps = rec.transcribe_scp(root / "beam.scp", beam_size=10, lm=lm,
                              lm_weight=0.6)
    beam_s = time.perf_counter() - t0
    check(len(hyps) == EVAL_BEAM_UTTS, "eval_asr: transcripts missing")
    # the shortest utterance's beam search profiled, with a cold LM cache
    short = min(n_frames, key=n_frames.get)
    (root / "short.scp").write_text(f"{short} {scp[short]}\n")
    cold = CharLstmLM.load(root / "char_lm.msgpack")
    beam_prof = _profiled(torch, lambda: rec.transcribe_scp(
        root / "short.scp", beam_size=10, lm=cold, lm_weight=0.6))

    # the LM's training step at the recipe's width
    texts = list(kaldi_io.load_dict_data(train / "text").values())
    lm2 = CharLstmLM(lm.itos, device="cuda")
    lm2.train(texts, steps=2, batch=32, params=lm.params)
    lm_prof = _profiled(torch, lambda: lm2.train(
        texts, steps=EVAL_PROFILE_STEPS, batch=32, params=lm.params))
    emit({"phase": "eval_asr", "cli_s": cli_s, "cli_last_line": lines[-1],
          "launches": launches, "steps": EVAL_ASR_STEPS,
          "transcribe_batches": nb, "longest_bucket": longest,
          "one_step_calls": calls, "step_ms": step_ms,
          "step_profile": step_prof, "transcribe_batch_profile": batch_prof,
          "beam": {"utterances": EVAL_BEAM_UTTS, "wall_s": beam_s,
                   "frames": frames,
                   "ms_per_frame": beam_s * 1e3 / frames,
                   "lm_steps": n_steps[0],
                   "lm_steps_per_frame": n_steps[0] / frames,
                   "shortest_utterance_frames": n_frames[short],
                   "shortest_utterance_profile": beam_prof},
          "lm_steps_profiled": EVAL_PROFILE_STEPS,
          "lm_profile": lm_prof})
    return cer, wer, launches, nb


def phase_eval_sim(torch, root):
    """``bin/eval_similarity`` at the recipe's width on the card (x-vector
    TDNN, PLDA and cosine) and the embedder's training step profiled.
    Returns (PLDA, COSSIM)."""
    from vae_npvc_tpu_torch.bin import eval_similarity
    from vae_npvc_tpu_torch.eval.similarity import train_embedder

    train = root / "sim_train"
    args = ["-c", str(root / "sim.json"), "--train_dir", str(train),
            "--converted_scp", str(root / "sim_conv" / "feats.scp"),
            "--trials", str(root / "trials"), "--enroll_dir", str(train),
            "--steps", str(EVAL_SIM_STEPS),
            "--embedder_ckpt", str(root / "spk_embedder.msgpack"),
            "--output_dir", str(root / "asv_result")]
    t0 = time.perf_counter()
    (plda, cos), lines = _quiet(eval_similarity.main, args)
    cli_s = time.perf_counter() - t0
    check(lines[-1].startswith("PLDA: ") and math.isfinite(plda)
          and math.isfinite(cos), f"eval_sim: last line {lines[-1]!r}")
    cfg = {"crop_length": 200}

    def embedder_steps(n):
        return _quiet(lambda: train_embedder(train, cfg, steps=n,
                                             log_every=0))
    embedder_steps(2)
    prof = _profiled(torch, lambda: embedder_steps(EVAL_PROFILE_STEPS))
    emit({"phase": "eval_sim", "cli_s": cli_s, "cli_last_line": lines[-1],
          "steps": EVAL_SIM_STEPS, "embedder_steps_profiled":
          EVAL_PROFILE_STEPS, "embedder_profile": prof})
    return plda, cos


def phase_eval(torch, root):
    """Stage 7 of the vae1 recipe on the card: the fixture, the recognizer
    with the neural LM, the speaker similarity and the mel-proxy MCD, and
    the recipe's RESULT line. Returns K4/K5's launches on the path."""
    from vae_npvc_tpu_torch.data import kaldi_io
    from vae_npvc_tpu_torch.eval.mcd import mcd_from_scp

    root.mkdir(parents=True, exist_ok=True)
    phase_eval_golden(torch, root / "golden")
    _eval_corpora(root)
    cer, wer, launches, nb = phase_eval_asr(torch, root)
    plda, cos = phase_eval_sim(torch, root)
    # mel-proxy MCD of the "converted" test utterances against a noisy
    # copy of them (the recipe's default mode: DCT-of-log-mel cepstra)
    rng = np.random.default_rng(EVAL_CORPUS_SEED)
    ref = root / "mcd_ref"
    ref.mkdir()
    with kaldi_io.ArkWriter(ref / "feats.ark", ref / "feats.scp") as w:
        for utt, rx in kaldi_io.read_scp(root / "asr_test" /
                                         "feats.scp").items():
            m = kaldi_io.load_mat(rx)
            w.write(utt, m + 0.3 * rng.normal(size=m.shape).astype(
                np.float32))
    mcd, per_utt = mcd_from_scp(root / "asr_test" / "feats.scp",
                                ref / "feats.scp")
    check(math.isfinite(mcd) and mcd > 0 and len(per_utt) == EVAL_TEST_UTTS,
          f"eval: MCD {mcd} over {len(per_utt)} utterances")
    line = (f"RESULT SEF1_TEF1  MCD: {mcd:.3f}  CER: {cer:.2f}  "
            f"WER: {wer:.2f}  PLDA: {plda:.4f}  COSSIM: {cos:.4f}")
    print(line, flush=True)
    emit({"phase": "eval", "result": line})
    return {"launches": launches, "steps": EVAL_ASR_STEPS,
            "transcribe_batches": nb}


# ------------------------------------------------- the last model families
# keys of egs/aishell3/vc2/conf/train_token_tts_tacotron2.yaml
# (tests/test_torch_port_tac2.py checks these three equal their files)
TAC2 = dict(
    {k: TTS[k] for k in ("trainer_type", "model_type", "max_iter",
                         "iters_per_checkpoint", "iters_per_log", "seed",
                         "batch_size", "optim_type", "learning_rate",
                         "max_grad_norm", "lr_scheduler", "lr_param",
                         "token_num", "y_num", "mel_dim", "max_tokens",
                         "max_frames", "use_spk_embed", "spk_embed_dim")},
    **{"block_type": "tacotron2", "embed-dim": 512, "elayers": 1,
       "eunits": 512, "econv-layers": 3, "econv-chans": 512,
       "econv-filts": 5, "dlayers": 2, "dunits": 1024, "prenet-layers": 2,
       "prenet-units": 256, "postnet-layers": 5, "postnet-chans": 512,
       "postnet-filts": 5, "atype": "location", "adim": 128,
       "aconv-chans": 32, "aconv-filts": 15, "cumulate-att-w": True,
       "use-concate": True, "bce-pos-weight": 3.0, "reduction-factor": 2,
       "dropout-rate": 0.5, "zoneout-rate": 0.1})
TAC2_STEPS, TAC2_TIMED_STEPS, TAC2_DECODE_UTTS = 3, 3, 4

_GENERATOR_KEYS = ("y_dim", "y_num", "z_dim", "encoder", "decoder",
                   "compute_dtype")
_RECIPE_KEYS = {"max_iter": 1000000, "iters_per_checkpoint": 20000,
                "iters_per_log": 1000, "seed": 777, "num_jobs": 8,
                "prefetch_factor": 2, "batch_size": 128, "crop_length": 256,
                "use_native_loader": True}
# keys of egs/vcc20/vae1/conf/train_vqvae_gan.yaml: the flagship generator
GAN = dict(
    {k: FLAGSHIP[k] for k in _GENERATOR_KEYS + (
        "z_num", "use_ema", "beta", "mu", "jitter_p", "decode_bucket_size",
        "decode_batch_size")}, **_RECIPE_KEYS,
    trainer_type="vae_npvc.trainer.wgan_gp",
    dataset_type="vae_npvc.dataset.utt2mel_spk",
    model_type="vae_npvc.model.vqvae", pre_iter=1000, gamma=1.0,
    gp_weight=1.0,
    generator_param={"per_iteration": 1, "optim_type": "RAdam",
                     "learning_rate": 1e-4, "max_grad_norm": 10,
                     "lr_scheduler": {"step_size": 100000, "gamma": 0.5}},
    discriminator_param={"per_iteration": 1, "optim_type": "RAdam",
                         "learning_rate": 5e-5, "max_grad_norm": 1,
                         "lr_scheduler": {"step_size": 100000,
                                          "gamma": 0.5}},
    discriminator={"channels": [128, 256, 512], "kernel_size": 5,
                   "strides": [2, 2, 2]})
# cut: the critic joins after 2 iterations, not 1,000
GAN_PRE_ITER, GAN_ITERS = 2, 6
GAN_CRITIC_LAUNCHES = {"vq_fused": 1, "fused_group_norm": 20,
                       "fused_group_norm_backward": 0}
GAN_GEN_LAUNCHES = {"vq_fused": 1, "fused_group_norm": 20,
                    "fused_group_norm_backward": 20}
# keys of egs/vcc20/vae1/conf/train_vae.yaml
VAE = dict(
    {k: FLAGSHIP[k] for k in _GENERATOR_KEYS}, **_RECIPE_KEYS,
    trainer_type="vae_npvc.trainer.basic", model_type="vae_npvc.model.vae",
    optim_type="Adam", learning_rate=0.001, max_grad_norm=10,
    lr_scheduler="StepLR", lr_param={"step_size": 100000, "gamma": 0.5},
    kld_weight=0.01)
VAE["encoder"] = dict(FLAGSHIP["encoder"], z_channels=256)
VAE_STEPS = 4
VAE_LAUNCHES = {"vq_fused": 0, "fused_group_norm": 20,
                "fused_group_norm_backward": 20}
# decode settings of the vae1 recipe for the VAE (its YAML has none)
VAE_DECODE = {"decode_bucket_size": 256, "decode_batch_size": 8}


def _state_against(got_path, want_path, what, free=()):
    """Two checkpoints: same trees, every leaf within GOLDEN_STATE_TOL
    (the leaves named in ``free`` only reported). Returns the largest
    absolute difference."""
    from vae_npvc_tpu_torch.utils import msgpack_io

    got = _leaves(msgpack_io.msgpack_restore(Path(got_path).read_bytes()))
    want = _leaves(msgpack_io.msgpack_restore(Path(want_path).read_bytes()))
    check(set(got) == set(want), f"{what}: checkpoint trees differ")
    atol, rtol = GOLDEN_STATE_TOL
    worst = 0.0
    for k in want:
        a, b = got[k].astype(np.float64), want[k].astype(np.float64)
        check(a.shape == b.shape, f"{what}: {k} shape {a.shape}")
        err = np.abs(a - b)
        worst = max(worst, float(err.max()) if err.size else 0.0)
        check(bool(np.all(err <= atol + rtol * np.abs(b))),
              f"{what}: {k} differs from JAX by {float(err.max())}")
    return worst


def _golden_steps(tr, batches, g, keys, what):
    """The fixture's steps through ``tr.train_step``: JAX's per-step
    detail within GOLDEN_LOSS_RTOL (NaN: not in that step's phase)."""
    worst = {}
    for i, batch in enumerate(batches):
        detail = tr.train_step(batch)
        for k in keys:
            want = float(g["detail/" + k][i])
            if math.isnan(want):
                check(k not in detail, f"{what}: step {i + 1} has {k}")
                continue
            rel = abs(float(detail[k]) - want) / max(abs(want), 1e-12)
            worst[k] = max(worst.get(k, 0.0), rel)
            check(rel <= GOLDEN_LOSS_RTOL,
                  f"{what}: step {i + 1} {k} {float(detail[k])}, JAX {want}")
    return worst


def phase_tac2_golden(torch):
    """The Tacotron2 synthesizer on the card against the committed JAX
    fixture (``train_token_tts_tacotron2_smoke.yaml`` widths, fp32, rates
    at 0): a free-running ``infer`` (``mel_lens`` exact: the fixture's stop
    decisions lie at least 0.1 from 0 in logit), three ``Trainer`` steps
    against JAX's losses and its final parameters and Adam moments."""
    from vae_npvc_tpu_torch.train import build_trainer

    cfg = json.loads((FIXTURES / "tac2_golden_config.json").read_text())
    g = np.load(FIXTURES / "tac2_golden.npz")
    names = ("tokens", "durations", "mels", "spks", "tok_lens", "mel_lens")
    steps = len(g["detail/Total"])
    tr = build_trainer(cfg, device="cuda")
    tr.load_checkpoint(FIXTURES / "tac2_golden.msgpack")
    args = [torch.as_tensor(g[f"{k}_0"], device=tr.device)
            for k in ("tokens", "spks", "tok_lens")]
    with torch.no_grad():
        mel, lens = tr.model.infer(*args)
        _, _, logits = tr.model.tac2(*args, max_frames=cfg["max_frames"],
                                     train=False, free_run=True)
    mel, lens = mel.cpu().numpy(), lens.cpu().numpy()
    check(lens.tolist() == g["infer/mel_lens"].tolist(),
          f"tac2_golden: mel_lens {lens.tolist()}, JAX "
          f"{g['infer/mel_lens'].tolist()}")
    mel_err = float(np.abs(mel - g["infer/mel"]).max())
    check(mel_err <= 1e-4, f"tac2_golden: mel differs from JAX by {mel_err}")
    logit_err = float(np.abs(logits.cpu().numpy()
                             - g["infer/stop_logits"]).max())
    worst = _golden_steps(tr, [tuple(g[f"{k}_{i}"] for k in names)
                               for i in range(steps)], g,
                          ("Total", "X like", "X pre like", "STOP loss",
                           "grad_norm", "skipped_nonfinite"), "tac2_golden")
    with tempfile.TemporaryDirectory() as tmp:
        tr.save_checkpoint(Path(tmp) / "final")
        state_err = _state_against(Path(tmp) / "final",
                                   FIXTURES / "tac2_golden_final.msgpack",
                                   "tac2_golden")
    emit({"phase": "tac2_golden", "steps": steps, "mel_lens": lens.tolist(),
          "mel_max_abs_err": mel_err, "mel_tolerance": 1e-4,
          "stop_logit_max_abs_err": logit_err, "stop_margin_of_fixture": 0.1,
          "worst_rel_err": worst, "loss_rtol": GOLDEN_LOSS_RTOL,
          "state_max_abs_err": state_err,
          "state_atol_rtol": list(GOLDEN_STATE_TOL)})


def phase_tac2(torch, root):
    """``train_token_tts_tacotron2.yaml`` at full width (fp32, 27.5 M
    parameters, seeded random weights) on a synthetic token-mel corpus:
    ``bin/train_tts`` for ``TAC2_STEPS`` steps at B = 32, L = 192,
    T = 768, the same trainer timed step by step and one step profiled,
    then ``bin/decode_tts`` of ``TAC2_DECODE_UTTS`` utterances free-running
    all 768 frames and one ``infer`` profiled. No kernel of the port is on
    this path: the counts of K1-K5 stay 0."""
    from vae_npvc_tpu_torch.bin import decode_tts, train_tts
    from vae_npvc_tpu_torch.data import kaldi_io
    from vae_npvc_tpu_torch.data.token_mel import TokenMelDataset
    from vae_npvc_tpu_torch.ops.attention import (fused_attention,
                                                  fused_attention_backward)
    from vae_npvc_tpu_torch.train import build_trainer

    cfg = dict(TAC2, max_iter=TAC2_STEPS, iters_per_log=1,
               iters_per_checkpoint=TAC2_STEPS)
    B, L, T = cfg["batch_size"], cfg["max_tokens"], cfg["max_frames"]
    root.mkdir(parents=True, exist_ok=True)
    _token_mel_corpus(root / "train", 2 * B, seed=9)
    conf = root / "conf.json"
    conf.write_text(json.dumps(cfg))
    _zero_counts()
    fused_attention.launches = fused_attention_backward.launches = 0
    t0 = time.perf_counter()
    train_tts.main(["-c", str(conf), "--train_dir", str(root / "train"),
                    "--output_dir", str(root / "exp")])
    cli_s = time.perf_counter() - t0
    ckpt = root / "exp" / "model.loss.best"
    log = (root / "exp" / "train.log").read_text()
    check(f"Iter {TAC2_STEPS}:" in log, "tac2: bin/train_tts logged no step")

    tr = build_trainer(cfg, device="cuda")
    check(tr.load_checkpoint(ckpt) == TAC2_STEPS, "tac2: iteration")
    batches = TokenMelDataset(root / "train", cfg).batches(
        B, shuffle=True, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, totals = [], []
    for _ in range(TAC2_TIMED_STEPS):
        batch = next(batches)
        t0 = time.perf_counter()
        d = tr.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        totals.append(float(d["Total"]))
        check(math.isfinite(totals[-1])
              and float(d["skipped_nonfinite"]) == 0.0,
              f"tac2: step {totals}")
    peak_bytes = torch.cuda.max_memory_allocated()
    batch = next(batches)
    profile = _profiled(torch, lambda: tr.train_step(batch),
                        by_operator=False)
    parameters = int(tr.flat.numel())
    del tr

    lines = kaldi_io.load_dict_data(root / "train" / "tokens.txt")
    utts = list(lines)[:TAC2_DECODE_UTTS]
    (root / "text").write_text("".join(f"{u} {lines[u]}\n" for u in utts))
    args = ["-c", str(conf), "--checkpoint", str(ckpt), "--tokens",
            str(root / "text"), "--spk", "3"]
    decode_tts.main(args + ["--output-dir", str(root / "warm")])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_tts.main(args + ["--output-dir", str(root / "dec")])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    scp = kaldi_io.load_dict_data(root / "dec" / "feats.scp")
    check(list(scp) == utts, f"tac2: decoded {list(scp)}")
    frames = []
    for u in utts:
        m = kaldi_io.load_mat(scp[u])
        check(m.ndim == 2 and m.shape[1] == cfg["mel_dim"]
              and 1 <= m.shape[0] <= T and bool(np.isfinite(m).all()),
              f"tac2: decoded {u} has shape {m.shape}")
        frames.append(int(m.shape[0]))
    # the model's own output: zeros after each row's stop
    model = decode_tts.load_model(cfg, ckpt, "cuda")
    tokens = np.zeros((2, L), np.int32)
    tok_lens = np.array([L, L // 2], np.int32)
    tokens[0] = np.arange(L) % cfg["token_num"]
    tokens[1, :L // 2] = 7
    ids = (torch.as_tensor(tokens, device="cuda"),
           torch.tensor([3, 5], dtype=torch.int32, device="cuda"),
           torch.as_tensor(tok_lens, device="cuda"))

    def one_infer():
        with torch.inference_mode():
            return model.infer(ids[0][:1], ids[1][:1], ids[2][:1])

    # seeded random weights never stop: shift the stop head's bias so that
    # each row's logit passes 0 within its first T/2 frames (the row whose
    # largest early logit is the smaller one by 1e-3, at that frame at the
    # latest), which puts the stop decision and the masking after it on
    # the card at full width (the decoder runs all T steps whatever the
    # stop head says, so the timed infers below cost the same)
    with torch.inference_mode():
        raw = model.tac2(*ids, max_frames=T, train=False,
                         free_run=True)[2].double().cpu().numpy()
    shift = 1e-3 - float(raw[:, :T // 2].max(axis=1).min())
    with torch.no_grad():
        model.tac2.dec_cell.prob_out.bias.add_(shift)
    with torch.inference_mode():
        mel2, lens2 = model.infer(*ids)
    lens2 = lens2.cpu().numpy()
    stop_want = [int(np.argmax(row > 0)) + 1 for row in raw + shift]
    check(lens2.tolist() == stop_want,
          f"tac2: mel_lens {lens2.tolist()}, stop logits say {stop_want}")
    for b in range(2):
        n = int(lens2[b])
        check(1 <= n <= T // 2 and not mel2[b, n:].any()
              and bool(mel2[b, :n].any())
              and bool(torch.isfinite(mel2).all()),
              f"tac2: infer row {b} of {n} frames")
    infer_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_infer()
        torch.cuda.synchronize()
        infer_ms.append((time.perf_counter() - t0) * 1e3)
    infer_profile = _profiled(torch, one_infer, by_operator=False)
    ours = dict(_read_counts(), fused_attention=fused_attention.launches,
                fused_attention_backward=fused_attention_backward.launches)
    check(not any(ours.values()), f"tac2: a port kernel launched: {ours}")
    steady = float(np.mean(times[1:]))
    emit({"phase": "tac2", "config": "train_token_tts_tacotron2.yaml",
          "dtype": "float32", "parameters": parameters,
          "train": {"cli_steps": TAC2_STEPS, "cli_s": cli_s, "B": B,
                    "L": L, "T": T, "decoder_steps": T // 2,
                    "step_ms": [round(t, 3) for t in times],
                    "ms_per_step": steady,
                    "frames_per_s": B * T / steady * 1e3,
                    "peak_memory_bytes": peak_bytes, "total": totals,
                    "one_step_profile": profile},
          "decode": {"utterances": len(utts), "max_frames": T,
                     "frames_written": frames,
                     "s_per_utterance": decode_s / len(utts),
                     "decoded_frames_per_s": len(utts) * T / decode_s,
                     "written_frames_per_s": sum(frames) / decode_s,
                     "b2_mel_lens": lens2.tolist(),
                     "b2_stop_bias_shift": shift,
                     "b2_mel_lens_from_stop_logits": stop_want,
                     "infer_b1_ms": infer_ms,
                     "infer_b1_frames_per_s": T / min(infer_ms) * 1e3,
                     "one_infer_profile": infer_profile},
          "port_kernel_launches": ours})


def _decode_dir(root, src_scp, n, targets):
    """A decode dir of ``n`` utterances of a corpus with ``trials`` to the
    named ``targets`` in turn and their ``spk2spk_id``."""
    from vae_npvc_tpu_torch.data import kaldi_io

    root.mkdir(parents=True, exist_ok=True)
    scp = kaldi_io.load_dict_data(src_scp)
    utts = list(scp)[:n]
    with kaldi_io.ArkWriter(root / "feats.ark", root / "feats.scp") as w:
        for u in utts:
            w.write(u, kaldi_io.load_mat(scp[u]))
    (root / "trials").write_text("".join(
        f"{u} spk{targets[i % len(targets)]}\n" for i, u in enumerate(utts)))
    kaldi_io.save_dict_data(root / "spk2spk_id",
                            {f"spk{t}": t for t in targets})
    return root


def _cli_decode(conf, ckpt, ddir, out, *extra):
    from vae_npvc_tpu_torch.bin import decode

    _zero_counts()
    t0 = time.perf_counter()
    n = decode.main(["-c", str(conf), "--checkpoint", str(ckpt),
                     "--decode-dir", str(ddir), "--output-dir", str(out),
                     *extra])
    return n, time.perf_counter() - t0, _read_counts()


def _check_decoded(out, n, what):
    from vae_npvc_tpu_torch.data import kaldi_io

    scp = kaldi_io.load_dict_data(Path(out) / "feats.scp")
    check(len(scp) == n, f"{what}: {len(scp)} outputs, expected {n}")
    for k, rx in scp.items():
        m = kaldi_io.load_mat(rx)
        check(m.ndim == 2 and m.shape[1] == 80
              and bool(np.isfinite(m).all()), f"{what}: {k} {m.shape}")


def _split_counts(torch, fn):
    """``fn()`` with the kernel counts set to 0 before and read after,
    its wall ms and its result."""
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, _read_counts()


def phase_gan_golden(torch):
    """The WGAN-GP trainer on the card against the committed JAX fixture
    (a tiny flat EMA VQ-VAE and critic, fp32): four iterations across the
    three phases with the fixture's codebook candidates and interpolation
    weights (``tests/test_torch_port_gan_vae.py``), then the final
    generator and critic parameters, both optimizers and the codebook."""
    _gan_vae_golden(torch, "gan", ("DISC loss", "gradient_penalty",
                                   "ADV loss", "Total", "X like", "VQ loss",
                                   "usage", "skipped_nonfinite"))


def phase_vae_golden(torch):
    """The Gaussian VAE's ``Trainer`` on the card against the committed
    JAX fixture with its reparameterization noise."""
    _gan_vae_golden(torch, "vae", ("Total", "KLD loss", "X like",
                                   "grad_norm", "skipped_nonfinite"))


def _gan_vae_golden(torch, name, keys):
    import vae_npvc_tpu_torch.models.vae as pvae
    import vae_npvc_tpu_torch.ops.vq as pvq
    import vae_npvc_tpu_torch.train.gan as pgan
    from vae_npvc_tpu_torch.train import build_trainer

    cfg = json.loads((FIXTURES / f"{name}_golden_config.json").read_text())
    g = np.load(FIXTURES / f"{name}_golden.npz")
    n = sum(1 for k in g.files if k.startswith("feats_"))
    saved = (pvq._tiled_candidates, pgan.gp_alpha, pvae.gaussian_sample)
    # the fixture's draws (torch cannot replay jax.random)
    if "candidates" in g.files:
        pvq._tiled_candidates = lambda gen, z, K: torch.as_tensor(
            g["candidates"][:K], device=z.device)
        pgan.gp_alpha = lambda gen, shape, device: torch.as_tensor(
            g["alphas"], device=device)
    if "eps" in g.files:
        pvae.gaussian_sample = lambda gen, mu, lv: mu + torch.exp(
            0.5 * lv) * torch.as_tensor(g["eps"], device=mu.device)
    try:
        tr = build_trainer(cfg, device="cuda")
        tr.load_checkpoint(FIXTURES / f"{name}_golden.msgpack")
        worst = _golden_steps(tr, [(g[f"feats_{i}"], g[f"spks_{i}"])
                                   for i in range(n)], g, keys,
                              f"{name}_golden")
        with tempfile.TemporaryDirectory() as tmp:
            tr.save_checkpoint(Path(tmp) / "final")
            state_err = _state_against(
                Path(tmp) / "final", FIXTURES / f"{name}_golden_final.msgpack",
                f"{name}_golden")
    finally:
        pvq._tiled_candidates, pgan.gp_alpha, pvae.gaussian_sample = saved
    emit({"phase": f"{name}_golden", "iterations": n, "worst_rel_err": worst,
          "loss_rtol": GOLDEN_LOSS_RTOL, "state_max_abs_err": state_err,
          "state_atol_rtol": list(GOLDEN_STATE_TOL)})


def _train_cli(conf, corpus, out):
    from vae_npvc_tpu_torch.bin import train

    t0 = time.perf_counter()
    train.main(["-c", str(conf), "--train_dir", str(corpus), "--output_dir",
                str(out)])
    return time.perf_counter() - t0


def phase_gan(torch, root):
    """``train_vqvae_gan.yaml`` at full width (flagship generator in bf16,
    critic [128, 256, 512] in fp32): ``bin/train`` for ``GAN_ITERS``
    iterations with ``pre_iter`` cut to ``GAN_PRE_ITER``, so they pass
    through the three phases; then, from its checkpoint, one critic step
    and one generator step with their launch counts, wall ms and profiles,
    and a whole iteration through ``train_step``; the checkpoint through
    ``bin/decode`` over trials and one HTTP ``/convert`` request. Returns
    the launches counted in this run: of the iteration driven through
    ``train_step`` (``iteration``), of one critic step (``critic``) and of
    one generator step (``generator``)."""
    from scipy.io import wavfile

    from vae_npvc_tpu_torch.data.dataset import (UttMelSpkDataset,
                                                 batch_iterator)
    from vae_npvc_tpu_torch.serve import ConversionEngine
    from vae_npvc_tpu_torch.train import build_trainer

    cfg = dict(GAN, pre_iter=GAN_PRE_ITER, max_iter=GAN_ITERS,
               iters_per_log=GAN_ITERS // 2, iters_per_checkpoint=GAN_ITERS,
               num_jobs=2)
    B = cfg["batch_size"]
    (root / "corpus").mkdir(parents=True, exist_ok=True)
    _synthetic_corpus(root / "corpus", B + 8, seed=12)
    conf = root / "conf.json"
    conf.write_text(json.dumps(cfg))
    cli_s = _train_cli(conf, root / "corpus", root / "exp")
    ckpt = root / "exp" / "model.loss.best"
    rows = [json.loads(ln) for ln in
            (root / "exp" / "metrics.jsonl").read_text().splitlines()]
    check([r["iter"] for r in rows] == [GAN_ITERS // 2, GAN_ITERS],
          f"gan: logged iterations {rows}")
    check({"DISC loss", "gradient_penalty", "ADV loss"} <= set(rows[-1])
          and all(math.isfinite(v) for r in rows for k, v in r.items()
                  if k not in ("iter", "split")), f"gan: log {rows}")

    tr = build_trainer(cfg, device="cuda")
    check(tr.load_checkpoint(ckpt) == GAN_ITERS, "gan: host iteration")
    check(tr.g_step == GAN_ITERS, f"gan: {tr.g_step} generator updates")
    data = UttMelSpkDataset(root / "corpus", cfg)
    batches = batch_iterator(data, B, shuffle=True, drop_last=True, seed=3,
                             num_workers=0)
    feats, spks = tr._to_device(next(batches))
    tr._disc_step(feats, spks)                       # warm-up
    tr._gen_step(feats, spks)
    tr._host_iter += 1
    codebook = tr.model.quantizer.emb.clone()
    critic, c_ms, c_counts = _split_counts(
        torch, lambda: tr._disc_step(feats, spks))
    check(torch.equal(tr.model.quantizer.emb, codebook),
          "gan: the critic step moved the codebook")
    gen, g_ms, g_counts = _split_counts(
        torch, lambda: tr._gen_step(feats, spks))
    tr._host_iter += 1
    check(c_counts == GAN_CRITIC_LAUNCHES,
          f"gan: critic step launched {c_counts}")
    check(g_counts == GAN_GEN_LAUNCHES,
          f"gan: generator step launched {g_counts}")
    for k, v in {**critic, **gen}.items():
        check(math.isfinite(float(v)), f"gan: {k} = {float(v)}")
    c_profile = _profiled(torch, lambda: tr._disc_step(feats, spks))
    g_profile = _profiled(torch, lambda: tr._gen_step(feats, spks))
    tr._host_iter += 1
    batch = next(batches)
    whole, it_ms, launches = _split_counts(torch,
                                           lambda: tr.train_step(batch))
    check(launches == {k: GAN_CRITIC_LAUNCHES[k] + GAN_GEN_LAUNCHES[k]
                       for k in launches},
          f"gan: one iteration launched {launches}")
    check({"DISC loss", "ADV loss", "Total"} <= set(whole),
          f"gan: iteration detail {sorted(whole)}")
    del tr

    # the GAN checkpoint's generator through bin/decode and /convert
    ddir = _decode_dir(root / "dd", root / "corpus" / "feats.scp", 12,
                       [3, 40])
    n, dec_s, dec_counts = _cli_decode(conf, ckpt, ddir, root / "dec")
    check(n == 12, f"gan: bin/decode wrote {n}")
    _check_decoded(root / "dec", 12, "gan decode")
    check(dec_counts["vq_fused"] >= 1 and dec_counts["fused_group_norm"]
          == 20 * dec_counts["vq_fused"], f"gan: decode launched "
          f"{dec_counts}")
    fs = 24000
    stats = _cmvn_stats()
    engine = ConversionEngine(cfg, ckpt, stats, vocoder="gl", device="cuda")
    httpd = None
    try:
        engine.warmup(1)
        httpd, thread, _ = _serving(engine)
        wav = _speechlike(2 * fs, fs, 31)
        buf = io.BytesIO()
        wavfile.write(buf, fs, (wav * 32767).astype(np.int16))
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/convert?target=40",
            data=buf.getvalue(), method="POST")
        _zero_counts()
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            sr, out = wavfile.read(io.BytesIO(r.read()))
        req_ms = (time.perf_counter() - t0) * 1e3
        req_counts = _read_counts()
    finally:
        if httpd is not None:
            _stop(httpd, thread)
        engine.close()
    check(sr == fs and out.size > 0 and np.abs(out).max() > 0,
          f"gan: /convert gave {out.shape} at {sr} Hz")
    check(req_counts == {"vq_fused": 1, "fused_group_norm": 20,
                         "fused_group_norm_backward": 0},
          f"gan: /convert launched {req_counts}")
    emit({"phase": "gan", "config": "train_vqvae_gan.yaml",
          "cut": {"pre_iter": [1000, GAN_PRE_ITER]},
          "cli_iterations": GAN_ITERS, "cli_s": cli_s, "B": B,
          "T": cfg["crop_length"], "log": rows,
          "critic_step": {"ms": c_ms, "launches": c_counts,
                          "detail": {k: float(v) for k, v in critic.items()},
                          "profile": c_profile},
          "generator_step": {"ms": g_ms, "launches": g_counts,
                             "detail": {k: float(v) for k, v in gen.items()},
                             "profile": g_profile},
          "iteration_ms": it_ms,
          "iteration_launches": launches,
          "decode": {"utterances": n, "s": dec_s, "launches": dec_counts},
          "convert": {"ms": req_ms, "launches": req_counts,
                      "samples": int(out.size)}})
    return {"iteration": launches, "critic": c_counts, "generator": g_counts}


def phase_vae(torch, root):
    """``train_vae.yaml`` at full width (bf16): ``bin/train`` for
    ``VAE_STEPS`` steps, then from its checkpoint two steps with their
    launch counts (K2 20, K3 20 each) and one profiled; ``bin/decode`` over
    trials and an ``--all-targets`` sweep of two targets. Returns the
    launches of the counted steps."""
    from vae_npvc_tpu_torch.data.dataset import (UttMelSpkDataset,
                                                 batch_iterator)
    from vae_npvc_tpu_torch.train import build_trainer

    cfg = dict(VAE, **VAE_DECODE, max_iter=VAE_STEPS,
               iters_per_log=VAE_STEPS, iters_per_checkpoint=VAE_STEPS,
               num_jobs=2)
    B = cfg["batch_size"]
    (root / "corpus").mkdir(parents=True, exist_ok=True)
    _synthetic_corpus(root / "corpus", B + 8, seed=13)
    conf = root / "conf.json"
    conf.write_text(json.dumps(cfg))
    cli_s = _train_cli(conf, root / "corpus", root / "exp")
    ckpt = root / "exp" / "model.loss.best"
    tr = build_trainer(cfg, device="cuda")
    check(tr.load_checkpoint(ckpt) == VAE_STEPS, "vae: iteration")
    data = UttMelSpkDataset(root / "corpus", cfg)
    batches = batch_iterator(data, B, shuffle=True, drop_last=True, seed=3,
                             num_workers=0)
    tr.train_step(next(batches))                     # warm-up
    steps, times, per_step = [], [], []
    launches = {k: 0 for k in VAE_LAUNCHES}
    for _ in range(2):
        batch = next(batches)
        d, ms, counts = _split_counts(torch, lambda: tr.train_step(batch))
        check(counts == VAE_LAUNCHES, f"vae: one step launched {counts}")
        check(all(math.isfinite(float(v)) for v in d.values())
              and float(d["skipped_nonfinite"]) == 0.0, f"vae: step {d}")
        steps.append({k: float(v) for k, v in d.items()})
        times.append(ms)
        per_step.append(counts)
        launches = {k: launches[k] + counts[k] for k in launches}
    batch = next(batches)
    profile = _profiled(torch, lambda: tr.train_step(batch))
    del tr
    ddir = _decode_dir(root / "dd", root / "corpus" / "feats.scp", 12,
                       [3, 40])
    n, dec_s, dec_counts = _cli_decode(conf, ckpt, ddir, root / "dec")
    check(n == 12, f"vae: bin/decode wrote {n}")
    _check_decoded(root / "dec", 12, "vae decode")
    check(dec_counts["vq_fused"] == 0 and dec_counts["fused_group_norm"] > 0
          and dec_counts["fused_group_norm"] % 20 == 0,
          f"vae: decode launched {dec_counts}")
    n2, sweep_s, sweep_counts = _cli_decode(conf, ckpt, ddir, root / "sweep",
                                            "--all-targets", "spk3,spk40")
    check(n2 == 24, f"vae: the sweep wrote {n2}")
    _check_decoded(root / "sweep", 24, "vae sweep")
    emit({"phase": "vae", "config": "train_vae.yaml", "cli_steps": VAE_STEPS,
          "cli_s": cli_s, "B": B, "T": cfg["crop_length"],
          "step_ms": times, "steps": steps, "launches": launches,
          "launches_per_step": per_step, "one_step_profile": profile,
          "decode": {"utterances": n, "s": dec_s, "launches": dec_counts},
          "sweep": {"outputs": n2, "s": sweep_s,
                    "launches": sweep_counts}})
    return launches


# trainer_rest: the flagship through bin/train on a Kaldi dir of 1-10 s
# utterances written as compressed CM arks. The host loader's batch of 128
# needs at least 128 utterances (drop_last), so the corpus holds 256.
REST_UTTS = 256
REST_SECONDS = np.linspace(1.0, 10.0, REST_UTTS)
REST_FRAMES = [int(round(s * OFFLINE_FEATURE["fs"]
                         / OFFLINE_FEATURE["n_shift"])) for s in REST_SECONDS]
REST_STEPS, REST_HOST_STEPS = 16, 8
REST_STEP_LAUNCHES = {"vq_fused": 1, "fused_group_norm": 20,
                      "fused_group_norm_backward": 20}
DOCTOR_LAUNCHES = {"vq_fused": 1, "fused_group_norm": 20}
DOCTOR_CHECKS = ("imports", "platform", "devices", "cpu-fallback",
                 "compile-cache", "model", "bundle")


def _record_method(cls, name, calls, keep):
    """Patch ``cls.name`` to append ``keep(args, result)`` to ``calls``;
    returns the original, for the caller to restore."""
    orig = getattr(cls, name)

    def recording(self, *args, **kw):
        out = orig(self, *args, **kw)
        calls.append(keep(args, out))
        return out

    setattr(cls, name, recording)
    return orig


def _metrics(out_dir):
    return [json.loads(ln) for ln in
            (Path(out_dir) / "metrics.jsonl").read_text().splitlines()]


def _trace_kernels(trace_dir):
    """The device kernels of the Chrome trace that ``--profile_dir``
    wrote: names by kernel class, and the trace's size."""
    (path,) = sorted(Path(trace_dir).glob("*.json"))
    events = json.loads(path.read_text())["traceEvents"]
    by_class = {}
    for e in events:
        if e.get("cat") == "kernel":
            m = re.search(r"::(\w+)", e["name"])
            by_class.setdefault(_kernel_class(e["name"]), set()).add(
                m.group(1) if m else e["name"][:40])
    return path, {k: sorted(v) for k, v in by_class.items()}, \
        path.stat().st_size, len(events)


def _python_windows(data_dir, crop, items):
    """``UttMelSpkDataset.get_at`` of each ``(idx, start)`` of ``items``:
    the windows read from disk by the port's Python kaldi_io (a worker
    process of :func:`_windows_equal`)."""
    from vae_npvc_tpu_torch.data.dataset import UttMelSpkDataset

    ds = UttMelSpkDataset(data_dir, {"crop_length": crop,
                                     "use_native_loader": False})
    return np.stack([ds.get_at(i, s)[0] for i, s in items])


def _windows_equal(data_dir, crop, pairs, batches, what, workers=8):
    """Every row of ``batches`` (one per ``(idx[B], starts[B])`` of
    ``pairs``) equals ``get_at`` read from disk, bit for bit. The reads
    decode CM arks in numpy, so they run in ``workers`` processes."""
    import multiprocessing

    items = [(int(i), int(s)) for idx, starts in pairs
             for i, s in zip(idx, starts)]
    got = np.concatenate([np.asarray(b, np.float32) for b in batches])
    check(len(got) == len(items), f"trainer_rest: {what}: {len(got)} rows "
                                  f"for {len(items)} windows")
    step = -(-len(items) // workers)
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        want = np.concatenate(list(ex.map(
            _python_windows, [str(data_dir)] * workers, [crop] * workers,
            [items[k:k + step] for k in range(0, len(items), step)])))
    bad = int(sum(not np.array_equal(a, b) for a, b in zip(got, want)))
    check(bad == 0, f"trainer_rest: {what}: {bad} of {len(items)} windows "
                    "differ from the Python reads")
    return len(items)


def phase_trainer_rest(torch, root, bundle, smi):
    """The trainer rest on the flagship (``train_vqvae.yaml``, bf16,
    B = 128, T = 256) through ``bin/train --device cuda`` on a Kaldi dir
    of ``REST_UTTS`` utterances of 1-10 s as CM arks: (a) ``iid`` sampling
    on the staged corpus, ``steps_per_call: 8``, ``REST_STEPS`` steps with
    ``--profile_dir`` (one step eager, one captured as a CUDA graph and
    the rest replayed; the K1/K2/K3 launches of the steps that call the
    wrappers; the trace names their kernels; every drawn crop, gathered
    again from the staged corpus after the run, against ``get_at`` from
    disk), then a run resumed from ``iter.8`` drawing what the
    uninterrupted one drew; (b)
    the host loader with ``use_native_loader`` through
    ``prefetch_to_device``, every native batch against the Python reads;
    the loader's frames/s beside both runs' training frames/s; (c)
    ``bin/doctor --config --bundle --json`` with the model probe's K1/K2
    launches. Returns the launches per step of (a) (of its steps that call
    the wrappers) and (b) and the doctor's."""
    import contextlib

    from vae_npvc_tpu_torch.bin import doctor
    from vae_npvc_tpu_torch.bin import train as train_cli
    from vae_npvc_tpu_torch.data.dataset import (UttMelSpkDataset,
                                                 index_iterator)
    from vae_npvc_tpu_torch.data.native_loader import NativeArkLoader
    from vae_npvc_tpu_torch.train.trainer import Trainer

    corpus = root / "corpus"
    corpus.mkdir(parents=True)
    t0 = time.perf_counter()
    _synthetic_corpus(corpus, REST_UTTS, seed=14, frames=REST_FRAMES,
                      compression_method=1)
    corpus_s = time.perf_counter() - t0
    with open(corpus / "feats.ark", "rb") as f:
        f.seek(int((corpus / "feats.scp").read_text().split("\n")[0]
                   .rsplit(":", 1)[1]))
        check(f.read(5) == b"\x00BCM ",
              "trainer_rest: the corpus is not CM-compressed")
    cfg = dict(FLAGSHIP, **TRAIN, device_resident_sampling="iid",
               max_iter=REST_STEPS, iters_per_log=8, iters_per_checkpoint=8)
    B, T = cfg["batch_size"], cfg["crop_length"]
    dataset = UttMelSpkDataset(corpus, cfg)
    check(dataset.native is not None, "trainer_rest: no native loader")
    short = sum(n < T for n in REST_FRAMES)

    def conf(name, **kw):
        path = root / f"{name}.json"
        path.write_text(json.dumps(dict(cfg, **kw)))
        return path

    def run(conf_path, out, *extra):
        _zero_counts()
        c0, r0 = Trainer.graph_captures, Trainer.graph_replays
        t0 = time.perf_counter()
        train_cli.main(["-c", str(conf_path), "--train_dir", str(corpus),
                        "--output_dir", str(out), *extra])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, _read_counts(), \
            (Trainer.graph_captures - c0, Trainer.graph_replays - r0)

    def per_step(counts, steps, graphs, want_graphs, what):
        """Launches per step of a run whose (captures, replays) must read
        ``want_graphs``: a replayed step calls no wrapper, so the wrappers
        count the eager steps' and the captures' calls."""
        check(graphs == want_graphs, f"trainer_rest: {what}: captures, "
                                     f"replays {graphs}, want {want_graphs}")
        called = steps - graphs[1] + graphs[0]
        want = {k: v * called for k, v in REST_STEP_LAUNCHES.items()}
        check(counts == want, f"trainer_rest: {what}: launches {counts} "
                              f"over {called} steps that called the "
                              f"wrappers, want {want}")
        return {k: v // called for k, v in counts.items()}

    # (a) iid sampling, with the draws and the trainer that staged the
    # corpus recorded: a step replayed from its CUDA graph runs no Python,
    # so the crops are gathered again from the staged corpus after the run
    draws, staged = [], []
    orig_sample = _record_method(
        Trainer, "_sample_iid", draws,
        lambda a, o: (a[0], o[0].clone(), o[1].clone()))
    orig_stage = Trainer.stage_dataset

    def staging(self, *args, **kw):
        staged.append(self)
        return orig_stage(self, *args, **kw)

    Trainer.stage_dataset = staging
    try:
        iid = conf("iid")
        full_s, counts, graphs = run(iid, root / "iid", "--profile_dir",
                                     str(root / "trace"))
        # the first step eager, the second captured, the rest replayed
        iid_per_step = per_step(counts, REST_STEPS, graphs,
                                (1, REST_STEPS - 1), "iid run")
        iid_graphs = graphs
        full_draws = list(draws)
        check(len(staged) == 1, f"trainer_rest: {len(staged)} stagings")
        full_crops = [staged[0]._gather(i, s)[0].clone()
                      for _, i, s in full_draws]
        draws.clear()
        staged.clear()
        # logged every 4 steps: steps 13-16 are a window past the staging
        resume_s, counts, graphs = run(conf("iid_resumed", iters_per_log=4),
                                       root / "iid_resumed", "--checkpoint",
                                       str(root / "iid" / "iter.8"))
        per_step(counts, REST_STEPS - 8, graphs, (1, REST_STEPS - 8 - 1),
                 "resumed iid run")
        staged.clear()
    finally:
        Trainer._sample_iid = orig_sample
        Trainer.stage_dataset = orig_stage
    check([d[0] for d in full_draws] == list(range(REST_STEPS)),
          f"trainer_rest: draws of steps {[d[0] for d in full_draws]}")
    check([d[0] for d in draws] == list(range(8, REST_STEPS)),
          f"trainer_rest: resumed draws of steps {[d[0] for d in draws]}")
    for (step, i1, s1), (_, i2, s2) in zip(full_draws[8:], draws):
        check(torch.equal(i1, i2) and torch.equal(s1, s2),
              f"trainer_rest: the resumed run drew other windows at step "
              f"{step + 1}")
    pairs = [(i.cpu().numpy(), s.cpu().numpy()) for _, i, s in full_draws]
    hi = np.maximum(np.asarray(REST_FRAMES) - T, 0)
    for idx, starts in pairs:
        check(bool(np.all(starts >= 0) & np.all(starts <= hi[idx])),
              "trainer_rest: a drawn start out of range")
    drawn_short = int(sum((np.asarray(REST_FRAMES)[idx] < T).sum()
                          for idx, _ in pairs))
    n_crops = _windows_equal(corpus, T, pairs,
                             [c.float().cpu().numpy() for c in full_crops],
                             "iid crops gathered on the card")
    rows = _metrics(root / "iid")
    resumed_rows = _metrics(root / "iid_resumed")
    for r in rows + resumed_rows:
        check(all(math.isfinite(v) for k, v in r.items()
                  if k not in ("iter", "split")),
              f"trainer_rest: non-finite log window {r}")
        check(r["skipped_nonfinite"] == 0.0, f"trainer_rest: skipped {r}")
    log = (root / "iid" / "train.log").read_text()
    check("(iid sampling)" in log and "Saved profiler trace to" in log,
          "trainer_rest: iid or profiler log line missing")
    trace, trace_kernels, trace_bytes, trace_events = _trace_kernels(
        root / "trace")
    for k in REST_STEP_LAUNCHES:
        check(bool(trace_kernels.get(k)),
              f"trainer_rest: the trace names no {k} kernel: "
              f"{sorted(trace_kernels)}")

    # (b) the host loader: native batches through prefetch_to_device
    loads = []
    orig_load = _record_method(
        NativeArkLoader, "load_batch", loads,
        lambda a, o: (np.asarray(a[0]).copy(), np.asarray(a[1]).copy(),
                      o.copy()))
    try:
        host_s, counts, graphs = run(
            conf("host", device_resident=False, use_native_loader=True,
                 max_iter=REST_HOST_STEPS, iters_per_log=4,
                 iters_per_checkpoint=REST_HOST_STEPS), root / "host")
    finally:
        NativeArkLoader.load_batch = orig_load
    # host batches: every step eager
    host_per_step = per_step(counts, REST_HOST_STEPS, graphs, (0, 0),
                             "host-loader run")
    check(len(loads) >= REST_HOST_STEPS,
          f"trainer_rest: {len(loads)} native batches for "
          f"{REST_HOST_STEPS} steps")
    scp_to_item = np.argsort(dataset._native_row)
    n_native = _windows_equal(
        corpus, T, [(scp_to_item[rws], st) for rws, st, _ in loads],
        [o for _, _, o in loads], "native batches")
    host_rows = _metrics(root / "host")
    for r in host_rows:
        check(all(math.isfinite(v) for k, v in r.items()
                  if k not in ("iter", "split")),
              f"trainer_rest: non-finite log window {r}")
    # the loader alone, as bin/train calls it (num_jobs = 8 threads), and
    # on one thread
    idx_it = index_iterator(dataset, B, shuffle=True, drop_last=True,
                            seed=cfg["seed"])
    jobs = [next(idx_it) for _ in range(8)]
    out = np.empty((B, T, 80), np.float32)

    def load(batches, threads):
        t0 = time.perf_counter()
        for idx, starts in batches:
            dataset.native.load_batch(dataset._native_row[idx], starts, T,
                                      out=out, nthreads=threads)
        return time.perf_counter() - t0

    loader_s = [load(jobs, 8) for _ in range(3)]
    loader_fps = 8 * B * T / min(loader_s)
    loader_fps_1 = 2 * B * T / load(jobs[:2], 1)

    # (c) the doctor, as a user runs it, on the stage-8 bundle
    _zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = doctor.main(["--config", str(iid), "--bundle", str(bundle),
                          "--json"])
    doctor_counts = _read_counts()
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rc == 0 and report["ok"], f"trainer_rest: doctor rc {rc}: "
                                    f"{report}")
    for name in DOCTOR_CHECKS:
        check(report["checks"][name]["status"] == "ok",
              f"trainer_rest: doctor {name}: {report['checks'][name]}")
    doctor_launches = report["checks"]["model"]["launches"]
    check(doctor_launches == DOCTOR_LAUNCHES,
          f"trainer_rest: doctor model launches {doctor_launches}")

    emit({"phase": "trainer_rest", "card": smi, "B": B, "T": T,
          "dtype": cfg["compute_dtype"], "utterances": REST_UTTS,
          "shorter_than_crop": short, "corpus_write_s": corpus_s,
          "iid": {"steps": REST_STEPS, "wall_s": full_s,
                  "resumed_wall_s": resume_s,
                  "launches_per_step": iid_per_step,
                  "graph_captures_replays": list(iid_graphs),
                  "frames_per_s_steps_1_8": rows[0]["frames_per_sec"],
                  "frames_per_s_9_16_profiled": rows[1]["frames_per_sec"],
                  "frames_per_s_resumed_9_12_13_16":
                      [r["frames_per_sec"] for r in resumed_rows],
                  "total_per_window": [r["Total"] for r in rows],
                  "resumed_total_per_window":
                      [r["Total"] for r in resumed_rows],
                  "crops_equal_get_at": n_crops,
                  "drawn_rows_shorter_than_crop": drawn_short,
                  "resumed_draws_equal": REST_STEPS - 8},
          "trace": {"file": trace.name, "bytes": trace_bytes,
                    "events": trace_events, "kernels": trace_kernels},
          "host_loader": {"steps": REST_HOST_STEPS, "wall_s": host_s,
                          "launches_per_step": host_per_step,
                          "native_batches": len(loads),
                          "windows_equal_python_reads": n_native,
                          "frames_per_s": [r["frames_per_sec"]
                                           for r in host_rows],
                          "total_per_window": [r["Total"]
                                               for r in host_rows]},
          "loader_frames_per_s": loader_fps,
          "loader_frames_per_s_one_thread": loader_fps_1,
          "loader_8_batches_s": loader_s,
          "doctor": {"rc": rc, "model_launches": doctor_launches,
                     "launches_with_bundle": doctor_counts,
                     "checks": {k: v["detail"] for k, v in
                                report["checks"].items()}}})
    return {"iid": iid_per_step, "host": host_per_step,
            "doctor": doctor_launches}


# ---------------------------------------------------------------- parallel
# The parallel slice (vae_npvc_tpu_torch/parallel) on the one card: NCCL at
# world size 1 for the flagship's data-parallel step and bin/train, and
# two ranks sharing cuda:0 over gloo (their collectives go through host
# memory: correctness and the kernels under collectives, not multi-card
# speed) for the rest.
PAR_DP1_STEPS = 16
PAR_B, PAR_T, PAR_STEPS, PAR_TP_STEPS = 16, 256, 4, 3
PAR_SEQ_T = 8192
PAR_PP_M, PAR_PP_B = 4, 8           # microbatches of B rows, T = PAR_T
PAR_LOSS_RTOL = 2e-5                # tests/test_parallel.py:160-166
# dp2's parameters and codebook after 4 fp32 steps, of each one's peak: the
# sums run in another order over two ranks
PAR_STATE_TOL = 1e-4
PAR_SEQ_TOL = 1e-4                  # of the mel's peak, fp32
PAR_PP_TOL, PAR_PP_GRAD_TOL = 1e-5, 1e-4
PAR_SERVE_TOL = 1e-5
PAR_VOC = dict(PWG, discriminator_train_start_steps=1)
PAR_VOC_B, PAR_VOC_M, PAR_VOC_STEPS = 4, 32, 3
PAR_CLI_STEPS = 8


def _flat_norms():
    """GroupNorms of the flagship flat model: one per encoder stack layer,
    one per decoder GLU block (20)."""
    enc, dec = FLAGSHIP["encoder"], FLAGSHIP["decoder"]
    return sum(enc["stacks"]) * enc["stack_layers"] + sum(dec["stacks"])


def _par_cfg(dtype="float32"):
    return dict(FLAGSHIP, **TRAIN, compute_dtype=dtype)


def _par_batches(n, B=PAR_B, T=PAR_T, seed=31):
    rng = np.random.default_rng(seed)
    return [(rng.normal(-3.0, 1.5, size=(B, T, 80)).astype(np.float32),
             rng.integers(0, FLAGSHIP["y_num"], size=B).astype(np.int32))
            for _ in range(n)]


def _inject_candidates(torch):
    """Every rank's lazy-init and restart candidates: one fixed (K, D)
    array; a gathered pool gives its first K rows. One process on the
    global batch then draws the same codebook (tests/test_torch_port_
    parallel.py injects the same way). Returns the restore function."""
    from vae_npvc_tpu_torch.ops import vq

    K, D = FLAGSHIP["z_num"], FLAGSHIP["z_dim"]
    C = torch.tensor(np.random.default_rng(5).normal(size=(K, D)),
                     dtype=torch.float32)
    saved = vq._tiled_candidates, vq._pick
    vq._tiled_candidates = lambda gen, z, k: C.to(z.device)
    vq._pick = lambda gen, n, k, device: torch.arange(k, device=device)

    def restore():
        vq._tiled_candidates, vq._pick = saved
    return restore


def _split_counters():
    from vae_npvc_tpu_torch.ops.groupnorm import (group_norm_split_apply,
                                                  group_norm_split_stats)

    return {"group_norm_split_stats": group_norm_split_stats,
            "group_norm_split_apply": group_norm_split_apply}


def _all_counts():
    return {k: fn.launches
            for k, fn in {**_counters(), **_split_counters()}.items()}


def _zero_all_counts():
    for fn in {**_counters(), **_split_counters()}.values():
        fn.launches = 0


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _par_dp1(torch, root):
    """The flagship's DP step over NCCL at world size 1 (B = 128, T = 256,
    bf16, 16 steps of the staged corpus) against the plain trainer from
    the same state on the same windows."""
    import torch.distributed as dist

    from vae_npvc_tpu_torch.data.dataset import UttMelSpkDataset
    from vae_npvc_tpu_torch.parallel import comm
    from vae_npvc_tpu_torch.parallel.mesh import make_mesh
    from vae_npvc_tpu_torch.train.trainer import Trainer

    cfg = _par_cfg("bfloat16")
    corpus = root / "dp_corpus"
    corpus.mkdir(parents=True)
    _synthetic_corpus(corpus, 256, seed=4)
    dataset = UttMelSpkDataset(corpus, cfg)
    keys = ("Total", "X like", "VQ loss", "grad_norm", "usage")
    dist.init_process_group("nccl", init_method=f"file://{root}/nccl1",
                            rank=0, world_size=1)
    try:
        # the two trainers' steps alternate (plain, DP, plain, ...), so a
        # drift of the host's speed falls on both
        plain_tr = Trainer(cfg, device="cuda")
        dp_tr = Trainer(cfg, device="cuda", mesh=make_mesh())
        for tr in (plain_tr, dp_tr):
            tr.init_state()
            tr.stage_dataset(dataset, cfg["batch_size"])
        plain, dp = ({k: [] for k in keys} for _ in range(2))
        plain_ms, dp_ms = [], []
        counts = {k: 0 for k in _counters()}
        comm.log = []
        for _ in range(PAR_DP1_STEPS):
            for tr, out, ms in ((plain_tr, plain, plain_ms),
                                (dp_tr, dp, dp_ms)):
                _zero_all_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                d = tr.train_steps_device(1)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                for k in keys:
                    out[k].append(float(d[k][0]))
                if tr is dp_tr:
                    for k, v in _read_counts().items():
                        counts[k] += v
        log, comm.log = comm.log, None
        n_params = int(dp_tr.flat.numel())
        plain_prof = _profiled(torch, lambda: plain_tr.train_steps_device(1))
        dp_prof = _profiled(torch, lambda: dp_tr.train_steps_device(1))
        del plain_tr, dp_tr
        rest = _par_dp1_rest(torch)
    finally:
        dist.destroy_process_group()
    for k in keys:
        check(dp[k] == plain[k], f"dp1: {k} {dp[k]} differs from the plain "
              f"trainer's {plain[k]}")
    want = {"vq_fused": 1, "fused_group_norm": _flat_norms(),
            "fused_group_norm_backward": _flat_norms()}
    check(counts == {k: v * PAR_DP1_STEPS for k, v in want.items()},
          f"dp1: launches {counts} over {PAR_DP1_STEPS} steps")
    grad_calls = sum(1 for name, ax, n in log if n == n_params)
    check(grad_calls == PAR_DP1_STEPS,
          f"dp1: {grad_calls} gradient collectives in {PAR_DP1_STEPS} steps")
    per_step = {}
    for name, ax, n in log:
        per_step[name] = per_step.get(name, 0) + 1 / PAR_DP1_STEPS
    steady = slice(2, None)
    emit({"phase": "parallel_dp1", "backend": "nccl", "world_size": 1,
          "steps": PAR_DP1_STEPS, "B": cfg["batch_size"],
          "T": cfg["crop_length"], "dtype": cfg["compute_dtype"],
          "losses_bit_equal_to_plain": True, "total": dp["Total"],
          "launches_per_step": want, "gradient_collectives_per_step": 1,
          "collectives_per_step": per_step,
          "ms_per_step_median": float(np.median(dp_ms[steady])),
          "plain_ms_per_step_median": float(np.median(plain_ms[steady])),
          "ms_per_step": dp_ms, "plain_ms_per_step": plain_ms,
          "steps_alternate": True,
          "one_step_profile": dp_prof, "plain_one_step_profile": plain_prof,
          "families_bit_equal_to_plain": rest})
    return {"ms": float(np.median(dp_ms[steady])),
            "plain_ms": float(np.median(plain_ms[steady])), "rest": rest}


def _par_references(torch, root):
    """One process on the card for the two-rank cases: the DP/TP steps on
    the global batch (candidates injected), the whole utterance's ids and
    mel (fp32 and bf16), the vocoder's steps."""
    from vae_npvc_tpu_torch.infer.convert import Converter
    from vae_npvc_tpu_torch.train.pwg import PwgTrainer
    from vae_npvc_tpu_torch.train.trainer import Trainer

    restore = _inject_candidates(torch)
    try:
        tr = Trainer(_par_cfg(), device="cuda")
        tr.init_state()
        totals = [float(tr.train_step(b)["Total"])
                  for b in _par_batches(PAR_STEPS)]
        q = tr.ema["quantizer"]
        torch.save({"totals": totals, "flat": tr.flat.cpu(),
                    "emb": q.emb.cpu(), "emb_sum": q.emb_sum.cpu(),
                    "emb_elem": q.emb_elem.cpu()}, root / "ref_dp.pt")
        del tr
    finally:
        restore()
    ckpt = root / "flagship.msgpack"
    _random_checkpoint(torch, ckpt, seed=3)
    x = _seq_utterance()
    seq = {}
    for dtype in ("float32", "bfloat16"):
        conv = Converter(dict(FLAGSHIP, compute_dtype=dtype), device="cuda")
        conv.load_checkpoint(ckpt)
        with torch.inference_mode():
            xt = torch.tensor(x, device="cuda")
            seq[f"{dtype}_ids"] = conv.model.encode(xt).cpu().numpy()
            seq[f"{dtype}_mel"] = conv.model.infer(
                xt, torch.tensor([5], device="cuda")).cpu().numpy()
        del conv
    np.savez(root / "ref_seq.npz", **seq)
    voc = PwgTrainer(PAR_VOC, device="cuda")
    voc.init_state()
    voc.save_checkpoint(root / "voc_seed.ckpt")
    wavs, mels, zs = _par_voc_batches()
    details = [{k: float(v) for k, v in voc.train_step((w, m), z).items()}
               for w, m, z in zip(wavs, mels, zs)]
    voc.save_checkpoint(root / "voc_one.ckpt")
    (root / "voc_one.json").write_text(json.dumps(details))
    return ckpt


def _seq_utterance():
    rng = np.random.default_rng(8)
    t = np.arange(PAR_SEQ_T)[:, None] / 100.0
    band = np.linspace(0, 1, 80)[None, :]
    mel = sum(np.sin(2 * np.pi * (rng.uniform(0.5, 4.0) * t
                                  + rng.uniform(0.5, 3.0) * band))
              for _ in range(4))
    return (mel - 3.0 + 0.1 * rng.normal(size=mel.shape))[None] \
        .astype(np.float32)


def _par_voc_batches():
    rng = np.random.default_rng(12)
    S = PAR_VOC_M * PAR_VOC["n_shift"]
    return ([(0.3 * rng.normal(size=(PAR_VOC_B, S))).astype(np.float32)
             for _ in range(PAR_VOC_STEPS)],
            [rng.normal(-3.0, 1.0, size=(PAR_VOC_B, PAR_VOC_M, 80))
             .astype(np.float32) for _ in range(PAR_VOC_STEPS)],
            [rng.normal(size=(PAR_VOC_B, S, 1)).astype(np.float32)
             for _ in range(PAR_VOC_STEPS)])


def _rank_dp2(torch, root, res):
    from vae_npvc_tpu_torch.parallel.mesh import make_mesh
    from vae_npvc_tpu_torch.train.trainer import Trainer

    ref = torch.load(root / "ref_dp.pt")
    tr = Trainer(_par_cfg(), device="cuda", mesh=make_mesh())
    tr.init_state()
    totals, ms = [], []
    for b in _par_batches(PAR_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        totals.append(float(tr.train_step(b)["Total"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    q = tr.ema["quantizer"]
    flat = tr.flat.cpu()
    res["dp2"] = {
        "totals": totals, "ref_totals": ref["totals"],
        "loss_rel_err": max(_rel(a, b) for a, b in zip(totals,
                                                       ref["totals"])),
        "params_err_of_peak": float((flat - ref["flat"]).abs().max()
                                    / ref["flat"].abs().max()),
        "ema_err_of_peak": {k: float((getattr(q, k).cpu() - ref[k]).abs()
                                     .max() / ref[k].abs().max())
                            for k in ("emb", "emb_sum", "emb_elem")},
        "ms_per_step_host_transport": ms, "params": int(flat.numel())}


def _rank_tp(torch, root, rank, res):
    from vae_npvc_tpu_torch.parallel.mesh import make_mesh
    from vae_npvc_tpu_torch.train.trainer import Trainer

    ref = torch.load(root / "ref_dp.pt")
    mesh = make_mesh(1, 2)
    tr = Trainer(_par_cfg(), device="cuda", mesh=mesh)
    tr.init_state()
    totals = [float(tr.train_step(b)["Total"])
              for b in _par_batches(PAR_STEPS)[:PAR_TP_STEPS]]
    tr.save_checkpoint(root / "tp.ckpt")
    back = Trainer(_par_cfg(), device="cuda", mesh=mesh)
    back.load_checkpoint(root / "tp.ckpt")
    back.save_checkpoint(root / "tp_again.ckpt")
    same = (rank != 0 or (root / "tp.ckpt").read_bytes()
            == (root / "tp_again.ckpt").read_bytes())
    res["tp"] = {
        "totals": totals,
        "loss_rel_err": max(_rel(a, b) for a, b in zip(
            totals, ref["totals"][:PAR_TP_STEPS])),
        "split_parameters": sum(1 for s in tr._tp.specs.values() if s),
        "parameters": len(tr._tp.specs),
        "local_floats": int(tr._opt_vector().numel()),
        "whole_floats": int(tr.flat.numel()),
        "checkpoint_round_trip_bit_equal": bool(same),
        "reloaded_flat_equal": bool(torch.equal(back.flat, tr.flat))}


def _rank_seq(torch, root, res):
    from vae_npvc_tpu_torch.infer.convert import Converter
    from vae_npvc_tpu_torch.parallel import comm
    from vae_npvc_tpu_torch.parallel.mesh import make_mesh
    from vae_npvc_tpu_torch.parallel.seq_infer import (
        sequence_parallel_infer, sequence_parallel_model)

    ref = np.load(root / "ref_seq.npz")
    mesh = make_mesh()
    ax = mesh.axis("data")
    x = _seq_utterance()
    T = x.shape[1] // ax.size
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dict(FLAGSHIP, compute_dtype=dtype)
        conv = Converter(cfg, device="cuda")
        conv.load_checkpoint(root / "flagship.msgpack")
        model = sequence_parallel_model(cfg, conv.model.state_dict(), "cuda")
        y = np.array([5], np.int32)
        sequence_parallel_infer(cfg, None, x, y, mesh, model=model)  # warm
        torch.cuda.synchronize()
        _zero_all_counts()
        t0 = time.perf_counter()
        mel = sequence_parallel_infer(cfg, None, x, y, mesh, model=model)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _all_counts()
        if dtype == "float32":
            pair = _seq_pair_device_ms(torch, lambda: sequence_parallel_infer(
                cfg, None, x, y, mesh, model=model), ax.index == 0)
        with comm.bind(mesh), torch.inference_mode():
            ids = model.encode(torch.tensor(
                x[:, ax.index * T:(ax.index + 1) * T], device="cuda"))
            ids = torch.cat(list(comm.all_gather(ids, "data")), dim=1)
        ids = ids.cpu().numpy()
        mel = mel.cpu().numpy()
        want = ref[f"{dtype}_mel"]
        out[dtype] = {
            "ms": ms, "launches": counts,
            "ids_equal_share": float((ids == ref[f"{dtype}_ids"]).mean()),
            "mel_err_of_peak": float(np.abs(mel - want).max()
                                     / np.abs(want).max()),
            "finite": bool(np.isfinite(mel).all()),
            "shape_ok": mel.shape == want.shape}
        if dtype == "float32":
            out[dtype]["split_pair"] = pair
        del conv, model
    res["seq"] = out


SEQ_PAIR_WINDOWS = 3


def _seq_pair_device_ms(torch, call, profile_it):
    """The device ms of K2's split pair in one sequence-parallel
    ``call()`` on this rank: the summed durations of its
    ``gn_split_stats_kernel`` and ``gn_split_apply_kernel`` launches, from
    a torch.profiler window around the call (after ``PROFILER_PAD`` spin
    kernels). Every rank makes ``SEQ_PAIR_WINDOWS`` calls, since each
    call's collectives need them all; the rank that ``profile_it`` traces
    each, and keeps the first window that holds as many of the pair's
    kernels as the wrappers counted, else fails. Other ranks return
    None."""
    from torch.profiler import ProfilerActivity, profile

    found = None
    for _ in range(SEQ_PAIR_WINDOWS):
        if not profile_it:
            call()
            torch.cuda.synchronize()
            continue
        _zero_all_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _profiler_pad(torch)
            call()
            torch.cuda.synchronize()
        counts = _all_counts()
        want = (counts["group_norm_split_stats"]
                + counts["group_norm_split_apply"])
        pair = [e for e in _kernel_events(torch, prof)
                if "gn_split_stats_kernel" in e.name
                or "gn_split_apply_kernel" in e.name]
        if found is None and want and len(pair) == want:
            found = {"device_ms": sum(e.time_range.elapsed_us()
                                      for e in pair) / 1e3,
                     "kernels": len(pair)}
    if profile_it:
        check(found is not None, "sequence-parallel infer: no profiler "
              "window held every launch of the split pair")
    return found


def _rank_pp(torch, root, rank, res):
    from vae_npvc_tpu_torch.infer.convert import Converter
    from vae_npvc_tpu_torch.parallel import pp
    from vae_npvc_tpu_torch.parallel.mesh import Mesh

    conv = Converter(dict(FLAGSHIP, compute_dtype="float32"), device="cuda")
    conv.load_checkpoint(root / "flagship.msgpack")
    dec = conv.model.decoder
    arch = FLAGSHIP["decoder"]
    names = pp.decoder_stack_names(arch)
    stacked = {k: v.detach().clone().requires_grad_() for k, v in
               pp.stack_layer_params(pp.decoder_layer_params(dec, names),
                                     names).items()}
    rng = np.random.default_rng(21)
    B = PAR_PP_M * PAR_PP_B
    W, S, Cc = arch["out_channels"][0], arch["skip_channels"], \
        arch["cond_channels"]
    h = torch.tensor(rng.normal(size=(B, PAR_T, W)), dtype=torch.float32,
                     device="cuda")
    c = torch.tensor(rng.normal(size=(B, 1, Cc)), dtype=torch.float32,
                     device="cuda")
    tgt = torch.tensor(rng.normal(size=(B, PAR_T, S)), dtype=torch.float32,
                       device="cuda")

    def loss(hh, ss):
        return ((ss - tgt) ** 2).mean() + 0.5 * (hh ** 2).mean()

    mesh = Mesh({"pipe": 2})
    _zero_all_counts()
    t0 = time.perf_counter()
    hp, sp = pp.pipeline_decoder_stack(FLAGSHIP, stacked, h, c, mesh,
                                       microbatches=PAR_PP_M)
    fwd = _read_counts()
    grads = torch.autograd.grad(loss(hp, sp), list(stacked.values()))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    bwd = _read_counts()
    hs, ss = h, torch.zeros(h.shape[:2] + (S,), device="cuda")
    for n in names:
        hs, s = getattr(dec, n)(hs, c)
        ss = ss + s
    params = [p for n in names for p in getattr(dec, n).parameters()]
    gs = torch.autograd.grad(loss(hs, ss), params)
    per = len(gs) // len(names)
    k = len(names) // 2
    grad_err = 0.0
    for i, key in enumerate(stacked):
        for j in range(rank * k, (rank + 1) * k):
            ref = gs[j * per + i]
            grad_err = max(grad_err, float((grads[i][j] - ref).abs().max()
                                           / ref.abs().max().clamp_min(
                                               1e-30)))
    res["pp"] = {
        "stages": 2, "microbatches": PAR_PP_M, "B_per_microbatch": PAR_PP_B,
        "T": PAR_T, "layers": len(names), "ms_forward_backward": ms,
        "h_err_of_peak": float((hp - hs).abs().max().detach()
                               / hs.abs().max()),
        "skip_err_of_peak": float((sp - ss).abs().max().detach()
                                  / ss.abs().max()),
        "grad_err_of_leaf_peak": grad_err,
        "k2_launches_forward": fwd["fused_group_norm"],
        "k3_launches_backward": bwd["fused_group_norm_backward"],
        "own_layers": [rank * k, (rank + 1) * k]}


def _rank_voc(torch, root, rank, res):
    from vae_npvc_tpu_torch.parallel.mesh import make_mesh
    from vae_npvc_tpu_torch.train.pwg import PwgTrainer

    tr = PwgTrainer(PAR_VOC, device="cuda", mesh=make_mesh())
    tr.init_state()
    tr.load_checkpoint(root / "voc_seed.ckpt")
    wavs, mels, zs = _par_voc_batches()
    details, ms = [], []
    for w, m, z in zip(wavs, mels, zs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        details.append({k: float(v) for k, v in
                        tr.train_step((w, m), z).items()})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    tr.save_checkpoint(root / "voc_dp.ckpt")
    res["pwg_dp"] = {"details": details, "ms_per_step_host_transport": ms}


def _parallel_ranks(rank, world, root):
    """Two ranks on cuda:0 over gloo: dp2, tp, seq, pp, pwg_dp, the
    other families' cases (hier_dp, hier_plain_dp, gan_dp, tts_dp, tac2_dp,
    accum_dp) and
    ``bin/train`` device-resident, each checked in the parent against its
    one-process reference."""
    import torch

    torch.cuda.set_device(0)
    root = Path(root)
    res = {}
    restore = _inject_candidates(torch)
    try:
        _rank_dp2(torch, root, res)
        _rank_tp(torch, root, rank, res)
    finally:
        restore()
    _rank_seq(torch, root, res)
    _rank_pp(torch, root, rank, res)
    _rank_voc(torch, root, rank, res)
    _rank_rest(torch, root, rank, res)
    _rank_train_cli_dev(torch, root, rank, world, res)
    (root / f"rank{rank}.json").write_text(json.dumps(res))


def _par_two_ranks(torch, root):
    from vae_npvc_tpu_torch.parallel.launch import spawn
    from vae_npvc_tpu_torch.utils import msgpack_io

    t0 = time.perf_counter()
    spawn(_parallel_ranks, 2, args=(str(root),), backend="gloo",
          timeout=600, threads=None)
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in (0, 1)]
    for r, res in enumerate(ranks):
        dp2, tp, seq, pp_, voc = (res[k] for k in ("dp2", "tp", "seq", "pp",
                                                   "pwg_dp"))
        check(dp2["loss_rel_err"] <= PAR_LOSS_RTOL,
              f"dp2 rank {r}: loss {dp2['totals']} vs one process "
              f"{dp2['ref_totals']}")
        check(dp2["params_err_of_peak"] <= PAR_STATE_TOL
              and max(dp2["ema_err_of_peak"].values()) <= PAR_STATE_TOL,
              f"dp2 rank {r}: parameters or codebook {dp2}")
        check(tp["loss_rel_err"] <= PAR_LOSS_RTOL,
              f"tp rank {r}: loss {tp['totals']} vs the DP-only run")
        check(tp["split_parameters"] > 0 and tp["local_floats"]
              < tp["whole_floats"], f"tp rank {r}: nothing split: {tp}")
        check(tp["checkpoint_round_trip_bit_equal"]
              and tp["reloaded_flat_equal"], f"tp rank {r}: round trip")
        s32 = seq["float32"]
        check(s32["ids_equal_share"] == 1.0,
              f"seq rank {r}: ids differ ({s32['ids_equal_share']})")
        check(s32["mel_err_of_peak"] <= PAR_SEQ_TOL,
              f"seq rank {r}: mel {s32['mel_err_of_peak']} of the peak")
        for dtype, case in seq.items():
            check(case["finite"] and case["shape_ok"],
                  f"seq rank {r} {dtype}: {case}")
            n = case["launches"]
            check(n["group_norm_split_stats"] == _flat_norms()
                  and n["group_norm_split_apply"] == _flat_norms()
                  and n["fused_group_norm"] == 0 and n["vq_fused"] == 1,
                  f"seq rank {r} {dtype}: launches {n}")
        check(pp_["h_err_of_peak"] <= PAR_PP_TOL
              and pp_["skip_err_of_peak"] <= PAR_PP_TOL,
              f"pp rank {r}: output {pp_}")
        check(pp_["grad_err_of_leaf_peak"] <= PAR_PP_GRAD_TOL,
              f"pp rank {r}: gradients {pp_['grad_err_of_leaf_peak']}")
        per_stage = pp_["layers"] // 2 * PAR_PP_M
        check(pp_["k2_launches_forward"] == per_stage
              and pp_["k3_launches_backward"] == per_stage,
              f"pp rank {r}: launches {pp_}")
    check(ranks[0]["dp2"]["totals"] == ranks[1]["dp2"]["totals"],
          "dp2: the ranks' losses differ")
    one = json.loads((root / "voc_one.json").read_text())
    worst = {}
    for i, (got, want) in enumerate(zip(ranks[0]["pwg_dp"]["details"], one)):
        for k, v in want.items():
            worst[k] = max(worst.get(k, 0.0), _rel(got[k], v))
            check(_rel(got[k], v) <= GOLDEN_LOSS_RTOL,
                  f"pwg_dp: step {i + 1} {k} {got[k]}, one process {v}")
    got = _leaves(msgpack_io.msgpack_restore(
        (root / "voc_dp.ckpt").read_bytes()))
    want = _leaves(msgpack_io.msgpack_restore(
        (root / "voc_one.ckpt").read_bytes()))
    voc_state = _voc_state_against(got, want, "pwg_dp")
    r0 = ranks[0]
    emit({"phase": "parallel_two_ranks", "backend": "gloo", "ranks": 2,
          "card": "one (cuda:0), collectives through host memory",
          "spawn_s": spawn_s,
          "dp2": {k: r0["dp2"][k] for k in (
              "totals", "loss_rel_err", "params_err_of_peak",
              "ema_err_of_peak", "ms_per_step_host_transport", "params")},
          "tp": r0["tp"], "seq": {r: res["seq"] for r, res in
                                  enumerate(ranks)},
          "pp": [res["pp"] for res in ranks],
          "pwg_dp": {"worst_rel_err": worst,
                     "state_max_abs_err": voc_state[0],
                     "g_moment_err_of_largest": voc_state[1],
                     "g_moment_rel_l2": voc_state[2],
                     "ms_per_step_host_transport":
                         r0["pwg_dp"]["ms_per_step_host_transport"]}})
    return ranks


def _par_dp_serve(torch, root, ckpt):
    """``ConversionEngine(data_parallel=True)`` (one replica per visible
    card: one here) against the plain engine over HTTP, then a local mesh
    of two replicas on cuda:0 against one replica on an fp32 batch."""
    from vae_npvc_tpu_torch.infer.convert import Converter
    from vae_npvc_tpu_torch.parallel.mesh import LocalMesh
    from vae_npvc_tpu_torch.serve import ConversionEngine

    fs = 24000
    stats = _cmvn_stats()
    wavs = [_speechlike(int(s * fs), fs, 40 + i)
            for i, s in enumerate(np.linspace(1.0, 4.0, 8))]
    served = {}
    for dp in (False, True):
        eng = ConversionEngine(FLAGSHIP, ckpt, stats, vocoder="none",
                               device="cuda", data_parallel=dp)
        httpd = None
        try:
            httpd, thread, port = _serving(eng)
            _zero_all_counts()
            bodies, ids = _k1_ids(lambda: [
                _post_convert(port, f"target={(5 * i) % 117}&mel=1", w, fs)
                for i, w in enumerate(wavs)])
            served[dp] = (bodies, [t.cpu() for t in ids], _read_counts(),
                          eng.batcher.pad_multiple, eng.batcher.max_batch)
        finally:
            if httpd is not None:
                _stop(httpd, thread)
            eng.close()
    (b0, i0, _, _, _), (b1, i1, n1, pad, mb) = served[False], served[True]
    check(len(b1) == 8 and b1 == b0, "dp_serve: the data-parallel engine's "
          "mel differs from the plain engine's")
    check(len(i1) == len(i0) and all(torch.equal(a, b)
                                     for a, b in zip(i0, i1)),
          "dp_serve: the data-parallel engine's ids differ")
    check(n1["vq_fused"] == 8
          and n1["fused_group_norm"] == 8 * _flat_norms(),
          f"dp_serve: launches {n1} for 8 requests")
    cfg = dict(FLAGSHIP, compute_dtype="float32")
    one = Converter(cfg, device="cuda")
    two = Converter(cfg, mesh=LocalMesh(["cuda:0", "cuda:0"]))
    one.load_checkpoint(ckpt)
    two.load_checkpoint(ckpt)
    rng = np.random.default_rng(9)
    feats = rng.normal(-3.0, 1.5, size=(8, 512, 80)).astype(np.float32)
    lengths = np.linspace(512, 100, 8).astype(np.int32)
    tgts = np.arange(8, dtype=np.int32) * 7
    want = one.infer(feats, tgts, lengths)
    got = two.infer(feats, tgts, lengths)
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    check(err <= PAR_SERVE_TOL * peak,
          f"dp_serve: two replicas' mel {err} from one's (peak {peak})")
    with torch.inference_mode():
        x = torch.tensor(feats, device="cuda")
        n = torch.tensor(lengths, device="cuda")
        ids_one = one.model.encode(x, n)
        ids_two = torch.cat([r.encode(x[i * 4:(i + 1) * 4],
                                      n[i * 4:(i + 1) * 4])
                             for i, r in enumerate(two.replicas)])
    valid = torch.arange(512, device="cuda")[None] < n[:, None]
    check(torch.equal(ids_one[valid], ids_two[valid]),
          "dp_serve: two replicas' ids differ from one's")
    emit({"phase": "parallel_dp_serve", "requests": 8,
          "engine_pad_multiple": pad, "engine_max_batch": mb,
          "bodies_equal_to_plain_engine": True, "ids_equal": True,
          "launches": n1, "replicas": 2, "batch": 8,
          "mel_err_of_peak_two_replicas": err / peak})


def _par_train_cli(torch, root, corpus):
    """``bin/train`` joining an NCCL group of one from torchrun's
    environment (RANK=0, WORLD_SIZE=1): 4 steps, then resumed to 8."""
    import socket

    from vae_npvc_tpu_torch.bin import train as train_cli

    cfg = dict(_par_cfg("bfloat16"), max_iter=PAR_CLI_STEPS // 2,
               iters_per_log=2, iters_per_checkpoint=PAR_CLI_STEPS // 2,
               num_jobs=2)
    conf = root / "cli.json"
    conf.write_text(json.dumps(cfg))
    out = root / "cli_exp"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    os.environ.update(env)
    counts = []
    try:
        for max_iter, ck in ((PAR_CLI_STEPS // 2, []),
                             (PAR_CLI_STEPS, ["--checkpoint", "auto"])):
            conf.write_text(json.dumps(dict(cfg, max_iter=max_iter)))
            _zero_all_counts()
            train_cli.main(["-c", str(conf), "--train_dir", str(corpus),
                            "--output_dir", str(out), *ck])
            counts.append(_read_counts())
    finally:
        for k in env:
            os.environ.pop(k, None)
    log = (out / "train.log").read_text()
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
            .splitlines() if x.strip()]
    check("Rank 0 of 1" in log and "Resumed from" in log,
          "train_cli: the log does not show the group and the resume")
    check((out / f"iter.{PAR_CLI_STEPS}").exists()
          and (out / "model.loss.best").exists(), "train_cli: checkpoints")
    check([r["iter"] for r in rows] == list(range(2, PAR_CLI_STEPS + 1, 2)),
          f"train_cli: metrics rows {[r['iter'] for r in rows]}")
    per_run = PAR_CLI_STEPS // 2
    want = {"vq_fused": per_run,
            "fused_group_norm": _flat_norms() * per_run,
            "fused_group_norm_backward": _flat_norms() * per_run}
    check(all(c == want for c in counts), f"train_cli: launches {counts}")
    emit({"phase": "parallel_train_cli", "backend": "nccl",
          "env": {k: v for k, v in env.items() if k != "MASTER_PORT"},
          "steps": PAR_CLI_STEPS, "resumed_at": per_run,
          "launches_per_run": counts,
          "x_like": [r["X like"] for r in rows]})


# ------------------------------------------- parallel: the other families
# The families the JAX package spreads over its chips besides the flat model
# and the vocoder, at the recipes' widths: two ranks on cuda:0 over gloo
# against one process on the global batch, and NCCL at world size 1 against
# the plain step. Global batches: 16 rows of 256 frames (hierarchy, GAN),
# 8 token-mel rows (synthesizer, the halves' frame and token counts
# unequal), 4 Tacotron2 rows cut to PAR_TAC2_T frames.
PAR_REST = {
    "hier_dp": (dict(HIER, use_ema=True), 16, 3),
    "hier_plain_dp": (dict(HIER), 16, 2),
    "gan_dp": (dict(GAN, pre_iter=1), 16, 4),
    "tts_dp": (dict(TTS), 8, 3),
    "tac2_dp": (dict(TAC2), 4, 2),
    # the flagship flat EMA model with grad_accum: 2 (each rank takes its
    # part of each global microbatch; the codebook chains through them)
    "accum_dp": (dict(FLAGSHIP, **TRAIN, grad_accum=2), 16, 3),
}
PAR_TAC2_L, PAR_TAC2_T = 48, 96
# the two-rank comparisons run in fp32: a rank's half batch and the whole
# batch take other bf16 GEMM and convolution algorithms, so bf16 rows
# round apart and move codes (the world-size-1 cases run the recipes' bf16)
PAR_REST_DTYPE = "float32"
# K1-K5 a step (a GAN step: an iteration; 2 of its 4 are the phase-1 step,
# 2 a critic and a generator step), on each rank as on one process; the
# kernels not named launch 0 times
PAR_REST_LAUNCHES = {
    "hier_dp": {"vq_fused": 2, "fused_group_norm": 40,
                "fused_group_norm_backward": 40},
    "hier_plain_dp": {"vq_fused": 2, "fused_group_norm": 40,
                      "fused_group_norm_backward": 40},
    "gan_dp": {"vq_fused": 1.5, "fused_group_norm": 30,
               "fused_group_norm_backward": 20},
    "tts_dp": {"fused_attention": 12, "fused_attention_backward": 12},
    "tac2_dp": {},
    "accum_dp": {"vq_fused": 2, "fused_group_norm": 40,
                 "fused_group_norm_backward": 40},
}
# the synthesizers' parameters after a few fp32 steps: Adam moves every
# element by about the learning rate at its first steps whatever the
# gradient's size, so an element whose gradient the two summation orders put
# on either side of 0 lands up to 2 learning rates a step apart (on an H100:
# 5e-4 of their peak after 3 steps); their bound is that reach
PAR_ADAM_REACH = ("tts_dp", "tac2_dp")
# the parameters whose exact gradient is 0 (an attention key projection's
# bias, a weight-normalized one-channel conv's v): Adam walks them by
# rounding noise, at most 2 learning rates a step
PAR_FREE = ("linear_k.bias", "pitch_proj.v", "energy_proj.v")


class _DeterministicCudnn:
    """cuDNN's deterministic algorithms inside the block: the comparisons
    of a step with another must not see run-to-run noise (cuDNN's default
    weight-gradient algorithms add with atomics; a synthesizer step then
    differs from itself by ~1e-3 after 3 steps on an H100)."""

    def __init__(self, torch):
        self.backends = torch.backends.cudnn

    def __enter__(self):
        self.was = self.backends.deterministic
        self.backends.deterministic = True

    def __exit__(self, *exc):
        self.backends.deterministic = self.was


def _k_fns():
    """K1-K5's wrappers by the ``kernels`` line's names."""
    from vae_npvc_tpu_torch.ops.attention import (fused_attention,
                                                  fused_attention_backward)

    return dict(_counters(), fused_attention=fused_attention,
                fused_attention_backward=fused_attention_backward)


def _k_zero():
    for fn in _k_fns().values():
        fn.launches = 0


def _k_read():
    return {k: fn.launches for k, fn in _k_fns().items()}


def _par_rest_launches_want(name):
    want = dict.fromkeys(_k_fns(), 0)
    want.update(PAR_REST_LAUNCHES[name])
    return want


def _par_rest_cfg(name, dtype=None):
    cfg, B, _ = PAR_REST[name]
    cfg = dict(cfg, batch_size=B)
    if name in ("hier_dp", "hier_plain_dp", "gan_dp", "accum_dp"):
        cfg["compute_dtype"] = dtype or PAR_REST_DTYPE
    if name == "tac2_dp":
        cfg.update(max_tokens=PAR_TAC2_L, max_frames=PAR_TAC2_T)
    return cfg


def _par_rest_batches(name):
    """The case's global batches (numpy), the same on every rank."""
    cfg, B, steps = PAR_REST[name]
    rng = np.random.default_rng(70 + list(PAR_REST).index(name))
    if name in ("hier_dp", "hier_plain_dp", "gan_dp", "accum_dp"):
        return [(rng.normal(-3.0, 1.5, size=(B, 256, 80)).astype(np.float32),
                 rng.integers(0, cfg["y_num"], size=B).astype(np.int32))
                for _ in range(steps)]
    L, T = ((cfg["max_tokens"], cfg["max_frames"]) if name == "tts_dp"
            else (PAR_TAC2_L, PAR_TAC2_T))
    D = cfg["mel_dim"]
    out = []
    for _ in range(steps):
        # the first half long, the second short: unequal frame and token
        # counts on the two ranks
        tok_lens = np.concatenate([
            rng.integers(L // 2, L + 1, size=B // 2),
            rng.integers(2, L // 3, size=B - B // 2)]).astype(np.int32)
        tokens = np.zeros((B, L), np.int32)
        durs = np.zeros((B, L), np.int32)
        mels = np.zeros((B, T, D), np.float32)
        for b, n in enumerate(tok_lens):
            tokens[b, :n] = rng.integers(0, cfg["token_num"], size=n)
            durs[b, :n] = rng.integers(1, 7, size=n)
            while durs[b].sum() > T:
                durs[b, int(np.argmax(durs[b]))] -= 1
        mel_lens = durs.sum(axis=1).astype(np.int32)
        for b, n in enumerate(mel_lens):
            mels[b, :n] = rng.normal(size=(n, D))
        spks = rng.integers(0, cfg["y_num"], size=B).astype(np.int32)
        out.append((tokens, durs, mels, spks, tok_lens, mel_lens))
    return out


def _par_rest_draws(torch, name):
    """The draws one process and every rank share (restored by the
    returned function): the EMA codebooks' candidates, the penalty's
    weights of the global batch, Tacotron2's dropout and zoneout masks
    (the i-th draw of a shape from a seed of i, so the whole batch's)."""
    from vae_npvc_tpu_torch.models import token_tts
    from vae_npvc_tpu_torch.train import gan

    restore = _inject_candidates(torch)
    saved = gan.gp_alpha, token_tts.bernoulli
    B = PAR_REST[name][1]
    alphas = torch.tensor(np.random.default_rng(6).uniform(size=(B, 1, 1)),
                          dtype=torch.float32)
    gan.gp_alpha = lambda gen, shape, device: alphas.to(device)
    calls = [0]

    def masks(gen, p, shape, device):
        calls[0] += 1
        m = np.random.default_rng(1000 + calls[0]).random(shape) < p
        return torch.as_tensor(m, device=device)

    token_tts.bernoulli = masks

    def undo():
        restore()
        gan.gp_alpha, token_tts.bernoulli = saved
    return undo


def _par_rest_run(torch, name, mesh=None, dtype=None):
    """The case's steps on one process (``mesh`` None) or this rank:
    per-step detail, K1-K5 launches a step, the final parameters by name
    and every EMA bank (CPU tensors)."""
    from vae_npvc_tpu_torch.train import build_trainer

    cfg = _par_rest_cfg(name, dtype)
    tr = build_trainer(cfg, device="cuda",
                       **({"mesh": mesh} if mesh is not None else {}))
    tr.init_state()
    undo = _par_rest_draws(torch, name)
    details, ms = [], []
    try:
        _k_zero()
        with _DeterministicCudnn(torch):
            for b in _par_rest_batches(name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                details.append({k: float(v)
                                for k, v in tr.train_step(b).items()})
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        counts = _k_read()
    finally:
        undo()
    steps = len(details)
    state = {"params": {n: p.detach().float().cpu() for n, p in
                        tr.model.named_parameters()},
             "ema": {n: q.emb.cpu() for n, q in tr.ema.items()}}
    if hasattr(tr, "d_flat"):
        state["params"]["critic"] = tr.d_flat.cpu()
    return {"details": details, "ms_per_step": ms,
            "launches_per_step": {k: v / steps for k, v in counts.items()},
            "params": int(tr.flat.numel())}, state


def _rank_rest(torch, root, rank, res):
    """The five cases on this rank of a ``data`` mesh of two; each rank's
    final state saved for the parent."""
    from vae_npvc_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    for name in PAR_REST:
        out, state = _par_rest_run(torch, name, mesh)
        torch.save(state, root / f"{name}_r{rank}.pt")
        res[name] = out


def _rank_train_cli_dev(torch, root, rank, world, res):
    """``bin/train`` under torchrun's environment at world 2 with the
    device-resident corpus (epoch sampling): every step's rows recorded."""
    from vae_npvc_tpu_torch.bin import train as train_cli
    from vae_npvc_tpu_torch.train.trainer import Trainer

    cfg = _par_cli_dev_cfg()
    conf = root / f"cli_dev_r{rank}.json"
    conf.write_text(json.dumps(cfg))
    rows, step = [], Trainer._step

    def recording(self, batch, sharded):
        rows.append([a.cpu().numpy() for a in batch])
        return step(self, batch, sharded)

    env = {"RANK": str(rank), "WORLD_SIZE": str(world),
           "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}
    os.environ.update(env)
    Trainer._step = recording
    _k_zero()
    try:
        train_cli.main(["-c", str(conf), "--train_dir",
                        str(root / "dp_corpus"), "--output_dir",
                        str(root / "cli_dev_exp")])
    finally:
        Trainer._step = step
        for k in env:
            os.environ.pop(k, None)
    counts = _k_read()
    np.savez(root / f"cli_dev_rows_r{rank}.npz",
             **{f"{i}/{j}": a for i, r in enumerate(rows)
                for j, a in enumerate(r)})
    res["cli_dev"] = {"steps": len(rows), "launches_per_step": {
        k: v / max(len(rows), 1) for k, v in counts.items()}}


def _par_cli_dev_cfg():
    return dict(_par_cfg("bfloat16"), batch_size=PAR_B,
                max_iter=PAR_CLI_STEPS, iters_per_log=PAR_CLI_STEPS // 2,
                iters_per_checkpoint=PAR_CLI_STEPS, num_jobs=2)


def _rel_errs(got, want):
    """Each detail key's largest relative error of ``got`` against
    ``want`` over the steps, with the step (an absolute 1e-7 floor for
    values at 0)."""
    out = {}
    for i, (g, w) in enumerate(zip(got, want)):
        for k, v in w.items():
            err = abs(g[k] - v)
            err = err / max(abs(v), 1e-12) if err > 1e-7 else 0.0
            if err >= out.get(k, (-1.0, 0))[0]:
                out[k] = (err, i)
    return out


def _par_rest_checks(torch, root, ranks):
    """Each case's ranks against one process on the global batch: every
    detail value of the first step (the same parameters on both sides:
    the data-parallel semantics) and the loss (``Total``, ``X like``) of
    every step within ``PAR_LOSS_RTOL``; the parameters and every EMA bank
    within ``PAR_STATE_TOL`` of their peaks (the synthesizers' parameters
    and every free one within Adam's reach), the ranks' banks equal; the
    one-process reference run twice (its spread is reported)."""
    out = {}
    for name in PAR_REST:
        ref, want = _par_rest_run(torch, name)
        _, again = _par_rest_run(torch, name)
        got = [torch.load(root / f"{name}_r{r}.pt") for r in (0, 1)]
        cfg = _par_rest_cfg(name)
        steps = len(ref["details"])
        reach = 2 * steps * cfg.get("generator_param", cfg).get(
            "learning_rate", 1e-3)
        r0 = ranks[0][name]
        errs = _rel_errs(r0["details"], ref["details"])
        first = _rel_errs(r0["details"][:1], ref["details"][:1])
        check(max(e for e, _ in first.values()) <= PAR_LOSS_RTOL,
              f"{name}: first step's detail {first} vs one process")
        loss = {k: errs[k] for k in ("Total", "X like") if k in errs}
        check(max(e for e, _ in loss.values()) <= PAR_LOSS_RTOL,
              f"{name}: loss {loss} vs one process")
        check(ranks[1][name]["details"] == r0["details"],
              f"{name}: the ranks' details differ")
        for r, res in enumerate(ranks):
            check(res[name]["launches_per_step"]
                  == _par_rest_launches_want(name),
                  f"{name} rank {r}: launches a step "
                  f"{res[name]['launches_per_step']}")
        diffs = {n: (got[0]["params"][n] - p).abs()
                 for n, p in want["params"].items()}
        peak = max(float(p.abs().max()) for n, p in want["params"].items()
                   if not n.endswith(PAR_FREE))
        worst = sorted(((float(d.max()) / peak, n) for n, d in diffs.items()
                        if not n.endswith(PAR_FREE)), reverse=True)
        params_err = worst[0][0]
        params_abs = max(float(d.max()) for d in diffs.values())
        over_lr = sum(int((d > reach / (2 * steps)).sum())
                      for d in diffs.values())
        free = max((float(d.max()) for n, d in diffs.items()
                    if n.endswith(PAR_FREE)), default=0.0)
        spread = max(float((again["params"][n] - p).abs().max())
                     for n, p in want["params"].items()) / peak
        if name in PAR_ADAM_REACH:
            check(params_abs <= reach,
                  f"{name}: parameters moved {params_abs} > {reach}")
        else:
            check(params_err <= PAR_STATE_TOL,
                  f"{name}: parameters {params_err} of their peak")
            check(free <= reach,
                  f"{name}: free parameters moved {free} > {reach}")
        banks = {}
        for n, e in want["ema"].items():
            banks[n] = float((got[0]["ema"][n] - e).abs().max()
                             / e.abs().max())
            check(banks[n] <= PAR_STATE_TOL,
                  f"{name}: codebook {n} {banks[n]} of its peak")
            check(torch.equal(got[0]["ema"][n], got[1]["ema"][n]),
                  f"{name}: the ranks' codebooks {n} differ")
        out[name] = {
            "B": PAR_REST[name][1], "steps": steps,
            "dtype": cfg.get("compute_dtype", "float32"),
            "params": r0["params"],
            "first_step_detail_rel_err": max(e for e, _ in first.values()),
            "loss_rel_err": loss,
            "detail_rel_err_by_key": errs,
            "params_err_of_peak": params_err,
            "params_max_abs_err": params_abs, "adam_reach": reach,
            "param_elements_moved_over_lr": over_lr,
            "one_process_repeat_err_of_peak": spread,
            "largest_params_errs_of_peak": worst[:4],
            "free_params_max_abs": free,
            "codebook_err_of_peak": banks,
            "ranks_codebooks_equal": True if banks else None,
            "launches_per_rank_per_step": r0["launches_per_step"],
            "ms_per_step_host_transport": r0["ms_per_step"],
            "one_process_ms_per_step": ref["ms_per_step"],
            "details": r0["details"], "one_process_details": ref["details"]}
    return out


def _par_cli_dev_checks(root, ranks):
    """``bin/train`` at world 2, device-resident: each step's rows of the
    two ranks, in rank order, are the host loader's global batch."""
    from vae_npvc_tpu_torch.data.dataset import (UttMelSpkDataset,
                                                 batch_iterator)

    cfg = _par_cli_dev_cfg()
    exp = root / "cli_dev_exp"
    log = (exp / "train.log").read_text()
    check("Rank 0 of 2" in log and "Device-resident corpus" in log,
          "cli_dp: bin/train at world 2 did not keep the staged corpus")
    check((exp / f"iter.{PAR_CLI_STEPS}").exists(),
          "cli_dp: bin/train wrote no checkpoint")
    rows = [np.load(root / f"cli_dev_rows_r{r}.npz") for r in (0, 1)]
    host = batch_iterator(UttMelSpkDataset(root / "dp_corpus", cfg),
                          PAR_B, shuffle=True, drop_last=True,
                          seed=cfg["seed"], num_workers=2)
    for i in range(PAR_CLI_STEPS):
        want = next(host)
        for j, w in enumerate(want):
            got = np.concatenate([r[f"{i}/{j}"] for r in rows])
            check(np.array_equal(got, np.asarray(w)),
                  f"cli_dp: step {i} entry {j} rows differ from the host "
                  "loader's global batch")
    if hasattr(host, "close"):
        host.close()
    steps = [r["cli_dev"]["steps"] for r in ranks]
    check(steps == [PAR_CLI_STEPS] * 2, f"cli_dp: steps {steps}")
    flat = dict.fromkeys(_k_fns(), 0)
    flat.update(vq_fused=1, fused_group_norm=_flat_norms(),
                fused_group_norm_backward=_flat_norms())
    for r, res in enumerate(ranks):
        check(res["cli_dev"]["launches_per_step"] == flat,
              f"cli_dp rank {r}: bin/train launches a step "
              f"{res['cli_dev']['launches_per_step']}")
    return {"world": 2, "steps": PAR_CLI_STEPS, "B": PAR_B,
            "rows_equal_host_loader": True,
            "launches_per_rank_per_step":
                ranks[0]["cli_dev"]["launches_per_step"]}


def _par_cli_rest(torch, root):
    """``bin/train_tts`` (the recipe's transformer, B = 8) and
    ``bin/train_pwg`` (the recipe's vocoder) joining an NCCL group of one
    from torchrun's environment: 4 steps, then resumed to 8."""
    import socket

    from vae_npvc_tpu_torch.bin import train_pwg, train_tts

    _token_mel_corpus(root / "cli_tts_data", 24, seed=13)
    _voc_corpus(root / "cli_pwg_data", 8, seed=31)
    half = PAR_CLI_STEPS // 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    os.environ.update(env)
    out = {}
    try:
        for name, cli, cfg in (
                ("train_tts", train_tts, dict(TTS, batch_size=8)),
                ("train_pwg", train_pwg,
                 dict(PWG, discriminator_train_start_steps=half,
                      steps_per_call=2))):
            exp = root / f"cli_{name}"
            counts = []
            for max_iter in (half, PAR_CLI_STEPS):
                conf = root / f"cli_{name}.json"
                conf.write_text(json.dumps(dict(
                    cfg, max_iter=max_iter, iters_per_log=2,
                    iters_per_checkpoint=half)))
                ck = (["--checkpoint", str(exp / f"iter.{half}")]
                      if name == "train_tts" and max_iter > half else [])
                data = root / ("cli_tts_data" if name == "train_tts"
                               else "cli_pwg_data")
                _k_zero()
                cli.main(["-c", str(conf), "--train_dir", str(data),
                          "--output_dir", str(exp), *ck])
                counts.append({k: v / half for k, v in _k_read().items()})
            log = (exp / "train.log").read_text()
            check("Rank 0 of 1" in log and "Resumed from" in log
                  and f"Iter {PAR_CLI_STEPS}:" in log,
                  f"cli_dp: {name}'s log does not show the group, the "
                  "resume and the last step")
            check((exp / f"iter.{PAR_CLI_STEPS}").exists(),
                  f"cli_dp: {name} wrote no iter.{PAR_CLI_STEPS}")
            out[name] = {"launches_per_step": counts,
                         "resumed_at": half, "steps": PAR_CLI_STEPS}
    finally:
        for k in env:
            os.environ.pop(k, None)
    tts = dict.fromkeys(_k_fns(), 0)
    tts.update(fused_attention=TTS["elayers"] + TTS["dlayers"],
               fused_attention_backward=TTS["elayers"] + TTS["dlayers"])
    for name, want in (("train_tts", tts),
                       ("train_pwg", dict.fromkeys(_k_fns(), 0))):
        for c in out[name]["launches_per_step"]:
            check(c == want, f"cli_dp: {name} launches a step {c}")
    return out


def _par_dp1_rest(torch):
    """The EMA hierarchy, the GAN, the synthesizer and the flagship's
    accumulation step (``grad_accum: 2``) through the DP trainer over the
    NCCL group of one (open) against the plain trainer from the same
    weights on the same batches, in the recipes' dtypes (bf16 hierarchy,
    GAN and flagship, fp32 synthesizer), the draws their own: every detail
    value and parameter equal."""
    from vae_npvc_tpu_torch.parallel.mesh import make_mesh
    from vae_npvc_tpu_torch.train import build_trainer

    out = {}
    for name in ("hier_dp", "gan_dp", "tts_dp", "accum_dp"):
        cfg = _par_rest_cfg(name, dtype="bfloat16")
        trainers = [build_trainer(cfg, device="cuda", **kw)
                    for kw in ({}, {"mesh": make_mesh()})]
        for tr in trainers:
            tr.init_state()
        with torch.no_grad():
            trainers[1].flat.copy_(trainers[0].flat)
            if hasattr(trainers[0], "d_flat"):
                trainers[1].d_flat.copy_(trainers[0].d_flat)
        runs = []
        for tr in trainers:
            _k_zero()
            with _DeterministicCudnn(torch):
                details = [{k: float(v) for k, v in tr.train_step(b).items()}
                           for b in _par_rest_batches(name)]
            torch.cuda.synchronize()
            runs.append((details, _k_read()))
        (plain, n_plain), (dp, n_dp) = runs
        check(dp == plain, f"dp1 {name}: {dp} differs from the plain "
              f"trainer's {plain}")
        check(torch.equal(trainers[0].flat, trainers[1].flat)
              and all(torch.equal(q.emb, trainers[1].ema[n].emb)
                      for n, q in trainers[0].ema.items()),
              f"dp1 {name}: the parameters or codebooks differ")
        per_step = {k: v / len(dp) for k, v in n_dp.items()}
        check(n_dp == n_plain and per_step == _par_rest_launches_want(name),
              f"dp1 {name}: launches {n_dp} vs {n_plain}")
        out[name] = {"steps": len(dp), "dtype": cfg.get("compute_dtype",
                                                        "float32"),
                     "bit_equal_to_plain": True,
                     "launches_per_step": per_step}
        del trainers
    return out


def _gn_split_case(torch, C, G, glu, dtype, rng):
    """K2's split entry points at a sequence-parallel rank's shape (one
    utterance, T_local = PAR_SEQ_T / 2): two ranks' partials merged, each
    half applied, against the plain GroupNorm of the whole row; times of
    each entry point beside its plain version, its bound and one PyTorch
    call of the same function (``torch.var_mean`` over the group's
    elements for the statistics, ``F.group_norm`` for the apply)."""
    import torch.nn.functional as F

    from vae_npvc_tpu_torch.ops.groupnorm import (
        group_norm_plain, group_norm_split_apply,
        group_norm_split_apply_plain, group_norm_split_stats,
        group_norm_split_stats_plain)

    dev = torch.device("cuda")
    T = PAR_SEQ_T
    Th = T // 2
    x = _channels_first(torch.tensor(rng.normal(0.5, 2.0, size=(1, T, C)),
                                     device=dev).to(dtype))
    scale = torch.tensor(rng.normal(1.0, 0.2, size=C), dtype=torch.float32,
                         device=dev)
    bias = torch.tensor(rng.normal(0.0, 0.2, size=C), dtype=torch.float32,
                        device=dev)
    halves = [x[:, :Th], x[:, Th:]]
    parts = [group_norm_split_stats(h, G) for h in halves]
    check(all(torch.equal(p, group_norm_split_stats(h, G))
              for p, h in zip(parts, halves)),
          "group_norm_split_stats: two calls on one input differ")

    def mean_var(p):
        return torch.stack([p[..., 1], p[..., 2] / p[..., 0]])

    # the count is exact; the mean and the variance (M2 / count) are the
    # values the apply uses
    stats_err = max(float((mean_var(p) - mean_var(
        group_norm_split_stats_plain(h, G))).abs().max())
        for p, h in zip(parts, halves))
    check(all(torch.equal(p[..., 0], group_norm_split_stats_plain(h, G)[
        ..., 0]) for p, h in zip(parts, halves)),
        "group_norm_split_stats: counts differ from the plain version")
    gathered = torch.stack(parts, dim=2)
    got = torch.cat([group_norm_split_apply(h, scale, bias, gathered, G,
                                            glu=glu) for h in halves], dim=1)
    check(torch.equal(got[:, :Th], group_norm_split_apply(
        halves[0], scale, bias, gathered, G, glu=glu)),
        "group_norm_split_apply: two calls on one input differ")
    ref = group_norm_plain(x, scale, bias, G, glu=glu)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    atol, rtol = K2_TOL[name]
    err = (got.float() - ref.float()).abs()
    what = f"group_norm_split 1x{T}x{C} G={G} glu={glu} {name}"
    check(bool((err <= atol + rtol * ref.float().abs()).all()),
          f"{what}: max err {float(err.max())}")
    h = halves[0]
    kernels = {
        "stats": _device_kernels(torch, lambda: group_norm_split_stats(h, G),
                                 "gn_split_stats_kernel"),
        "apply": _device_kernels(torch, lambda: group_norm_split_apply(
            h, scale, bias, gathered, G, glu=glu), "gn_split_apply_kernel")}
    for part, (names, per_call) in kernels.items():
        check(len(names) == 1 and per_call == 1, f"{what}: the {part} ran "
              f"{names}, {per_call} device kernels a call, not one")
    case = {"T_local": Th, "C": C, "G": G, "glu": glu, "dtype": name,
            "ranks": 2, "stats_max_abs_err": stats_err,
            "apply_max_abs_err": float(err.max()),
            "device_kernels": {k: v[0] for k, v in kernels.items()},
            "device_kernels_per_call": {k: v[1] for k, v in
                                        kernels.items()},
            "bit_equal_in_two_calls": True}
    n = Th * C
    item = h.element_size()
    # L2-hot (one input) and L2-cold (inputs cycled through 100 MiB of
    # copies, outputs held as long, calls run back to back: a rank's 8 MB
    # row and the apply's output otherwise stay in the 50 MB L2 or are
    # written back between launches, and the apply then runs faster than
    # the HBM bound)
    case["stats_ms"], _ = timed(torch, lambda a: group_norm_split_stats(a, G),
                                [(h,)])
    case["stats_ms_l2_cold"], _ = timed(
        torch, lambda a: group_norm_split_stats(a, G), l2_cold((h,)))
    case["stats_plain_ms"], _ = timed(
        torch, lambda a: group_norm_split_stats_plain(a, G), [(h,)])
    xg = h.transpose(1, 2).reshape(1, G, -1)
    case["stats_library_ms"], _ = timed(
        torch, lambda a: torch.var_mean(a, dim=-1, correction=0), [(xg,)])
    case["stats_bound_ms"], case["stats_bound_by"] = _bound(
        n * item + 12 * G, 3 * n)
    # yardsticks on the same L2-cold inputs: PyTorch's one-kernel reduction
    # over the statistics' bytes, and an elementwise kernel that reads x
    # and writes its size (the apply's bytes without the GLU)
    case["sum_ms_l2_cold"], _ = timed(
        torch, lambda a: a.sum(dtype=torch.float32), l2_cold((h,)))
    case["mul_ms_l2_cold"], _ = timed(
        torch, lambda a: a.mul(2), l2_cold((h,)))
    case["apply_ms"], _ = timed(
        torch, lambda a: group_norm_split_apply(a, scale, bias, gathered, G,
                                                glu=glu), [(h,)])
    case["apply_ms_l2_cold"], _ = timed(
        torch, lambda a: group_norm_split_apply(a, scale, bias, gathered, G,
                                                glu=glu), l2_cold((h,)))
    case["apply_plain_ms"], _ = timed(
        torch, lambda a: group_norm_split_apply_plain(
            a, scale, bias, gathered, G, glu=glu), [(h,)])
    case["apply_library_ms"] = None
    if not glu:
        s, b = scale.to(dtype), bias.to(dtype)
        case["apply_library_ms"], _ = timed(
            torch, lambda a: F.group_norm(a, G, s, b, 1e-5),
            [(h.transpose(1, 2),)])
    out_c = C // 2 if glu else C
    case["apply_bound_ms"], case["apply_bound_by"] = _bound(
        n * item + Th * out_c * item + 8 * C + 24 * G,
        4 * n + (4 * n // 2 if glu else 0))
    for part in ("stats", "apply"):
        check(case[f"{part}_ms_l2_cold"] >= case[f"{part}_bound_ms"],
              f"{what}: the {part} L2-cold time "
              f"{case[f'{part}_ms_l2_cold']} ms is below its bound "
              f"{case[f'{part}_bound_ms']} ms: the timing misses traffic")
    return case


def _device_kernels(torch, call, what, n=50):
    """``(distinct names, device kernels per call)`` of ``n`` calls of
    ``call()`` in one torch.profiler window, after a warm call and
    ``PROFILER_PAD`` spin kernels (:func:`_profiler_pad`).
    The kernels whose names hold ``what`` count; any other kernel but the
    spins fails (a window without device events is taken again, up to
    three times, and then fails)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _profiler_pad(torch)
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        names = [e.name for e in _kernel_events(torch, prof)]
        if names:
            check(all(what in m for m in names),
                  f"{what}: the calls also ran {sorted(set(names))}")
            return sorted(set(names)), len(names) / n
    check(False, f"{what}: the profiler recorded no device kernels")


def _gn_split_ragged(torch, rng):
    """K2's split pair over R = 4 ranks of a (2, PAR_SEQ_T, 1,024) fp32
    GLU row pair, channels-first, with ragged lengths (6,000 and 3,000
    frames), so the last rank holds no valid frame of either row: every
    rank's counts against the plain version, the empty rank's partials
    (0, 0, 0), the row's output against the plain GroupNorm of the whole
    rows."""
    from vae_npvc_tpu_torch.ops.groupnorm import (
        group_norm_plain, group_norm_split_apply, group_norm_split_stats,
        group_norm_split_stats_plain)

    dev = torch.device("cuda")
    B, T, C, G, R = 2, PAR_SEQ_T, 1024, 2, 4
    x = _channels_first(torch.tensor(rng.normal(0.5, 2.0, size=(B, T, C)),
                                     dtype=torch.float32, device=dev))
    scale = torch.tensor(rng.normal(1.0, 0.2, size=C), dtype=torch.float32,
                         device=dev)
    bias = torch.tensor(rng.normal(0.0, 0.2, size=C), dtype=torch.float32,
                        device=dev)
    lengths = torch.tensor([6000, 3000], dtype=torch.int32, device=dev)
    Tr = T // R
    pieces = [(x[:, r * Tr:(r + 1) * Tr],
               (lengths - r * Tr).clamp(0, Tr).to(torch.int32))
              for r in range(R)]
    parts = [group_norm_split_stats(xp, G, n) for xp, n in pieces]
    for (xp, n), p in zip(pieces, parts):
        check(torch.equal(p[..., 0], group_norm_split_stats_plain(
            xp, G, n)[..., 0]), "split R=4: counts differ from the plain "
              "version")
    check(torch.equal(parts[-1], torch.zeros_like(parts[-1])),
          f"split R=4: the rank without a valid frame wrote {parts[-1]}")
    gathered = torch.stack(parts, dim=2)
    got = torch.cat([group_norm_split_apply(xp, scale, bias, gathered, G,
                                            lengths=n, glu=True)
                     for xp, n in pieces], dim=1)
    ref = group_norm_plain(x, scale, bias, G, lengths=lengths, glu=True)
    torch.cuda.synchronize()
    atol, rtol = K2_TOL["float32"]
    err = (got - ref).abs()
    check(bool((err <= atol + rtol * ref.abs()).all()),
          f"split R=4 ragged: max err {float(err.max())}")
    return {"B": B, "T": T, "C": C, "G": G, "glu": True, "ranks": R,
            "lengths": [6000, 3000], "ranks_without_valid_frames": [R - 1],
            "max_abs_err": float(err.max())}


def phase_parallel(torch, root):
    """The parallel slice on the one card: ``dp1`` (NCCL, world size 1;
    the flagship, then the hierarchy, the GAN, the synthesizer and the
    flagship's accumulation step against their plain steps), then
    dp2/tp/seq/pp/pwg_dp and hier_dp, hier_plain_dp, gan_dp, tts_dp,
    tac2_dp, accum_dp and device-resident ``bin/train`` on two gloo ranks
    sharing cuda:0 against one process, K2's split pair (three timed
    shapes, then R = 4 ranks with ragged lengths),
    ``dp_serve``, ``train_cli`` and ``cli_dp`` (bin/train, bin/train_tts and
    bin/train_pwg under torchrun's environment). Returns the split entry
    points' launches per GroupNorm of the sequence-parallel run, their
    timed cases and K1-K5's launches per rank per step of each case."""
    root.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    dp1 = _par_dp1(torch, root)
    ckpt = _par_references(torch, root)
    ranks = _par_two_ranks(torch, root)
    t_rest = time.perf_counter()
    rest = _par_rest_checks(torch, root, ranks)
    cli_dev = _par_cli_dev_checks(root, ranks)
    _par_dp_serve(torch, root, ckpt)
    _par_train_cli(torch, root, root / "dp_corpus")
    cli_rest = _par_cli_rest(torch, root)
    emit({"phase": "parallel_rest", "backend": "gloo (two ranks on "
          "cuda:0, collectives through host memory: not a multi-card "
          "speed); nccl at world size 1 for dp1 and the CLIs",
          "cases": rest, "dp1_bit_equal": dp1["rest"],
          "cli_dp": {"train_device_resident": cli_dev, **cli_rest},
          "seconds_after_spawn": time.perf_counter() - t_rest})
    rng = np.random.default_rng(61)
    split = [_gn_split_case(torch, 512, 1, False, torch.float32, rng),
             _gn_split_case(torch, 1024, 2, True, torch.float32, rng),
             _gn_split_case(torch, 1024, 2, True, torch.bfloat16, rng)]
    ragged = _gn_split_ragged(torch, rng)
    seq = ranks[0]["seq"]["float32"]
    # the split pair's device ms in rank 0's sequence-parallel fp32 infer,
    # from its profiler trace
    pair_ms = seq["split_pair"]["device_ms"]
    emit({"phase": "parallel", "seconds": time.perf_counter() - t0,
          "dp1_ms_per_step": dp1["ms"],
          "dp1_plain_ms_per_step": dp1["plain_ms"],
          "seq_fp32_ms": seq["ms"], "seq_fp32_split_pair_device_ms": pair_ms,
          "seq_fp32_split_pair_kernels": seq["split_pair"]["kernels"],
          "split_cases": split, "split_ragged_r4": ragged})
    return {"launches": seq["launches"], "split": split, "seq_ms": seq["ms"],
            "seq_pair_ms": pair_ms,
            "rest": {name: case["launches_per_rank_per_step"]
                     for name, case in rest.items()},
            "dp1_rest": {name: case["launches_per_step"]
                         for name, case in dp1["rest"].items()},
            "cli": dict({name: case["launches_per_step"][-1]
                         for name, case in cli_rest.items()},
                        train_device_resident_world2=cli_dev[
                            "launches_per_rank_per_step"])}


def _stream_launches(kernel, stream, vs_launches, vs_calls,
                     bridge_launches, bridge_calls):
    """The ``kernels`` line's keys of the stream, voc_stream and
    ckpt_bridge phases for ``kernel``."""
    out = {}
    for mode in ("exact", "chunked"):
        run = stream[mode]
        out[f"launches_stream_{mode}"] = run["launches"][kernel]
        out[f"stream_{mode}_infer_calls_items"] = [run["infer_calls"],
                                                   run["infer_items"]]
    out["launches_voc_stream"] = vs_launches[kernel]
    out["voc_stream_infer_calls"] = vs_calls
    out["launches_ckpt_bridge"] = bridge_launches[kernel]
    out["ckpt_bridge_infer_calls"] = bridge_calls
    return out


def _rest_launches(kernel, rest):
    """The ``kernels`` line's keys of the trainer_rest phase for
    ``kernel``: launches per iid step, per host-loader step and, for K1
    and K2, per doctor ``infer``."""
    out = {"launches_per_iid_step": rest["iid"][kernel],
           "launches_per_host_loader_step": rest["host"][kernel]}
    if kernel in rest["doctor"]:
        out["launches_doctor_infer"] = rest["doctor"][kernel]
    return out


def _par_rest_launches(kernel, par):
    """The ``kernels`` line's keys of the other families' parallel cases for
    ``kernel``: launches per rank per step of each two-rank case, per step
    of each world-size-1 case and of each CLI."""
    return {"launches_per_rank_per_step_parallel":
                {name: c[kernel] for name, c in par["rest"].items()},
            "launches_per_step_dp1_world_size_1":
                {name: c[kernel] for name, c in par["dp1_rest"].items()},
            "launches_per_step_cli_dp":
                {name: c[kernel] for name, c in par["cli"].items()}}


def _split_kernel_lines(par):
    """The ``kernels`` line's entries of K2's split entry points: the
    sequence-parallel run's launches (rank 0, per utterance: one of each
    per GroupNorm), times at the encoder's fp32 row (C = 512, G = 1, the
    shape with a library call), the other shapes beside."""
    main = par["split"][0]
    keys = ("T_local", "C", "G", "glu", "dtype")
    out = []
    for name, part in (("group_norm_split_stats", "stats"),
                       ("group_norm_split_apply", "apply")):
        out.append({
            "name": name, "route": "cuda",
            "source": "vae_npvc_tpu_torch/csrc/groupnorm.cu",
            "replaces": "vae_npvc_tpu/ops/groupnorm_pallas.py:200",
            "launches": par["launches"][name],
            "max_abs_err": main[f"{part}_max_abs_err"],
            "ms": main[f"{part}_ms"],
            "ms_l2_cold": main[f"{part}_ms_l2_cold"],
            "plain_ms": main[f"{part}_plain_ms"],
            "bound_ms": main[f"{part}_bound_ms"],
            "bound_by": main[f"{part}_bound_by"],
            "library_ms": main[f"{part}_library_ms"],
            "shape": {k: main[k] for k in keys},
            "seq_infer_ms_per_rank": par["seq_ms"],
            "seq_infer_split_pair_device_ms": par["seq_pair_ms"],
            "device_kernels_per_call":
                main["device_kernels_per_call"][part],
            "other_shapes": [dict({k: c[k] for k in keys},
                                  ms=c[f"{part}_ms"],
                                  ms_l2_cold=c[f"{part}_ms_l2_cold"],
                                  plain_ms=c[f"{part}_plain_ms"],
                                  bound_ms=c[f"{part}_bound_ms"],
                                  library_ms=c[f"{part}_library_ms"],
                                  max_abs_err=c[f"{part}_max_abs_err"])
                             for c in par["split"][1:]]})
    return out


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
    vq, gn, gnb, attn, attn_long = phase_kernels(torch)
    phase_golden(torch)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        launches, stream = phase_serve(torch, tmp / "serve")
        phase_grad_fp32(torch)
        phase_train_golden(torch)
        trained = tmp / "flagship_trained.msgpack"
        train_launches = phase_train(torch, trained)
        phase_tts_golden(torch)
        tts_launches = phase_tts(torch)
        phase_hier_golden(torch)
        hier_train, hier_infer, hier_k1, hier_ckpt = phase_hier(torch, tmp)
        bridge_launches, bridge_calls = phase_ckpt_bridge(
            torch, trained, hier_ckpt, tmp / "bridge")
        offline = phase_offline(torch, hier_ckpt, tmp / "offline")
        bundle = phase_bundle(torch, offline["paths"], hier_ckpt)
        rest = phase_trainer_rest(torch, tmp / "rest",
                                  offline["paths"]["root"] / "bundle_fp32",
                                  smi)
        bnf = phase_bnf(torch, tmp / "bnf")
        (voc_launches, voc_calls), (vs_launches, vs_calls) = phase_voc(
            torch, tmp)
        evaluation = phase_eval(torch, tmp / "eval")
        phase_tac2_golden(torch)
        phase_tac2(torch, tmp / "tac2")
        phase_gan_golden(torch)
        gan_launches = phase_gan(torch, tmp / "gan")
        phase_vae_golden(torch)
        vae_launches = phase_vae(torch, tmp / "vae")
        par = phase_parallel(torch, tmp / "parallel")

    vq_main = vq[0]
    # K2 and K3 in the layout the model hands them (channels-first x)
    def gn_case(cases, B, T, C, dtype="bfloat16"):
        return next(c for c in cases if (c["B"], c["T"], c["C"]) == (B, T, C)
                    and c["dtype"] == dtype
                    and c["layout"] == "channels-first")

    gn_main = gn_case(gn, 8, 256, 1024)
    # the training step's shapes: K1 in its statistics mode at N = B*T,
    # K2 and K3 at the decoder's (128, 256, 1024) GLU norm in bf16
    vq_train = next(c for c in vq if c["N"] == 32768)
    gn_train, gnb_train = gn_case(gn, 128, 256, 1024), \
        gn_case(gnb, 128, 256, 1024)
    # the encoder's (128, 256, 512) plain norm, the one shape with a
    # library call (F.group_norm and autograd's backward of it)
    gn_enc, gnb_enc = gn_case(gn, 128, 256, 512), gn_case(gnb, 128, 256, 512)
    gnb_enc32 = gn_case(gnb, 128, 256, 512, "float32")
    gn_long, gnb_long = gn_case(gn, 2, 4096, 1024), \
        gn_case(gnb, 2, 4096, 1024)
    gn_keys = ("B", "T", "C", "dtype", "layout", "plan", "ms", "ms_l2_cold",
               "plain_ms", "bound_ms", "bound_by", "library_ms",
               "max_abs_err")
    # the hierarchy's cases (HIER): K1 on unit-norm rows, the strided
    # levels' short GroupNorm rows
    vq_hier = [{k: c[k] for k in (
        "N", "mode", "ms", "ms_l2_cold", "plain_ms", "bound_ms", "bound_by",
        "fma_bound_ms", "sgemm_argmin_ms", "rescored_rows",
        "rescored_all_codes", "near_ties", "ids_differ", "max_abs_err")}
        for c in vq if c["kind"] == "unit"]

    def short_rows(cases):
        return [dict({k: c[k] for k in gn_keys}, G=c["G"], glu=c["glu"],
                     masked=c["masked"])
                for c in cases if c["T"] <= 128 and c["B"] in (8, 96)
                and c["layout"] == "channels-first" and c["C"] >= 512]
    # the synthesizer's shapes in fp32, the recipe's type: a training batch's
    # decoder (32, 4, 768, 96) and encoder (32, 4, 192, 96) attention with
    # ragged lengths, and one decoded utterance's decoder (1, 4, 768, 96)
    # (the decoder shape in bf16 beside them)
    def attn_case(B, T, dtype="float32"):
        return next(c for c in attn if (c["B"], c["T"], c["d"]) == (B, T, 96)
                    and c["dtype"] == dtype and c["q_scale"] == 1.0)

    attn_dec, attn_enc, attn_one = (attn_case(32, 768), attn_case(32, 192),
                                    attn_case(1, 768))
    # the recognizer's training and transcribe batches (d = 48)
    attn_rec, attn_tr = (next(c for c in attn if (c["B"], c["T"], c["d"])
                              == (16, T, 48)) for T in (600, 1536))
    eval_launches = evaluation["launches"]
    eval_keys = {"eval_steps": evaluation["steps"],
                 "eval_transcribe_batches":
                     evaluation["transcribe_batches"]}
    attn_bf16 = attn_case(32, 768, "bfloat16")
    fwd_keys = ("B", "T", "valid_keys", "ms", "ms_l2_cold", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "max_abs_err")
    bwd_keys = ("B", "T", "valid_keys", "bwd_ms", "bwd_ms_l2_cold",
                "bwd_plain_ms", "bwd_bound_ms", "bwd_bound_by",
                "bwd_library_ms", "bwd_max_abs_err")
    emit({"phase": "smoke", "seconds": time.perf_counter() - _T0})
    emit({"kernels": [
        {"name": "vq_fused", "route": "cuda",
         "source": "vae_npvc_tpu_torch/csrc/vq.cu",
         "replaces": "vae_npvc_tpu/ops/vq_pallas.py:105",
         **_par_rest_launches("vq_fused", par),
         "launches": launches["vq_fused"],
         "max_abs_err": vq_main["max_abs_err"], "ms": vq_main["ms"],
         "ms_l2_cold": vq_main["ms_l2_cold"],
         "plain_ms": vq_main["plain_ms"], "bound_ms": vq_main["bound_ms"],
         "bound_by": vq_main["bound_by"], "library_ms": None,
         "fma_bound_ms": vq_main["fma_bound_ms"],
         "sgemm_argmin_ms_not_library": vq_main["sgemm_argmin_ms"],
         "kernels_per_call": vq_main["kernels"],
         "ms_l2_cold_by_kernel": vq_main["ms_l2_cold_by_kernel"],
         "rescored_rows": vq_main["rescored_rows"],
         "rescored_all_codes": vq_main["rescored_all_codes"],
         "launches_train": train_launches["vq_fused"],
         **_rest_launches("vq_fused", rest),
         "train_shape": {k: vq_train[k] for k in (
             "N", "mode", "ms", "ms_l2_cold", "plain_ms", "bound_ms",
             "bound_by", "fma_bound_ms", "sgemm_argmin_ms", "kernels",
             "ms_l2_cold_by_kernel", "rescored_rows", "rescored_all_codes",
             "sum_max_abs_err")},
         "near_ties": [{k: c[k] for k in (
             "N", "K", "D", "kind", "mode", "rescored_rows",
             "rescored_all_codes", "ids_differ",
             "max_loss_vs_fp64")} for c in vq if c["kind"] not in (
                 "random", "unit")],
         "launches_hier_train": hier_train["vq_fused"],
         "launches_hier_infer": hier_infer["vq_fused"],
         "hier_shapes": vq_hier, "hier_calls_of_one_step": hier_k1,
         "launches_offline_flat_decode": offline["flat_decode"]["vq_fused"],
         "launches_offline_hier_sweep": offline["hier_sweep"]["vq_fused"],
         "offline_decode_batches": offline["decode_batches"],
         "offline_hier_sweep_batches": offline["hier_sweep_batches"],
         "offline_hier_calls": offline["k1_hier"],
         "launches_voc_serve": voc_launches["vq_fused"],
         "voc_serve_infer_calls": voc_calls,
         "launches_bundle": bundle["launches"]["vq_fused"],
         "bundle_launches_per_infer": bundle["per_infer"]["vq_fused"],
         "launches_bnf": bnf["launches"]["vq_fused"],
         "bnf_batches": bnf["batches"],
         "launches_gan_iteration": gan_launches["iteration"]["vq_fused"],
         "launches_per_gan_critic_and_generator_step": [
             gan_launches["critic"]["vq_fused"],
             gan_launches["generator"]["vq_fused"]],
         **_stream_launches("vq_fused", stream, vs_launches, vs_calls,
                            bridge_launches, bridge_calls)},
        {"name": "fused_group_norm", "route": "cuda",
         "source": "vae_npvc_tpu_torch/csrc/groupnorm.cu",
         "replaces": "vae_npvc_tpu/ops/groupnorm_pallas.py:200",
         **_par_rest_launches("fused_group_norm", par),
         "launches": launches["fused_group_norm"],
         "max_abs_err": gn_main["max_abs_err"], "ms": gn_main["ms"],
         "ms_l2_cold": gn_main["ms_l2_cold"],
         "plain_ms": gn_main["plain_ms"], "bound_ms": gn_main["bound_ms"],
         "bound_by": gn_main["bound_by"], "library_ms": None,
         "launches_train": train_launches["fused_group_norm"],
         **_rest_launches("fused_group_norm", rest),
         "train_shape": {k: gn_train[k] for k in gn_keys},
         "encoder_shape": {k: gn_enc[k] for k in gn_keys},
         "long_row": {k: gn_long[k] for k in gn_keys},
         "launches_hier_train": hier_train["fused_group_norm"],
         "launches_hier_infer": hier_infer["fused_group_norm"],
         "hier_shapes": short_rows(gn),
         "launches_offline_flat_decode":
             offline["flat_decode"]["fused_group_norm"],
         "launches_offline_hier_sweep":
             offline["hier_sweep"]["fused_group_norm"],
         "offline_plans": offline["k2_plans"],
         "offline_shapes": [dict({k: c[k] for k in gn_keys}, G=c["G"],
                                 glu=c["glu"], masked=c["masked"])
                            for c in gn if c["T"] in (768, 1024)],
         "launches_voc_serve": voc_launches["fused_group_norm"],
         "voc_serve_infer_calls": voc_calls,
         "launches_bundle": bundle["launches"]["fused_group_norm"],
         "bundle_launches_per_infer":
             bundle["per_infer"]["fused_group_norm"],
         "launches_bnf": bnf["launches"]["fused_group_norm"],
         "bnf_batches": bnf["batches"],
         "launches_gan_iteration":
             gan_launches["iteration"]["fused_group_norm"],
         "launches_per_gan_critic_and_generator_step": [
             gan_launches["critic"]["fused_group_norm"],
             gan_launches["generator"]["fused_group_norm"]],
         "launches_vae_two_steps": vae_launches["fused_group_norm"],
         **_stream_launches("fused_group_norm", stream, vs_launches,
                            vs_calls, bridge_launches, bridge_calls)},
        {"name": "fused_group_norm_backward", "route": "cuda",
         "source": "vae_npvc_tpu_torch/csrc/groupnorm.cu",
         "replaces": "vae_npvc_tpu/ops/groupnorm_pallas.py:225",
         **_par_rest_launches("fused_group_norm_backward", par),
         "launches": train_launches["fused_group_norm_backward"],
         **_rest_launches("fused_group_norm_backward", rest),
         "max_abs_err": gnb_train["max_abs_err"], "ms": gnb_train["ms"],
         "ms_l2_cold": gnb_train["ms_l2_cold"],
         "plain_ms": gnb_train["plain_ms"],
         "bound_ms": gnb_train["bound_ms"],
         "bound_by": gnb_train["bound_by"], "library_ms": None,
         "encoder_shape": {k: gnb_enc[k] for k in gn_keys},
         "encoder_shape_fp32": {k: gnb_enc32[k] for k in gn_keys},
         "long_row": {k: gnb_long[k] for k in gn_keys},
         "launches_hier_train": hier_train["fused_group_norm_backward"],
         "hier_shapes": short_rows(gnb),
         "launches_gan_iteration":
             gan_launches["iteration"]["fused_group_norm_backward"],
         "launches_per_gan_critic_and_generator_step": [
             gan_launches["critic"]["fused_group_norm_backward"],
             gan_launches["generator"]["fused_group_norm_backward"]],
         "launches_vae_two_steps":
             vae_launches["fused_group_norm_backward"]},
        {"name": "fused_attention", "route": "cuda",
         "source": "vae_npvc_tpu_torch/csrc/attention.cu",
         "replaces": "vae_npvc_tpu/ops/attention_pallas.py:121",
         **_par_rest_launches("fused_attention", par),
         "launches": tts_launches["fused_attention"],
         "max_abs_err": attn_dec["max_abs_err"], "ms": attn_dec["ms"],
         "ms_l2_cold": attn_dec["ms_l2_cold"],
         "plain_ms": attn_dec["plain_ms"], "bound_ms": attn_dec["bound_ms"],
         "bound_by": attn_dec["bound_by"],
         "library_ms": attn_dec["library_ms"],
         "fma_bound_ms": attn_dec["fma_bound_ms"],
         "encoder_shape": {k: attn_enc[k] for k in fwd_keys},
         "decode_shape": {k: attn_one[k] for k in fwd_keys},
         "bf16_shape": {k: attn_bf16[k] for k in fwd_keys},
         "launches_eval_asr": eval_launches["fused_attention"], **eval_keys,
         "recognizer_step_shape": {k: attn_rec[k] for k in fwd_keys},
         "recognizer_transcribe_shape": {k: attn_tr[k] for k in fwd_keys},
         "long_fp32_o_vs_f64": [{k: c[k] for k in ("T", "d", "o")}
                                for c in attn_long]},
        {"name": "fused_attention_backward", "route": "cuda",
         "source": "vae_npvc_tpu_torch/csrc/attention.cu",
         "replaces": "vae_npvc_tpu/ops/attention_pallas.py:225",
         **_par_rest_launches("fused_attention_backward", par),
         "launches": tts_launches["fused_attention_backward"],
         "max_abs_err": attn_dec["bwd_max_abs_err"], "ms": attn_dec["bwd_ms"],
         "ms_l2_cold": attn_dec["bwd_ms_l2_cold"],
         "plain_ms": attn_dec["bwd_plain_ms"],
         "bound_ms": attn_dec["bwd_bound_ms"],
         "bound_by": attn_dec["bwd_bound_by"],
         "library_ms": attn_dec["bwd_library_ms"],
         "fma_bound_ms": attn_dec["bwd_fma_bound_ms"],
         "encoder_shape": {k: attn_enc[k] for k in bwd_keys},
         "bf16_shape": {k: attn_bf16[k] for k in bwd_keys},
         "launches_eval_asr": eval_launches["fused_attention_backward"],
         **eval_keys,
         "recognizer_step_shape": {k: attn_rec[k] for k in bwd_keys},
         "long_fp32_vs_f64": [{k: c[k] for k in ("T", "d", "dq", "dk", "dv")}
                              for c in attn_long]},
    ] + _split_kernel_lines(par)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
