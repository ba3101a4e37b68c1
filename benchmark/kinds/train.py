"""The ``train`` kind: the recipe's training job through ``Trainer``.

Set-up builds the kernels, makes the weights and a synthetic corpus on
the device from the seed, stages the corpus (``Trainer.stage_dataset``)
and drives the one trainer through the checked steps with
``Trainer.train_steps_indices``, the window's own call: first
``checked_steps`` calls of one step (each step's loss, the first gradient
read back from Adam's first moment, each leaf's change after the last),
then ``checked_calls`` calls of ``steps_per_call`` steps, the window's own
call shape (the training state each began with, and the loss and gradient
norm of its first ``followed_steps`` steps). These calls warm every shape
the window runs. Every row of a step comes from a distinct utterance. The
window then calls ``train_steps_indices`` with further chunks until
``--seconds`` have passed, and ends in a synchronization;
``train_frames_per_s`` is B * T * (steps completed) over the window's
seconds. With ``--trace`` a slice of ``trace_chunks`` chunks, started
``trace_at`` of the way into the window, runs under the profiler; a slice
that lost kernel events is taken again at the next chunk, up to
``trace_tries`` times. What a whole slice holds is read in set-up: one
eager step under the profiler counts the ``gn_*`` and ``vq_*`` kernels a
step launches, which a step replayed from its CUDA graph launches too.

Once the window has closed and the peak memory is read, the trainer is
freed and the plain reference (``reference/vqvae.py``, float32) takes the
same weights and windows through the checked steps, and follows each
checked call's first steps from the state that call began with: two
trajectories drift apart within a few steps by rounding alone, so a
longer comparison could not tell a fault from a sound run.
"""

from __future__ import annotations

import gc
import math
import re
import time

import numpy as np
import torch

from .. import data, device_info, harness, yardstick
from ..reference import vqvae as ref

GN = re.compile(r"\bgn_")
VQ = re.compile(r"\bvq_")

# the faults a training cell can have (the exchange between chips is
# absent from every one-chip cell)
FAULTS = ("state_unchanged", "half_batch")


def _state(tr):
    """Every tensor of the trainer's training state: the flat parameters,
    Adam's moments and counts, each EMA codebook's buffers."""
    return [tr.flat, *(t for t in tr.opt_state if t is not None),
            *(t for q in tr.ema.values() for t in q.state())]


def fault(name):
    """A context that plants fault ``name`` under the timed path.

    ``state_unchanged``: each step writes the training state it began
    with back in place (``copy_``), so that the state stays frozen in an
    eager step and in a CUDA graph captured under the patch.
    ``half_batch``: each step takes the first half of its windows' rows.
    """
    from vae_npvc_tpu_torch.train.trainer import Trainer

    if name == "state_unchanged":
        def make(orig):
            def frozen(self, flat_g, new_ema, detail):
                before = [t.clone() for t in _state(self)]
                out = orig(self, flat_g, new_ema, detail)
                with torch.no_grad():
                    for t, b in zip(_state(self), before):
                        t.copy_(b)
                return out
            return frozen
        return harness.patched(Trainer, "_finish_step", make)
    if name == "half_batch":
        def make(orig):
            def half(self, idx, starts):
                x, s = orig(self, idx, starts)
                return x[:x.shape[0] // 2], s[:s.shape[0] // 2]
            return half
        return harness.patched(Trainer, "_gather", make)
    raise ValueError(f"unknown fault {name!r}")


def windows(rng, n_frames, n_steps, B, crop):
    """``(idx[n_steps, B], starts[n_steps, B])``: each step's rows from
    distinct utterances, each window uniform within its utterance."""
    n = len(n_frames)
    idx = np.stack([rng.permutation(n)[:B] for _ in range(n_steps)])
    hi = np.maximum(n_frames[idx] - crop, 0)
    starts = np.floor(rng.random(idx.shape) * (hi + 1)).astype(np.int64)
    return idx, np.minimum(starts, hi)


def leaf_norms(flat, layout):
    """``{name: ||leaf||}`` of a flat fp32 vector laid out as ``layout``."""
    out, off = {}, 0
    for name, shape in layout:
        n = math.prod(shape)
        out[name] = float(flat[off:off + n].norm())
        off += n
    return out


def norm_gap(got, want, names):
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(np.median([want[n] for n in names]))
    return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30)
               for n in names)


def program_side(recipe, weights, corpus, plan, seed, device):
    """The trainer with the benchmark's weights and staged corpus, taken
    through the checked steps, one call each, and then through the checked
    calls of ``steps_per_call`` steps. Returns (trainer, readings of the
    program)."""
    from vae_npvc_tpu_torch.train import build_trainer

    tr = build_trainer(recipe, device=device, seed=seed)
    tr.init_state()
    named = dict(tr.model.named_parameters())
    if {n: tuple(p.shape) for n, p in named.items()} != \
            {n: tuple(w.shape) for n, w in weights.items()}:
        raise RuntimeError("the reference's parameter layout differs from "
                           "the program's")
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(weights[n])
    tr.stage_dataset(corpus, recipe["batch_size"])
    idx, starts = plan["steps"]
    losses, grad1 = [], None
    b1 = recipe.get("betas", (0.5, 0.999))[0]
    for s in range(len(idx)):
        d = tr.train_steps_indices(idx[s:s + 1], starts[s:s + 1])
        losses.append(float(d["Total"][0]))
        if s == 0:
            grad1 = leaf_norms(tr.opt_state.mu / (1 - b1), tr.layout)
    change = leaf_norms(tr.flat - _flat(weights, tr.layout),
                        tr.layout)
    for name, q in tr.ema.items():
        change[f"{name}.emb"] = float(q.emb.norm())
    n, calls = plan["followed"], []
    for idx, starts in plan["calls"]:
        state = trainer_state(tr)
        d = tr.train_steps_indices(idx, starts)
        calls.append({"state": state,
                      "loss": d["Total"][:n].float().cpu().tolist(),
                      "grad_norm": d["grad_norm"][:n].float().cpu()
                      .tolist()})
    return tr, {"loss": losses, "grad1": grad1, "change": change,
                "calls": calls}


def _flat(weights, layout):
    return torch.cat([weights[n].reshape(-1) for n, _ in layout])


def _split(flat, layout):
    out, off = {}, 0
    for name, shape in layout:
        k = math.prod(shape)
        out[name] = flat[off:off + k].reshape(shape).detach().cpu().clone()
        off += k
    return out


def trainer_state(tr):
    """The trainer's training state on the host, in the form
    ``Reference.load_state`` takes."""
    if len(tr.ema) > 1:
        raise RuntimeError("the reference follows one EMA codebook")
    book = None
    for q in tr.ema.values():
        initted, *rest = q.state()
        book = (bool(initted), *(t.detach().cpu().clone() for t in rest))
    st = tr.opt_state
    return {"params": _split(tr.flat, tr.layout),
            "m": _split(st.mu, tr.layout), "v": _split(st.nu, tr.layout),
            "step": tr.iteration, "book": book}


def _steps(model, corpus, idx, starts):
    """The reference through one step a window: [(loss, the gradient's
    global norm, the clipped gradient by name)]."""
    feats, _, spk = corpus.padded_arrays()
    dev = feats.device
    frames = torch.arange(corpus.crop_length, device=dev)
    out = []
    for ii, ss in zip(torch.as_tensor(idx, device=dev),
                      torch.as_tensor(starts, device=dev)):
        x = feats[ii[:, None], ss[:, None] + frames]
        loss, grads = model.train_step(x, spk[ii].long())
        out.append((loss, model.grad_norm, grads))
    return out


def _first(model, corpus, plan, weights):
    """Loss per step, first gradient and change by leaf over the checked
    steps from the benchmark's weights."""
    steps = _steps(model, corpus, *plan["steps"])
    change = {n: float((model.P[n].detach() - weights[n]).norm())
              for n in model.names}
    if model.book is not None:
        change["quantizer.emb"] = float(model.book.emb.norm())
    return {"loss": [s[0] for s in steps],
            "grad1": {n: float(g.norm()) for n, g in steps[0][2].items()},
            "change": change}


def reference_side(recipe, weights, corpus, plan, seed, follow,
                   precision="fp32"):
    """The plain reference: the checked steps from the benchmark's
    weights, then the first ``followed`` steps of each checked call from
    the training state that call began with on the side it checks
    (``follow``: that side's ``calls``)."""
    def make():
        return ref.Reference(recipe, weights, seed, ref.Precision(precision))

    out = _first(make(), corpus, plan, weights)
    n, out["calls"] = plan["followed"], []
    for (idx, starts), got in zip(plan["calls"], follow):
        model = make()
        model.load_state(got["state"])
        steps = _steps(model, corpus, idx[:n], starts[:n])
        out["calls"].append({"loss": [s[0] for s in steps],
                             "grad_norm": [s[1] for s in steps]})
    return out


def reference_program(recipe, weights, corpus, plan, seed, precision):
    """The reference computed in ``precision`` in the program's place:
    readings in the form :func:`program_side` gives."""
    model = ref.Reference(recipe, weights, seed, ref.Precision(precision))
    got = _first(model, corpus, plan, weights)
    n, got["calls"] = plan["followed"], []
    for idx, starts in plan["calls"]:
        state = model.state()
        steps = _steps(model, corpus, idx, starts)
        got["calls"].append({"state": state,
                             "loss": [s[0] for s in steps[:n]],
                             "grad_norm": [s[1] for s in steps[:n]]})
    return got


def _rel(got, want):
    if len(got) != len(want) or not want:
        return None
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def compare(got, want):
    """The numbers the check holds to their limits."""
    loss = _rel(got["loss"], want["loss"])
    grad1 = norm_gap(got["grad1"], want["grad1"], list(want["grad1"]))
    # leaves whose reference gradient is nought to rounding (under a
    # thousandth of the median leaf's) move by round-off alone under Adam
    gmed = float(np.median(list(want["grad1"].values())))
    moved = [n for n in want["change"]
             if n not in want["grad1"] or want["grad1"][n] >= 1e-3 * gmed]
    change = norm_gap(got["change"], want["change"], moved)
    # the gradient norms of each checked call's followed steps; their
    # losses go to the log line only (a sound run's step-two loss gap
    # lies too near a frozen state's to be held)
    gaps = [_rel(g["grad_norm"], w["grad_norm"])
            for g, w in zip(got["calls"], want["calls"])]
    calls = (None if not gaps or None in gaps
             or len(gaps) != len(got["calls"]) else max(gaps))
    return {"loss_gap": loss, "grad1_gap": grad1, "change_gap": change,
            "call_grad_gap": calls}


def make_inputs(recipe, traffic, seed, device):
    """Weights, staged corpus and the host-chosen windows of a seed: the
    check's plan (``steps``: one window a step; ``calls``: one chunk of
    ``steps_per_call`` windows each; ``followed``: how many steps of each
    call the reference follows) and the window's chunks."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    weights = ref.init_weights(recipe, gen, device)
    D = recipe["encoder"]["in_channels"][0] if "encoder" in recipe \
        else recipe["encoder.0"]["in_channels"][0]
    feats, n_frames, spk = data.mel_corpus(
        gen, traffic["utterances"], traffic["frames"], D,
        recipe["y_num"], device)
    corpus = data.StagedCorpus(feats, n_frames, spk, recipe["crop_length"])
    rng = np.random.default_rng(seed % (1 << 63))
    nf = n_frames.cpu().numpy()
    B, T = recipe["batch_size"], recipe["crop_length"]
    K = recipe.get("steps_per_call", 1)
    plan = {"steps": windows(rng, nf, traffic["checked_steps"], B, T),
            "calls": [windows(rng, nf, K, B, T)
                      for _ in range(traffic["checked_calls"])],
            "followed": traffic["followed_steps"]}
    # the window's chunks: far more than any window completes, cycled
    chunks = [windows(rng, nf, K, B, T)
              for _ in range(traffic["window_chunks"])]
    return weights, corpus, plan, chunks


def control_readings(config, traffic, seed, device):
    """The reference computed in float8 in the program's place (the
    trainer has no other state to keep), held to the float32 reference as
    a run holds the program."""
    recipe = config["recipe"]
    weights, corpus, plan, _ = make_inputs(recipe, traffic, seed, device)
    got = reference_program(recipe, weights, corpus, plan, seed, "fp8")
    want = reference_side(recipe, weights, corpus, plan, seed,
                          got["calls"])
    return compare(got, want)


def _launches():
    """The program's counters of K1, K2 and K3 wrapper calls (an eager
    step's; none of a replayed one): ``tools/torch_span_breakdown.py``
    holds its slices to them."""
    from vae_npvc_tpu_torch.ops import groupnorm, vq_fused

    return {"gn": getattr(groupnorm.fused_group_norm, "launches", 0)
            + getattr(groupnorm.fused_group_norm_backward, "launches", 0),
            "vq": getattr(vq_fused.vq_fused, "launches", 0)}


def kernel_counts(sl):
    """The ``gn_*`` (K2, K3) and ``vq_*`` (K1) kernels of a traced slice."""
    return {"gn": len(sl.kernels(GN)), "vq": len(sl.kernels(VQ))}


def step_kernels(tr, window, tries):
    """:func:`kernel_counts` of one eager step on ``window`` (``(idx[1, B],
    starts[1, B])``), read on the device: what every step launches, also
    one replayed from its graph, which calls no kernel wrapper. A slice
    that lost a launch's kernel is taken again, up to ``tries`` times."""
    from vae_npvc_tpu_torch.train.trainer import Trainer

    from .. import trace as tracing

    with Trainer.eager_steps():
        for _ in range(tries):
            sl = tracing.traced(lambda: tr.train_steps_indices(*window))
            if not sl.lost:
                break
    return kernel_counts(sl)


def shortfall(sl, expected):
    """Why a traced slice is incomplete, or None: a launch with no kernel
    in the trace, or fewer ``gn_*``/``vq_*`` kernels than ``expected``
    (the slice's steps times :func:`step_kernels`)."""
    if sl.lost:
        return f"{sl.lost} of {sl.launched} launches without a kernel"
    for key, n in kernel_counts(sl).items():
        if n < expected[key]:
            return f"{n} {key} kernels for {expected[key]} expected"
    return None


def run(*, config, traffic, seed, seconds, trace, device, started, chips):
    from vae_npvc_tpu_torch.ops import _build

    recipe = config["recipe"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        _build.build_all()
    B, T = recipe["batch_size"], recipe["crop_length"]
    K = recipe.get("steps_per_call", 1)
    weights, corpus, plan, chunks = make_inputs(recipe, traffic, seed,
                                                device)
    tr, got = program_side(recipe, weights, corpus, plan, seed, device)
    if trace:
        from .. import trace as tracing

        tracing.warm()
        per_step = step_kernels(tr, tuple(a[:1] for a in chunks[0]),
                                traffic["trace_tries"])
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    host0 = device_info.host_counters()
    t0 = time.perf_counter()
    setup_s = time.time() - (started or time.time())
    steps, skipped, i = 0, [], 0
    sliced, tries, traces = None, 0, []
    traced_steps, traced_s = 0, 0.0
    marks = []      # host seconds into the window at each chunk's return

    def chunk():
        nonlocal i, steps
        d = tr.train_steps_indices(*chunks[i % len(chunks)])
        skipped.append(d["skipped_nonfinite"].sum())
        i += 1
        steps += K

    while time.perf_counter() - t0 < seconds:
        if trace and sliced is None and tries < traffic["trace_tries"] \
                and time.perf_counter() - t0 >= traffic["trace_at"] * seconds:
            n0, s0 = steps, time.perf_counter()
            sl = tracing.traced(
                lambda: [chunk() for _ in range(traffic["trace_chunks"])])
            tries += 1
            traced_steps += steps - n0
            traced_s += time.perf_counter() - s0
            expected = {k: v * (steps - n0) for k, v in per_step.items()}
            why = shortfall(sl, expected)
            traces.append({"launched": sl.launched, "lost": sl.lost,
                           "kernels": kernel_counts(sl),
                           "expected": expected, "retaken": why})
            if why is None:
                sliced, sliced_steps = sl, steps - n0
            continue
        chunk()
        marks.append(time.perf_counter() - t0)
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    host = device_info.counters_delta(host0, device_info.host_counters())
    failed = int(torch.stack(skipped).sum()) if skipped else 0
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    dev_info = device_info.describe(device, chips,
                                    max(setup_peak, peak_window)
                                    if cuda else 0)
    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    want = reference_side(recipe, weights, corpus, plan, seed,
                          got["calls"])
    reference_s = time.perf_counter() - r0
    readings = compare(got, want)
    rec = None
    if trace:
        if sliced is None:
            raise RuntimeError("no complete traced slice in the window: "
                               + "; ".join(t["retaken"] for t in traces)
                               if traces else "window too short")
        step = yardstick.vqvae_step(recipe, B, T)
        rec = {"slice": sliced, "steps": sliced_steps, "step": step,
               # the window outside the traced slices, where the tracer
               # adds no cost
               "untraced": (steps - traced_steps, window_s - traced_s),
               "itemsize": yardstick.ITEMSIZE[recipe.get("compute_dtype",
                                                         "float32")],
               "gn_pattern": GN, "vq_pattern": VQ,
               "peak_window_bytes": peak_window}
        dev_info.update(busy_s=sliced.busy_s, window_s=sliced.seconds)
    return {"end_to_end": {"train_frames_per_s": B * T * steps / window_s,
                           "setup_s": setup_s},
            "attempted": steps, "failed": failed, "device": dev_info,
            "rec": rec, "readings": readings,
            "log": {"window_s": window_s, "steps": steps,
                    # a slow process is slow all through its window
                    "chunks_by_quarter": np.histogram(
                        marks, 4, (0, max(marks, default=1)))[0].tolist(),
                    "host": host, "reference_s": reference_s,
                    # each checked call's followed steps, both sides
                    "calls": [{k: [g[k], w[k]] for k in ("loss",
                                                         "grad_norm")}
                              for g, w in zip(got["calls"],
                                              want["calls"])],
                    "traces": traces}}
