"""Training CLI.

Counterpart of ``vae_npvc_tpu/bin/train.py``: same flags, config keys, log
format, checkpoint naming (``iter.N``), ``metrics.jsonl``, ``best.json``
and best-model selection (``check_loss_kind`` -> copy to
``model.loss.best``), driving the port's trainer on the GPU (``--device
cpu`` for a CPU run). The config is a YAML file (or a ``.json`` file, for
hosts without a YAML parser).

The host loader's batches reach the device through
``data.dataset.prefetch_to_device`` (``prefetch_factor`` batches ahead).
``device_resident: true`` stages the corpus on the device: ``epoch``
sampling gathers the host loader's windows there, ``iid`` draws them there
(``Trainer.train_steps_device``); on the GPU those windowed steps are
replayed from a CUDA graph, and each log line gives the share of its
interval's steps that were. ``--profile_dir`` traces one log
interval with ``torch.profiler`` once two steps are done and writes a
Chrome trace into the directory, with the port's spans of that interval
(``utils/spans.py``: the trainer's phases, the kernels' wrappers) on the
same clock.

Under torchrun (``WORLD_SIZE`` in the environment, even 1) every process
joins the default group (NCCL on the GPU, gloo with ``--device cpu``,
``parallel/mesh.initialize_multihost``), takes the card ``LOCAL_RANK``
names, and trains data-parallel over a ``data`` mesh of all ranks: every
rank reads the same global batches and keeps its rows, and validation
gives each rank every ``WORLD_SIZE``-th batch. Only rank 0 writes the log,
``metrics.jsonl``, ``best.json`` and the checkpoints. The device-resident
corpus is staged whole on every rank, which draws the global batch's
windows as every other rank does and gathers its own rows; it is
single-host only (``LOCAL_WORLD_SIZE`` below ``WORLD_SIZE``: the host
loader), as the JAX CLI's is. ``bin/train_tts`` and ``bin/train_pwg``
start the same way (:func:`join_data_parallel`).

    torchrun --nproc_per_node 8 -m vae_npvc_tpu_torch.bin.train -c conf.yaml \
        --train_dir dump/train --output_dir exp/vqvae

Usage:
    python -m vae_npvc_tpu_torch.bin.train -c conf/train_vqvae.yaml \
        --train_dir dump/train --valid_dir dump/dev --output_dir exp/vqvae
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import time
from pathlib import Path
from shutil import copyfile

import numpy as np


def load_config(path):
    """A config dict from a YAML or ``.json`` file (a dict passes
    through)."""
    if isinstance(path, dict):
        return path
    with open(path) as f:
        if str(path).endswith(".json"):
            return json.load(f)
        import yaml

        return yaml.safe_load(f)


def chunk_size(i, steps_per_call, iters_per_log, iters_per_checkpoint,
               max_iter):
    """Largest K <= steps_per_call from completed-step count ``i`` that does
    not cross a log/checkpoint/max_iter boundary."""
    k = steps_per_call
    if k > 1:
        k = min(k, iters_per_log - i % iters_per_log,
                iters_per_checkpoint - i % iters_per_checkpoint,
                max_iter - i)
    return max(k, 1)


def pull_chunk(iterator, k):
    """Up to ``k`` items; shorter (possibly empty) when exhausted."""
    out = []
    try:
        for _ in range(k):
            out.append(next(iterator))
    except StopIteration:
        pass
    return out


def flat_mean_log(train_log):
    """Host means over accumulated detail values: entries are per-step
    scalars or (K,) per-chunk vectors on the device; flattening weighs
    every step equally. This is where a log window waits for the device."""
    import torch

    return {k: float(torch.cat([x.reshape(-1).float() for x in v]).mean())
            for k, v in train_log.items()}


def start_profiler(device):
    """A running ``torch.profiler`` of the host and, on a CUDA device, of
    the device's kernels; the span recorder on beside it."""
    from torch.profiler import ProfilerActivity, profile

    from ..utils import spans

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    spans.drain()
    prof.start()
    spans.enable(True)
    return prof


def stop_profiler(prof, device, profile_dir, iteration):
    """Wait for the device, stop ``prof`` and the span recorder and write
    the Chrome trace, with the spans as ``ph: "X"`` events on the
    profiler's clock, into ``profile_dir``; returns the trace's path."""
    import torch

    from ..utils import spans

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    spans.enable(False)
    prof.stop()
    path = Path(profile_dir) / f"trace_iter{iteration}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    trace["traceEvents"] += spans.chrome_events(
        spans.drain()["spans"], trace.get("baseTimeNanoseconds", 0),
        os.getpid())
    path.write_text(json.dumps(trace))
    return path


def get_logger(output_dir, writes=True):
    """The run's logger: to the console and ``train.log``, or, on a rank
    that does not write, warnings to the console only."""
    logger = logging.getLogger("vae_npvc_tpu_torch.train")
    logger.setLevel(logging.INFO if writes else logging.WARNING)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(message)s",
                            datefmt="%m-%d %H:%M:%S")
    handlers = [logging.StreamHandler()]
    if writes:
        handlers.append(
            logging.FileHandler(str(Path(output_dir) / "train.log")))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def join_data_parallel(device):
    """Under torchrun (``WORLD_SIZE`` in the environment, even 1): join the
    default process group (NCCL for a CUDA ``device``, gloo for the CPU),
    take the card ``LOCAL_RANK`` names and build a ``data`` mesh of every
    rank. Returns ``(device, mesh, rank, world, joined)``; ``joined`` says
    whether this call created the group (the caller then destroys it).
    Outside torchrun: ``(device, None, 0, 1, False)``."""
    if "WORLD_SIZE" not in os.environ:
        return device, None, 0, 1, False
    import torch.distributed as dist

    from ..parallel import mesh as mesh_mod

    cuda = not str(device).startswith("cpu")
    if cuda:
        device = mesh_mod.local_cuda_device()
        import torch

        torch.cuda.set_device(device)
    joined = not dist.is_initialized()
    rank, world = mesh_mod.initialize_multihost(
        backend="nccl" if cuda else "gloo")
    return device, mesh_mod.make_mesh(), rank, world, joined


def leave_data_parallel(joined):
    """Destroy the default group if :func:`join_data_parallel` made it."""
    if joined:
        import torch.distributed as dist

        dist.destroy_process_group()


def train(args):
    from ..data.dataset import (UttMelSpkDataset, batch_iterator,
                                index_iterator, prefetch_to_device)
    from ..train import build_trainer

    config = load_config(args.config)

    max_iter = config.get("max_iter", 100000)
    iters_per_checkpoint = config.get("iters_per_checkpoint", 10000)
    iters_per_log = config.get("iters_per_log", 1000)
    check_loss_kind = config.get("check_loss_kind", "X like")
    num_jobs = config.get("num_jobs", 8)
    prefetch_factor = config.get("prefetch_factor", 2)
    seed = config.get("seed", 777)

    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    device, mesh, rank, world, joined = join_data_parallel(args.device)
    writes = rank == 0
    logger = get_logger(output_dir, writes)
    if mesh is not None:
        logger.info(f"Rank {rank} of {world}: data-parallel over {mesh}")
    trainer = (build_trainer(config, device=device, mesh=mesh)
               if mesh is not None else build_trainer(config, device=device))

    train_batch = config.get("train_batch_size", config.get("batch_size", 32))
    valid_batch = config.get("valid_batch_size", config.get("batch_size", 1))
    train_set = UttMelSpkDataset(args.train_dir, config)

    # device-resident corpus (opt-in): stage every utterance on the device
    # once. "epoch" sampling gathers the host loader's exact
    # epoch-permutation + crop windows there (data.dataset.index_iterator
    # is the single source of both), so only indices cross to the device
    # per step; "iid" draws utterances and crops on the device
    use_dev = bool(config.get("device_resident", False))
    dev_sampling = config.get("device_resident_sampling", "epoch")
    if dev_sampling not in ("epoch", "iid"):
        raise ValueError(
            f"device_resident_sampling must be 'epoch' or 'iid', got "
            f"{dev_sampling!r}")
    # the GAN trainer's per-iteration phase schedule runs single steps
    # from the host loader (the JAX CLI's fallback)
    sequential = not getattr(trainer, "supports_steps_per_call", False)
    if use_dev and sequential:
        logger.warning("device_resident is not supported by this trainer; "
                       "using the host loader")
        use_dev = False
    if use_dev and world > int(os.environ.get("LOCAL_WORLD_SIZE", world)):
        logger.warning("device_resident is single-host only; "
                       "using the host loader")
        use_dev = False
    if use_dev:
        limit = config.get("device_resident_limit_bytes", 4 << 30)
        need = train_set.padded_nbytes()
        if need > limit:
            logger.warning(
                f"device_resident corpus would need {need / 1e9:.1f} GB "
                f"> limit {limit / 1e9:.1f} GB; using the host loader")
            use_dev = False

    train_iter = () if use_dev else prefetch_to_device(
        batch_iterator(train_set, train_batch, shuffle=True, drop_last=True,
                       seed=seed, num_workers=num_jobs),
        size=prefetch_factor, device=trainer.device)

    valid_set = None
    if args.valid_dir:
        try:
            valid_set = UttMelSpkDataset(args.valid_dir, config, valid=True)
        except FileNotFoundError:
            valid_set = None

    def valid_batches():
        it = batch_iterator(valid_set, valid_batch, shuffle=False,
                            drop_last=False, num_workers=num_jobs, epochs=1)
        # several ranks: each takes every world-th batch as its own stream
        # (Trainer.valid assembles the global batches)
        return itertools.islice(it, rank, None, world) if world > 1 else it

    # initialize / resume
    trainer.init_state()
    iteration = 1
    ckpt = args.checkpoint
    if ckpt == "auto":
        # preemption recovery: resume from the newest iter.N in output_dir
        cands = sorted(output_dir.glob("iter.*"),
                       key=lambda p: int(p.name.split(".")[1]))
        ckpt = str(cands[-1]) if cands else None
    if ckpt:
        iteration = trainer.load_checkpoint(ckpt) + 1
        logger.info(f"Resumed from {ckpt} at iteration {iteration}")
        # drop metrics rows from beyond the resume point: those windows
        # replay with different values, and the machine-readable file must
        # not carry conflicting duplicate iters
        mfile = output_dir / "metrics.jsonl"
        if writes and mfile.exists():
            kept = [ln for ln in mfile.read_text().splitlines()
                    if ln.strip()
                    and json.loads(ln).get("iter", 0) < iteration]
            mfile.write_text("".join(ln + "\n" for ln in kept))

    logger.info(trainer.get_model_info())
    logger.info(f"Output directory: {output_dir}")
    logger.info(f"Training utterances: {len(train_set)}")
    logger.info(f"Validation utterances: "
                f"{len(valid_set) if valid_set else 0}")
    logger.info("Start training...")

    train_log: dict[str, list] = {}
    best_loss = {check_loss_kind: np.inf}
    best_iter = 0
    # best-so-far survives preemption resumes via a sidecar
    best_file = output_dir / "best.json"
    if ckpt and best_file.exists():
        try:
            prev = json.loads(best_file.read_text())
            if (prev.get("check_loss_kind") == check_loss_kind
                    and prev.get("iteration", 0) < iteration
                    and (output_dir / f"iter.{prev['iteration']}").exists()):
                best_iter = int(prev["iteration"])
                best_loss = {k: float(v) for k, v in prev["loss"].items()}
                logger.info(f"Best-so-far restored: iteration {best_iter} "
                            f"({check_loss_kind}: "
                            f"{best_loss[check_loss_kind]:.6f})")
        except (ValueError, KeyError, TypeError):
            logger.warning(f"Could not parse {best_file}; best tracking "
                           "restarts from this run")
    t_log = time.time()
    # steps replayed from a captured CUDA graph (train/trainer.py)
    replayed = getattr(type(trainer), "graph_replays", 0)
    frames_per_batch = train_batch * train_set.crop_length

    profile_dir = getattr(args, "profile_dir", None)
    profiler = None

    # K optimizer steps per trainer call; chunks never cross a
    # log/checkpoint/max_iter boundary, so the logging cadence and the
    # checkpoint contents do not depend on K
    steps_per_call = max(1, int(config.get("steps_per_call", 1)))
    if steps_per_call > 1 and sequential:
        logger.warning("steps_per_call > 1 is not supported by this "
                       "trainer; using 1")
        steps_per_call = 1

    if iteration > max_iter:
        # a finished run re-invoked (e.g. --checkpoint auto after
        # completion) must be a no-op, not train one extra step
        logger.info(f"Resumed at iteration {iteration} > max_iter "
                    f"{max_iter}; nothing to train")
        train_iter = ()
        use_dev = False
    idx_it = None
    if use_dev:
        nbytes = trainer.stage_dataset(train_set, train_batch)
        logger.info(f"Device-resident corpus: {nbytes / 1e6:.0f} MB staged "
                    f"on {trainer.device}; crops gathered on the device "
                    f"({dev_sampling} sampling)")
        if dev_sampling == "epoch":
            idx_it = index_iterator(train_set, train_batch, shuffle=True,
                                    drop_last=True, seed=seed)
    train_it = iter(train_iter)
    running = True
    while running:
        i = trainer.iteration
        if i >= max_iter:
            break
        if profile_dir and profiler is None and i >= 2:
            # past the first steps (lazy init, cuDNN's algorithm search),
            # trace one log interval
            profiler = start_profiler(trainer.device)
        K = chunk_size(i, steps_per_call, iters_per_log,
                       iters_per_checkpoint, max_iter)
        if idx_it is not None:
            pairs = pull_chunk(idx_it, K)   # infinite iterator: always K
            detail = trainer.train_steps_indices(
                np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))
        elif use_dev:
            detail = trainer.train_steps_device(K)
        else:
            batches = pull_chunk(train_it, K)
            if len(batches) < K:
                running = False
            if not batches:
                break
            detail = trainer.train_steps(batches)
        iteration = trainer.iteration
        if profiler is not None and profile_dir and (
                iteration >= 2 + iters_per_log or iteration >= max_iter):
            path = stop_profiler(profiler, trainer.device, profile_dir,
                                 iteration)
            logger.info(f"Saved profiler trace to {path}")
            profile_dir = None
        for k, v in detail.items():
            train_log.setdefault(k, []).append(v)

        if iteration % iters_per_log == 0 and train_log:
            host_log = flat_mean_log(train_log)
            dt = time.time() - t_log
            fps = iters_per_log * frames_per_batch / dt
            mseg = f"Iter {iteration}:"
            for k, v in host_log.items():
                mseg += f"  {k}: {v:.6f}"
            mseg += f"  |  {fps:,.0f} frames/s"
            now = getattr(type(trainer), "graph_replays", 0)
            mseg += (f"  |  {(now - replayed) / iters_per_log:.0%} of steps "
                     "replayed")
            replayed = now
            logger.info(mseg)
            with open(output_dir / "metrics.jsonl" if writes
                      else os.devnull, "a") as mf:
                mf.write(json.dumps(
                    {"iter": int(iteration), "split": "train",
                     "frames_per_sec": round(float(fps), 1),
                     **{k: float(v) for k, v in host_log.items()}}) + "\n")
            train_log = {}
            t_log = time.time()

        if iteration % iters_per_checkpoint == 0:
            ckpt = output_dir / f"iter.{iteration}"
            trainer.save_checkpoint(ckpt)
            logger.info(f"Saved checkpoint to {ckpt}")

            if valid_set:
                loss_detail = trainer.valid(valid_batches())
                check = np.mean(loss_detail[check_loss_kind])
                if np.mean(best_loss[check_loss_kind]) >= check:
                    best_loss = {k: float(np.mean(v))
                                 for k, v in loss_detail.items()}
                    best_iter = iteration
                    if writes:
                        best_file.write_text(json.dumps(
                            {"iteration": best_iter,
                             "check_loss_kind": check_loss_kind,
                             "loss": best_loss}, indent=1))
                mseg = f"Valid {iteration}:"
                for k, v in loss_detail.items():
                    mseg += f"  {k}: {np.mean(v):.6f}"
                mseg += (f"  |  Best {best_iter}:  {check_loss_kind}: "
                         f"{np.mean(best_loss[check_loss_kind]):.6f}")
                logger.info(mseg)
                with open(output_dir / "metrics.jsonl" if writes
                          else os.devnull, "a") as mf:
                    mf.write(json.dumps(
                        {"iter": int(iteration), "split": "valid",
                         "best_iter": int(best_iter),
                         **{k: float(np.mean(v))
                            for k, v in loss_detail.items()}}) + "\n")
            t_log = time.time()

        if iteration >= max_iter:
            break

    if hasattr(train_it, "close"):
        train_it.close()      # stops the prefetch thread
    if best_iter > 0:
        if writes:
            copyfile(str(output_dir / f"iter.{best_iter}"),
                     str(output_dir / "model.loss.best"))
        logger.info(f"Best model: iteration {best_iter} "
                    f"({check_loss_kind}: "
                    f"{np.mean(best_loss[check_loss_kind]):.6f})")
    else:
        # no validation set: the final state is the best we know of (a
        # no-op rerun must point at the existing final checkpoint)
        final = output_dir / f"iter.{trainer.iteration}"
        need = not final.exists()
        if mesh is not None:
            # every rank decides before rank 0 may write it
            from ..parallel import comm

            comm.barrier()
        if need:
            trainer.save_checkpoint(final)
        if writes:
            copyfile(str(final), str(output_dir / "model.loss.best"))
        logger.info(f"No validation set; model.loss.best = iteration "
                    f"{trainer.iteration}")
    logger.info("Finished")
    leave_data_parallel(joined)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a VQ-VAE (PyTorch, GPU)")
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="YAML (or .json) experiment config")
    parser.add_argument("--output_dir", type=str, required=True,
                        help="Directory for checkpoint output")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="checkpoint path to keep training, or 'auto' to "
                             "resume from the newest iter.N in output_dir")
    parser.add_argument("--train_dir", type=str, required=True,
                        help="Training data dir")
    parser.add_argument("--valid_dir", type=str, default=None,
                        help="Validation data dir")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace of the "
                             "first log interval after two steps into this "
                             "directory")
    train(parser.parse_args(argv))


if __name__ == "__main__":
    main()
