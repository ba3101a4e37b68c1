"""Token-to-mel synthesizer training CLI (the second stage).

Counterpart of ``vae_npvc_tpu/bin/train_tts.py``: same flags, config keys,
log lines, checkpoint naming (``iter.N``), ``best.json`` and best-model
selection (``check_loss_kind`` -> copy to ``model.loss.best``), resume and
boundary-safe chunking, driving ``models/token_tts.py`` through the port's
trainer on the token-mel data contract (``data/token_mel.py``) on the GPU
(``--device cpu`` for a CPU run). The config is a YAML file (or a ``.json``
file, for hosts without a YAML parser).

Under torchrun every process joins one group and trains data-parallel
(``bin/train.py`` ``join_data_parallel``; the JAX CLI's trainer spreads
over every local chip): every rank reads the same global batches and
keeps its rows, validation gives each rank every ``WORLD_SIZE``-th batch,
and only rank 0 writes the log, ``best.json`` and the checkpoints.

    torchrun --nproc_per_node 8 -m vae_npvc_tpu_torch.bin.train_tts \
        -c conf/train_token_tts.yaml --train_dir data/token_mel_train \
        --output_dir exp/token_tts

Usage:
    python -m vae_npvc_tpu_torch.bin.train_tts -c conf/train_token_tts.yaml \
        --train_dir data/token_mel_train --valid_dir data/token_mel_dev \
        --output_dir exp/token_tts
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from pathlib import Path
from shutil import copyfile

import numpy as np

from .train import (chunk_size, flat_mean_log, get_logger,
                    join_data_parallel, leave_data_parallel, load_config,
                    pull_chunk)


def train(args):
    from ..data.token_mel import TokenMelDataset
    from ..train import build_trainer

    config = load_config(args.config)
    max_iter = config.get("max_iter", 100000)
    iters_per_checkpoint = config.get("iters_per_checkpoint", 10000)
    iters_per_log = config.get("iters_per_log", 1000)
    check_loss_kind = config.get("check_loss_kind", "X like")
    seed = config.get("seed", 777)
    batch_size = config.get("batch_size", 32)

    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    device, mesh, rank, world, joined = join_data_parallel(args.device)
    writes = rank == 0
    logger = get_logger(output_dir, writes)
    if mesh is not None:
        logger.info(f"Rank {rank} of {world}: data-parallel over {mesh}")
        trainer = build_trainer(config, device=device, mesh=mesh)
    else:
        trainer = build_trainer(config, device=device)
    train_set = TokenMelDataset(args.train_dir, config)
    valid_set = (TokenMelDataset(args.valid_dir, config, valid=True)
                 if args.valid_dir else None)

    def valid_batches():
        it = valid_set.batches(batch_size, shuffle=False, epochs=1)
        # several ranks: each takes every world-th batch as its own stream
        # (Trainer.valid assembles the global batches)
        return itertools.islice(it, rank, None, world) if world > 1 else it

    trainer.init_state()
    iteration = 1
    if args.checkpoint:
        iteration = trainer.load_checkpoint(args.checkpoint) + 1
        logger.info(f"Resumed from {args.checkpoint} at iteration {iteration}")

    logger.info(trainer.get_model_info())
    logger.info(f"Training utterances: {len(train_set)}; "
                f"validation: {len(valid_set) if valid_set else 0}")
    logger.info("Start training...")

    train_log: dict[str, list] = {}
    best_loss = {check_loss_kind: np.inf}
    best_iter = 0
    # best-so-far survives preemption resumes, like bin/train.py's sidecar
    best_file = output_dir / "best.json"
    if args.checkpoint and best_file.exists():
        try:
            prev = json.loads(best_file.read_text())
            if (prev.get("check_loss_kind") == check_loss_kind
                    and prev.get("iteration", 0) < iteration
                    and (output_dir / f"iter.{prev['iteration']}").exists()):
                best_iter = int(prev["iteration"])
                best_loss = {k: float(v) for k, v in prev["loss"].items()}
                logger.info(f"Best-so-far restored: iteration {best_iter}")
        except (ValueError, KeyError, TypeError):
            logger.warning(f"could not parse {best_file}; best restarts")
    t_log = time.time()

    # K optimizer steps per trainer call; chunks never cross a
    # log/checkpoint/max_iter boundary (the helpers of bin/train.py)
    steps_per_call = max(1, int(config.get("steps_per_call", 1)))

    batches = (train_set.batches(batch_size, shuffle=True, seed=seed)
               if iteration <= max_iter else ())  # finished run reruns as no-op
    train_it = iter(batches)
    running = True
    while running:
        i = trainer.iteration
        if i >= max_iter:
            break
        K = chunk_size(i, steps_per_call, iters_per_log,
                       iters_per_checkpoint, max_iter)
        chunk = pull_chunk(train_it, K)
        if len(chunk) < K:
            running = False
        if not chunk:
            break
        detail = (trainer.train_step(chunk[0]) if len(chunk) == 1
                  else trainer.train_steps(chunk))
        iteration = trainer.iteration
        for k, v in detail.items():
            train_log.setdefault(k, []).append(v)

        if iteration % iters_per_log == 0 and train_log:
            host = flat_mean_log(train_log)
            mseg = f"Iter {iteration}:" + "".join(
                f"  {k}: {v:.6f}" for k, v in host.items())
            mseg += f"  |  {time.time() - t_log:.1f}s"
            logger.info(mseg)
            train_log = {}
            t_log = time.time()

        if iteration % iters_per_checkpoint == 0:
            ckpt = output_dir / f"iter.{iteration}"
            trainer.save_checkpoint(ckpt)
            logger.info(f"Saved checkpoint to {ckpt}")
            if valid_set:
                detail = trainer.valid(valid_batches())
                check = np.mean(detail[check_loss_kind])
                if np.mean(best_loss[check_loss_kind]) >= check:
                    best_loss = {k: float(np.mean(v))
                                 for k, v in detail.items()}
                    best_iter = iteration
                    if writes:
                        best_file.write_text(json.dumps(
                            {"iteration": best_iter,
                             "check_loss_kind": check_loss_kind,
                             "loss": best_loss}, indent=1))
                logger.info(f"Valid {iteration}:" + "".join(
                    f"  {k}: {np.mean(v):.6f}" for k, v in detail.items()))
            t_log = time.time()

        if iteration >= max_iter:
            break

    if best_iter > 0:
        if writes:
            copyfile(str(output_dir / f"iter.{best_iter}"),
                     str(output_dir / "model.loss.best"))
        logger.info(f"Best model: iteration {best_iter}")
    else:
        # no validation set: the final state is the best we know of
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
        description="Train the token->mel synthesizer (PyTorch, GPU)")
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--train_dir", type=str, required=True)
    parser.add_argument("--valid_dir", type=str, default=None)
    parser.add_argument("--device", default="cuda")
    train(parser.parse_args(argv))


if __name__ == "__main__":
    main()
