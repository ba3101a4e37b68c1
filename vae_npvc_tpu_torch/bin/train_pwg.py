"""Neural-vocoder (Parallel WaveGAN) training CLI.

Counterpart of ``vae_npvc_tpu/bin/train_pwg.py``: trains the native vocoder
(``models/pwg.py``, ``train/pwg.py``) on a Kaldi data dir's ``wav.scp``,
with the log-mel extracted by the experiment's fbank parameters, on the GPU
(``--device cpu`` for a CPU run). Same config keys and log lines, resumes
from the newest ``iter.N`` of the output dir when no ``--checkpoint`` is
given, and leaves ``model.final`` of a finished run unchanged. The config
is a YAML file (or a ``.json`` file, for hosts without a YAML parser).

``device_resident`` (``auto``, the default, ``true`` or ``false``) stages
the whole corpus on the device and draws the crops there
(``PwgTrainer.stage_dataset``); ``auto`` does so when the corpus is
preloaded and its padded arrays are smaller than
``device_resident_limit_bytes`` (4 GiB).

Under torchrun every process joins one group and trains data-parallel
(``bin/train.py`` ``join_data_parallel``; the JAX CLI's trainer spreads
over every local chip): every rank draws the same global batches (host
or device-resident) and keeps its rows, and only rank 0 writes the log
and the checkpoints.

    torchrun --nproc_per_node 8 -m vae_npvc_tpu_torch.bin.train_pwg \
        -c conf/train_jpwg.yaml --train_dir data/train --output_dir exp/jpwg

Usage:
    python -m vae_npvc_tpu_torch.bin.train_pwg -c conf/train_jpwg.yaml \
        --train_dir data/train --output_dir exp/jpwg
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from .train import (flat_mean_log, get_logger, join_data_parallel,
                    leave_data_parallel, load_config)


def train(args):
    from ..data.wav_mel import WavMelDataset
    from ..train.pwg import PwgTrainer

    config = load_config(args.config)
    max_iter = config.get("max_iter", 100000)
    iters_per_checkpoint = config.get("iters_per_checkpoint", 10000)
    iters_per_log = config.get("iters_per_log", 500)
    batch_size = config.get("batch_size", 8)

    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    device, mesh, rank, world, joined = join_data_parallel(args.device)
    logger = get_logger(output_dir, rank == 0)
    if mesh is not None:
        logger.info(f"Rank {rank} of {world}: data-parallel over {mesh}")

    dataset = WavMelDataset(args.train_dir, config)
    logger.info(f"PWG vocoder training: {len(dataset)} utterances, "
                f"segment {dataset.max_frames} frames x hop {dataset.hop}")

    trainer = PwgTrainer(config, device=device, mesh=mesh)
    batches = dataset.batches(batch_size, seed=config.get("seed", 777))
    # the first batch is the JAX trainer's init example: not trained on
    trainer.init_state(next(batches))

    # with no --checkpoint, resume from the newest iter.N of the output dir
    ckpt = args.checkpoint
    if not ckpt:
        iters = sorted(output_dir.glob("iter.*"),
                       key=lambda p: int(p.name.split(".")[1]))
        if iters:
            ckpt = str(iters[-1])
    iteration = 0
    if ckpt:
        iteration = trainer.load_checkpoint(ckpt)
        logger.info(f"Resumed from {ckpt} (iteration {iteration})")

    steps_per_call = max(1, config.get("steps_per_call", 1))

    dev_res = config.get("device_resident", "auto")
    want_dev = dev_res in ("auto", True, "true")
    use_dev = dataset.preload and want_dev
    if want_dev and not dataset.preload:
        logger.warning("device_resident requested but the corpus exceeds "
                       "preload_limit (lazy mode) — falling back to the "
                       "host-dispatch path")
    if use_dev and dev_res == "auto":
        use_dev = (dataset.padded_nbytes()
                   < config.get("device_resident_limit_bytes", 4 << 30))
    if use_dev:
        nbytes = trainer.stage_dataset(dataset, batch_size)
        logger.info(f"Device-resident corpus: {nbytes / 1e6:.0f} MB staged "
                    f"to the device; crops drawn there")

    if iteration >= max_iter:
        # a finished run invoked again: model.final stays as it is
        logger.info(f"Already at iteration {iteration} >= max_iter "
                    f"{max_iter}; nothing to do")
        need = not (output_dir / "model.final").exists()
        if mesh is not None:
            # every rank decides before rank 0 may write it
            from ..parallel import comm

            comm.barrier()
        if need:
            trainer.save_checkpoint(output_dir / "model.final")
        leave_data_parallel(joined)
        return

    running: dict = {}
    t0 = time.time()
    while iteration < max_iter:
        K = min(steps_per_call, max_iter - iteration)
        if use_dev:
            detail = trainer.train_steps_device(K)
        else:
            detail = trainer.train_steps([next(batches) for _ in range(K)])
        for k, v in detail.items():
            running.setdefault(k, []).append(v)
        logged = iteration // iters_per_log
        saved = iteration // iters_per_checkpoint
        iteration += K
        if iteration // iters_per_log > logged:
            host = flat_mean_log(running)
            running.clear()
            msg = "  ".join(f"{k}: {v:.6f}" for k, v in sorted(host.items()))
            logger.info(f"Iter {iteration}:  {msg}  |  "
                        f"{time.time() - t0:.1f}s")
            t0 = time.time()
        if iteration // iters_per_checkpoint > saved:
            path = output_dir / f"iter.{iteration}"
            trainer.save_checkpoint(path)
            logger.info(f"Saved checkpoint to {path}")
    trainer.save_checkpoint(output_dir / "model.final")
    logger.info("Finished")
    leave_data_parallel(joined)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train the native Parallel WaveGAN vocoder")
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("--train_dir", type=str, required=True,
                        help="Kaldi data dir (or wav.scp) with the training "
                             "waveforms")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    train(parser.parse_args(argv))


if __name__ == "__main__":
    main()
