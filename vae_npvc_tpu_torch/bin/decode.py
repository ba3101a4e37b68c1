"""Conversion CLI: Kaldi trials (or every utterance, ``--all-targets``) ->
converted mel arks.

Counterpart of ``vae_npvc_tpu/bin/decode.py``: same flags and outputs
(``feats.ark`` + ``feats.scp`` with Kaldi compression method 1, and
``decode.log`` in ``--output-dir``), running ``infer/convert.Converter`` on
the GPU (``--device cpu`` for a CPU run). The config is a YAML file (or a
``.json`` file, for hosts without a YAML parser).

Usage:
    python -m vae_npvc_tpu_torch.bin.decode -c conf/train_vqvae.json \
        --checkpoint exp/vqvae/model.loss.best \
        --decode-dir dump/eval --output-dir exp/vqvae/decode
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from .train import load_config


def decode(args):
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    logger = logging.getLogger("vae_npvc_tpu_torch.convert")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(message)s",
                            datefmt="%m-%d %H:%M:%S")
    for h in (logging.StreamHandler(),
              logging.FileHandler(str(output_dir / "decode.log"))):
        h.setFormatter(fmt)
        logger.addHandler(h)
    try:
        config = load_config(args.config)

        from ..infer.convert import Converter

        # the reference's decoder_type dispatch; the basic any-to-many
        # decoder is the only one shipped
        decoder_type = config.get("decoder_type", "vae_npvc.decoder.basic")
        if decoder_type.split(":")[0] not in (
                "vae_npvc.decoder.basic", "basic", "converter"):
            raise KeyError(f"unknown decoder_type {decoder_type!r}")
        converter = Converter(config, device=args.device)
        it = converter.load_checkpoint(args.checkpoint)
        logger.info(f"Decoding dataset: {args.decode_dir}")
        logger.info(f"Decoding model: {args.checkpoint} (iteration {it})")
        logger.info("Start decoding...")
        if args.all_targets:
            targets = args.all_targets.split(",")
            n = converter.sweep(args.decode_dir, output_dir, targets)
            logger.info(f"Finished sweep ({n} conversions)")
        else:
            n = converter.decode(args.decode_dir, output_dir)
            logger.info(f"Finished ({n} utterances)")
        return n
    finally:
        for h in list(logger.handlers):
            h.close()
            logger.removeHandler(h)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert Kaldi trials with a checkpoint (PyTorch, GPU)")
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="YAML or .json experiment config")
    parser.add_argument("--output-dir", "--output_dir", dest="output_dir",
                        type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--decode-dir", "--decode_dir", dest="decode_dir",
                        type=str, required=True)
    parser.add_argument("-g", "--gpu", type=str, default=None,
                        help="ignored (use --device)")
    parser.add_argument("--all-targets", "--all_targets", dest="all_targets",
                        type=str, default=None,
                        help="comma-separated target speakers: convert EVERY "
                             "utterance in feats.scp to every listed target "
                             "(no trials file needed)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, or cpu for a CPU run)")
    return decode(parser.parse_args(argv))


if __name__ == "__main__":
    main()
