"""Convert a reference PyTorch checkpoint to the msgpack checkpoint format.

Counterpart of ``vae_npvc_tpu/bin/convert_checkpoint.py``; runs on the
host (no device). Usage::

    python -m vae_npvc_tpu_torch.bin.convert_checkpoint -c conf/train.json \\
        reference_ckpt/model.loss.best converted/model.loss.best

The config is a YAML or ``.json`` experiment file (``bin/train.load_config``).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("torch_ckpt", type=str)
    parser.add_argument("out_path", type=str)
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="the experiment YAML or .json (same keys both "
                             "frameworks)")
    args = parser.parse_args(argv)

    from ..utils.torch_convert import convert_checkpoint_file
    from .train import load_config

    it = convert_checkpoint_file(args.torch_ckpt, load_config(args.config),
                                 args.out_path)
    print(f"Converted {args.torch_ckpt} (iteration {it}) -> {args.out_path}")


if __name__ == "__main__":
    main()
