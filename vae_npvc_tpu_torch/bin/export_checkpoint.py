"""Export a msgpack checkpoint to the reference PyTorch toolkit's format.

Counterpart of ``vae_npvc_tpu/bin/export_checkpoint.py``, the inverse of
``bin/convert_checkpoint``; runs on the host (no device). The reference's
``--checkpoint`` resume path loads the file it writes. Usage::

    python -m vae_npvc_tpu_torch.bin.export_checkpoint \\
        exp/.../model.loss.best -c conf/train.json -o model.loss.best.pt
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export a msgpack checkpoint to reference torch format")
    parser.add_argument("our_ckpt", type=str)
    parser.add_argument("-c", "--config", required=True,
                        help="experiment YAML or .json (reference flat key "
                             "set)")
    parser.add_argument("-o", "--out_path", required=True)
    args = parser.parse_args(argv)

    from ..utils.torch_export import export_checkpoint_file
    from .train import load_config

    it = export_checkpoint_file(args.our_ckpt, load_config(args.config),
                                args.out_path)
    print(f"Exported {args.our_ckpt} (iteration {it}) -> {args.out_path}")


if __name__ == "__main__":
    main()
