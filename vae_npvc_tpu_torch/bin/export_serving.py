"""Export a trained checkpoint into a self-contained serving bundle.

Counterpart of ``vae_npvc_tpu/bin/export_serving.py`` with the same flags,
except that ``--platforms`` is ``--device`` (default ``cuda``): the device
the model is built on and the programs are traced for. The bundle
(``torch.export`` programs per bucket + params + metadata,
``infer/export_serving.py``) runs conversion with torch and the port's
operators only.

Usage:
    python -m vae_npvc_tpu_torch.bin.export_serving -c conf/train.yaml \\
        -m exp/.../model.loss.best -o exp/.../serving_bundle \\
        --max_frames 2048 [--spk2spk_id dump/train/spk2spk_id]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export a checkpoint as a torch.export serving bundle")
    parser.add_argument("-c", "--config", required=True,
                        help="experiment YAML or .json (flat key set)")
    parser.add_argument("-m", "--checkpoint", required=True)
    parser.add_argument("-o", "--out_dir", required=True)
    parser.add_argument("--buckets", type=str, default=None,
                        help="comma-separated padded lengths (default: "
                             "multiples of decode_bucket_size to max_frames)")
    parser.add_argument("--max_frames", type=int, default=2048)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="default: the config's decode_batch_size")
    parser.add_argument("--n_targets", type=int, default=1,
                        help="targets per trials line baked into the "
                             "programs (hierarchical per-level speakers)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="device the programs are exported on")
    parser.add_argument("--quantize", choices=("int8",), default=None,
                        help="weight-only int8 params (~4x smaller bundle; "
                             "loader dequantizes, programs unchanged)")
    parser.add_argument("--quantize_min_size", type=int, default=4096,
                        help="float leaves below this element count stay "
                             "fp32 (norm scales, biases, small codebooks)")
    parser.add_argument("--spk2spk_id", type=str, default=None,
                        help="speaker-map file to embed (name id per line)")
    args = parser.parse_args(argv)

    from ..infer.export_serving import export_bundle
    from .train import load_config

    spk_map = None
    if args.spk2spk_id:
        from ..data import kaldi_io
        spk_map = {k: int(v) for k, v in
                   kaldi_io.load_dict_data(args.spk2spk_id).items()}
    buckets = ([int(t) for t in args.buckets.split(",")]
               if args.buckets else None)
    meta = export_bundle(
        load_config(args.config), args.checkpoint, args.out_dir,
        buckets=buckets, max_frames=args.max_frames,
        batch_size=args.batch_size, n_targets=args.n_targets,
        device=args.device, spk2spk_id=spk_map, quantize=args.quantize,
        quantize_min_size=args.quantize_min_size)
    print(f"Exported bundle -> {args.out_dir}: buckets={meta['buckets']}, "
          f"batch={meta['batch_size']}, device={meta['device']}")
    return meta


if __name__ == "__main__":
    main()
