"""CMVN CLIs: compute stats, apply (dump) and reverse (de-normalize).

Counterpart of ``vae_npvc_tpu/bin/apply_cmvn.py``: the same subcommands,
flags and files; the stats arks are Kaldi-layout (``data/cmvn.py``). Runs
on the host (numpy).

Usage:
    python -m vae_npvc_tpu_torch.bin.apply_cmvn compute \
        scp:data/train/feats.scp data/train/cmvn.ark
    python -m vae_npvc_tpu_torch.bin.apply_cmvn apply data/train/cmvn.ark \
        scp:data/train/feats.scp dump/train          # writes feats.ark/scp
    python -m vae_npvc_tpu_torch.bin.apply_cmvn apply --reverse cmvn.ark \
        scp:decode/feats.scp decode_denorm
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..data import cmvn, kaldi_io


def _strip_scp(spec):
    kind, _, path = spec.partition(":")
    return path if path else kind


def compute(feats_scp, out_path):
    stats = cmvn.compute_stats(_strip_scp(feats_scp))
    cmvn.write_stats(out_path, stats)
    print(f"Computed CMVN stats over {int(stats[0, -1])} frames -> {out_path}")


def apply_dir(cmvn_path, feats_scp, out_dir, reverse=False, norm_vars=True,
              extra_files=()):
    """Normalize (or, ``reverse``, de-normalize) every matrix of an scp into
    ``out_dir/feats_cmvn.ark`` + ``feats.scp``, copying the companion files
    ``extra_files`` of the scp's directory beside them."""
    stats = cmvn.read_stats(cmvn_path)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    scp_path = _strip_scp(feats_scp)
    n = 0
    with kaldi_io.ArkWriter(out_dir / "feats_cmvn.ark",
                            out_dir / "feats.scp") as w:
        for utt, rx in kaldi_io.read_scp(scp_path).items():
            mat = kaldi_io.load_mat(rx)
            w.write(utt, cmvn.apply(mat, stats, norm_vars=norm_vars,
                                    reverse=reverse).astype(np.float32))
            n += 1
    src_dir = Path(scp_path).parent
    for f in extra_files:
        if (src_dir / f).exists():
            (out_dir / f).write_text((src_dir / f).read_text())
    print(f"{'De-normalized' if reverse else 'Normalized'} {n} utterances "
          f"-> {out_dir}")
    return n


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("compute")
    p1.add_argument("feats_scp")
    p1.add_argument("out_path")
    p2 = sub.add_parser("apply")
    p2.add_argument("cmvn_ark")
    p2.add_argument("feats_scp")
    p2.add_argument("out_dir")
    p2.add_argument("--reverse", action="store_true")
    p2.add_argument("--norm-vars", type=str, default="true")
    p2.add_argument("--copy", nargs="*",
                    default=["utt2num_frames", "utt2spk_id", "utt2spk"],
                    help="companion files to copy into out_dir")
    args = parser.parse_args(argv)
    if args.cmd == "compute":
        compute(args.feats_scp, args.out_path)
    else:
        apply_dir(args.cmvn_ark, args.feats_scp, args.out_dir,
                  reverse=args.reverse,
                  norm_vars=args.norm_vars.lower() == "true",
                  extra_files=args.copy)


if __name__ == "__main__":
    main()
