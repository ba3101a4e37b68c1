"""BNF / VQ-token extraction CLI.

Counterpart of ``vae_npvc_tpu/bin/extract_bnf.py`` (same flags; ``-g`` is
ignored as there) plus ``--device`` (default ``cuda``). The config is YAML
or ``.json`` (``bin/train.load_config``).

Usage:
    python -m vae_npvc_tpu_torch.bin.extract_bnf -c conf/train.yaml \\
        -m exp/vqvae/model.loss.best -k csid --durations exp/vqvae/dur.txt \\
        scp:dump/train/feats.scp exp/vqvae/vq_tokens.txt
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("rspecifier", type=str,
                        help="input features, e.g. scp:feats.scp or ark:f.ark")
    parser.add_argument("wspecifier", type=str,
                        help="output text path, or ark,scp:... when "
                             "--output_txt false")
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-m", "--model_path", type=str, required=True)
    parser.add_argument("-k", "--bnf_kind", type=str, default="csid",
                        choices=["id", "csid", "token"])
    parser.add_argument("--output_txt", type=str, default="true")
    parser.add_argument("--durations", type=str, default=None,
                        help="also write per-token run lengths (duration "
                             "targets for the token-to-mel synthesizer)")
    parser.add_argument("-g", "--gpu", type=str, default=None,
                        help="ignored (the device is --device)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from ..infer.bnf import BnfExtractor
    from .train import load_config

    ex = BnfExtractor(load_config(args.config), device=args.device)
    it = ex.load_checkpoint(args.model_path)
    print(f"Extracting BNF {args.bnf_kind} with model at iteration {it}")
    n = ex.extract(args.rspecifier, args.wspecifier, args.bnf_kind,
                   args.output_txt.lower() == "true",
                   durations_path=args.durations)
    print(f"Finished extracting BNF {args.bnf_kind} ({n} utterances)")
    return n


if __name__ == "__main__":
    main()
