"""Speaker-embedding extraction CLI (the x-vector stage analog).

Counterpart of ``vae_npvc_tpu/bin/extract_spk_emb.py``, the same arguments
with ``--device`` (default ``cuda``; ``cpu`` for a CPU run) in place of
``--platform``; the config is a YAML or ``.json`` file. Trains the
eval/similarity embedder on the training mels, then embeds every utterance
of a data dir into ``spk_emb.ark/scp`` (per-utt (1, E) matrices, the
token-mel dir contract), and with ``--spk_mean`` the unit-norm speaker means
into ``spk_emb_mean.ark/scp``.

Usage:
    python -m vae_npvc_tpu_torch.bin.extract_spk_emb -c conf/train.yaml \
        --train_dir dump/train --data_dir data/tts [--out data/tts] \
        [--spk_mean] [--steps 2000]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("--train_dir", type=str, required=True,
                        help="data dir to train the embedder on "
                             "(feats.scp + utt2spk_id)")
    parser.add_argument("--data_dir", type=str, required=True,
                        help="data dir whose utterances to embed (feats.scp)")
    parser.add_argument("--out", type=str, default=None,
                        help="output dir (default: the data dir)")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--emb_dim", type=int, default=64)
    parser.add_argument("--spk_mean", action="store_true",
                        help="also write per-SPEAKER mean embeddings "
                             "(spk_emb_mean.scp keyed by speaker)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, or cpu for a CPU run)")
    args = parser.parse_args(argv)

    from ..data import kaldi_io
    from ..eval.similarity import embed_scp, train_embedder
    from .train import load_config

    config = load_config(args.config)
    model, params = train_embedder(args.train_dir, config, steps=args.steps,
                                   emb_dim=args.emb_dim, device=args.device)

    data_dir = Path(args.data_dir)
    out = Path(args.out or data_dir)
    out.mkdir(parents=True, exist_ok=True)
    embs = embed_scp(model, params, data_dir / "feats.scp")
    with kaldi_io.ArkWriter(out / "spk_emb.ark", out / "spk_emb.scp") as w:
        for utt in sorted(embs):
            w.write(utt, embs[utt][None, :].astype(np.float32))
    print(f"Wrote {len(embs)} utterance embeddings -> {out}/spk_emb.scp")

    if args.spk_mean:
        u2s_file = (data_dir / "utt2spk" if (data_dir / "utt2spk").exists()
                    else data_dir / "utt2spk_id")
        u2s = kaldi_io.load_dict_data(u2s_file)
        by_spk: dict = {}
        for utt, e in embs.items():
            if utt in u2s:
                by_spk.setdefault(u2s[utt], []).append(e)
        with kaldi_io.ArkWriter(out / "spk_emb_mean.ark",
                                out / "spk_emb_mean.scp") as w:
            for spk in sorted(by_spk):
                m = np.mean(by_spk[spk], axis=0)
                w.write(spk, (m / max(np.linalg.norm(m), 1e-9))[None, :]
                        .astype(np.float32))
        print(f"Wrote {len(by_spk)} speaker means -> {out}/spk_emb_mean.scp")
    return len(embs)


if __name__ == "__main__":
    main()
