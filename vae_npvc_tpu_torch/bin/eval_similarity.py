"""Speaker-similarity CLI: train embedder -> embed -> PLDA + cosine report.

Counterpart of ``vae_npvc_tpu/bin/eval_similarity.py``, the same arguments
with ``--device`` (default ``cuda``; ``cpu`` for a CPU run) in place of
``--platform``; the config is a YAML or ``.json`` file. The embedder
(``--embedder_ckpt``, the JAX msgpack payload, both ways) is trained on the
training dump (or loaded), the converted, enrollment and training
utterances are embedded on the device, the PLDA is trained on the training
embeddings on the host, and the PLDA LLR and cosine scores are reported
(and written in the reference's scores-file shape with ``--output_dir``).
The last line printed is ``PLDA: ... COSSIM: ...``.

Usage:
    python -m vae_npvc_tpu_torch.bin.eval_similarity -c conf/train.yaml \
        --train_dir dump/train --converted_scp decode_out/feats.scp \
        --trials dump/eval/trials --enroll_dir dump/train \
        [--output_dir exp/.../asv_result]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("--train_dir", type=str, required=True,
                        help="dump dir to train the speaker embedder on")
    parser.add_argument("--converted_scp", type=str, required=True)
    parser.add_argument("--trials", type=str, required=True,
                        help="trials file: utt TARGET_SPK(or id) lines")
    parser.add_argument("--enroll_dir", type=str, required=True,
                        help="data dir with feats.scp + utt2spk(_id) of real "
                             "target-speaker utterances")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--embedder", choices=("tdnn", "conv3"),
                        default="tdnn",
                        help="tdnn: SITW x-vector TDNN; conv3: legacy "
                             "3-conv stand-in")
    parser.add_argument("--embedder_width", type=int, default=128,
                        help="TDNN frame-layer width (512 = SITW size)")
    parser.add_argument("--embedder_ckpt", type=str, default=None,
                        help="embedder checkpoint: loaded if it exists, "
                             "else trained and saved there")
    parser.add_argument("--frontend", choices=("mel", "mfcc_vad"),
                        default="mel",
                        help="mel: embed the dump-dir mel features; "
                             "mfcc_vad: the reference's wav-domain chain "
                             "(30-dim MFCC + energy VAD) — requires wav.scp "
                             "in the train/enroll dirs and "
                             "--converted_wav_dir")
    parser.add_argument("--converted_wav_dir", type=str, default=None,
                        help="dir of converted wavs (<utt>.wav) for "
                             "--frontend mfcc_vad")
    parser.add_argument("--train_wav_scp", type=str, default=None,
                        help="wav.scp for the embedder training set "
                             "(default <train_dir>/wav.scp)")
    parser.add_argument("--enroll_wav_scp", type=str, default=None,
                        help="wav.scp of the enrollment utterances "
                             "(default <enroll_dir>/wav.scp)")
    parser.add_argument("--output_dir", type=str, default=None,
                        help="write per-target plda_scores/cossim_scores "
                             "files (reference scores-file shape)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, or cpu for a CPU run)")
    args = parser.parse_args(argv)

    from ..data import kaldi_io
    from ..eval.plda import plda_train
    from ..eval.similarity import (cosine_similarity_report, embed_feats,
                                   embed_scp, mfcc_vad_scp,
                                   plda_similarity_report, train_embedder,
                                   write_scores)
    from .train import load_config

    config = load_config(args.config)
    enroll_dir = Path(args.enroll_dir)
    common = dict(steps=args.steps, arch=args.embedder,
                  width=args.embedder_width, ckpt=args.embedder_ckpt,
                  device=args.device)
    if args.frontend == "mfcc_vad":
        if not args.converted_wav_dir:
            parser.error("--frontend mfcc_vad requires --converted_wav_dir")
        train_feats = mfcc_vad_scp(
            args.train_wav_scp or Path(args.train_dir) / "wav.scp")
        model, params = train_embedder(args.train_dir, config,
                                       feats=train_feats, **common)
        wavs = sorted(Path(args.converted_wav_dir).glob("*.wav"))
        conv_embs = embed_feats(model, params, mfcc_vad_scp(
            {w.stem: str(w) for w in wavs}))
        enroll_embs = embed_feats(model, params, mfcc_vad_scp(
            args.enroll_wav_scp or enroll_dir / "wav.scp"))
        train_embs = embed_feats(model, params, train_feats)
    else:
        model, params = train_embedder(args.train_dir, config, **common)
        conv_embs = embed_scp(model, params, args.converted_scp)
        enroll_embs = embed_scp(model, params, enroll_dir / "feats.scp")
        train_embs = None
    # enrollment speakers by NAME when available, else by id; trial targets
    # may be either — normalize through spk2spk_id if present
    if (enroll_dir / "utt2spk").exists():
        enroll_utt2spk = kaldi_io.load_dict_data(enroll_dir / "utt2spk")
    else:
        enroll_utt2spk = kaldi_io.load_dict_data(enroll_dir / "utt2spk_id")
    utt2target = {p[0]: p[1] for p in kaldi_io.load_list_data(args.trials)}
    enroll_spks = set(enroll_utt2spk.values())
    missing = [t for t in set(utt2target.values()) if t not in enroll_spks]
    if missing and (enroll_dir / "spk2spk_id").exists():
        name2id = kaldi_io.load_dict_data(enroll_dir / "spk2spk_id")
        id2name = {str(int(v)): k for k, v in name2id.items()}
        remap = {**{k: k for k in enroll_spks}, **name2id, **id2name}
        utt2target = {u: remap.get(t, t) for u, t in utt2target.items()}

    cos_mean, cos_per_utt = cosine_similarity_report(
        conv_embs, enroll_embs, utt2target, enroll_utt2spk)

    # PLDA trained on the training-set embeddings (speaker labels from the
    # train dir) — the offline stand-in for the reference's SITW PLDA
    train_dir = Path(args.train_dir)
    if train_embs is None:
        train_embs = embed_scp(model, params, train_dir / "feats.scp")
    if (train_dir / "utt2spk").exists():
        train_utt2spk = kaldi_io.load_dict_data(train_dir / "utt2spk")
    else:
        train_utt2spk = kaldi_io.load_dict_data(train_dir / "utt2spk_id")
    utts = [u for u in train_embs if u in train_utt2spk]
    plda = plda_train(np.stack([train_embs[u] for u in utts]),
                      [train_utt2spk[u] for u in utts])
    plda_mean, plda_per_utt = plda_similarity_report(
        plda, conv_embs, enroll_embs, utt2target, enroll_utt2spk)

    if args.output_dir:
        out = Path(args.output_dir)
        for tgt in sorted(set(utt2target.values())):
            d = out / tgt
            d.mkdir(parents=True, exist_ok=True)
            tgt_utts = [u for u, t in utt2target.items() if t == tgt]
            pu_cos = {u: cos_per_utt[u] for u in tgt_utts if u in cos_per_utt}
            pu_plda = {u: plda_per_utt[u] for u in tgt_utts
                       if u in plda_per_utt}
            if pu_cos:
                write_scores(d / "cossim_scores", tgt, pu_cos,
                             float(np.mean(list(pu_cos.values()))))
            if pu_plda:
                write_scores(d / "plda_scores", tgt, pu_plda,
                             float(np.mean(list(pu_plda.values()))))

    print(f"PLDA: {plda_mean:.4f}  COSSIM: {cos_mean:.4f} "
          f"over {len(cos_per_utt)} utterances")
    return plda_mean, cos_mean


if __name__ == "__main__":
    main()
