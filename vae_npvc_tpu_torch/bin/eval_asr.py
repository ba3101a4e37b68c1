"""Intelligibility (CER/WER) evaluation CLI.

Counterpart of ``vae_npvc_tpu/bin/eval_asr.py``, the same arguments with
``--device`` (default ``cuda``; ``cpu`` for a CPU run) in place of
``--platform``: train (or load) the CTC proxy recognizer on the experiment's
own (mel, transcript) pairs, or take a pluggable ``--recognizer
module:Class``, decode the converted utterances (beam search with a
shallow-fused char n-gram or neural LSTM LM), and score CER/WER with the
sclite-semantics scorer, writing ``hyp.text``, ``result.txt`` (char) and
``result.wrd.txt`` (word). Checkpoints (``--recognizer_ckpt``,
``--lm_ckpt``) are the JAX package's msgpack payloads, read and written
both ways. The last line printed is ``CER: ... WER: ...``.

Usage:
    python -m vae_npvc_tpu_torch.bin.eval_asr \
        --train_dir dump/train --eval_scp out/feats.scp \
        --ref_text data/eval/text --output_dir exp/.../asr_result
"""

from __future__ import annotations

import argparse
import inspect
from pathlib import Path


def _ckpt_matches(path, arch):
    """Reuse a cached recognizer checkpoint only when its stored arch
    matches the request (the ckpt filename encodes the frontend but not
    the arch)."""
    from ..utils import msgpack_io

    try:
        payload = msgpack_io.msgpack_restore(Path(path).read_bytes())
        stored = payload.get("arch", "conv")
        if isinstance(stored, bytes):
            stored = stored.decode()
    except Exception:
        return False
    if arch and stored != arch:
        print(f"ignoring {path}: stored arch {stored!r} != requested "
              f"{arch!r}; retraining")
        return False
    return True


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_dir", type=str, default=None,
                        help="data dir with feats.scp + text to train the "
                             "CTC proxy recognizer on")
    parser.add_argument("--eval_scp", type=str, required=True,
                        help="feats.scp of the (converted) utterances")
    parser.add_argument("--ref_text", type=str, required=True,
                        help="Kaldi text file with reference transcripts")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--recognizer", type=str, default=None,
                        help="module.path:ClassName recognizer override "
                             "(e.g. a wrapper around a real pretrained ASR)")
    parser.add_argument("--recognizer_ckpt", type=str, default=None,
                        help="reuse/persist the trained CTC proxy here")
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--width", type=int, default=None,
                        help="CTC-proxy width (train: default 192; load: "
                             "inferred from the checkpoint)")
    parser.add_argument("--specaug", action="store_true",
                        help="SpecAugment during CTC-proxy training")
    parser.add_argument("--arch", type=str, default="conv",
                        choices=["conv", "transformer"],
                        help="CTC-proxy encoder: dilated convs, or a "
                             "transformer encoder (load: inferred from the "
                             "checkpoint)")
    # decode knobs of the reference's conf/ob_eval/decode_asr.yaml
    parser.add_argument("--beam_size", type=int, default=10,
                        help="1 = greedy; >1 = CTC prefix beam search")
    parser.add_argument("--lm_weight", type=float, default=0.6)
    parser.add_argument("--penalty", type=float, default=0.0,
                        help="per-token insertion bonus")
    parser.add_argument("--lm_order", type=int, default=3)
    parser.add_argument("--lm_type", type=str, default="ngram",
                        choices=["ngram", "neural"],
                        help="shallow-fusion LM: Witten-Bell char n-gram or "
                             "neural char-LSTM")
    parser.add_argument("--lm_ckpt", type=str, default=None,
                        help="neural-LM checkpoint path (loaded if it "
                             "exists, else trained and saved there)")
    parser.add_argument("--lm_steps", type=int, default=600,
                        help="neural-LM training steps")
    parser.add_argument("--no_lm", action="store_true",
                        help="disable LM fusion during beam search")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, or cpu for a CPU run)")
    args = parser.parse_args(argv)

    from ..data import kaldi_io
    from ..eval import wer
    from ..eval.asr import CTCRecognizer, get_recognizer, train_ctc

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    if args.recognizer:
        rec = get_recognizer(args.recognizer)
    elif (args.recognizer_ckpt and Path(args.recognizer_ckpt).exists()
          and _ckpt_matches(args.recognizer_ckpt, args.arch)):
        rec = CTCRecognizer.load(args.recognizer_ckpt, width=args.width,
                                 device=args.device)
        print(f"loaded recognizer from {args.recognizer_ckpt}")
    else:
        if not args.train_dir:
            raise SystemExit("--train_dir required to train the CTC proxy "
                             "(or pass --recognizer/--recognizer_ckpt)")
        rec = train_ctc(args.train_dir, steps=args.steps,
                        width=args.width or 192, specaug=args.specaug,
                        arch=args.arch, device=args.device)
        if args.recognizer_ckpt:
            Path(args.recognizer_ckpt).parent.mkdir(parents=True,
                                                    exist_ok=True)
            rec.save(args.recognizer_ckpt)

    lm = None
    if (args.beam_size > 1 and not args.no_lm and args.train_dir
            and (Path(args.train_dir) / "text").exists()):
        texts = kaldi_io.load_dict_data(Path(args.train_dir) / "text")
        if args.lm_type == "neural":
            from ..eval.neural_lm import CharLstmLM, train_char_lm
            if args.lm_ckpt and Path(args.lm_ckpt).exists():
                lm = CharLstmLM.load(args.lm_ckpt, device=args.device)
                print(f"loaded neural char LM from {args.lm_ckpt}")
            else:
                lm = train_char_lm(texts.values(), steps=args.lm_steps,
                                   log_every=max(args.lm_steps // 3, 1),
                                   device=args.device)
                if args.lm_ckpt:
                    Path(args.lm_ckpt).parent.mkdir(parents=True,
                                                    exist_ok=True)
                    lm.save(args.lm_ckpt)
            print(f"neural char-LSTM LM over {len(texts)} transcripts "
                  f"({len(lm.vocab)} chars), lm_weight {args.lm_weight}")
        else:
            from ..eval.lm import CharNgramLM
            lm = CharNgramLM(texts.values(), order=args.lm_order)
            print(f"char {args.lm_order}-gram LM over {len(texts)} "
                  f"transcripts ({len(lm.vocab)} chars), "
                  f"lm_weight {args.lm_weight}")

    # the documented pluggable interface is transcribe_scp(scp) -> {utt:
    # text}; only pass decode knobs to recognizers that accept them
    sig = inspect.signature(rec.transcribe_scp)
    if "beam_size" in sig.parameters:
        hyps = rec.transcribe_scp(args.eval_scp, beam_size=args.beam_size,
                                  lm=lm, lm_weight=args.lm_weight,
                                  penalty=args.penalty)
    else:
        hyps = rec.transcribe_scp(args.eval_scp)
    refs_all = kaldi_io.load_dict_data(args.ref_text)
    # converted utterances keep their source utterance name
    refs = {u: refs_all[u] for u in hyps if u in refs_all}
    if not refs:
        raise SystemExit("no utterances shared between --eval_scp and "
                         "--ref_text")

    with open(out / "hyp.text", "w") as f:
        for u in sorted(hyps):
            f.write(f"{u} {hyps[u]}\n")
    cer = wer.write_report(out / "result.txt", refs, hyps, "char")
    w = wer.write_report(out / "result.wrd.txt", refs, hyps, "word")
    print(f"CER: {cer.err_pct:.2f}  WER: {w.err_pct:.2f} "
          f"over {len(refs)} utterances")
    return cer.err_pct, w.err_pct


if __name__ == "__main__":
    main()
