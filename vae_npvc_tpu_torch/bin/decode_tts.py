"""Token-to-mel synthesis CLI: token transcripts + speaker -> mel arks.

Counterpart of ``vae_npvc_tpu/bin/decode_tts.py``: same flags and outputs
(``mel.ark`` + ``feats.scp`` in ``--output-dir``), running
``models/token_tts.py`` ``Model.infer`` on the GPU (``--device cpu`` for a
CPU run) from a checkpoint either trainer wrote. The config is a YAML file
(or a ``.json`` file, for hosts without a YAML parser).

Usage:
    python -m vae_npvc_tpu_torch.bin.decode_tts -c conf/train_token_tts.yaml \
        --checkpoint exp/token_tts/model.loss.best \
        --tokens data/tts/text --spk 3 --output-dir exp/token_tts/decode
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .train import load_config


def load_model(config, checkpoint, device="cuda"):
    """The synthesizer of ``config`` on ``device`` with the parameters of a
    checkpoint in the JAX format, in eval mode."""
    from ..infer.convert import read_checkpoint
    from ..models import build_model
    from ..utils.bridge import from_jax_variables

    model = build_model(config, device).eval()
    _, variables = read_checkpoint(checkpoint)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Synthesize mels from token transcripts (PyTorch, GPU)")
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--tokens", type=str, required=True,
                        help="token transcript file: utt <i><j>... lines")
    parser.add_argument("--spk", type=str, default=None,
                        help="target speaker id (int), or utt2spk_id file "
                             "for per-utterance speakers")
    parser.add_argument("--spk_emb", type=str, default=None,
                        help="continuous speaker embedding(s): an scp/ark of "
                             "per-utterance (1, E) matrices, or one matrix "
                             "file used for every utterance (unseen-speaker "
                             "synthesis)")
    parser.add_argument("--trials", type=str, default=None,
                        help="voice-conversion trials file 'utt TARGET': "
                             "synthesize each utterance's tokens with the "
                             "TARGET speaker (resolved through --spk (ids) "
                             "or --spk_emb keyed by speaker)")
    parser.add_argument("--output-dir", "--output_dir", dest="output_dir",
                        type=str, required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from ..data import kaldi_io
    from ..data.token_mel import parse_token_line

    if not args.spk and not args.spk_emb:
        raise SystemExit("pass --spk (ids) or --spk_emb (embeddings)")
    config = load_config(args.config)
    if args.spk_emb and not config.get("use_spk_embed", False):
        config = dict(config, use_spk_embed=True)
    model = load_model(config, args.checkpoint, args.device)
    device = next(model.parameters()).device
    L = config.get("max_tokens", 128)

    utt2target = None
    if args.trials:
        utt2target = {ln.split()[0]: ln.split()[1]
                      for ln in open(args.trials) if ln.strip()}
    utt2spk = utt2emb = fixed_emb = None
    if args.spk_emb:
        emb_path = Path(args.spk_emb)
        if emb_path.suffix == ".scp" or "scp" in emb_path.name:
            utt2emb = kaldi_io.load_dict_data(emb_path)
        else:
            fixed_emb = kaldi_io.load_mat(str(emb_path))[0]
    else:
        spk_file = Path(args.spk)
        utt2spk = (kaldi_io.load_dict_data(spk_file) if spk_file.exists()
                   else None)

    def emb(mat):
        return torch.as_tensor(np.asarray(mat, np.float32), device=device)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    with kaldi_io.ArkWriter(out_dir / "mel.ark", out_dir / "feats.scp") as w:
        for utt, line in kaldi_io.load_dict_data(args.tokens).items():
            if utt2target is not None and utt not in utt2target:
                continue
            toks = parse_token_line(line)[:L]
            pad = np.zeros((1, L), np.int32)
            pad[0, :len(toks)] = toks
            if utt2target is not None:
                # VC trials: the speaker source is keyed by TARGET speaker
                # (an embedding table, or an int id)
                tgt = utt2target[utt]
                if utt2emb is not None:
                    y = emb(kaldi_io.load_mat(utt2emb[tgt])[:1])
                else:
                    y = torch.tensor([int(tgt)], dtype=torch.int32,
                                     device=device)
            elif utt2emb is not None:
                y = emb(kaldi_io.load_mat(utt2emb[utt])[:1])
            elif fixed_emb is not None:
                y = emb(fixed_emb[None, :])
            else:
                spk = int(utt2spk[utt]) if utt2spk else int(args.spk)
                y = torch.tensor([spk], dtype=torch.int32, device=device)
            with torch.inference_mode():
                mel, lens = model.infer(
                    torch.as_tensor(pad, device=device), y,
                    torch.tensor([len(toks)], dtype=torch.int32,
                                 device=device))
            w.write(utt, mel[0, :int(lens[0])].float().cpu().numpy())
            n += 1
    print(f"Synthesized {n} utterances -> {out_dir}")


if __name__ == "__main__":
    main()
