"""Token->mel dataset for the second-stage synthesizer.

The port's own copy of ``vae_npvc_tpu/data/token_mel.py`` (numpy only), on
the port's ``data/kaldi_io.py``.

File contract (a "token-mel dir"):
  tokens.txt     utt <i><j>...      collapsed VQ tokens
  durations.txt  utt d1 d2 ...      per-token frame counts (run lengths)
  feats.scp      utt -> mel matrix  target mels (the frames the tokens came from)
  utt2spk_id     utt id
  spk_emb.scp    utt -> (1, E) mat  optional continuous speaker embeddings,
                                    used when config ``use_spk_embed`` is true

Batches are padded to config ``max_tokens``/``max_frames``; true lengths ride
along for masking. Yields ``(tokens, durations, mels, spks, tok_lens,
mel_lens)`` where ``spks`` is (B,) int32 ids or (B, E) float32 embeddings in
``use_spk_embed`` mode.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from . import kaldi_io

_TOKEN_RE = re.compile(r"<(\d+)>")


def parse_token_line(s):
    return np.asarray([int(t) for t in _TOKEN_RE.findall(s)], np.int32)


def write_token_mel_dir(out_dir, items, spk_embs=None):
    """Write a token-mel dir: items = [(utt, tokens, durations, mel, spk)];
    ``spk_embs`` optionally maps utt -> (E,) continuous embedding."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "tokens.txt", "w") as tf, \
            open(out_dir / "durations.txt", "w") as df, \
            open(out_dir / "utt2spk_id", "w") as uf, \
            kaldi_io.ArkWriter(out_dir / "mel.ark",
                               out_dir / "feats.scp") as w:
        for utt, toks, durs, mel, spk in items:
            tf.write(f"{utt} " + "".join(f"<{t}>" for t in toks) + "\n")
            df.write(f"{utt} " + " ".join(str(int(d)) for d in durs) + "\n")
            uf.write(f"{utt} {spk}\n")
            w.write(utt, np.asarray(mel, np.float32))
    if spk_embs is not None:
        with kaldi_io.ArkWriter(out_dir / "spk_emb.ark",
                                out_dir / "spk_emb.scp") as w:
            for utt, emb in spk_embs.items():
                w.write(utt, np.asarray(emb, np.float32)[None, :])


class TokenMelDataset:
    def __init__(self, data_dir, config, valid=False):
        data_dir = Path(data_dir)
        self.max_tokens = config.get("max_tokens", 128)
        self.max_frames = config.get("max_frames", 512)
        tokens = kaldi_io.load_dict_data(data_dir / "tokens.txt")
        durs = kaldi_io.load_dict_data(data_dir / "durations.txt")
        self.feats_scp = kaldi_io.load_dict_data(data_dir / "feats.scp")
        spk = kaldi_io.load_dict_data(data_dir / "utt2spk_id")
        self.spk_emb_scp = None
        if config.get("use_spk_embed"):
            if not (data_dir / "spk_emb.scp").exists():
                # silently falling back to int ids would train the wrong
                # conditioning mode
                raise FileNotFoundError(
                    f"use_spk_embed: true but {data_dir}/spk_emb.scp is "
                    "missing: extract the speaker embeddings first")
            self.spk_emb_scp = kaldi_io.load_dict_data(
                data_dir / "spk_emb.scp")
        self.items = []
        for utt in tokens:
            if utt not in durs or utt not in self.feats_scp or utt not in spk:
                continue
            if self.spk_emb_scp is not None and utt not in self.spk_emb_scp:
                continue
            t = parse_token_line(tokens[utt])
            d = np.asarray([int(x) for x in durs[utt].split()], np.int32)
            if len(t) != len(d) or len(t) > self.max_tokens \
                    or int(d.sum()) > self.max_frames:
                continue
            self.items.append((utt, t, d, int(spk[utt])))
        if not self.items:
            raise ValueError(f"no usable items in {data_dir} (check "
                             f"max_tokens/max_frames)")
        self.num_data = len(self.items)
        mel0 = kaldi_io.load_mat(self.feats_scp[self.items[0][0]])
        self.mel_dim = mel0.shape[1]

    def __len__(self):
        return self.num_data

    def get(self, index, rng):
        utt, toks, durs, spk = self.items[index]
        if self.spk_emb_scp is not None:
            spk = kaldi_io.load_mat(self.spk_emb_scp[utt])[0].astype(
                np.float32)
        else:
            spk = np.int32(spk)
        mel = kaldi_io.load_mat(self.feats_scp[utt]).astype(np.float32)
        L, T = self.max_tokens, self.max_frames
        tok = np.zeros((L,), np.int32)
        dur = np.zeros((L,), np.int32)
        tok[:len(toks)] = toks
        dur[:len(durs)] = durs
        n_frames = min(int(durs.sum()), mel.shape[0], T)
        out_mel = np.zeros((T, self.mel_dim), np.float32)
        out_mel[:n_frames] = mel[:n_frames]
        return (tok, dur, out_mel, spk,
                np.int32(len(toks)), np.int32(n_frames))

    def batches(self, batch_size, *, shuffle, seed=0, epochs=None):
        if epochs is None and batch_size > self.num_data:
            # the drop-last loop below would otherwise yield nothing forever
            raise ValueError(
                f"batch_size {batch_size} > dataset size {self.num_data}; "
                "reduce batch_size (training drops partial batches)")
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(self.num_data)
            if shuffle:
                rng.shuffle(order)
            for lo in range(0, self.num_data, batch_size):
                idx = order[lo:lo + batch_size]
                if len(idx) < batch_size and epochs is None:
                    break
                items = [self.get(i, rng) for i in idx]
                yield tuple(np.stack([it[j] for it in items])
                            for j in range(6))
            epoch += 1
