"""Character n-gram language model for shallow fusion in ASR decoding.

The reference's intelligibility eval decodes with a downloaded LibriSpeech
RNNLM shallow-fused into beam search (reference:
egs/vcc20/vae1/local/ob_eval/evaluate.sh:150-152 ``--rnnlm ${lang_model}``,
``conf/ob_eval/decode_asr.yaml`` ``lm-weight: 0.6``). No pretrained model can
be downloaded here, so the in-framework analog is a Witten-Bell-smoothed
character n-gram trained on the experiment's own transcripts — exact
probabilities, no training loop, and enough signal to bias the CTC proxy's
beam search toward in-domain character sequences.

Witten-Bell interpolation (order k, context ``ctx`` of length k-1)::

    P(c | ctx) = (N(ctx, c) + T(ctx) * P(c | ctx[1:])) / (N(ctx) + T(ctx))

where ``N`` are counts and ``T(ctx)`` the number of *distinct* continuations
seen after ``ctx``; the unigram base case interpolates with the uniform
distribution over the vocabulary (+ EOS), so every string has nonzero
probability.

The port's own copy of ``vae_npvc_tpu/eval/lm.py`` (host numpy; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

BOS = "\x02"  # sentence-start padding symbol (never predicted)
EOS = "\x03"  # end-of-sentence symbol (predicted, scored at finalization)


class CharNgramLM:
    """Witten-Bell interpolated character n-gram with BOS/EOS handling."""

    def __init__(self, texts: Iterable[str], order: int = 3):
        if order < 1:
            raise ValueError("order must be >= 1")
        self.order = order
        # counts[k] maps a length-k context tuple -> {char: count}
        counts: list = [defaultdict(lambda: defaultdict(int))
                        for _ in range(order)]
        vocab = set()
        n_sent = 0
        for text in texts:
            n_sent += 1
            chars = list(text) + [EOS]
            vocab.update(text)
            padded = [BOS] * (order - 1) + chars
            for i, c in enumerate(chars):
                pos = i + order - 1
                for k in range(order):
                    ctx = tuple(padded[pos - k:pos])
                    counts[k][ctx][c] += 1
        if n_sent == 0:
            raise ValueError("no training texts")
        self.vocab = sorted(vocab)
        # freeze to plain dicts: ctx -> (total, n_distinct, {char: count})
        self._tables: list = []
        for k in range(order):
            tbl: Dict[Tuple[str, ...], Tuple[int, int, Dict[str, int]]] = {}
            for ctx, cc in counts[k].items():
                tot = sum(cc.values())
                tbl[ctx] = (tot, len(cc), dict(cc))
            self._tables.append(tbl)
        # uniform floor over vocab + EOS
        self._uniform = 1.0 / (len(self.vocab) + 1)

    # ------------------------------------------------------------- scoring
    def prob(self, context: Sequence[str], char: str) -> float:
        """P(char | context), context = preceding characters of the string."""
        ctx_full = ([BOS] * (self.order - 1) + list(context))
        p = self._uniform
        # build up from unigram to the highest available order
        for k in range(self.order):
            ctx = tuple(ctx_full[len(ctx_full) - k:]) if k else ()
            entry = self._tables[k].get(ctx)
            if entry is None:
                continue  # unseen context: keep lower-order estimate
            tot, distinct, cc = entry
            p = (cc.get(char, 0) + distinct * p) / (tot + distinct)
        return p

    def logp(self, context: Sequence[str], char: str) -> float:
        return float(np.log(self.prob(context, char)))

    def logp_eos(self, context: Sequence[str]) -> float:
        return self.logp(context, EOS)

    def next_logps(self, context: Sequence[str],
                   chars: Sequence[str]) -> np.ndarray:
        """log P(c | context) for each c in ``chars`` (vectorized helper)."""
        return np.array([self.logp(context, c) for c in chars], np.float64)
