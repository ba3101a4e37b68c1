"""Neural character LM for shallow fusion in ASR decoding.

Counterpart of ``vae_npvc_tpu/eval/neural_lm.py`` (``CharLstmLM``,
``train_char_lm``, ``BOS``/``EOS``): a character-level LSTM LM (embedding,
``layers`` LSTM layers, a Dense head) trained on the experiment's own
transcripts, behind the ``logp``/``logp_eos`` interface of the Witten-Bell
n-gram (eval/lm.py), so either can back ``ctc_prefix_beam_search``
(``lm-type: neural`` of the recipe's decode yaml).

Layer ``i`` is ``OptimizedLSTMCell_{i}``, a ``nn/rnn.LSTM`` (cuDNN on
the GPU) named after the flax cell it holds: flax's ``OptimizedLSTMCell``
has no input bias, so that layer holds its input bias at zero and does not
train it. Parameters cross to the JAX payload through
``utils/bridge.params_to_flax``. Training follows JAX's loop: Adam,
``np.random.default_rng(seed)`` batches of whole padded transcripts with a
BOS column, the NLL averaged over the real characters and the EOS. The
seeded initial parameters are not flax's; ``train`` takes injected ones.

Incremental scoring keeps JAX's cache: one B = 1 LSTM step per new prefix
from its deepest cached ancestor (beam search extends prefixes one character
at a time), the carries kept on the device, the log-softmax over the next
character read back to the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import Dense, Embed, init_parameters
from ..nn.rnn import LSTM
from ..utils import msgpack_io
from ..utils.bridge import load_flax_params, params_to_flax
from ..utils.device import resolve_device

BOS = "\x02"
EOS = "\x03"


def _build_vocab(texts):
    chars = sorted({c for t in texts for c in t})
    # id 0 = BOS (never predicted), id 1 = EOS
    itos = [BOS, EOS] + chars
    stoi = {c: i for i, c in enumerate(itos)}
    return itos, stoi


class CharLstmNet(nn.Module):
    """(B, L) tokens [, carries] -> ((B, L, V) logits, carries); the
    carries are one ``(h, c)`` per layer, each (B, hidden)."""

    def __init__(self, V, embed, hidden, layers):
        super().__init__()
        self.embed = Embed(V, embed)
        for i in range(layers):
            setattr(self, f"OptimizedLSTMCell_{i}",
                    LSTM(embed if i == 0 else hidden, hidden))
        self.out = Dense(hidden, V)
        self.layers = layers

    def forward(self, tokens, carries=None):
        h, new = self.embed(tokens), []
        for i in range(self.layers):
            h, carry = getattr(self, f"OptimizedLSTMCell_{i}")(
                h, None if carries is None else carries[i])
            new.append(carry)
        return self.out(h), new


class CharLstmLM:
    """LSTM char LM with train/score/save/load conveniences, on
    ``device``."""

    def __init__(self, vocab: Sequence[str], embed=64, hidden=256, layers=2,
                 device="cuda"):
        self.itos = list(vocab)
        self.stoi = {c: i for i, c in enumerate(self.itos)}
        self.embed, self.hidden, self.layers = embed, hidden, layers
        self.device = resolve_device(device)
        self.net = CharLstmNet(len(self.itos), embed, hidden,
                               layers).to(self.device)
        self._cache: dict = {}

    @property
    def params(self):
        """The parameters as a flax ``params`` tree of numpy arrays."""
        return params_to_flax(self.net.state_dict())

    @params.setter
    def params(self, tree):
        load_flax_params(self.net, tree)
        self._cache.clear()

    # ----------------------------------------------------------------- train
    def train(self, texts: Iterable[str], *, steps=600, batch=32, lr=2e-3,
              max_len=128, seed=0, log_every=0, params=None, losses=None):
        """``params`` (a flax tree) replaces the seeded initial parameters;
        ``losses``, a list, receives each step's NLL per character."""
        from ..train.optim import Adam, apply_updates

        texts = [t[: max_len - 1] for t in texts if t]
        if not texts:
            raise ValueError("no training texts")
        L = max(len(t) + 1 for t in texts)  # +1 for EOS
        ids = np.zeros((len(texts), L + 1), np.int64)  # col 0 = BOS
        mask = np.zeros((len(texts), L), np.float32)
        for i, t in enumerate(texts):
            seq = [self.stoi[c] for c in t] + [self.stoi[EOS]]
            ids[i, 1:1 + len(seq)] = seq
            mask[i, :len(seq)] = 1.0

        if params is None:
            init_parameters(self.net, seed)
        else:
            self.params = params
        self.net.train()
        weights = list(self.net.parameters())
        tx = Adam(lr, 0.9, 0.999, None)
        opt_state = None
        dev = self.device
        rng = np.random.default_rng(seed)
        n = len(texts)
        step_losses = []
        for s in range(steps):
            idx = rng.integers(0, n, size=min(batch, n))
            inp, tgt, m = (torch.as_tensor(a, device=dev) for a in (
                ids[idx, :-1], ids[idx, 1:], mask[idx]))
            logits, _ = self.net(inp)
            nll = -torch.gather(F.log_softmax(logits, dim=-1), 2,
                                tgt[..., None])[..., 0]
            loss = torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
            grads = torch.autograd.grad(loss, weights)
            opt_state = apply_updates(tx, opt_state, weights, grads)
            step_losses.append(loss.detach())
            if log_every and (s + 1) % log_every == 0:
                print(f"lm step {s + 1}: nll/char "
                      f"{float(step_losses[-1]):.4f}")
        if losses is not None:
            losses.extend(float(v) for v in step_losses)
        self.net.eval()
        self._cache.clear()
        return self

    # ----------------------------------------------------------------- score
    def _step(self, cid, carries):
        tok = torch.full((1, 1), cid, dtype=torch.long, device=self.device)
        with torch.inference_mode():
            logits, carries = self.net(tok, carries)
            logps = F.log_softmax(logits[0, 0], dim=-1).cpu().numpy()
        return carries, logps

    def _store(self, prefix, entry):
        if len(self._cache) > 20000:
            # evict the oldest half (insertion order) — never the full
            # cache: live beam prefixes' ancestors usually survive, and a
            # miss replays iteratively from the deepest surviving ancestor
            for k in list(self._cache)[:10000]:
                del self._cache[k]
        self._cache[prefix] = entry
        return entry

    def _state(self, prefix: tuple):
        """(carries, log-softmax over the next char) after consuming
        ``prefix``: walks back to the deepest cached ancestor and replays
        forward one step per char."""
        if prefix in self._cache:
            return self._cache[prefix]
        i = len(prefix)
        while i > 0 and prefix[:i] not in self._cache:
            i -= 1
        if i == 0 and () not in self._cache:
            self._store((), self._step(self.stoi[BOS], None))
        entry = self._cache[prefix[:i]]
        for j in range(i, len(prefix)):
            carries = entry[0]
            cid = self.stoi.get(prefix[j])
            if cid is None:  # OOV char: keep state, uniform-floor the score
                entry = self._store(prefix[:j + 1], (carries, None))
                continue
            entry = self._store(prefix[:j + 1], self._step(cid, carries))
        return entry

    def _floor(self):
        return float(-np.log(len(self.itos)))

    def logp(self, context: Sequence[str], char: str) -> float:
        _, logps = self._state(tuple(context))
        cid = self.stoi.get(char)
        if logps is None or cid is None:
            return self._floor()
        return float(logps[cid])

    def logp_eos(self, context: Sequence[str]) -> float:
        _, logps = self._state(tuple(context))
        if logps is None:
            return self._floor()
        return float(logps[self.stoi[EOS]])

    def next_logps(self, context: Sequence[str],
                   chars: Sequence[str]) -> np.ndarray:
        _, logps = self._state(tuple(context))
        if logps is None:
            return np.full(len(chars), self._floor())
        return np.array([logps[self.stoi[c]] if c in self.stoi
                         else self._floor() for c in chars])

    @property
    def vocab(self):
        return [c for c in self.itos if c not in (BOS, EOS)]

    # ------------------------------------------------------------------- io
    def save(self, path):
        payload = {
            "vocab": "".join(self.itos[2:]),
            "embed": self.embed, "hidden": self.hidden, "layers": self.layers,
            "params": self.params,
        }
        Path(path).write_bytes(msgpack_io.msgpack_serialize(payload))

    @classmethod
    def load(cls, path, device="cuda"):
        payload = msgpack_io.msgpack_restore(Path(path).read_bytes())
        lm = cls([BOS, EOS] + list(payload["vocab"]),
                 embed=int(payload["embed"]), hidden=int(payload["hidden"]),
                 layers=int(payload["layers"]), device=device)
        lm.params = payload["params"]
        lm.net.eval()
        return lm


def train_char_lm(texts, *, steps=600, embed=64, hidden=256, layers=2,
                  seed=0, log_every=0, device="cuda"):
    """Train a CharLstmLM on an iterable of transcript strings."""
    texts = [t for t in texts if t]
    itos, _ = _build_vocab(texts)
    lm = CharLstmLM(itos, embed=embed, hidden=hidden, layers=layers,
                    device=device)
    return lm.train(texts, steps=steps, seed=seed, log_every=log_every)
