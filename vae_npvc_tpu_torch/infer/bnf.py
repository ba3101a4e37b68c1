"""BNF / VQ-token extraction: mel features -> code-id transcripts.

Counterpart of ``vae_npvc_tpu/infer/bnf.py``: stream an rspecifier, run the
model's encoder and quantizer, and emit one of

- ``id``:    the full per-frame code-id sequence
- ``csid``:  consecutive duplicates collapsed (the VQ-token transcripts the
             AISHELL-3 TTS recipe trains on)
- ``token``: the id matrix (for ark output)

as ``<i><j>...`` text lines or a Kaldi ark, and optionally the run lengths
of the collapsed tokens (``durations_path``), the token-to-mel
synthesizer's duration targets.

The flat family's utterances are bucketed and encoded in batches (length
masks make the padding exact); a bucket's last batch holds only its own
utterances, where the JAX package fills it to ``decode_batch_size`` with
length-1 rows to reuse a compiled shape. The hierarchies encode per
utterance and emit the finest level's ids. The encoder's GroupNorms and the
search run K2 and K1 on the card (through the registered operators).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import kaldi_io
from ..models import build_model
from ..models import vqvae as flat_vqvae
from ..models.vqvae import Encoder
from ..utils.bridge import from_jax_variables, to_jax_variables
from ..utils.migrate import maybe_migrate_model
from .convert import checkpoint_variables, encoder_archs, read_payload


def collapse_consecutive(ids):
    """Run-length collapse (``torch.unique_consecutive`` equivalent)."""
    ids = np.asarray(ids).reshape(-1)
    if ids.size == 0:
        return ids
    keep = np.ones(ids.shape, bool)
    keep[1:] = ids[1:] != ids[:-1]
    return ids[keep]


def collapse_with_durations(ids):
    """Run-length collapse returning ``(tokens, run_lengths)``: the
    duration targets of the token-to-mel synthesizer."""
    ids = np.asarray(ids).reshape(-1)
    if ids.size == 0:
        return ids, ids
    keep = np.ones(ids.shape, bool)
    keep[1:] = ids[1:] != ids[:-1]
    starts = np.flatnonzero(keep)
    lengths = np.diff(np.append(starts, ids.size))
    return ids[starts], lengths.astype(np.int64)


class BnfExtractor:
    """Builds the model once on ``device`` (default the GPU) in the
    config's ``compute_dtype``."""

    def __init__(self, config, device="cuda"):
        self.config = config
        self.model = build_model(config, device).eval()
        self.device = next(self.model.parameters()).device
        self.bucket_size = config.get("decode_bucket_size", 256)
        self.batch_size = config.get("decode_batch_size", 8)
        self.min_frames = Encoder.min_input_frames(encoder_archs(config))
        self._is_flat = isinstance(self.model, flat_vqvae.Model)

    def load_checkpoint(self, path):
        """Load a JAX-format msgpack checkpoint (the JAX trainer's or the
        port's; weight-norm axis format 1 is migrated by
        ``utils/migrate.py``); returns its iteration."""
        payload = read_payload(path)
        template = to_jax_variables(self.model.state_dict())["params"]
        model, _ = maybe_migrate_model(payload, template)
        self.model.load_state_dict(
            from_jax_variables(checkpoint_variables(payload, model)),
            strict=True)
        return int(payload.get("iteration", 0))

    def _dev(self, a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=self.device)

    def _encode_batch(self, feats, lengths):
        """(b, T, D), (b,) -> list of per-utterance id arrays (true
        length)."""
        if self._is_flat:
            with torch.inference_mode():
                ids = self.model.encode(self._dev(feats, np.float32),
                                        self._dev(lengths, np.int32))
            ids = ids.cpu().numpy()
            out_lens = Encoder.out_lengths(self.config.get("encoder", {}),
                                           np.asarray(lengths, np.int64))
            return [ids[b, :out_lens[b]] for b in range(ids.shape[0])]
        # hierarchical: per utterance, finest VQ level. Inputs shorter than
        # the hierarchy's total downsampling keep their padding (with the
        # real length threaded) so no level's time axis is empty.
        outs = []
        arch = self.config.get("encoder.0", self.config.get("encoder", {}))
        for b in range(feats.shape[0]):
            T = max(int(lengths[b]), self.min_frames)
            with torch.inference_mode():
                enc = self.model.encode(
                    self._dev(feats[b:b + 1, :T], np.float32),
                    self._dev(lengths[b:b + 1], np.int32))
            ids = enc[0] if isinstance(enc, tuple) else enc
            if isinstance(ids, (list, tuple)):
                ids = ids[-1]
            fin_len = int(Encoder.out_lengths(
                arch, np.asarray(lengths[b:b + 1], np.int64))[0])
            outs.append(ids.cpu().numpy()[0, :fin_len])
        return outs

    def extract(self, rspecifier, wspecifier, bnf_kind="csid",
                output_txt=True, durations_path=None):
        """Write the ids of every utterance of ``rspecifier``; returns the
        number written."""
        items = list(kaldi_io.read_rspecifier(rspecifier))
        output_txt = output_txt and bnf_kind in ("id", "csid")

        buckets: dict[int, list] = {}
        for utt, feat in items:
            T = feat.shape[0]
            T_pad = max(-(-T // self.bucket_size) * self.bucket_size,
                        self.min_frames)
            buckets.setdefault(T_pad, []).append((utt, feat))

        results = {}
        for T_pad in sorted(buckets):
            group = buckets[T_pad]
            for lo in range(0, len(group), self.batch_size):
                chunk = group[lo:lo + self.batch_size]
                D = chunk[0][1].shape[1]
                feats = np.zeros((len(chunk), T_pad, D), np.float32)
                lengths = np.ones((len(chunk),), np.int32)
                for b, (utt, feat) in enumerate(chunk):
                    feats[b, :feat.shape[0]] = feat
                    lengths[b] = feat.shape[0]
                for (utt, _), ids in zip(chunk,
                                         self._encode_batch(feats, lengths)):
                    results[utt] = ids

        n = 0
        if durations_path is not None:
            with open(durations_path, "w") as df:
                for utt, _ in items:
                    _, runs = collapse_with_durations(results[utt])
                    df.write(f"{utt} " + " ".join(map(str, runs)) + "\n")
        if output_txt:
            with open(wspecifier, "w") as wf:
                for utt, _ in items:
                    ids = results[utt]
                    if bnf_kind == "csid":
                        ids = collapse_consecutive(ids)
                    wf.write(f"{utt} "
                             + "".join(f"<{i}>" for i in ids.reshape(-1))
                             + "\n")
                    n += 1
        else:
            with kaldi_io.write_helper(wspecifier,
                                       compression_method=1) as wf:
                for utt, _ in items:
                    ids = results[utt]
                    if bnf_kind == "csid":
                        ids = collapse_consecutive(ids)
                    wf.write(utt, ids.reshape(-1, 1).astype(np.float32))
                    n += 1
        return n
