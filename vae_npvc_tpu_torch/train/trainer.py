"""Trainer: the train step, validation and checkpointing on one device.

Counterpart of the core of ``vae_npvc_tpu/train/trainer.py`` (``Trainer``:
``init_state``, ``train_step``, ``train_steps``, the non-finite guard,
``grad_accum``, ``valid``, ``stage_dataset`` + ``train_steps_indices``,
``train_steps_device``, ``save_checkpoint`` / ``load_checkpoint`` in the
JAX checkpoint format).
Meshes, model-axis sharding and multi-host assembly belong to the parallel
slice. It drives any registered model: the flat VQ-VAE with its EMA
codebook and ``(feats, spks)`` batches, the hierarchical VQ-VAEs with one
EMA codebook per level (or plain codebooks), and models without EMA state
such as the token->mel synthesizer with its six-entry batches (``tokens,
durations, mels, spks, tok_lens, mel_lens``); a batch is a tuple the model's
``forward`` takes entry by entry. The EMA codebooks are the model's
``EmaQuantizer`` children, kept by name (``quantizer``, ``quantizer_{i}``).

One step, in the JAX trainer's order: renorm (normalized plain VQ only) ->
forward and gradient -> clip -> optimizer -> guard -> EMA commit. Every parameter lives in one flat
fp32 vector (``self.flat``; the model's parameters are views into it), and
so do Adam's moments, so the optimizer and the guard are a few kernels over
flat tensors, and the checkpoint's trees are slices of them. The guard
(``skip_nonfinite_updates``, default on) keeps the old parameters,
optimizer state and every EMA codebook with tensor selects when the squared
gradient norm is not finite; nothing in a step reads a tensor on the host,
and ``detail`` values stay device tensors until the caller logs them.

Random draws (lazy codebook init, dead-code restarts, jitter) come from a
``torch.Generator`` on the trainer's device, reseeded from ``(seed, step)``
at every step, so a resumed run draws what an uninterrupted one would; each
EMA level of a hierarchy draws from its own generator, reseeded from
``(seed, step, level)``. The crops of :meth:`Trainer.train_steps_device`
come from a generator of their own, reseeded from ``(seed, IID_SALT,
step)``, so the VQ draws are the same with or without on-device sampling.
They are not the JAX package's draws.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..infer.convert import checkpoint_variables, read_payload
from ..models import build_model, codebook_renorm_fn
from ..models.hier_common import HierVQMixin
from ..models.vqvae import EmaQuantizer
from ..ops.vq import ema_vq_init
from ..utils import msgpack_io
from ..utils.bridge import (from_jax_variables, optimizer_from_jax,
                            optimizer_to_jax, to_jax_variables)
from ..utils.migrate import WN_AXIS_FORMAT, maybe_migrate_model
from .optim import OptState, build_optimizer

# the iid sampler's stream, apart from the VQ draws' (JAX folds the same
# constant into its base key)
IID_SALT = 0x5A5A5A


def _select(ok, new, old):
    """``new`` where the 0-d bool ``ok`` holds, else ``old``, leaf by leaf
    (``None`` leaves pass through)."""
    return type(new)(*(n if n is None else torch.where(ok, n, o)
                       for n, o in zip(new, old)))


class Trainer:
    """Owns the model, the optimizer state and the train/valid steps on
    ``device`` (the GPU unless the caller asks for the CPU)."""

    # bin/train may hand it chunks of K steps (``steps_per_call``) and the
    # device-resident corpus
    supports_steps_per_call = True

    def __init__(self, config, device="cuda", seed=None):
        self.config = config
        self.model = build_model(config, device)
        self.device = next(self.model.parameters()).device
        # the EMA codebooks by name (the JAX ``ema`` collection's roots)
        self.ema = {n: m for n, m in self.model.named_children()
                    if isinstance(m, EmaQuantizer)}
        self.has_ema = bool(self.ema)
        # a hierarchy takes its EMA states as a dict by name, and draws
        # each level's lazy init and restarts from that level's generator
        self._hier = isinstance(self.model, HierVQMixin)
        self.tx = build_optimizer(config)
        self.seed = int(config.get("seed", 777) if seed is None else seed)
        self.gen = torch.Generator(device=self.device)
        self.level_gens = ({i: torch.Generator(device=self.device)
                            for i in range(self.model.levels)}
                           if self._hier and self.has_ema else None)
        self._renorm = codebook_renorm_fn(config)
        self.skip_nonfinite = config.get("skip_nonfinite_updates", True)
        self.grad_accum = int(config.get("grad_accum", 1))

        self.params = list(self.model.parameters())
        self.layout = [(name, tuple(p.shape))
                       for name, p in self.model.named_parameters()]
        self.flat = None          # (P,) fp32: every parameter, in order
        self.opt_state = None
        self._host_iter = 0       # completed optimizer steps
        self._dev_corpus = None
        self._dev_batch = None
        self.sample_gen = torch.Generator(device=self.device)

    # ------------------------------------------------------------------ init
    def _flatten_parameters(self):
        """Move the parameters into one flat vector and make each a view
        of its slice (in-place writes to either side are seen by both)."""
        with torch.no_grad():
            self.flat = torch.cat([p.detach().float().reshape(-1)
                                   for p in self.params])
            off = 0
            for p in self.params:
                n = p.numel()
                p.data = self.flat[off:off + n].view(p.shape)
                off += n

    def init_state(self, example_batch=None):
        """Seeded random parameters, a fresh EMA codebook and optimizer
        state at step 0. ``example_batch`` is accepted for the JAX
        trainer's signature; the port's shapes come from the config."""
        self.model.init_random(self.seed)
        for q in self.ema.values():
            q.set_state(ema_vq_init(*q.emb.shape, device=self.device))
        self._flatten_parameters()
        self.opt_state = self.tx.init(self.flat)
        self._host_iter = 0

    def _require_state(self):
        if self.flat is None:
            raise ValueError("call init_state first")

    # ----------------------------------------------------------------- steps
    def _to_device(self, batch):
        return tuple(torch.as_tensor(a, device=self.device) for a in batch)

    def _reseed(self):
        """Reseed the step's generators from ``(seed, host iteration)``."""
        step_seed = self.seed * 1_000_003 + self._host_iter
        self.gen.manual_seed(step_seed % (1 << 63))
        if self.level_gens is not None:
            for i, g in self.level_gens.items():
                g.manual_seed((step_seed * 1_000_033 + i + 1) % (1 << 63))

    def _begin_step(self):
        self._reseed()
        if self._renorm is not None:
            self._renorm(self.model)

    def _ema_states(self):
        """The committed EMA states, by name."""
        return {n: q.state() for n, q in self.ema.items()}

    def _forward(self, batch, ema=None):
        """The training forward ``(xhat, loss, detail)`` of one
        (micro)batch and its pending EMA states by name (None without EMA
        codebooks); ``ema`` chains microbatches."""
        kwargs = {}
        if self._hier:
            kwargs = {"ema_state": ema, "level_gens": self.level_gens}
        elif self.has_ema:
            kwargs = {"ema_state": None if ema is None else ema["quantizer"]}
        out = self.model(*batch, True, gen=self.gen, **kwargs)
        pending = self.model.pending_ema if self.has_ema else None
        if pending is not None and not self._hier:
            pending = {"quantizer": pending}
        return out, pending

    def _flat_grad(self, loss):
        grads = torch.autograd.grad(loss, self.params)
        return torch.cat([g.float().reshape(-1) for g in grads])

    def _loss_and_grad(self, batch, ema=None):
        """Flat gradient, the pending EMA states (by name) and the detail
        of one (micro)batch; ``ema`` chains microbatches."""
        (_, loss, detail), pending = self._forward(batch, ema)
        flat_g = self._flat_grad(loss)
        return flat_g, pending, {k: v.detach() for k, v in detail.items()}

    def _train_step(self, batch):
        self._begin_step()
        flat_g, new_ema, detail = self._loss_and_grad(batch)
        return self._finish_step(flat_g, new_ema, detail)

    def _train_step_accum(self, batch):
        """One optimizer step from the mean of ``grad_accum`` microbatch
        gradients; the EMA codebook statistics chain through the
        microbatches in order, the detail is their mean."""
        k = self.grad_accum
        B = batch[0].shape[0]
        if B % k != 0:
            raise ValueError(
                f"grad_accum={k} requires the batch size to be divisible; "
                f"got {B}")
        self._begin_step()
        ema = self._ema_states() if self.has_ema else None
        gsum, details = None, []
        for i in range(k):
            mb = tuple(a[i * (B // k):(i + 1) * (B // k)] for a in batch)
            flat_g, ema, detail = self._loss_and_grad(mb, ema)
            gsum = flat_g if gsum is None else gsum + flat_g
            details.append(detail)
        detail = {key: torch.stack([d[key] for d in details]).mean(dim=0)
                  for key in details[0]}
        return self._finish_step(gsum / k, ema, detail)

    def _finish_step(self, flat_g, new_ema, detail):
        """Optimizer update and non-finite guard; commits the parameters,
        the optimizer state and the EMA codebooks."""
        update, opt_state = self.tx.update(flat_g, self.opt_state,
                                           self.flat)
        new_flat = self.flat + update
        grad_sq = torch.sum(flat_g * flat_g)
        if self.skip_nonfinite:
            ok = torch.isfinite(grad_sq)
            new_flat = torch.where(ok, new_flat, self.flat)
            opt_state = _select(ok, opt_state, self.opt_state)
            if new_ema is not None:
                new_ema = {n: _select(ok, s, self.ema[n].state())
                           for n, s in new_ema.items()}
            detail["skipped_nonfinite"] = 1.0 - ok.float()
        with torch.no_grad():
            self.flat.copy_(new_flat)
        self.opt_state = opt_state
        for n, s in (new_ema or {}).items():
            self.ema[n].set_state(s)
        self._count_step()
        detail["grad_norm"] = torch.sqrt(grad_sq)
        return detail

    def _count_step(self):
        self._host_iter += 1

    def train_step(self, batch):
        """One optimizer step. ``batch`` is the tuple of numpy arrays or
        tensors the model's ``forward`` takes: (feats[B, T, D], spks[B]) for
        the VQ-VAE, (tokens, durations, mels, spks, tok_lens, mel_lens) for
        the token->mel synthesizer. Returns the loss detail as device
        scalars."""
        self._require_state()
        batch = self._to_device(batch)
        if self.grad_accum > 1:
            return self._train_step_accum(batch)
        return self._train_step(batch)

    def train_steps(self, batches):
        """K sequential optimizer steps over a list of K batches; returns
        the detail with a leading (K,) axis per key."""
        details = [self.train_step(b) for b in batches]
        return {k: torch.stack([d[k] for d in details]) for k in details[0]}

    # ------------------------------------------------- device-resident data
    def stage_dataset(self, dataset, batch_size):
        """Upload the whole training corpus to the device once;
        :meth:`train_steps_indices` then gathers host-chosen windows there
        and :meth:`train_steps_device` draws ``batch_size`` windows a step
        there, so at most indices cross to the device per step. Returns the
        staged feature bytes."""
        feats, n_frames, spk_ids = dataset.padded_arrays()
        self._dev_corpus = (
            torch.as_tensor(feats, device=self.device),
            torch.as_tensor(n_frames, device=self.device),
            torch.as_tensor(spk_ids, device=self.device))
        self._dev_batch = int(batch_size)
        self._dev_crop = dataset.crop_length
        return feats.nbytes

    def _require_corpus(self):
        if self._dev_corpus is None:
            raise ValueError("call stage_dataset first")

    def _gather(self, idx, starts):
        """The ``(feats[B, crop, D], spks[B])`` batch of the staged
        corpus's windows ``(idx[B], starts[B])`` (device tensors)."""
        feats, _, spk_ids = self._dev_corpus
        frames = torch.arange(self._dev_crop, device=self.device)
        return feats[idx[:, None], starts[:, None] + frames], spk_ids[idx]

    def _sample_iid(self, step):
        """Step ``step``'s draws ``(idx[B], starts[B])`` (device int64):
        utterances uniform over the corpus, then ``u ~ U[0, 1)`` per row
        and ``start = floor(u * (max(n - crop, 0) + 1))``, from
        :attr:`sample_gen` reseeded from ``(seed, IID_SALT, step)``."""
        _, n_frames, _ = self._dev_corpus
        B, crop = self._dev_batch, self._dev_crop
        seed = (self.seed * 1_000_003 + IID_SALT) * 1_000_033 + step
        self.sample_gen.manual_seed(seed % (1 << 63))
        idx = torch.randint(0, n_frames.shape[0], (B,),
                            generator=self.sample_gen, device=self.device)
        hi = (n_frames[idx].long() - crop).clamp_min(0)
        u = torch.rand((B,), generator=self.sample_gen, device=self.device)
        # u * (hi + 1) may round up to hi + 1 in float32
        starts = torch.minimum((u * (hi + 1).float()).long(), hi)
        return idx, starts

    def train_steps_device(self, K):
        """K optimizer steps on windows drawn iid on the device from the
        staged corpus (:meth:`_sample_iid` of each step's iteration);
        returns the detail with a leading (K,) axis per key."""
        self._require_corpus()
        self._require_state()
        details = [self.train_step(self._gather(
            *self._sample_iid(self._host_iter))) for _ in range(K)]
        return {k: torch.stack([d[k] for d in details]) for k in details[0]}

    def train_steps_indices(self, idx, starts):
        """K steps gathering host-chosen windows from the staged corpus.
        ``idx``/``starts`` are (K, B) int arrays from
        :func:`..data.dataset.index_iterator`."""
        self._require_corpus()
        feats = self._dev_corpus[0]
        idx = torch.as_tensor(np.asarray(idx), device=self.device).long()
        starts = torch.as_tensor(np.asarray(starts), device=self.device) \
            .long().clamp(0, feats.shape[1] - self._dev_crop)
        return self.train_steps([self._gather(ii, ss)
                                 for ii, ss in zip(idx, starts)])

    # ------------------------------------------------------------ validation
    def valid(self, batches):
        """Loss detail over an iterable of batches, as lists of floats (the
        caller takes the mean)."""
        self._require_state()
        acc: dict[str, list] = {}
        with torch.no_grad():
            for batch in batches:
                _, _, detail = self.model(*self._to_device(batch), False)
                for k, v in detail.items():
                    acc.setdefault(k, []).append(v)
        return {k: [float(x) for x in torch.stack(v).cpu()]
                for k, v in acc.items()}

    @property
    def iteration(self):
        return self._host_iter

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, path):
        """Write ``{model, ema, optimizer, iteration, wn_axis_format}`` as
        the JAX trainer does (msgpack, same trees)."""
        self._require_state()
        v = to_jax_variables(self.model.state_dict())
        payload = {
            "model": v["params"],
            "ema": {"ema": v["ema"]} if v["ema"] else {},
            "optimizer": optimizer_to_jax(self.opt_state, self.layout,
                                          self.tx.clips, self.tx.decoupled),
            "iteration": self._host_iter,
            "wn_axis_format": WN_AXIS_FORMAT,
        }
        with open(path, "wb") as f:
            f.write(msgpack_io.msgpack_serialize(payload))

    def load_checkpoint(self, path, example_batch=None):
        """Restore a checkpoint in the JAX format. One of weight-norm axis
        format 1 is migrated (``utils/migrate.py``); the moments are
        re-initialized when it carries no optimizer state or when the
        migration re-decomposed a layer. Returns the stored iteration."""
        if self.flat is None:
            self.init_state(example_batch)
        payload = read_payload(path)
        model, migrated = maybe_migrate_model(
            payload, to_jax_variables(self.model.state_dict())["params"])
        self.model.load_state_dict(
            from_jax_variables(checkpoint_variables(payload, model)),
            strict=True)
        if payload.get("optimizer") and not migrated:
            self.opt_state = OptState(*optimizer_from_jax(
                payload["optimizer"], self.layout, self.tx.clips,
                self.tx.scheduled, self.device, self.tx.decoupled))
        else:
            self.opt_state = self.tx.init(self.flat)
            if migrated and payload.get("optimizer"):
                logging.getLogger("vae_npvc_tpu_torch.train").warning(
                    "weight-norm axis migration applied: optimizer moments "
                    "re-initialized (checkpoint of weight-norm axis format "
                    "1)")
        iteration = int(payload["iteration"])
        self._host_iter = iteration
        return iteration

    def get_model_info(self):
        n = self.flat.numel() if self.flat is not None else 0
        cls = type(self.model)
        return (f"{cls.__module__}.{cls.__name__} ({n / 1e6:.2f}M params, "
                f"device={self.device})")
