"""WGAN-GP adversarial trainer, on one device or data-parallel.

Counterpart of ``vae_npvc_tpu/train/gan.py`` (``GanTrainer``): the
3-phase schedule on the host iteration ``it`` (0 for the first step):

- phase 1 (``it <= pre_iter``): the base trainer's step (forward and
  gradient, clip, optimizer, non-finite guard, EMA commit) on the
  generator's optimizer;
- phase 2, every ``discriminator_param.per_iteration`` iterations, the
  critic step: the generator's training forward without a gradient and
  without committing its EMA codebook state (the pending state, a lazy
  codebook init included, is dropped), then ``-mean D(x) + mean D(x_fake)
  + gp_weight * GP`` with the interpolated-sample penalty
  ``mean((sqrt(|grad D(inter)|^2 + 1e-12) - 1)^2)``, its gradient taken
  with ``create_graph`` (the double backward runs through the critic's
  convolutions only), and the critic's optimizer; no non-finite guard, as
  in JAX;
- phase 3, every ``generator_param.per_iteration`` iterations, the
  generator step: the VAE loss plus ``gamma * (-mean D(G(x)))`` read
  through the critic after its step, with ``ADV loss`` and ``Total`` in
  the detail, and the base step's guard.

Both optimizers are ``RAdam`` with StepLR by default (``train/optim.py``),
each clipping its own network's gradient. The critic step and the
generator step of one iteration reseed the step generator alike, so their
generator forwards draw the same (as both fold ``state.step`` into JAX's
key); the penalty's per-row ``alpha`` is drawn after the critic step's
forward. Two counters: ``iteration`` (the host iteration, which drives the
schedule) and the generator's update count (the JAX ``state.step``).
Checkpoints carry JAX's payload: ``model``, ``discriminator``, ``ema``,
``optimizer_G``, ``optimizer_D``, ``iteration`` (generator updates),
``host_iteration`` and ``wn_axis_format``. A basic trainer's checkpoint
loads with a fresh critic and fresh optimizers (fine-tuning with the
adversary from a VAE pretrain).

With a ``mesh`` (as JAX's ``GanTrainer(config, mesh)`` shards each batch
over its ``data`` axis) each rank takes its rows of the global batch; the
generator's forward sums its EMA statistics and pools its candidates over
the axis in both steps (the critic step still drops the pending state);
the critic's and the generator's flat gradients and the detail are
averaged over the axis; the penalty's ``alpha`` is drawn for the global
batch on every rank and sliced to the rank's rows. A ``model`` axis
shards nothing here: its ranks repeat the step, as the JAX GAN step
replicates its state. Rank 0 writes checkpoints.
"""

from __future__ import annotations

import logging

import torch

from ..infer.convert import checkpoint_variables, read_payload
from ..models.discriminator import Discriminator
from ..parallel import comm
from ..parallel.shard import AXIS, local_rows
from ..utils import msgpack_io
from ..utils.bridge import (from_jax_variables, optimizer_from_jax,
                            optimizer_to_jax, to_jax_variables)
from ..utils.migrate import WN_AXIS_FORMAT, maybe_migrate_model
from .optim import OptState, build_optimizer
from .trainer import Trainer

GEN_DEFAULTS = {"per_iteration": 1, "optim_type": "RAdam",
                "learning_rate": 1e-4, "max_grad_norm": 10,
                "lr_scheduler": {"step_size": 100000, "gamma": 0.5}}
DISC_DEFAULTS = {"per_iteration": 1, "optim_type": "RAdam",
                 "learning_rate": 5e-5, "max_grad_norm": 1,
                 "lr_scheduler": {"step_size": 100000, "gamma": 0.5}}


def _sub_optimizer(param):
    cfg = {"optim_type": param.get("optim_type", "RAdam"),
           "learning_rate": param.get("learning_rate", 1e-4),
           "max_grad_norm": param.get("max_grad_norm", 0),
           "lr_scheduler": "StepLR" if param.get("lr_scheduler") else None,
           "lr_param": param.get("lr_scheduler", {})}
    if "betas" in param:
        cfg["betas"] = tuple(param["betas"])
    return build_optimizer(cfg)


def gp_alpha(gen, shape, device):
    """The penalty's interpolation weights, uniform in [0, 1)."""
    return torch.rand(shape, generator=gen, device=device)


class GanTrainer(Trainer):
    """3-phase WGAN-GP trainer; the base trainer's API."""

    # the critic/generator alternation is per-iteration host control flow
    # with phase-dependent detail keys: bin/train runs single steps
    supports_steps_per_call = False
    # nor is it captured as a CUDA graph
    supports_graphs = False

    def __init__(self, config, device="cuda", seed=None, mesh=None):
        super().__init__(config, device=device, seed=seed, mesh=mesh)
        self.n_model = 1          # the whole parameters on every rank
        if self.grad_accum > 1:
            raise ValueError("grad_accum is not supported by the GAN "
                             "trainer (3-phase step)")
        self.gamma = config.get("gamma", 1.0)
        self.gp_weight = config.get("gp_weight", 1.0)
        self.pre_iter = config.get("pre_iter", 1000)
        self.gen_param = {**GEN_DEFAULTS,
                          **config.get("generator_param", {})}
        self.disc_param = {**DISC_DEFAULTS,
                           **config.get("discriminator_param", {})}
        self.tx = _sub_optimizer(self.gen_param)
        self.tx_d = _sub_optimizer(self.disc_param)
        in_ch = dict(config.get("encoder", {})).get("in_channels", [80])[0]
        self.discriminator = Discriminator(
            config.get("discriminator", {}), in_ch).to(self.device)
        self.d_params = list(self.discriminator.parameters())
        self.d_layout = [(n, tuple(p.shape)) for n, p in
                         self.discriminator.named_parameters()]
        self.d_flat = None
        self.d_opt_state = None
        self.g_step = 0           # generator updates (JAX ``state.step``)

    # ------------------------------------------------------------------ init
    def init_state(self, example_batch=None):
        super().init_state(example_batch)
        self.discriminator.init_random(self.seed + 1)
        with torch.no_grad():
            self.d_flat = torch.cat([p.detach().float().reshape(-1)
                                     for p in self.d_params])
            off = 0
            for p in self.d_params:
                n = p.numel()
                p.data = self.d_flat[off:off + n].view(p.shape)
                off += n
        self.d_opt_state = self.tx_d.init(self.d_flat)
        self.g_step = 0

    def _count_step(self):
        self.g_step += 1

    # ----------------------------------------------------------------- steps
    def _gp(self, x_real, x_fake):
        B = x_real.shape[0]
        alpha = local_rows(
            lambda shape: gp_alpha(self.gen, shape, x_real.device),
            (B,) + (1,) * (x_real.dim() - 1),
            AXIS if self.mesh is not None else None)
        inter = (alpha * x_real + (1.0 - alpha) * x_fake).requires_grad_(True)
        g, = torch.autograd.grad(self.discriminator(inter).sum(), inter,
                                 create_graph=True)
        gnorm = torch.sqrt(torch.sum(g.reshape(B, -1) ** 2, dim=-1) + 1e-12)
        return torch.mean((gnorm - 1.0) ** 2)

    def _disc_step(self, feats, spks, sharded=False):
        self._reseed()
        with self._bound(sharded):
            with torch.no_grad():
                (xhat, _, _), _ = self._forward((feats, spks))
            # JAX discards the forward's mutable EMA collection here
            self.model.pending_ema = None
            x_real, x_fake = feats.float(), xhat.float()
            D = self.discriminator
            disc_loss = -D(x_real).mean() + D(x_fake).mean()
            gp = self._gp(x_real, x_fake)
        grads = torch.autograd.grad(disc_loss + self.gp_weight * gp,
                                    self.d_params)
        flat_g = torch.cat([g.float().reshape(-1) for g in grads])
        flat_g, detail = self._reduced(
            flat_g, {"DISC loss": disc_loss.detach(),
                     "gradient_penalty": gp.detach()}, sharded)
        update, self.d_opt_state = self.tx_d.update(flat_g, self.d_opt_state,
                                                    self.d_flat)
        with torch.no_grad():
            self.d_flat.add_(update)
        return detail

    def _gen_step(self, feats, spks, sharded=False):
        self._begin_step()
        with self._bound(sharded):
            (xhat, loss, detail), pending = self._forward((feats, spks))
            adv = -self.discriminator(xhat.float()).mean()
            total = loss + self.gamma * adv
            flat_g = self._flat_grad(total)
        detail = {k: v.detach() for k, v in detail.items()}
        detail["Total"] = total.detach()
        detail["ADV loss"] = adv.detach()
        flat_g, detail = self._reduced(flat_g, detail, sharded)
        return self._finish_step(flat_g, pending, detail)

    def _step(self, batch, sharded):
        """One iteration of the schedule on this rank's rows of a
        ``(feats, spks)`` batch; returns the detail of the steps it ran as
        device scalars."""
        it = self._host_iter
        if it <= self.pre_iter:
            detail = self._train_step(batch, sharded)
        else:
            detail = {}
            if it % self.disc_param["per_iteration"] == 0:
                detail.update(self._disc_step(*batch, sharded))
            if it % self.gen_param["per_iteration"] == 0:
                detail.update(self._gen_step(*batch, sharded))
        self._host_iter = it + 1
        return detail

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, path):
        """Write the JAX GAN trainer's payload (msgpack, same trees). On a
        mesh rank 0 writes and every rank waits for the write."""
        self._require_state()
        if self.writes:
            self._write_checkpoint(path)
        if self.mesh is not None:
            comm.barrier()

    def _write_checkpoint(self, path):
        v = to_jax_variables(self.model.state_dict())
        payload = {
            "wn_axis_format": WN_AXIS_FORMAT,
            "model": v["params"],
            "discriminator": to_jax_variables(
                self.discriminator.state_dict())["params"],
            "ema": {"ema": v["ema"]} if v["ema"] else {},
            "optimizer_G": optimizer_to_jax(self.opt_state, self.layout,
                                            self.tx.clips,
                                            self.tx.decoupled),
            "optimizer_D": optimizer_to_jax(self.d_opt_state, self.d_layout,
                                            self.tx_d.clips,
                                            self.tx_d.decoupled),
            "iteration": self.g_step,
            "host_iteration": self._host_iter,
        }
        with open(path, "wb") as f:
            f.write(msgpack_io.msgpack_serialize(payload))

    def load_checkpoint(self, path, example_batch=None):
        """Restore a GAN checkpoint of either package, or a basic
        trainer's (then the critic and both optimizers start fresh).
        Returns the host iteration."""
        if self.flat is None:
            self.init_state(example_batch)
        payload = read_payload(path)
        model, migrated = maybe_migrate_model(
            payload, to_jax_variables(self.model.state_dict())["params"])
        self.model.load_state_dict(
            from_jax_variables(checkpoint_variables(payload, model)),
            strict=True)
        if payload.get("optimizer_G") and not migrated:
            self.opt_state = OptState(*optimizer_from_jax(
                payload["optimizer_G"], self.layout, self.tx.clips,
                self.tx.scheduled, self.device, self.tx.decoupled))
        else:
            self.opt_state = self.tx.init(self.flat)
            if migrated:
                logging.getLogger("vae_npvc_tpu_torch.train").warning(
                    "weight-norm axis migration applied: generator "
                    "optimizer moments re-initialized (checkpoint of "
                    "weight-norm axis format 1)")
        if payload.get("discriminator"):
            self.discriminator.load_state_dict(
                from_jax_variables({"params": payload["discriminator"]}),
                strict=True)
        if payload.get("optimizer_D"):
            self.d_opt_state = OptState(*optimizer_from_jax(
                payload["optimizer_D"], self.d_layout, self.tx_d.clips,
                self.tx_d.scheduled, self.device, self.tx_d.decoupled))
        self.g_step = int(payload["iteration"])
        self._host_iter = int(payload.get("host_iteration",
                                          payload["iteration"]))
        return self._host_iter
