"""Parallel WaveGAN vocoder trainer, on one device or data-parallel.

Counterpart of ``vae_npvc_tpu/train/pwg.py`` (``PwgTrainer``): the
published scheme (Yamamoto et al., ICASSP 2020) in the JAX step's order.

- The generator's loss is spectral convergence + log-STFT magnitude
  (``ops/stft_loss.py``, the multi-resolution set) + ``lambda_adv *
  E[(D(x_hat) - 1)^2]`` read through the discriminator's parameters of
  before the step. The adversarial term is computed and reported from the
  first step; it weighs 0 before ``discriminator_train_start_steps``.
- The discriminator's loss is ``E[(D(x) - 1)^2] + E[D(x_hat)^2]`` on the
  same forward pass's ``x_hat``, without its gradient. Before the start
  step its parameters, optimizer state and StepLR count do not move (its
  losses are still reported).
- Two optimizers, RAdam 1e-4 for G and 5e-5 for D with betas (0.9, 0.999)
  by default, each clipping its own network's gradient (10 and 1).

Every parameter of a network lives in one flat fp32 vector (the modules'
parameters are views into it) beside its optimizer's moments, as in
``train/trainer.py``. The noise ``z`` (B, S, 1) of a step, and the crops of
``train_steps_device``, come from a ``torch.Generator`` on the trainer's
device reseeded from ``(seed, step)``, so a resumed run draws what an
uninterrupted one would; they are not ``jax.random``'s draws, so a step
takes an injected ``z`` for the lockstep tests.

With a ``mesh`` (``parallel/mesh.py``) the step is data-parallel: each rank
of the ``data`` axis takes its rows of the global batch (and of the global
noise, drawn whole on every rank from the same generator), and the
generator's and the discriminator's flat gradients are each averaged over
the axis before their updates, as the JAX GSPMD step reduces them; the
detail is averaged too. Both losses are means over the batch's rows, so
equal shards give the global batch's values. Rank 0 writes checkpoints.

Detail keys: ``Total``, ``spectral_convergence``, ``log_stft_magnitude``,
``adversarial``, ``disc_real``, ``disc_fake``. Checkpoints: msgpack
``{generator, discriminator, optimizer_G, optimizer_D, iteration}``, as the
JAX trainer writes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.pwg import PWGDiscriminator, PWGGenerator
from ..ops.stft_loss import DEFAULT_RESOLUTIONS, multi_stft_loss
from ..utils import msgpack_io
from ..utils.bridge import (from_jax_variables, optimizer_from_jax,
                            optimizer_to_jax, to_jax_variables)
from ..parallel import comm
from ..parallel.shard import AXIS, mean_detail, shard_rows
from ..utils.device import resolve_device
from .optim import OptState, build_optimizer

# the published PWG betas are RAdam's defaults (0.9, 0.999), not the VC
# trainer's (0.5, 0.999)
GEN_DEFAULTS = {"optim_type": "RAdam", "learning_rate": 1e-4,
                "betas": (0.9, 0.999), "max_grad_norm": 10,
                "lr_scheduler": {"step_size": 200000, "gamma": 0.5}}
DISC_DEFAULTS = {"optim_type": "RAdam", "learning_rate": 5e-5,
                 "betas": (0.9, 0.999), "max_grad_norm": 1,
                 "lr_scheduler": {"step_size": 200000, "gamma": 0.5}}


def _sub_optimizer(param):
    cfg = {"optim_type": param.get("optim_type", "RAdam"),
           "learning_rate": param.get("learning_rate", 1e-4),
           "betas": tuple(param.get("betas", (0.9, 0.999))),
           "max_grad_norm": param.get("max_grad_norm", 0),
           "lr_scheduler": "StepLR" if param.get("lr_scheduler") else None,
           "lr_param": param.get("lr_scheduler", {})}
    return build_optimizer(cfg)


class _Net:
    """One network with its flat parameter vector and optimizer state."""

    def __init__(self, module, tx):
        self.module, self.tx = module, tx
        self.params = list(module.parameters())
        self.layout = [(n, tuple(p.shape))
                       for n, p in module.named_parameters()]
        self.flat = None
        self.opt_state = None

    def flatten(self):
        """Move the parameters into one flat vector; each becomes a view of
        its slice."""
        with torch.no_grad():
            self.flat = torch.cat([p.detach().float().reshape(-1)
                                   for p in self.params])
            off = 0
            for p in self.params:
                n = p.numel()
                p.data = self.flat[off:off + n].view(p.shape)
                off += n
        self.opt_state = self.tx.init(self.flat)

    def step(self, loss, mesh=None):
        """Gradient of ``loss`` over this network (averaged over the data
        axis of ``mesh``), then the update."""
        grads = torch.autograd.grad(loss, self.params)
        flat_g = torch.cat([g.float().reshape(-1) for g in grads])
        if mesh is not None:
            with comm.bind(mesh, (AXIS,)):
                comm.pmean_(flat_g, AXIS)
        update, self.opt_state = self.tx.update(flat_g, self.opt_state,
                                                self.flat)
        with torch.no_grad():
            self.flat.add_(update)

    def params_tree(self):
        return to_jax_variables(self.module.state_dict())["params"]

    def opt_tree(self):
        return optimizer_to_jax(self.opt_state, self.layout, self.tx.clips,
                                self.tx.decoupled)

    def load(self, params, opt_tree, device):
        self.module.load_state_dict(from_jax_variables({"params": params}),
                                    strict=True)
        self.opt_state = OptState(*optimizer_from_jax(
            opt_tree, self.layout, self.tx.clips, self.tx.scheduled, device,
            self.tx.decoupled))


class PwgTrainer:
    """Owns the generator, the discriminator and the GAN step on ``device``
    (the GPU unless the caller asks for the CPU)."""

    def __init__(self, config, device="cuda", seed=None, mesh=None):
        self.config = dict(config)
        self.device = resolve_device(device)
        self.mesh = mesh
        scales = self.config.get("upsample_scales", (4, 4, 4, 4))
        self.hop = math.prod(scales)
        if "n_shift" in self.config and self.hop != self.config["n_shift"]:
            raise ValueError(
                f"prod(upsample_scales)={self.hop} must equal the fbank hop "
                f"n_shift={self.config['n_shift']}")
        self.generator = PWGGenerator(self.config).to(self.device)
        self.discriminator = PWGDiscriminator(self.config).to(self.device)
        self.G = _Net(self.generator, _sub_optimizer(
            {**GEN_DEFAULTS, **self.config.get("generator_param", {})}))
        self.D = _Net(self.discriminator, _sub_optimizer(
            {**DISC_DEFAULTS, **self.config.get("discriminator_param", {})}))
        self.lambda_adv = self.config.get("lambda_adv", 4.0)
        self.d_start = self.config.get("discriminator_train_start_steps",
                                       100000)
        self.resolutions = tuple(
            tuple(r) for r in self.config.get("stft_loss_params",
                                              DEFAULT_RESOLUTIONS))
        self.seed = int(self.config.get("seed", 777) if seed is None
                        else seed)
        self.gen = torch.Generator(device=self.device)
        self._host_step = 0
        self._dev_data = None

    # ------------------------------------------------------------------ init
    def init_state(self, example_batch=None):
        """Seeded random weights (G from ``seed``, D from ``seed + 1``) and
        fresh optimizer states at step 0. ``example_batch`` is accepted for
        the JAX trainer's signature; the shapes come from the config."""
        self.generator.init_random(self.seed)
        self.discriminator.init_random(self.seed + 1)
        self.G.flatten()
        self.D.flatten()
        self._host_step = 0

    def _require_state(self):
        if self.G.flat is None:
            raise ValueError("call init_state first")

    @property
    def iteration(self):
        return self._host_step

    def _reseed(self):
        step_seed = self.seed * 1_000_003 + self._host_step
        self.gen.manual_seed(step_seed % (1 << 63))

    def noise(self, B, S):
        """The step's noise (B, S, 1), drawn after :meth:`_reseed`."""
        return torch.randn((B, S, 1), generator=self.gen,
                           device=self.device)

    # ------------------------------------------------------------------ step
    def _step(self, wav, mel, z):
        mesh = None
        if self.mesh is not None:
            (wav, mel, z), sharded = shard_rows((wav, mel, z), self.mesh)
            mesh = self.mesh if sharded else None
        active = self._host_step >= self.d_start
        wav_hat = self.generator(z, mel)[..., 0]
        sc, mag = multi_stft_loss(wav_hat, wav, self.resolutions)
        # the adversarial term through D's old parameters; before the
        # start step only its value is needed
        with torch.set_grad_enabled(active):
            adv = torch.mean((self.discriminator(wav_hat[..., None])
                              - 1.0) ** 2)
        total = sc + mag + (self.lambda_adv * float(active)) * adv
        self.G.step(total, mesh)

        # D on the same forward's x_hat, real and fake in one batch
        fake = wav_hat.detach()
        with torch.set_grad_enabled(active):
            logits = self.discriminator(torch.cat([wav, fake])[..., None])
            real_l, fake_l = logits.split(wav.shape[0])
            d_real = torch.mean((real_l - 1.0) ** 2)
            d_fake = torch.mean(fake_l ** 2)
        if active:
            self.D.step(d_real + d_fake, mesh)
        self._host_step += 1
        detail = {"Total": total.detach(), "spectral_convergence": sc.detach(),
                  "log_stft_magnitude": mag.detach(),
                  "adversarial": adv.detach(), "disc_real": d_real.detach(),
                  "disc_fake": d_fake.detach()}
        if mesh is not None:
            with comm.bind(mesh, (AXIS,)):
                detail = mean_detail(detail)
        return detail

    def _dev(self, a):
        if torch.is_tensor(a):
            return a.to(self.device, torch.float32)
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    def train_step(self, batch, z=None):
        """One step on ``batch`` = (wav (B, S), mel (B, M, n_mels)); ``z``
        (B, S, 1) replaces the step's own noise. Returns the loss detail as
        device scalars."""
        self._require_state()
        wav, mel = (self._dev(a) for a in batch)
        self._reseed()
        z = (self.noise(*wav.shape) if z is None else self._dev(z))
        return self._step(wav, mel, z)

    def train_steps(self, batches):
        """K steps over a list of K batches (or the ``(wavs, mels)`` pair of
        :meth:`stage_batches`); the detail with a leading (K,) axis."""
        if isinstance(batches, tuple) and torch.is_tensor(batches[0]):
            batches = list(zip(*batches))
        details = [self.train_step(b) for b in batches]
        return {k: torch.stack([d[k] for d in details]) for k in details[0]}

    def stage_batches(self, batches):
        """Stack K host batches and upload them once: ``(wavs (K, B, S),
        mels (K, B, M, n_mels))`` on the device, which :meth:`train_steps`
        takes."""
        wavs = np.stack([np.asarray(b[0]) for b in batches])
        mels = np.stack([np.asarray(b[1]) for b in batches])
        return self._dev(wavs), self._dev(mels)

    # ------------------------------------------------- device-resident data
    def stage_dataset(self, dataset, batch_size):
        """Upload the whole corpus to the device once
        (``WavMelDataset.padded_arrays``); :meth:`train_steps_device` then
        draws random aligned crops there. Returns the staged bytes."""
        wavs, mels, m_hi = dataset.padded_arrays()
        self._dev_data = (self._dev(wavs), self._dev(mels),
                          torch.as_tensor(m_hi, device=self.device))
        self._dev_batch = int(batch_size)
        self._dev_M = dataset.max_frames
        return wavs.nbytes + mels.nbytes

    def _sample(self):
        """One step's crops and noise from the reseeded generator: the
        utterances, the starts (uniform over each one's valid starts), then
        the noise, as JAX's sampler splits its key three ways."""
        wavs, mels, m_hi = self._dev_data
        B, M, hop = self._dev_batch, self._dev_M, self.hop
        idx = torch.randint(0, wavs.shape[0], (B,), generator=self.gen,
                            device=self.device)
        u = torch.rand((B,), generator=self.gen, device=self.device)
        m0 = (u * (m_hi[idx] + 1).float()).long()
        frames = m0[:, None] + torch.arange(M, device=self.device)
        mel = mels[idx[:, None], frames]
        samples = m0[:, None] * hop + torch.arange(M * hop,
                                                   device=self.device)
        wav = wavs[idx[:, None], samples]
        return wav, mel, self.noise(B, M * hop)

    def train_steps_device(self, K):
        """K steps on crops drawn on the device from the staged corpus."""
        if self._dev_data is None:
            raise ValueError("call stage_dataset first")
        self._require_state()
        details = []
        for _ in range(K):
            self._reseed()
            details.append(self._step(*self._sample()))
        return {k: torch.stack([d[k] for d in details]) for k in details[0]}

    # ------------------------------------------------------------- synthesis
    def synthesize(self, mel, z=None, seed=0):
        """(B, T, n_mels) log-mel -> (B, T * hop) waveform (numpy); ``z``
        (B, T * hop, 1) defaults to ``infer/vocoder.decode_noise``'s first
        draw for ``seed``."""
        from ..infer.vocoder import decode_noise, run_generator

        mel = self._dev(mel)
        B, T = mel.shape[0], mel.shape[1]
        if z is None:
            z = decode_noise(seed, 0, (B, T * self.hop, 1), self.device)
        return run_generator(self.generator, self._dev(z), mel)

    # ------------------------------------------------------- checkpointing
    def save_checkpoint(self, path):
        """Rank 0 writes; on a mesh every rank waits for the write."""
        self._require_state()
        if self.mesh is None or self.mesh.rank == 0:
            payload = {
                "generator": self.G.params_tree(),
                "discriminator": self.D.params_tree(),
                "optimizer_G": self.G.opt_tree(),
                "optimizer_D": self.D.opt_tree(),
                "iteration": self._host_step,
            }
            with open(path, "wb") as f:
                f.write(msgpack_io.msgpack_serialize(payload))
        if self.mesh is not None:
            comm.barrier()

    def load_checkpoint(self, path, example_batch=None):
        """Restore a checkpoint of the JAX trainer or of this one; returns
        its iteration."""
        if self.G.flat is None:
            self.init_state(example_batch)
        with open(path, "rb") as f:
            payload = msgpack_io.msgpack_restore(f.read())
        self.G.load(payload["generator"], payload["optimizer_G"],
                    self.device)
        self.D.load(payload["discriminator"], payload["optimizer_D"],
                    self.device)
        self._host_step = int(payload["iteration"])
        return self._host_step
