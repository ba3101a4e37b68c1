"""Trainer: the train step, validation and checkpointing.

Counterpart of the core of ``vae_npvc_tpu/train/trainer.py`` (``Trainer``:
``init_state``, ``train_step``, ``train_steps``, the non-finite guard,
``grad_accum``, ``valid``, ``stage_dataset`` + ``train_steps_indices``,
``train_steps_device``, ``save_checkpoint`` / ``load_checkpoint`` in the
JAX checkpoint format, ``shard_batch``, ``_assemble_multihost`` and the
model-axis shardings of a mesh). It drives any registered model: the flat
VQ-VAE with its EMA codebook and ``(feats, spks)`` batches, the hierarchical VQ-VAEs with one
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

With a ``mesh`` (``parallel/mesh.py``, one process per rank) the step is
data-parallel (``parallel/shard.py``): each rank of the ``data`` axis takes
its rows of the global batch (with ``grad_accum``, its part of each
global microbatch, as JAX shards each microbatch), the flat gradient and
the detail are averaged over the axis, every EMA codebook (the flat one
and each level of a hierarchy) sums its statistics and pools its
candidates over it, and the models keep the global batch's masked means, root mean squares and
per-row draws. The device-resident corpus draws the global batch's windows
alike on every rank and gathers the rank's rows only. A ``model`` axis
above 1 splits parameters and Adam moments by the shape-generic rule
(``parallel/tp.py``): each rank updates its slices and all-gathers the
whole parameters after the step.
Checkpoints hold the whole trees in the JAX format; rank 0 writes them and
every rank waits for the write.

On a CUDA device without a mesh, the windowed step (the staged corpus's
windows, :meth:`Trainer.train_steps_indices` and
:meth:`Trainer.train_steps_device`) is replayed as a CUDA graph: a window
shape's first step runs eager, its second captures :meth:`Trainer._step`
(gather, forward, gradient, update) into one graph with a private memory
pool, and every step then copies its windows into the graph's static
inputs, reseeds the step's generators on the host (they are registered
with the graph, so a replay draws what the eager step draws) and replays
it. The state the step updates is written in place (parameters, Adam's
state, the EMA codebooks), so one capture serves every later step;
staging a corpus, :meth:`Trainer.init_state` and
:meth:`Trainer.load_checkpoint` drop the graphs. Host batches, a mesh,
the CPU and a trainer whose step is host control flow
(``supports_graphs`` False) stay eager, and so does every step inside
``with Trainer.eager_steps():`` (to see each kernel wrapper's calls, or
as an eager reference). ``Trainer.graph_captures`` and
``Trainer.graph_replays`` count the mechanism's use. The kernel wrappers'
``.launches`` count their calls: an eager step's and a capture's, and
none of a replay, which calls no Python.

With the span recorder on (``utils/spans.py``) a call records
``train.call``, each optimizer step ``train.step`` and within it
``step.gather``, ``step.forward`` and ``step.backward`` (once a
microbatch) and ``step.update`` (of a graphed step at its capture only,
each replay ``step.replay``); the stacking of the details is
``train.stack``.
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

from ..infer.convert import checkpoint_variables, read_payload
from ..models import build_model, codebook_renorm_fn
from ..models.hier_common import HierVQMixin
from ..models.vqvae import EmaQuantizer
from ..ops.vq import ema_vq_init
from ..parallel import comm
from ..parallel.shard import (AXIS, bind_data, enable_explicit_dp,
                              mean_detail, reduce_gradient, shard_rows)
from ..utils import msgpack_io, spans
from ..utils.bridge import (from_jax_variables, optimizer_from_jax,
                            optimizer_to_jax, to_jax_variables)
from ..utils.migrate import WN_AXIS_FORMAT, maybe_migrate_model
from .optim import OptState, build_optimizer

# the iid sampler's stream, apart from the VQ draws' (JAX folds the same
# constant into its base key)
IID_SALT = 0x5A5A5A


def _stacked(details):
    """Per-step details stacked: each key with a leading (K,) axis."""
    with spans.span("train.stack"):
        return {k: torch.stack([d[k] for d in details]) for k in details[0]}


class _StepGraph:
    """One captured windowed step: the graph and its static inputs and
    outputs."""

    __slots__ = ("graph", "idx", "starts", "detail")


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
    # its windowed step may be captured and replayed as a CUDA graph
    supports_graphs = True

    # windowed steps captured as CUDA graphs, and steps replayed from them
    graph_captures = 0
    graph_replays = 0
    # set inside :meth:`eager_steps`
    _eager_only = False

    def __init__(self, config, device="cuda", seed=None, mesh=None):
        self.config = config
        # with a mesh the model reduces over the data axis where the global
        # batch's values are not a mean of the ranks' (parallel/shard.py)
        self.model = build_model(
            config if mesh is None else enable_explicit_dp(config), device)
        self.device = next(self.model.parameters()).device
        self.mesh = mesh
        self.n_model = dict(mesh.shape).get("model", 1) if mesh else 1
        self.tp_min_param_size = config.get("tp_min_param_size", 1024)
        self._tp = None           # parallel.tp.TpLayout, with a model axis
        self._warned_shard = False
        self._batch_spec = None   # ((trailing shape, dtype), ...) seen last
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
        self._graphs = {}         # window shape -> _StepGraph
        self._warm = set()        # window shapes that ran one eager step
        self._pool = None         # the graphs' private memory pool
        self._capturing = False

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
        self._drop_graphs()
        self.model.init_random(self.seed)
        for q in self.ema.values():
            q.set_state(ema_vq_init(*q.emb.shape, device=self.device))
        self._flatten_parameters()
        self._init_layout()
        self.opt_state = self.tx.init(self._opt_vector())
        self._host_iter = 0
        if example_batch is not None:
            self._note_spec(example_batch)

    def _init_layout(self):
        """With a model axis, the slices this rank keeps (tp.TpLayout)."""
        if self.n_model > 1 and self._tp is None:
            from ..parallel.tp import TpLayout

            self._tp = TpLayout(self.layout, self.n_model,
                                self.mesh.coords["model"],
                                self.tp_min_param_size, self.device)

    def _opt_vector(self):
        """The vector the optimizer updates: every parameter, or with a
        model axis this rank's slices and the whole parameters."""
        return self.flat if self._tp is None else self._tp.local(self.flat)

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
        if not self._capturing:     # a replay is reseeded before it runs
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
        with spans.span("step.forward"):
            out = self.model(*batch, True, gen=self.gen, **kwargs)
        pending = self.model.pending_ema if self.has_ema else None
        if pending is not None and not self._hier:
            pending = {"quantizer": pending}
        return out, pending

    def _flat_grad(self, loss):
        with spans.span("step.backward"):
            grads = torch.autograd.grad(loss, self.params)
            return torch.cat([g.float().reshape(-1) for g in grads])

    def _loss_and_grad(self, batch, ema=None):
        """Flat gradient, the pending EMA states (by name) and the detail
        of one (micro)batch; ``ema`` chains microbatches."""
        (_, loss, detail), pending = self._forward(batch, ema)
        flat_g = self._flat_grad(loss)
        return flat_g, pending, {k: v.detach() for k, v in detail.items()}

    # ----------------------------------------------------------- mesh
    def shard_batch(self, batch, micro=1):
        """``(local batch, sharded)``: this rank's rows of the global
        batch cut into ``micro`` microbatches (``parallel/shard.shard_rows``:
        each microbatch split over the data axis, the rank's parts in
        microbatch order), or without a mesh the batch itself. A batch
        whose microbatch the data axis does not divide runs whole on every
        rank (``sharded`` False), as the JAX trainer replicates it."""
        if self.mesh is None:
            return batch, False
        local, sharded = shard_rows(batch, self.mesh, micro=micro)
        if not sharded and not self._warned_shard:
            B = batch[0].shape[0]
            rows = (f"batch size {B}" if micro == 1 else
                    f"batch size {B} in {micro} microbatches")
            logging.getLogger("vae_npvc_tpu_torch.train").warning(
                f"{rows} not divisible by data-axis size "
                f"{self.mesh.shape['data']}; replicating this batch")
            self._warned_shard = True
        return local, sharded

    def _bound(self, sharded):
        """The data axis bound around a step's model calls: the mesh's
        when the ranks split the batch, an axis of one when each holds it
        whole (no mesh: nothing to bind)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return bind_data(self.mesh, sharded)

    def _reduced(self, flat_g, detail, sharded):
        """The sharded step's means over the data axis."""
        if not sharded:
            return flat_g, detail
        with comm.bind(self.mesh, (AXIS,)):
            return reduce_gradient(flat_g, detail)

    def _train_step(self, batch, sharded):
        """One optimizer step on this rank's rows (``sharded``: the ranks
        split the global batch)."""
        self._begin_step()
        with self._bound(sharded):
            flat_g, new_ema, detail = self._loss_and_grad(batch)
        flat_g, detail = self._reduced(flat_g, detail, sharded)
        return self._finish_step(flat_g, new_ema, detail)

    def _train_step_accum(self, batch, sharded):
        """One optimizer step from the mean of ``grad_accum`` microbatch
        gradients; the EMA codebook statistics chain through the
        microbatches in order, the detail is their mean. ``batch`` holds
        this rank's part of each global microbatch in order
        (:meth:`shard_batch` by ``grad_accum``, the one split of every
        training entry point), so slice i is its part of microbatch i."""
        k = self.grad_accum
        B = batch[0].shape[0]
        if B % k != 0:
            raise ValueError(
                f"grad_accum={k} requires the batch size to be divisible; "
                f"got {B}")
        self._begin_step()
        ema = self._ema_states() if self.has_ema else None
        gsum, details = None, []
        with self._bound(sharded):
            for i in range(k):
                mb = tuple(a[i * (B // k):(i + 1) * (B // k)] for a in batch)
                flat_g, ema, detail = self._loss_and_grad(mb, ema)
                gsum = flat_g if gsum is None else gsum + flat_g
                details.append(detail)
        detail = {key: torch.stack([d[key] for d in details]).mean(dim=0)
                  for key in details[0]}
        flat_g, detail = self._reduced(gsum / k, detail, sharded)
        return self._finish_step(flat_g, ema, detail)

    def _finish_step(self, flat_g, new_ema, detail):
        """Optimizer update and non-finite guard; commits the parameters,
        the optimizer state and the EMA codebooks. With a model axis the
        update is of this rank's slices (the gradient reduce-scattered, the
        norm summed over the axis), then the whole parameters are
        gathered."""
        with spans.span("step.update"):
            params = self._opt_vector()
            if self._tp is None:
                grad_sq = torch.sum(flat_g * flat_g)
                update, opt_state = self.tx.update(flat_g, self.opt_state,
                                                   params)
            else:
                with comm.bind(self.mesh, ("model",)):
                    flat_g = self._tp.reduce_scatter(flat_g)
                    grad_sq = self._tp.sq_norm(flat_g)
                update, opt_state = self.tx.update(flat_g, self.opt_state,
                                                   params, torch.sqrt(grad_sq))
            new_params = params + update
            if self.skip_nonfinite:
                ok = torch.isfinite(grad_sq)
                new_params = torch.where(ok, new_params, params)
                opt_state = _select(ok, opt_state, self.opt_state)
                if new_ema is not None:
                    new_ema = {n: _select(ok, s, self.ema[n].state())
                               for n, s in new_ema.items()}
                detail["skipped_nonfinite"] = 1.0 - ok.float()
            with torch.no_grad():
                if self._tp is None:
                    self.flat.copy_(new_params)
                else:
                    with comm.bind(self.mesh, ("model",)):
                        self._tp.gather(new_params, self.flat)
                # in place, so that a captured step updates the state the
                # next replay reads
                for old, new in zip(self.opt_state, opt_state):
                    if old is not None:
                        old.copy_(new)
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
        with spans.span("train.step"):
            return self._step(*self.shard_batch(self._to_device(batch),
                                                self.grad_accum))

    def _step(self, batch, sharded):
        """One optimizer step on this rank's rows of a global batch."""
        if self.grad_accum > 1:
            return self._train_step_accum(batch, sharded)
        return self._train_step(batch, sharded)

    def train_steps(self, batches):
        """K sequential optimizer steps over a list of K batches; returns
        the detail with a leading (K,) axis per key."""
        with spans.span("train.call"):
            return _stacked([self.train_step(b) for b in batches])

    # ------------------------------------------------- device-resident data
    def stage_dataset(self, dataset, batch_size):
        """Upload the whole training corpus to the device once;
        :meth:`train_steps_indices` then gathers host-chosen windows there
        and :meth:`train_steps_device` draws ``batch_size`` windows a step
        there, so at most indices cross to the device per step. Returns the
        staged feature bytes."""
        feats, n_frames, spk_ids = dataset.padded_arrays()
        self._drop_graphs()
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
        with spans.span("step.gather"):
            frames = torch.arange(self._dev_crop, device=self.device)
            return feats[idx[:, None], starts[:, None] + frames], \
                spk_ids[idx]

    def _window_step(self, idx, starts):
        """One step on the global batch's windows ``(idx[B], starts[B])``
        (every rank holds the same): each rank gathers its own rows."""
        with spans.span("train.step"):
            if self._graphed():
                return self._graph_step(idx, starts)
            (idx, starts), sharded = self.shard_batch((idx, starts),
                                                      self.grad_accum)
            return self._step(self._gather(idx, starts), sharded)

    # ----------------------------------------------------------- CUDA graphs
    @staticmethod
    @contextlib.contextmanager
    def eager_steps():
        """Every trainer's windowed steps run eager inside the block, so
        that each kernel wrapper sees every call (recording a step's calls,
        an eager reference beside a graphed trainer). The graphs captured
        before are kept: the state they read is written in place."""
        before = Trainer._eager_only
        Trainer._eager_only = True
        try:
            yield
        finally:
            Trainer._eager_only = before

    def _graphed(self):
        """Whether the windowed step is replayed as a CUDA graph: a CUDA
        device and no mesh (gloo's host transport cannot be captured),
        outside :meth:`eager_steps`."""
        return (self.supports_graphs and not Trainer._eager_only
                and self.mesh is None and self.device.type == "cuda")

    def _drop_graphs(self):
        """Forget the captured steps: they read the staged corpus and the
        training state by address."""
        self._graphs.clear()
        self._pool = None

    def _graph_step(self, idx, starts):
        """One windowed step replayed from its shape's graph. The shape's
        first step runs eager (it builds the kernels and sets up the
        libraries' workspaces); the next one captures the graph."""
        key = tuple(idx.shape)
        g = self._graphs.get(key)
        if g is None:
            if key not in self._warm:
                detail = self._step(self._gather(idx, starts), False)
                self._warm.add(key)
                return detail
            g = self._graphs[key] = self._capture(idx, starts)
        g.idx.copy_(idx)
        g.starts.copy_(starts)
        self._reseed()
        with spans.span("step.replay"):
            g.graph.replay()
        self._count_step()
        Trainer.graph_replays += 1
        # the graph's outputs are overwritten by its next replay
        return {k: v.clone() for k, v in g.detail.items()}

    def _capture(self, idx, starts):
        """Capture :meth:`_step` on the windows held in new static
        buffers. Nothing runs: the host iteration is left as it was (the
        kernel wrappers count the calls the capture made)."""
        g = _StepGraph()
        g.idx, g.starts = idx.clone(), starts.clone()
        g.graph = torch.cuda.CUDAGraph()
        # the lazy init's and the restarts' draws: a replay takes the
        # generators' seeds and offsets as they are when it is launched
        for gen in (self.gen, *(self.level_gens or {}).values()):
            g.graph.register_generator_state(gen)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        it = self._host_iter
        self._capturing = True
        try:
            with torch.cuda.graph(g.graph, pool=self._pool):
                g.detail = self._step(self._gather(g.idx, g.starts), False)
        finally:
            self._capturing = False
            self._host_iter = it
        Trainer.graph_captures += 1
        return g

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
        with spans.span("train.call"):
            return _stacked([self._window_step(
                *self._sample_iid(self._host_iter)) for _ in range(K)])

    def train_steps_indices(self, idx, starts):
        """K steps gathering host-chosen windows from the staged corpus.
        ``idx``/``starts`` are (K, B) int arrays from
        :func:`..data.dataset.index_iterator`."""
        self._require_corpus()
        self._require_state()
        with spans.span("train.call"):
            feats = self._dev_corpus[0]
            idx = torch.as_tensor(np.asarray(idx), device=self.device).long()
            starts = torch.as_tensor(np.asarray(starts), device=self.device) \
                .long().clamp(0, feats.shape[1] - self._dev_crop)
            return _stacked([self._window_step(ii, ss)
                             for ii, ss in zip(idx, starts)])

    # ------------------------------------------------------------ validation
    def _valid_detail(self, batch):
        """The loss detail of one global batch: split over the data axis
        (the detail averaged over it) when the axis divides it, else whole
        on every rank, as the JAX trainer replicates such a batch."""
        local, sharded = self.shard_batch(batch)
        with self._bound(sharded):
            detail = self.model(*local, False)[2]
            return mean_detail(detail) if sharded else detail

    def valid(self, batches):
        """Loss detail over an iterable of batches, as lists of floats (the
        caller takes the mean).

        With several data-axis ranks each rank passes its own stream of
        local batches, which may differ in count and size: every rank
        drains its stream, adds a zero-row batch once it is exhausted, and
        every global batch is assembled from all ranks' rows in rank order
        (:meth:`_assemble_multihost`); the loop ends when the global row
        count is 0, after the same number of steps on every rank.
        """
        self._require_state()
        acc: dict[str, list] = {}
        multi = self.mesh is not None and self.mesh.shape["data"] > 1
        with torch.no_grad():
            it = iter(batches)
            while True:
                batch = next(it, None)
                if multi:
                    if batch is None:
                        batch = self._empty_local_batch()
                    batch, total = self._assemble_multihost(batch)
                    if total == 0:
                        break
                elif batch is None:
                    break
                else:
                    batch = self._to_device(batch)
                detail = self._valid_detail(batch)
                for k, v in detail.items():
                    acc.setdefault(k, []).append(v)
        return {k: [float(x) for x in torch.stack(v).cpu()]
                for k, v in acc.items()}

    def _note_spec(self, batch):
        self._batch_spec = tuple(
            (tuple(a.shape[1:]), a.dtype if torch.is_tensor(a)
             else torch.as_tensor(np.asarray(a)[:0]).dtype) for a in batch)

    def _empty_local_batch(self):
        """A zero-row batch of the last spec seen (a drained stream)."""
        if self._batch_spec is None:
            raise ValueError("a rank drained its stream before seeing a "
                             "batch: pass example_batch to init_state")
        return tuple(torch.zeros((0,) + shape, dtype=dtype,
                                 device=self.device)
                     for shape, dtype in self._batch_spec)

    def _assemble_multihost(self, batch):
        """The global batch of every data-axis rank's local rows, in rank
        order: ``(arrays on the device, rows)``.

        Every rank first gathers one small int vector ``[rows, trailing
        dims...]``; every branch then depends only on that shared vector.
        The trailing dims are the maximum over ranks that hold rows; each
        rank pads its rows to the largest count, the padded blocks are
        gathered and the true rows re-sliced in rank order. ``rows == 0``
        (every rank empty) returns ``(None, 0)``, the same decision on every
        rank. A rank with no rows left still takes part, which is how
        :meth:`valid` drains unequal streams.
        """
        arrs = [torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                else a).to(self.device) for a in batch]
        if arrs[0].shape[0] > 0:
            self._note_spec(arrs)
        vec = torch.tensor([arrs[0].shape[0]] + [d for a in arrs
                                                 for d in a.shape[1:]],
                           dtype=torch.int64, device=self.device)
        with comm.bind(self.mesh, (AXIS,)):
            all_vecs = comm.all_gather(vec, AXIS).cpu().numpy()
            sizes = all_vecs[:, 0]
            total = int(sizes.sum())
            if total == 0:
                return None, 0
            tmax = all_vecs[sizes > 0, 1:].max(axis=0)
            max_b = int(sizes.max())
            out, off = [], 0
            for a in arrs:
                nd = a.dim() - 1
                tshape = tuple(int(x) for x in tmax[off:off + nd])
                off += nd
                pad = torch.zeros((max_b,) + tshape, dtype=a.dtype,
                                  device=self.device)
                # a drained rank's spec may be wider than the real rows:
                # crop to the agreed dims
                sl = tuple(slice(0, min(x, t)) for x, t in
                           zip(a.shape[1:], tshape))
                pad[(slice(0, a.shape[0]),) + sl] = a[(slice(None),) + sl]
                g = comm.all_gather(pad, AXIS)
                out.append(torch.cat([g[r, :int(sizes[r])]
                                      for r in range(len(sizes))]))
        return tuple(out), total

    @property
    def iteration(self):
        return self._host_iter

    # ------------------------------------------------------------ checkpoint
    def _whole_opt_state(self):
        """The optimizer state over every parameter (with a model axis the
        moments' slices gathered; every rank of the mesh takes part)."""
        if self._tp is None:
            return self.opt_state
        st = self.opt_state
        with comm.bind(self.mesh, ("model",)):
            mu = self._tp.gather(st.mu, torch.empty_like(self.flat))
            nu = self._tp.gather(st.nu, torch.empty_like(self.flat))
        return OptState(st.count, mu, nu, st.sched_count)

    @property
    def writes(self):
        """Whether this rank writes files (rank 0 of a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def save_checkpoint(self, path):
        """Write ``{model, ema, optimizer, iteration, wn_axis_format}`` as
        the JAX trainer does (msgpack, same trees). On a mesh every rank
        calls it, rank 0 writes the whole trees, and every rank waits for
        the write."""
        self._require_state()
        opt_state = self._whole_opt_state()
        if self.writes:
            v = to_jax_variables(self.model.state_dict())
            payload = {
                "model": v["params"],
                "ema": {"ema": v["ema"]} if v["ema"] else {},
                "optimizer": optimizer_to_jax(opt_state, self.layout,
                                              self.tx.clips,
                                              self.tx.decoupled),
                "iteration": self._host_iter,
                "wn_axis_format": WN_AXIS_FORMAT,
            }
            with open(path, "wb") as f:
                f.write(msgpack_io.msgpack_serialize(payload))
        if self.mesh is not None:
            comm.barrier()

    def load_checkpoint(self, path, example_batch=None):
        """Restore a checkpoint in the JAX format. One of weight-norm axis
        format 1 is migrated (``utils/migrate.py``); the moments are
        re-initialized when it carries no optimizer state or when the
        migration re-decomposed a layer. Returns the stored iteration."""
        if self.flat is None:
            self.init_state(example_batch)
        self._drop_graphs()
        payload = read_payload(path)
        model, migrated = maybe_migrate_model(
            payload, to_jax_variables(self.model.state_dict())["params"])
        self.model.load_state_dict(
            from_jax_variables(checkpoint_variables(payload, model)),
            strict=True)
        if payload.get("optimizer") and not migrated:
            st = OptState(*optimizer_from_jax(
                payload["optimizer"], self.layout, self.tx.clips,
                self.tx.scheduled, self.device, self.tx.decoupled))
            if self._tp is not None:
                # re-sharded: this rank keeps its slices of the moments
                st = OptState(st.count, self._tp.local(st.mu),
                              self._tp.local(st.nu), st.sched_count)
            self.opt_state = st
        else:
            self.opt_state = self.tx.init(self._opt_vector())
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
