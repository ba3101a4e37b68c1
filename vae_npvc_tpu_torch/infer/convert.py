"""Bucketed, masked batch conversion: online ``infer`` and the offline
Kaldi-trials ``decode`` and any-to-all ``sweep``.

Counterpart of ``vae_npvc_tpu/infer/convert.py`` (``_bucket``,
``auto_bucket_edges``, ``encoder_archs``, ``Converter``). Utterances are
padded to bucket lengths (the fixed ``decode_bucket_size`` grid, or
corpus-adaptive edges with ``decode_bucket_auto: true``) and batched; length
masks inside the model make a padded batch equal to unpadded
per-utterance runs. ``decode`` pads a bucket's last chunk up to
``decode_batch_size`` with zero rows of length 1, as the JAX package does:
then every batch has the shape of a serving bundle's programs
(``infer/export_serving.py``, fixed at the same batch size). The rows of a
batch are independent, but on the card a convolution's rounding depends on
the batch size, and in bf16 that rounding can move a frame's code; the
``sweep``s batch a chunk at its own size. Every call runs on the
converter's device or raises: there is no retry on another device.

File contract of ``decode``: ``decode_dir`` holds ``trials`` lines ``utt
target[ target...]`` (several targets give the hierarchies' per-level
speakers) and ``feats.scp``; an optional ``spk2spk_id`` maps speaker names
to integer ids. Outputs go to ``output_dir/feats.ark`` + ``feats.scp``, with
Kaldi compression method 1 unless ``compress=False``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from ..data import kaldi_io
from ..models import build_model
from ..models import vqvae as flat_vqvae
from ..models import vqvae2
from ..models.hier_common import HierVQMixin
from ..models.vqvae import Encoder
from ..utils import msgpack_io
from ..utils.bridge import from_jax_variables, to_jax_variables
from ..utils.migrate import WN_AXIS_FORMAT, maybe_migrate_model

logger = logging.getLogger("vae_npvc_tpu_torch.convert")


def _bucket(T, bucket_size, min_len=1):
    return max(-(-T // bucket_size) * bucket_size, min_len)


def auto_bucket_edges(lengths, max_buckets=6, align=32, min_len=1):
    """At most ``max_buckets`` padded-length edges, chosen from the
    corpus's own ``align``-rounded lengths by an exact partition DP that
    minimizes the total padded frames (covering a group costs its largest
    member's length times its size, less its lengths)."""
    cands = sorted({_bucket(int(T), align, min_len) for T in lengths})
    n = len(cands)
    if n == 0:
        return []
    K = min(max_buckets, n)
    idx = {c: i for i, c in enumerate(cands)}
    counts = np.zeros(n, np.int64)
    sums = np.zeros(n, np.float64)
    for T in lengths:
        i = idx[_bucket(int(T), align, min_len)]
        counts[i] += 1
        sums[i] += T
    ccum = np.concatenate([[0], np.cumsum(counts)])
    scum = np.concatenate([[0.0], np.cumsum(sums)])

    def cost(i, j):          # groups i..j inclusive, edge = cands[j]
        return cands[j] * (ccum[j + 1] - ccum[i]) - (scum[j + 1] - scum[i])

    INF = float("inf")
    dp = np.full((K + 1, n), INF)
    choice = np.zeros((K + 1, n), np.int64)
    for j in range(n):
        dp[1][j] = cost(0, j)
    for k in range(2, K + 1):
        for j in range(k - 1, n):
            best, arg = INF, 0
            for i in range(k - 2, j):
                c = dp[k - 1][i] + cost(i + 1, j)
                if c < best:
                    best, arg = c, i
            dp[k][j], choice[k][j] = best, arg
    k_best = int(np.argmin([dp[k][n - 1] for k in range(1, K + 1)])) + 1
    edges, j = [], n - 1
    for k in range(k_best, 0, -1):
        edges.append(cands[j])
        j = int(choice[k][j])
    return sorted(edges)


def encoder_archs(config):
    """The chained encoder arch dicts of a config (flat or hierarchical)."""
    if "encoder" in config:
        return [config["encoder"]]
    keys = sorted((k for k in config if k.startswith("encoder.")),
                  key=lambda k: int(k.split(".")[1]))
    return [config[k] for k in keys]


def read_payload(path):
    """The payload tree of a JAX-format msgpack checkpoint, unmigrated."""
    with open(path, "rb") as f:
        return msgpack_io.msgpack_restore(f.read())


def checkpoint_variables(payload, params):
    """``{"params": params, "ema": ...}`` of a checkpoint payload."""
    ema = payload.get("ema", {})
    return {"params": params, "ema": ema.get("ema", ema)}


def read_checkpoint(path):
    """The JAX package's msgpack checkpoint of weight-norm axis format 2 as
    ``(payload, variables)``: ``variables = {"params": ..., "ema": ...}``
    numpy trees. The optimizer subtree is parsed and not used. An older
    format is refused here; the loaders that migrate it read the payload
    with :func:`read_payload` and ``utils/migrate.maybe_migrate_model``."""
    payload = read_payload(path)
    fmt = payload.get("wn_axis_format", 1)
    if fmt != WN_AXIS_FORMAT:
        raise ValueError(
            f"{path}: checkpoint weight-norm axis format {fmt}, expected "
            f"{WN_AXIS_FORMAT}; bin/decode_tts refuses it, as the JAX "
            "package's does. Converter.load_checkpoint and "
            "Trainer.load_checkpoint migrate it (utils/migrate.py)")
    return payload, checkpoint_variables(payload, payload["model"])


def _migrate_codebook(model, stored):
    """Adopt a stored plain-VQ codebook whose size differs from the
    config's (the JAX package's ``_migrate_codebook``)."""
    key = "quantizer_embedding"
    param = model._parameters.get(key)
    if param is None or key not in stored:
        return
    shape = tuple(np.shape(stored[key]))
    if tuple(param.shape) != shape:
        logger.warning(f"codebook size mismatch: checkpoint {shape} vs "
                       f"config {tuple(param.shape)}; adopting the "
                       "checkpoint's shape")
        setattr(model, key, torch.nn.Parameter(
            param.new_zeros(shape), requires_grad=param.requires_grad))


def _speaker_map(decode_dir):
    path = Path(decode_dir) / "spk2spk_id"
    if not path.exists():
        return None
    return {k: int(v) for k, v in kaldi_io.load_dict_data(path).items()}


class Converter:
    """Builds the model once on ``device`` in the config's
    ``compute_dtype``; runs bucketed masked batches.

    ``mesh`` (``parallel/mesh.data_mesh``, a ``LocalMesh``) holds one
    replica per device: :meth:`infer` splits a batch along B, runs each
    share on its replica in a thread of its own, and returns the outputs
    in order (the JAX ``Converter(mesh=...)``'s batch-sharded ``infer``).
    The batch must divide by the mesh size (the serving engine pads to a
    multiple). Everything else runs on the first replica.
    """

    def __init__(self, config, device="cuda", mesh=None):
        self.config = config
        self.mesh = mesh
        devices = [device] if mesh is None else list(mesh.devices)
        self.replicas = [build_model(config, d).eval() for d in devices]
        self.model = self.replicas[0]
        self.device = next(self.model.parameters()).device
        self._pool = None
        if len(self.replicas) > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(len(self.replicas),
                                            thread_name_prefix="replica")
        self.bucket_size = config.get("decode_bucket_size", 256)
        self.batch_size = config.get("decode_batch_size", 8)
        self.auto_buckets = bool(config.get("decode_bucket_auto", False))
        self.max_buckets = int(config.get("decode_max_buckets", 6))
        # utterances shorter than the hierarchy's total downsampling are
        # padded up so no level's time axis is empty
        self.min_frames = Encoder.min_input_frames(encoder_archs(config))
        self.iteration = None

    def load_checkpoint(self, path):
        """Load a JAX-format msgpack checkpoint (weight-norm axis format 1
        is migrated, a plain codebook of another size adopted); returns
        its iteration."""
        payload = read_payload(path)
        _migrate_codebook(self.model, payload.get("model", {}))
        template = to_jax_variables(self.model.state_dict())["params"]
        model, _ = maybe_migrate_model(payload, template)
        state = from_jax_variables(checkpoint_variables(payload, model))
        for i, m in enumerate(self.replicas):
            if i:
                _migrate_codebook(m, payload.get("model", {}))
            m.load_state_dict(state, strict=True)
        self.iteration = int(payload.get("iteration", 0))
        return self.iteration

    def _dev(self, a, dtype=np.int32):
        return torch.as_tensor(np.asarray(a, dtype), device=self.device)

    def _infer_on(self, model, feats, tgts, lengths):
        dev = next(model.parameters()).device

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype), device=dev)

        with torch.inference_mode():
            return model.infer(put(feats, np.float32), put(tgts, np.int32),
                               put(lengths, np.int32)).cpu().numpy()

    def infer(self, feats, tgts, lengths):
        """(B, T_pad, D) feats, (B,) or (B, K) target ids, (B,) lengths ->
        (B, T_pad, D') float32 numpy mel, computed on the device (with a
        mesh, B split over the replicas)."""
        if self._pool is None:
            return self._infer_on(self.model, feats, tgts, lengths)
        n = len(self.replicas)
        B = np.shape(feats)[0]
        if B % n:
            raise ValueError(f"batch of {B} does not divide over the mesh's "
                             f"{n} replicas (pad it to a multiple)")
        per = B // n
        futs = [self._pool.submit(
            self._infer_on, m, np.asarray(feats)[i * per:(i + 1) * per],
            np.asarray(tgts)[i * per:(i + 1) * per],
            np.asarray(lengths)[i * per:(i + 1) * per])
            for i, m in enumerate(self.replicas)]
        return np.concatenate([f.result() for f in futs])

    # ----------------------------------------------------------- batching
    def _bucket_fn(self, lengths):
        """Padded length of an utterance of T frames: the fixed grid, or
        DP edges over ``lengths`` (``decode_bucket_auto: true``)."""
        if not self.auto_buckets or not lengths:
            return lambda T: _bucket(T, self.bucket_size, self.min_frames)
        edges = auto_bucket_edges(lengths, max_buckets=self.max_buckets,
                                  align=32, min_len=self.min_frames)

        def pick(T):
            T = max(T, self.min_frames)
            return next((e for e in edges if e >= T), edges[-1])

        fixed = sum(_bucket(T, self.bucket_size, self.min_frames) - T
                    for T in lengths)
        auto = sum(pick(T) - T for T in lengths)
        logger.info(f"auto buckets {edges}: {auto} padded frames vs "
                    f"{fixed} on the fixed {self.bucket_size} grid")
        return pick

    def _chunks(self, jobs):
        """``(T_pad, chunk)`` over the buckets in increasing length, each
        split into chunks of at most ``decode_batch_size`` jobs; a job is
        ``(utt, rxspecifier, frames, ...)``."""
        pick = self._bucket_fn([j[2] for j in jobs])
        buckets = {}
        for job in jobs:
            buckets.setdefault(pick(job[2]), []).append(job)
        for T_pad in sorted(buckets):
            group = buckets[T_pad]
            for lo in range(0, len(group), self.batch_size):
                yield T_pad, group[lo:lo + self.batch_size]

    @staticmethod
    def _load(chunk, T_pad, rows=None):
        """Zero-padded (B, T_pad, D) feats and (B,) lengths of a chunk; B is
        ``rows`` (the chunk and length-1 zero rows) or the chunk's size."""
        D = kaldi_io.matrix_header(chunk[0][1])[1]
        B = rows or len(chunk)
        feats = np.zeros((B, T_pad, D), np.float32)
        lengths = np.ones((B,), np.int32)
        for b, job in enumerate(chunk):
            feats[b, :job[2]] = kaldi_io.load_mat(job[1])
            lengths[b] = max(job[2], 1)
        return feats, lengths

    @staticmethod
    def _writer(output_dir, compress):
        return kaldi_io.write_helper(
            f"ark,scp:{output_dir}/feats.ark,{output_dir}/feats.scp",
            compression_method=1 if compress else None)

    @staticmethod
    def _sweep_inputs(decode_dir, output_dir, targets):
        """``(output_dir, jobs of every utterance, target ids)``."""
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        feats_scp = kaldi_io.load_dict_data(Path(decode_dir) / "feats.scp")
        spk_map = _speaker_map(decode_dir)
        jobs = [(u, rx, kaldi_io.matrix_header(rx)[0])
                for u, rx in feats_scp.items()]
        return (output_dir, jobs,
                [spk_map[t] if spk_map else int(t) for t in targets])

    # -------------------------------------------------------------- decode
    def decode(self, decode_dir, output_dir, compress=True):
        """Convert every trials line; returns the utterances written."""
        decode_dir = Path(decode_dir)
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        for f in ("trials", "feats.scp"):
            if not (decode_dir / f).is_file():
                raise FileNotFoundError(decode_dir / f)
        feats_scp = kaldi_io.load_dict_data(decode_dir / "feats.scp")
        spk_map = _speaker_map(decode_dir)
        jobs = []
        for parts in kaldi_io.load_list_data(decode_dir / "trials"):
            utt, tgt = parts[0], []
            for t in parts[1:]:
                try:
                    tgt.append(spk_map[t] if spk_map else int(t))
                except (ValueError, KeyError) as e:
                    raise ValueError(
                        f"trial target {t!r} in {decode_dir}/trials is not "
                        f"{'in spk2spk_id' if spk_map else 'an integer id'}"
                        f"; named targets need a spk2spk_id file in the "
                        f"decode dir (reference decoder/basic.py:50-53)"
                    ) from e
            rx = feats_scp[utt]
            jobs.append((utt, rx, kaldi_io.matrix_header(rx)[0], tgt))

        n_done = 0
        with self._writer(output_dir, compress) as wf:
            for T_pad, chunk in self._chunks(jobs):
                feats, lengths = self._load(chunk, T_pad, self.batch_size)
                # per-level target columns (the hierarchies); a row with
                # fewer targets repeats its last, the flat model reads
                # column 0
                K = max(len(j[3]) for j in chunk)
                tgts = np.zeros((self.batch_size, K), np.int32)
                tgts[:len(chunk)] = [[tgt[min(k, len(tgt) - 1)]
                                      for k in range(K)]
                                     for _, _, _, tgt in chunk]
                out = self.infer(feats, tgts, lengths)
                for b, (utt, _, T, tgt) in enumerate(chunk):
                    wf[utt] = out[b, :min(T, out.shape[1])]
                    n_done += 1
                    logger.info(f"Decode {n_done}: {utt} to "
                                f"{' '.join(map(str, tgt))}")
        return n_done

    # --------------------------------------------------------------- sweep
    def sweep(self, decode_dir, output_dir, targets, compress=True):
        """Any-to-all conversion: every utterance of ``feats.scp`` to every
        target of ``targets``, keyed ``<utt>__<target>``. The flat model
        encodes each utterance once (B = 1) and decodes its codes for the
        K targets in one batch; the other families go through
        :meth:`_sweep_generic`. Returns the conversions written."""
        if not isinstance(self.model, flat_vqvae.Model):
            return self._sweep_generic(decode_dir, output_dir, targets,
                                       compress=compress)
        output_dir, jobs, tgt_ids = self._sweep_inputs(
            decode_dir, output_dir, targets)
        K = len(tgt_ids)
        arch = self.config.get("encoder", {})
        n_done = 0
        with self._writer(output_dir, compress) as wf, \
                torch.inference_mode():
            y = self._dev(tgt_ids)
            for T_pad, chunk in self._chunks(jobs):
                for job in chunk:
                    feats, lengths = self._load([job], T_pad)
                    ids = self.model.encode(self._dev(feats, np.float32),
                                            self._dev(lengths))
                    z_len = int(Encoder.out_lengths(arch, lengths)[0])
                    z_lens = torch.full((K,), z_len, dtype=torch.int32,
                                        device=self.device)
                    out = self.model.decode(ids.expand(K, -1), y, z_lens) \
                        .cpu().numpy()
                    utt, T = job[0], job[2]
                    for k, name in enumerate(targets):
                        wf[f"{utt}__{name}"] = out[k, :min(T, out.shape[1])]
                        n_done += 1
                    logger.info(f"Sweep: {utt} -> {K} targets")
        return n_done

    def _sweep_generic(self, decode_dir, output_dir, targets, compress=True):
        """Any-to-all sweep over bucketed batches of another family. A
        hierarchy (vqvae2/2a/2b, whose ``infer`` is encode then decode)
        encodes each batch once and decodes it per target (vqvae2 passes
        its style); any other model (the Gaussian VAE) runs its ``infer``
        per target, as the JAX package does."""
        hier = isinstance(self.model, HierVQMixin)
        if not hier and not callable(getattr(self.model, "infer", None)):
            raise TypeError(f"{type(self.model).__name__} has no infer: "
                            "nothing to sweep with")
        output_dir, jobs, tgt_ids = self._sweep_inputs(
            decode_dir, output_dir, targets)
        with_style = isinstance(self.model, vqvae2.Model)
        n_done = 0
        with self._writer(output_dir, compress) as wf:
            for T_pad, chunk in self._chunks(jobs):
                feats, lengths = self._load(chunk, T_pad)
                B = len(chunk)
                outs = []
                with torch.inference_mode():
                    x = self._dev(feats, np.float32)
                    n = self._dev(lengths)
                    enc = self.model.encode(x, n) if hier else None
                    for tid in tgt_ids:
                        y = torch.full((B,), tid, dtype=torch.int32,
                                       device=self.device)
                        if not hier:
                            out = self.model.infer(x, y, n)
                        elif with_style:
                            out = self.model.decode(
                                enc[0], y, style=enc[1], target_len=T_pad,
                                lengths=n)
                        else:
                            out = self.model.decode(
                                enc, y, target_len=T_pad, lengths=n)
                        outs.append(out.cpu().numpy())
                for name, out in zip(targets, outs):
                    for b, (utt, _, T) in enumerate(chunk):
                        wf[f"{utt}__{name}"] = out[b, :min(T, out.shape[1])]
                        n_done += 1
                logger.info(f"Sweep: {B} utts -> {len(tgt_ids)} targets")
        return n_done
