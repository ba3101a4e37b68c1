"""Online conversion engine: wav in -> converted wav out, batched.

Counterpart of ``vae_npvc_tpu/serve/engine.py``. Per request:

    resample -> log-mel fbank (device) -> CMVN (host)
    -> Converter.infer, or an exported bundle's ServingBundle.infer
       (device, masked + bucketed, coalesced by _InferBatcher)
    -> reverse CMVN -> Griffin-Lim or the native Parallel WaveGAN
       (``jpwg``, device) or mel only

The front end runs in slabs of :data:`FRONT_ROWS` frames, one call per
slab, so a frame's rfft and mel product have the same shape whether it
comes from a whole request or from a streamed block
(``serve/streaming.py``): on the card cuFFT and cuBLAS pick their kernels
by shape, and a streamed row then equals the offline row bit for bit.

Every device stage runs on the engine's device or raises; there is no
retry on another device. ``data_parallel=True`` serves the live model over
every visible card (``parallel/mesh.data_mesh``): one replica per card,
each coalesced batch padded to a multiple of the card count and split
along B (``Converter(mesh=...)``).

Two latency histograms are always counted (:class:`LogHistogram`): each
request's, from ``convert``'s entry to its result, and each request's
wait in the batcher's queue, from ``submit`` to the moment the worker
takes its group.
"""

from __future__ import annotations

import bisect
import logging
import queue
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import torch

from ..data import cmvn as cmvn_mod
from ..data import features
from ..infer.convert import Converter, _bucket

logger = logging.getLogger("vae_npvc_tpu_torch.serve")

# frames per front-end call: one rfft and one mel product shape for the
# offline canvas and for every streamed block (a multiple of it keeps the
# streamed rows bit-identical to the offline ones on the card)
FRONT_ROWS = 64

# the vcc20 recipe's front-end settings (egs/vcc20/vae1/run.sh:13-18)
DEFAULT_FEATURE = {
    "fs": 24000, "n_fft": 1024, "n_shift": 256, "n_mels": 80,
    "fmin": 80.0, "fmax": 7600.0, "win_length": None,
}


class LogHistogram:
    """Counts of millisecond values in fixed log-spaced buckets:
    :data:`PER_DECADE` a decade from :data:`LO` to :data:`HI` ms, one below
    and one above. Quantiles interpolate within a bucket, so they lie
    within one bucket's width (12 %) of the values' own; thread-safe."""

    PER_DECADE = 20
    LO, HI = 1e-2, 1e6

    def __init__(self):
        n = round(np.log10(self.HI / self.LO)) * self.PER_DECADE
        # upper edges of buckets 0..n-1; bucket n holds what passes HI
        self.edges = (self.LO * 10.0 ** (np.arange(n + 1) / self.PER_DECADE)
                      ).tolist()
        self._lock = threading.Lock()
        self.clear()

    def clear(self):
        with self._lock:
            self.counts = [0] * (len(self.edges) + 1)
            self.count, self.sum = 0, 0.0
            self.min = self.max = None

    def add(self, ms):
        ms = float(ms)
        with self._lock:
            self.counts[bisect.bisect_left(self.edges, ms)] += 1
            self.count += 1
            self.sum += ms
            self.min = ms if self.min is None else min(self.min, ms)
            self.max = ms if self.max is None else max(self.max, ms)

    def quantile(self, q):
        """The ``q`` quantile (0..1) as ``numpy.percentile`` places it in
        the values, within their bucket; None when empty."""
        with self._lock:
            if not self.count:
                return None
            rank, seen = q * (self.count - 1), 0
            for i, c in enumerate(self.counts):
                if c and seen + c > rank:
                    lo = self.edges[i - 1] if i else self.min
                    hi = self.edges[i] if i < len(self.edges) else self.max
                    lo, hi = max(lo, self.min), min(hi, self.max)
                    return lo + (hi - lo) * min(1.0, (rank - seen + 0.5) / c)
                seen += c
            return self.max

    def prometheus(self, name):
        """The Prometheus text lines of a histogram ``name``."""
        with self._lock:
            lines, seen = [f"# TYPE {name} histogram"], 0
            for edge, c in zip(self.edges, self.counts):
                seen += c
                lines.append(f'{name}_bucket{{le="{edge:.6g}"}} {seen}')
            lines += [f'{name}_bucket{{le="+Inf"}} {self.count}',
                      f"{name}_sum {self.sum!r}", f"{name}_count {self.count}"]
        return lines


class _InferBatcher:
    """Coalesces concurrent same-bucket requests into one batched call.

    One worker thread drains a queue of ``(feats (T_pad, D), length,
    target, Future, submitted)`` items, groups them by padded length, waits
    up to ``window_ms`` for more (stopping at ``max_batch``), pads the batch
    axis to the next power of two (first item repeated; rows are
    independent) and runs ``runner(feats, targets, lengths)`` once per
    group. The single worker also serializes device calls. ``queue_wait``
    counts each item's wait from ``submit`` to the moment the worker takes
    its group.
    """

    def __init__(self, runner, max_batch: int = 8, window_ms: float = 5.0,
                 pad_multiple: int = 1):
        self.runner = runner
        self.max_batch = int(max_batch)
        # a data-parallel mesh takes batches divisible by its size: the
        # power-of-two padding is rounded up to a multiple of it
        self.pad_multiple = int(pad_multiple)
        if self.max_batch % self.pad_multiple:
            raise ValueError(f"max_batch {max_batch} not divisible by "
                             f"pad_multiple {pad_multiple}")
        self.window_s = float(window_ms) / 1e3
        self._q: queue.Queue = queue.Queue()
        self.calls = 0                       # batched device calls
        self.items = 0                       # requests served
        self.queue_wait = LogHistogram()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="vae-npvc-infer-batcher")
        self._thread.start()

    def submit(self, feats, length, target) -> Future:
        fut: Future = Future()
        self._q.put((feats, int(length), int(target), fut, time.monotonic()))
        return fut

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=5)

    def _take_group(self, first):
        group, stash = [first], []
        deadline = time.monotonic() + self.window_s
        T_pad = first[0].shape[0]
        while len(group) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                stash.append(item)
                break
            if item[0].shape[0] == T_pad:
                group.append(item)
            else:
                stash.append(item)
        for item in stash:
            self._q.put(item)
        return group

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            group = self._take_group(item)
            self._count_waits(group)
            B = len(group)
            m = self.pad_multiple
            B_pad = min(-(-(1 << (B - 1).bit_length()) // m) * m,
                        self.max_batch)
            pad = [group[0]] * (B_pad - B)
            feats = np.stack([g[0] for g in group] + [p[0] for p in pad])
            lengths = np.asarray([g[1] for g in group]
                                 + [p[1] for p in pad], np.int32)
            tgts = np.asarray([g[2] for g in group]
                              + [p[2] for p in pad], np.int32)
            try:
                out = self.runner(feats, tgts, lengths)
            except Exception as e:  # noqa: BLE001 — deliver to every waiter
                for g in group:
                    g[3].set_exception(e)
                continue
            self.calls += 1
            self.items += B
            for b, g in enumerate(group):
                g[3].set_result(np.asarray(out[b]))

    def _count_waits(self, group):
        taken = time.monotonic()
        for g in group:
            self.queue_wait.add((taken - g[4]) * 1e3)


class ConversionEngine:
    """Warm end-to-end voice-conversion engine for online serving.

    ``config`` is the experiment dict or a YAML path, ``checkpoint`` the
    JAX package's msgpack checkpoint; or ``bundle`` is an exported serving
    bundle directory (``bin/export_serving``), whose programs, speaker map
    and buckets serve without a config or checkpoint. ``cmvn`` is a Kaldi
    stats ark path or the (2, D+1) stats array. ``vocoder`` is ``"gl"``
    (Griffin-Lim), ``"jpwg"``
    (the native Parallel WaveGAN of ``voc_config`` and ``voc_checkpoint``)
    or ``"none"`` (mel only). ``device`` defaults to the GPU and raises when
    there is none.
    """

    def __init__(self, config, checkpoint, cmvn, *, bundle=None,
                 feature=None, spk2spk_id=None, vocoder="gl", gl_iters=64,
                 bucket_frames=None, max_batch=8, batch_window_ms=5.0,
                 seed=0, data_parallel=False, voc_config=None,
                 voc_checkpoint=None, device="cuda"):
        if vocoder not in ("gl", "jpwg", "none"):
            raise ValueError(f"unknown vocoder {vocoder!r}")
        self.bundle = None
        mesh, pad_multiple = None, 1
        if data_parallel:
            # one replica per visible card (or per device of a given
            # LocalMesh); bundles are single-device programs
            if bundle is not None:
                raise ValueError("data_parallel serves the live model; "
                                 "bundles are single-device programs")
            from ..parallel.mesh import LocalMesh, data_mesh

            mesh = (data_parallel if isinstance(data_parallel, LocalMesh)
                    else data_mesh(None if torch.device(device).type
                                   == "cuda" else [device]))
            pad_multiple = len(mesh.devices)
            # round max_batch up to a multiple the batcher can submit
            max_batch = -(-max(int(max_batch), pad_multiple)
                          // pad_multiple) * pad_multiple
        if bundle is not None:
            # exported-program backend: no model code, config or checkpoint
            from ..infer.export_serving import ServingBundle

            self.bundle = ServingBundle(bundle, device=device)
            self.converter = None
            self.config = {}
            self.device = self.bundle.device
            self.iteration = int(self.bundle.meta.get("iteration", 0))
            self._min_frames = int(self.bundle.meta.get("min_frames", 1))
            runner = self.bundle.infer
            max_batch = min(int(max_batch), self.bundle.batch_size)
            y_num = int(self.bundle.meta.get("y_num") or 0)
        else:
            if config is None or checkpoint is None:
                raise ValueError(
                    "pass config + checkpoint, or bundle= (an exported "
                    "serving-bundle directory)")
            if not isinstance(config, dict):
                import yaml

                with open(config) as f:
                    config = yaml.safe_load(f)
            self.config = config
            self.converter = Converter(config, device=device, mesh=mesh)
            self.device = self.converter.device
            self.iteration = self.converter.load_checkpoint(checkpoint)
            self._min_frames = self.converter.min_frames
            runner = self.converter.infer
            y_num = int(config.get("y_num", 0))
        self.feature = dict(DEFAULT_FEATURE, **(feature or {}))
        self.fs = int(self.feature["fs"])
        self.n_shift = int(self.feature["n_shift"])
        self.stats = (cmvn if isinstance(cmvn, np.ndarray)
                      else cmvn_mod.read_stats(cmvn))
        self.spk_map = None
        if spk2spk_id is not None:
            if isinstance(spk2spk_id, (str, Path)):
                from ..data import kaldi_io
                spk2spk_id = {k: int(v) for k, v in kaldi_io.load_dict_data(
                    spk2spk_id).items()}
            self.spk_map = dict(spk2spk_id)
        elif self.bundle is not None and self.bundle.spk2spk_id:
            self.spk_map = dict(self.bundle.spk2spk_id)
        self.bucket_frames = int(
            bucket_frames
            or (min(self.bundle.buckets) if self.bundle is not None
                else config.get("decode_bucket_size", 256)))
        self.gl_iters = int(gl_iters)
        self.seed = int(seed)
        self.vocoder = vocoder
        self._voc = (_JPWG(voc_config, voc_checkpoint,
                           self.feature["n_mels"], self.device)
                     if vocoder == "jpwg" else None)
        # speaker-id bound for resolve_target's range guard (an
        # out-of-range id would index past the embedding table)
        self._y_bound = y_num
        if not self._y_bound and self.spk_map:
            self._y_bound = max(int(v) for v in self.spk_map.values()) + 1
        if not self._y_bound:
            logger.warning("speaker-id range unknown (no y_num in %s, no "
                           "spk2spk_id map): out-of-range numeric target ids "
                           "cannot be rejected",
                           "bundle meta" if self.bundle else "config")
        self._y_num = y_num
        self.batcher = _InferBatcher(runner, max_batch=max_batch,
                                     window_ms=batch_window_ms,
                                     pad_multiple=pad_multiple)
        self._stats_lock = threading.Lock()
        self.n_requests = 0
        self.latency = LogHistogram()        # ms, convert's entry to result

    # ------------------------------------------------------------ helpers
    def close(self):
        self.batcher.close()

    def speakers(self):
        if self.spk_map is not None:
            return dict(self.spk_map)
        return {str(i): i for i in range(self._y_num)}

    def resolve_target(self, target):
        if self.spk_map is not None and str(target) in self.spk_map:
            return self.spk_map[str(target)]
        try:
            idx = int(target)
        except (TypeError, ValueError):
            raise KeyError(
                f"unknown target speaker {target!r}; known: "
                f"{sorted(self.speakers())}") from None
        if self._y_bound and not 0 <= idx < self._y_bound:
            raise KeyError(f"target speaker id {idx} out of range "
                           f"[0, {self._y_bound})")
        return idx

    def _front_kw(self):
        return {k: v for k, v in self.feature.items() if k != "fs"}

    def _mel_window(self, window):
        """Log-mel rows of the frames a window of samples holds.

        ``window`` is a host (N,) float32 array, ``N = (T - 1) * hop +
        n_fft``, starting at the first sample of frame 0 (``center=False``
        framing): returns the (T, M) host rows, computed on the device in
        slabs of :data:`FRONT_ROWS` frames, the last zero-padded to a full
        slab."""
        hop, n_fft = self.n_shift, int(self.feature["n_fft"])
        T = 1 + (window.size - n_fft) // hop
        span = (FRONT_ROWS - 1) * hop + n_fft
        rows = []
        with torch.inference_mode():
            x = torch.as_tensor(window, device=self.device)
            for t0 in range(0, T, FRONT_ROWS):
                seg = x[t0 * hop:t0 * hop + span]
                if seg.numel() < span:
                    seg = torch.nn.functional.pad(seg, (0, span - seg.numel()))
                rows.append(features.logmelspectrogram(
                    seg[None], fs=self.fs, **self._front_kw(),
                    center=False)[0, :T - t0])
            return torch.cat(rows).cpu().numpy()

    def _mel_batch(self, xp):
        """(B, N) host waveform -> (B, T, M) host log-mel (centered frames,
        reflect padding), through :meth:`_mel_window`."""
        pad = int(self.feature["n_fft"]) // 2
        return np.stack([self._mel_window(np.pad(x, pad, mode="reflect"))
                         for x in np.asarray(xp, np.float32)])

    def _pick_pad(self, T_true):
        if self.bundle is not None:
            # the exported buckets are the shape set: rounding to
            # bucket_frames could pass the largest of them
            return self.bundle.pick_bucket(max(T_true, self._min_frames))
        return _bucket(max(T_true, self._min_frames), self.bucket_frames)

    def _infer_mel(self, feats, T_true, tgt):
        out = self.batcher.submit(feats, T_true, tgt).result()
        T_out = min(T_true, out.shape[0])
        return cmvn_mod.apply(out[:T_out], self.stats, reverse=True)

    def _count_request(self, t0):
        self.latency.add((time.monotonic() - t0) * 1e3)
        with self._stats_lock:
            self.n_requests += 1

    # ------------------------------------------------------------ pipeline
    def convert(self, wav, sr, target, *, return_mel=False):
        """Convert a waveform to ``target``'s voice. Returns ``(wav_out,
        fs)``, or ``(mel_out (T, M), fs)`` with ``return_mel``."""
        t0 = time.monotonic()
        tgt = self.resolve_target(target)
        x = features.resample(np.asarray(wav, np.float32).ravel(), int(sr),
                              self.fs)
        if x.size == 0:
            raise ValueError("empty waveform")
        T_true = features.num_frames(x.size, self.n_shift)
        T_pad = self._pick_pad(T_true)
        # largest sample count giving exactly T_pad frames (1 + n // shift)
        xp = np.zeros((1, T_pad * self.n_shift - 1), np.float32)
        xp[0, :x.size] = x
        mel = self._mel_batch(xp)[0]                      # (T_pad, M)
        feats = np.zeros_like(mel)
        feats[:T_true] = cmvn_mod.apply(mel[:T_true], self.stats)
        mel_out = self._infer_mel(feats, T_true, tgt)
        if return_mel or self.vocoder == "none":
            result = mel_out.astype(np.float32)
        else:
            result = self._vocode(mel_out, T_pad)
        self._count_request(t0)
        return result, self.fs

    @staticmethod
    def _silence_canvas(mel_out, T_pad):
        """The valid mel in a log-mel-silence canvas of the bucket shape
        (log10(EPS): magnitude EPS adds nothing)."""
        canvas = np.full((T_pad, mel_out.shape[1]), np.log10(features.EPS),
                         np.float32)
        canvas[:mel_out.shape[0]] = mel_out
        return canvas

    def _vocode(self, mel_out, T_pad):
        """Synthesis on the bucket shape (the silence canvas), cut to the
        true length afterwards."""
        T_out = mel_out.shape[0]
        canvas = self._silence_canvas(mel_out, T_pad)
        if self._voc is not None:
            wav = self._voc.synthesize(canvas, self.seed)
            return wav[:T_out * self._voc.hop].astype(np.float32)
        with torch.inference_mode():
            wav = features.griffin_lim(
                torch.as_tensor(canvas[None], device=self.device),
                fs=self.fs, **self._front_kw(), n_iter=self.gl_iters,
                seed=self.seed)[0].cpu().numpy()
        return wav[:T_out * self.n_shift].astype(np.float32)

    def warmup(self, n_buckets=1):
        """Run the first ``n_buckets`` bucket shapes end to end, then (live
        model only: a bundle pads every batch to its exported size) the
        coalesced batch shapes of the first bucket."""
        tgt = next(iter(self.speakers().values()), 0)
        if self.bundle is not None:
            pads = self.bundle.buckets[:n_buckets]
        else:
            pads = [i * self.bucket_frames for i in range(1, n_buckets + 1)]
        for T_pad in pads:
            n = (T_pad - 1) * self.n_shift
            self.convert(np.zeros((max(n, self.n_shift),), np.float32),
                         self.fs, tgt)
        if pads and self.bundle is None:
            T_pad, D = pads[0], int(self.feature["n_mels"])
            B, m = 1, self.batcher.pad_multiple
            while B < self.batcher.max_batch:
                B = min(-(-(B * 2) // m) * m, self.batcher.max_batch)
                self.batcher.runner(np.zeros((B, T_pad, D), np.float32),
                                    np.full((B,), tgt, np.int32),
                                    np.full((B,), T_pad, np.int32))
        with self._stats_lock:       # warmup doesn't count as traffic
            self.n_requests = 0
        self.latency.clear()
        self.batcher.queue_wait.clear()
        logger.info("warmup done: %d bucket(s)", len(pads))

    def stats_snapshot(self):
        """Counters, and quantiles of the latency histograms since the
        warm-up (None before a request)."""
        wait = self.batcher.queue_wait
        with self._stats_lock:
            requests = self.n_requests
        return {
            "requests": requests,
            "infer_calls": self.batcher.calls,
            "infer_items": self.batcher.items,
            "mean_batch": (self.batcher.items / self.batcher.calls
                           if self.batcher.calls else 0.0),
            "latency_ms_p50": self.latency.quantile(0.5),
            "latency_ms_p99": self.latency.quantile(0.99),
            "latency_ms_max": self.latency.max,
            "queue_wait_ms_p50": wait.quantile(0.5),
            "queue_wait_ms_p99": wait.quantile(0.99),
            "iteration": self.iteration,
            "vocoder": self.vocoder,
        }


class _JPWG:
    """The native Parallel WaveGAN backend of the engine: the generator of a
    vocoder checkpoint (the JAX trainer's or the port's) on the engine's
    device."""

    def __init__(self, config, checkpoint, n_mels, device):
        from ..bin.train import load_config
        from ..infer.vocoder import jpwg_receptive_frames, load_generator

        if config is None or checkpoint is None:
            raise ValueError("vocoder='jpwg' needs voc_config and "
                             "voc_checkpoint")
        self.config = load_config(config)
        self.gen = load_generator(self.config, checkpoint, n_mels, device)
        self.device = device
        self.hop = self.gen.hop
        # context frames on each side of a streamed synthesis chunk
        self.halo = jpwg_receptive_frames(self.config)

    def noise(self, T_pad, seed):
        """The synthesis noise (T_pad * hop, 1) of a ``T_pad``-frame canvas
        for ``seed``: ``infer/vocoder.decode_noise``'s first draw, on the
        device."""
        from ..infer.vocoder import decode_noise

        return decode_noise(seed, 0, (T_pad * self.hop, 1), self.device)

    def synthesize(self, canvas, seed):
        """One pass of the generator over a (T_pad, n_mels) canvas:
        (T_pad * hop,) samples."""
        from ..infer.vocoder import run_generator

        z = self.noise(canvas.shape[0], seed)
        return run_generator(self.gen, z[None],
                             canvas[None].astype(np.float32))[0]
