"""Kaldi data-dir dataset and host-side batch iterators, in numpy.

Counterpart of ``vae_npvc_tpu/data/dataset.py`` (the port keeps its own
copy): a data dir holds ``feats.scp``, ``utt2num_frames`` and
``utt2spk_id``; an item is a ``crop_length``-frame window of an
utterance's mel matrix (random start for training, start 0 for validation,
zero-padded when shorter), read straight from the ark by row range.
:func:`index_iterator` is the single source of the epoch permutation and
the per-item crop starts: :func:`batch_iterator` loads those windows from
disk, and ``Trainer.train_steps_indices`` gathers the same windows from
the corpus staged on the device. With ``use_native_loader`` (default on,
as in the JAX package) a batch is read by the C++ loader
(``data/native_loader.py``) in one call, bit for bit what the Python reads
give; scps it does not take are read with Python. :func:`prefetch_to_device`
keeps batches ahead of the train step, copied on a side CUDA stream from
pinned memory.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from . import kaldi_io


class UttMelSpkDataset:
    """Map-style dataset over a Kaldi data dir: item = (mel[T, D], spk_id)."""

    def __init__(self, data_dir, config, valid=False):
        crop_length = config.get("crop_length", 256)
        key = "valid_crop_length" if valid else "train_crop_length"
        self.crop_length = config.get(key, crop_length)
        self.valid = valid

        data_dir = Path(data_dir)
        self.feats_scp = kaldi_io.load_dict_data(data_dir / "feats.scp")
        self.utt2num_frames = {
            k: int(v) for k, v in
            kaldi_io.load_dict_data(data_dir / "utt2num_frames").items()}
        self.utt2spks = kaldi_io.load_list_data(data_dir / "utt2spk_id")
        self.num_data = len(self.utt2spks)

        # the native loader's rows follow feats.scp's line order
        self.native = None
        self._native_row = None
        if config.get("use_native_loader", True):
            from .native_loader import NativeArkLoader

            self.native = NativeArkLoader.open(data_dir / "feats.scp")
            if self.native is not None:
                scp_row = {u: i for i, u in enumerate(self.feats_scp)}
                self._native_row = np.asarray(
                    [scp_row[u] for u, _ in self.utt2spks], np.int64)
        self.spk_ids = np.asarray([int(s) for _, s in self.utt2spks],
                                  np.int32)

    def crop_start(self, index, rng):
        """Crop start for one item."""
        feat_length = self.utt2num_frames[self.utt2spks[index][0]]
        if feat_length <= self.crop_length or self.valid:
            return 0
        return int(rng.integers(0, feat_length - self.crop_length + 1))

    def __len__(self):
        return self.num_data

    def feat_dim(self):
        """Feature dim from the first scp entry's ark header."""
        first = next(iter(self.feats_scp.values()))
        return kaldi_io.matrix_header(first)[1]

    def _padded_max_frames(self):
        return max(max(self.utt2num_frames[u] for u, _ in self.utt2spks),
                   self.crop_length)

    def padded_nbytes(self):
        """Size of the :meth:`padded_arrays` feature tensor, unloaded."""
        return self.num_data * self._padded_max_frames() * self.feat_dim() * 4

    def padded_arrays(self, num_workers=8):
        """Whole corpus as one zero-padded tensor (device staging):
        ``(feats[N, M, D] float32, n_frames[N] int32, spk_ids[N] int32)``
        with ``M = max(longest utterance, crop_length)``."""
        utts = [u for u, _ in self.utt2spks]
        feats = np.zeros((self.num_data, self._padded_max_frames(),
                          self.feat_dim()), np.float32)
        n_frames = np.asarray([self.utt2num_frames[u] for u in utts],
                              np.int32)

        def _load(i):
            m = kaldi_io.load_mat(self.feats_scp[utts[i]]).astype(np.float32)
            feats[i, :m.shape[0]] = m

        if num_workers > 0:
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                list(pool.map(_load, range(self.num_data)))
        else:
            for i in range(self.num_data):
                _load(i)
        return feats, n_frames, self.spk_ids

    def get(self, index, rng: np.random.Generator):
        """Read one cropped item; ``rng`` drives the random crop start."""
        return self.get_at(index, self.crop_start(index, rng))

    def get_at(self, index, start):
        """Read one item at a given crop start."""
        utt, spk = self.utt2spks[index][0], self.utt2spks[index][1]
        crop = self.crop_length
        start = int(start)
        end = min(start + crop, self.utt2num_frames[utt])
        feat = kaldi_io.load_mat(
            f"{self.feats_scp[utt]}[{start}:{end - 1}]").astype(np.float32)
        if feat.shape[0] < crop:
            feat = np.pad(feat, ((0, crop - feat.shape[0]), (0, 0)))
        return feat, np.int32(spk)


def index_iterator(dataset, batch_size, *, shuffle, drop_last, seed=0,
                   epochs=None):
    """Yield ``(indices[B] int64, crop_starts[B] int64)`` per batch: the
    epoch permutation and an independent crop seed per item."""
    if drop_last and batch_size > len(dataset):
        raise ValueError(
            f"batch_size {batch_size} > dataset size {len(dataset)} with "
            f"drop_last=True would yield no batches ever")
    order_rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        idx = np.arange(len(dataset))
        if shuffle:
            order_rng.shuffle(idx)
        for lo in range(0, len(idx), batch_size):
            chunk = idx[lo:lo + batch_size]
            if drop_last and len(chunk) < batch_size:
                break
            seeds = order_rng.integers(0, 2 ** 63, size=len(chunk))
            starts = np.asarray(
                [dataset.crop_start(i, np.random.default_rng(sd))
                 for i, sd in zip(chunk, seeds)], np.int64)
            yield chunk, starts
        epoch += 1


def batch_iterator(dataset, batch_size, *, shuffle, drop_last, seed=0,
                   num_workers=8, epochs=None):
    """Yield ``(feats[B, T, D] float32, spks[B] int32)`` numpy batches:
    forever when ``epochs`` is None (training), one pass when given
    (validation). Worker threads read the per-item ark ranges."""
    pool = (ThreadPoolExecutor(max_workers=num_workers)
            if num_workers > 0 else None)
    try:
        for chunk, starts in index_iterator(
                dataset, batch_size, shuffle=shuffle, drop_last=drop_last,
                seed=seed, epochs=epochs):
            if dataset.native is not None:
                yield (dataset.native.load_batch(
                    dataset._native_row[chunk], starts, dataset.crop_length,
                    nthreads=max(num_workers, 1)), dataset.spk_ids[chunk])
                continue
            pairs = list(zip(chunk, starts))
            if pool is not None:
                items = list(pool.map(lambda a: dataset.get_at(*a), pairs))
            else:
                items = [dataset.get_at(i, s) for i, s in pairs]
            yield (np.stack([it[0] for it in items]),
                   np.asarray([it[1] for it in items], np.int32))
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)


def prefetch_to_device(iterator, size=2, device="cuda", put=None):
    """Move the batches of ``iterator`` to ``device`` in a producer thread,
    keeping up to ``size`` of them ahead of the consumer; yields tuples of
    tensors. ``put`` (``batch -> device batch``) replaces the move.

    On a CUDA device each batch is pinned (a fresh pinned buffer per
    batch) and copied with ``non_blocking=True`` on a side stream, then an
    event is recorded; the consumer makes its current stream wait on that
    event and calls ``record_stream`` before it uses the tensors. On the
    CPU the tensors are only wrapped; no stream is involved. An error of
    the loader is raised in the consumer.
    """
    import torch

    device = torch.device(device)
    side = (torch.cuda.Stream(device)
            if put is None and device.type == "cuda" else None)

    def move(batch):
        if put is not None:
            return put(batch), None, None
        if side is None:
            return tuple(torch.as_tensor(a, device=device)
                         for a in batch), None, None
        host = [torch.as_tensor(a).contiguous().pin_memory() for a in batch]
        with torch.cuda.stream(side):
            out = tuple(h.to(device, non_blocking=True) for h in host)
            ready = torch.cuda.Event()
            ready.record(side)
        # the pinned buffers stay referenced until the consumer moves on
        return out, ready, host

    q: queue.Queue = queue.Queue(maxsize=max(int(size), 1))
    stop = threading.Event()
    end = object()

    def offer(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for batch in iterator:
                if not offer(move(batch)):
                    return
            offer(end)
        except BaseException as e:  # raised again in the consumer
            offer(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=producer, daemon=True,
                              name="prefetch_to_device")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            out, ready, _host = item
            if ready is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(ready)
                for t in out:
                    t.record_stream(current)
            yield out
    finally:
        stop.set()
