"""Streaming conversion sessions over :class:`serve.engine.ConversionEngine`.

Counterpart of ``vae_npvc_tpu/serve/streaming.py``. A client feeds audio in
chunks and receives converted audio back in chunks:

- **Ingest (incremental)**: frame ``t`` of the offline transform reads
  canvas samples ``[t*hop - p, t*hop + p)`` (p = n_fft // 2, centered STFT
  with reflect padding), so it is fixed, left reflect edge included, once
  ``t*hop + p`` samples have arrived. Those frames are computed block by
  block on the engine's device through ``engine._mel_window``, the helper
  the offline path runs too: the same frame content through the same
  fixed-shape calls, so a streamed row equals the offline row bit for bit
  (with ``block_frames`` a multiple of ``engine.FRONT_ROWS``).
- **Convert (utterance end)**: GroupNorm statistics run over the whole
  utterance, so exact conversion runs once at :meth:`finish`, through the
  engine's coalescing batcher. ``chunk_frames`` selects the approximate
  chunked mode, which converts growing prefixes while audio arrives.
- **Synthesize (streamed)**: the native vocoder (``jpwg``) emits audio chunk
  by chunk through ``infer/vocoder.jpwg_synthesize_stream`` (a halo of the
  generator's receptive field on each side); Griffin-Lim is a global
  transform, synthesized whole and then cut into chunks.

A device failure raises; nothing retries on another device.
"""

from __future__ import annotations

import time

import numpy as np

from ..data import cmvn as cmvn_mod
from ..data import features

__all__ = ["StreamingSession"]


class StreamingSession:
    """One streaming conversion request.

    Usage::

        s = StreamingSession(engine, target="TEF1", sr=24000)
        for chunk in incoming_audio:
            s.feed(chunk)                     # mel frames accrue here
        for offset, wav_piece in s.finish():  # convert + streamed synthesis
            send(wav_piece)

    Parameters
    ----------
    engine : ConversionEngine
    target : speaker name or integer id (resolved at once: an unknown
        target fails before any audio is buffered)
    sr : int
        Input sample rate. When it differs from the engine's, the whole
        signal is resampled at :meth:`finish` (the polyphase filter must
        see the same signal as the offline path), so no frame is computed
        while audio arrives.
    block_frames : int
        Mel frames per front-end block.
    out_chunk_frames : int
        Output granularity in mel frames (``x hop`` samples per yielded
        wav chunk); defaults to the engine's ``bucket_frames``.
    chunk_frames : int or None
        ``None`` (default): exact mode, one conversion at :meth:`finish`
        with the utterance's GroupNorm statistics, equal to the offline
        path. An int: approximate chunked mode, where mel chunk ``k``
        (frames ``[kC, (k+1)C)``) is converted once ``(k+1)C + lookahead``
        frames exist, by running the model on that prefix (masked
        GroupNorm statistics over it) and keeping chunk ``k``'s rows.
    lookahead_frames : int
        Future frames each chunk's prefix reaches past its end (chunked
        mode only).
    """

    def __init__(self, engine, target, sr, *, block_frames=64,
                 out_chunk_frames=None, chunk_frames=None,
                 lookahead_frames=64):
        self.engine = engine
        self.tgt = engine.resolve_target(target)
        self.sr = int(sr)
        self.fs = engine.fs
        self.hop = engine.n_shift
        feat = engine.feature
        self.n_fft = int(feat["n_fft"])
        self.pad = self.n_fft // 2
        self.n_mels = int(feat["n_mels"])
        self.block_frames = int(block_frames)
        self.out_chunk_frames = int(out_chunk_frames
                                    or engine.bucket_frames)
        self._incremental = self.sr == self.fs
        self._buf = np.zeros((1 << 14,), np.float32)
        self._n = 0                      # received samples
        # raw log-mel blocks (a list: concatenating per block is O(T^2))
        self._mel_blocks: list = []
        self._mel_frames = 0
        self._done = False
        self.chunk_frames = None if chunk_frames is None else int(chunk_frames)
        self.lookahead_frames = int(lookahead_frames)
        if self.chunk_frames is not None and self.chunk_frames <= 0:
            raise ValueError(f"chunk_frames must be > 0 "
                             f"(got {self.chunk_frames}); use None for "
                             "exact utterance-end conversion")
        if self.lookahead_frames < 0:
            raise ValueError(
                f"lookahead_frames must be >= 0 (got {self.lookahead_frames})")
        self._conv_blocks: list = []     # converted mel chunks (chunked mode)
        self._conv_frames = 0

    # ------------------------------------------------------------- ingest
    @property
    def frames_ready(self) -> int:
        """Mel frames computed so far."""
        return self._mel_frames

    def feed(self, samples):
        """Append an audio chunk (1-D float array at ``sr``)."""
        if self._done:
            raise RuntimeError("session already finished")
        x = np.asarray(samples, np.float32).ravel()
        if x.size:
            need = self._n + x.size
            if need > self._buf.size:
                nb = np.zeros((max(need, 2 * self._buf.size),), np.float32)
                nb[:self._n] = self._buf[:self._n]
                self._buf = nb
            self._buf[self._n:need] = x
            self._n = need
        if self._incremental:
            self._drain_safe_frames()
            if self.chunk_frames is not None:
                self._convert_ready_chunks()

    def _drain_safe_frames(self):
        """Emit every whole block whose frames' windows are covered by the
        received samples (frame t needs t * hop + pad of them)."""
        while True:
            t0 = self._mel_frames
            t1 = t0 + self.block_frames
            if (t1 - 1) * self.hop + self.pad >= self._n:
                return
            self._emit_block(t0, self._received_window(t0, t1))

    def _received_window(self, t0, t1):
        """Samples of frames [t0, t1), canvas coordinates
        [t0 * hop - pad, (t1 - 1) * hop + pad), from received audio only;
        the left edge is reflected as the offline padding does."""
        lo = t0 * self.hop - self.pad
        hi = (t1 - 1) * self.hop + self.pad
        if lo >= 0:
            return self._buf[lo:hi].copy()
        out = np.empty((hi - lo,), np.float32)
        out[:-lo] = self._buf[1:1 - lo][::-1]          # reflect: x[-j] = x[j]
        out[-lo:] = self._buf[:hi]
        return out

    def _canvas_window(self, t0, t1, L, n_pad):
        """The same span from the whole offline canvas (the signal, zeros to
        ``n_pad`` samples, reflected at both ends), for the tail frames at
        :meth:`finish`. Coordinates past the right reflection (only in rows
        at or past the true length, which are dropped) are zero."""
        lo = t0 * self.hop - self.pad
        hi = (t1 - 1) * self.hop + self.pad
        idx = np.arange(lo, hi)
        idx = np.where(idx < 0, -idx, idx)                   # left reflect
        idx = np.where(idx >= n_pad, 2 * (n_pad - 1) - idx,  # right reflect
                       idx)
        valid = (idx >= 0) & (idx < L)
        out = np.zeros((hi - lo,), np.float32)
        out[valid] = self._buf[idx[valid]]
        return out

    def _emit_block(self, t0, window):
        mel = self.engine._mel_window(window)
        if mel.shape != (self.block_frames, self.n_mels) \
                or t0 != self._mel_frames:
            raise RuntimeError(f"front-end block at frame {t0} gave "
                               f"{mel.shape} after {self._mel_frames} frames")
        self._mel_blocks.append(mel)
        self._mel_frames += self.block_frames

    # ------------------------------------------------ approximate chunked mode
    @property
    def converted_frames(self) -> int:
        """Mel frames converted during ingest (chunked mode)."""
        return self._conv_frames

    def _convert_prefix(self, end, pe):
        """Convert prefix ``[0, pe)`` through the engine's masked bucketed
        model (GroupNorm statistics over the prefix) and keep rows
        ``[converted_frames, end)``."""
        eng = self.engine
        mel_raw = np.concatenate(self._mel_blocks, axis=0)[:pe]
        feats = np.zeros((eng._pick_pad(pe), self.n_mels), np.float32)
        feats[:pe] = cmvn_mod.apply(mel_raw, eng.stats)
        out = eng._infer_mel(feats, pe, self.tgt)
        self._conv_blocks.append(
            out[self._conv_frames:end].astype(np.float32))
        self._conv_frames = end

    def _convert_ready_chunks(self):
        """Convert every chunk whose prefix and lookahead have arrived."""
        C, L = self.chunk_frames, self.lookahead_frames
        while self._mel_frames >= self._conv_frames + C + L:
            end = self._conv_frames + C
            self._convert_prefix(end, end + L)

    # ------------------------------------------------------------- finish
    def finish(self):
        """End of input: convert and yield output chunks.

        Returns a generator of ``(sample_offset, wav_chunk)`` pairs
        (float32, engine rate); with ``engine.vocoder == 'none'`` a single
        ``(0, mel (T, M))`` pair. The session is closed at the call, not at
        the first iteration: a later ``feed`` or ``finish`` raises at once.
        """
        if self._done:
            raise RuntimeError("session already finished")
        self._done = True
        if not self._incremental:
            x = features.resample(self._buf[:self._n], self.sr, self.fs)
            self._buf, self._n = x, x.size
        if self._n == 0:
            raise ValueError("empty waveform")
        return self._finish_gen()

    def _finish_gen(self):
        eng = self.engine
        t0 = time.monotonic()        # server-side latency: convert + vocode
        L = self._n
        T_true = features.num_frames(L, self.hop)
        T_pad = eng._pick_pad(T_true)
        n_pad = T_pad * self.hop - 1
        # the tail frames (all frames when resampled) from the canvas
        while self._mel_frames < T_true:
            self._emit_block(self._mel_frames, self._canvas_window(
                self._mel_frames, self._mel_frames + self.block_frames,
                L, n_pad))
        mel_raw = np.concatenate(self._mel_blocks, axis=0)

        if self.chunk_frames is not None:
            # the tail chunks, prefixes clipped to the utterance (the last
            # chunk's statistics are the whole utterance's)
            while self._conv_frames < T_true:
                end = min(T_true, self._conv_frames + self.chunk_frames)
                pe = min(T_true, end + self.lookahead_frames)
                self._convert_prefix(end, pe)
            mel_out = np.concatenate(self._conv_blocks, axis=0)
        else:
            feats = np.zeros((T_pad, self.n_mels), np.float32)
            feats[:T_true] = cmvn_mod.apply(mel_raw[:T_true], eng.stats)
            mel_out = eng._infer_mel(feats, T_true, self.tgt)
        T_out = mel_out.shape[0]

        if eng.vocoder == "none":
            eng._count_request(t0)
            yield 0, mel_out.astype(np.float32)
            return
        if eng.vocoder == "jpwg":
            canvas = eng._silence_canvas(mel_out, T_pad)
            yield from self._stream_jpwg(canvas, T_out)
        else:
            # Griffin-Lim is global: synthesize whole, then cut
            wav = eng._vocode(mel_out, T_pad)
            step = self.out_chunk_frames * self.hop
            for a in range(0, wav.size, step):
                yield a, wav[a:a + step]
        eng._count_request(t0)

    def _stream_jpwg(self, canvas, T_out):
        """Chunks of the generator over ``canvas`` with the engine's noise
        for its bucket (the one-shot path's ``z``), frames past ``T_out``
        not synthesized."""
        from ..infer.vocoder import jpwg_synthesize_stream

        voc = self.engine._voc
        z = voc.noise(canvas.shape[0], self.engine.seed)
        n_keep = T_out * voc.hop
        for at, wav in jpwg_synthesize_stream(
                voc.gen, canvas, z, chunk_frames=self.out_chunk_frames,
                halo_frames=voc.halo, hop=voc.hop, stop_frame=T_out):
            if at >= n_keep:
                break
            yield at, wav[:n_keep - at].astype(np.float32)
