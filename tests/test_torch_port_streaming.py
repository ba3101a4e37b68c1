"""The port's streaming sessions and ``/stream`` route against the JAX
package's on the CPU.

One counterpart for each case of ``tests/test_streaming.py``. The port's
``StreamingSession`` and JAX's run on the same checkpoint (a JAX-trained toy
flat model) and the same bytes: their mel agrees within 1e-3 absolute, as
``tests/test_torch_port_serve.py`` holds the engines. Where JAX's contract
promises equality (streamed rows against the offline path of the same
engine), the port's own streamed output is held bit for bit. Synthesized
audio is held against the port's own one-shot path: the two frameworks draw
Griffin-Lim phases and vocoder noise from different generators.
"""

import io
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.test_torch_port_serve import FEAT, SPK, parts  # noqa: F401
from tests.test_torch_port_serve import _port_engine as _port
from vae_npvc_tpu_torch.serve import ConversionEngine, StreamingSession

torch.set_num_threads(1)

JAX_TOL = 1e-3


def _ragged_chunks(x, seed=0):
    """``x`` in ragged chunks (1 to 1,024 samples), an empty one second."""
    rng = np.random.default_rng(seed)
    out, i = [], 0
    while i < x.size:
        n = int(rng.choice([1, 7, 130, 333, 1024]))
        out.append(x[i:i + n])
        i += n
    out.insert(1, x[:0])
    return out


def _wav(n, seed):
    return (np.random.default_rng(seed).normal(size=(n,)) * 0.1).astype(
        np.float32)


@pytest.fixture(scope="module")
def engines(parts):  # noqa: F811
    """(port mel-only engine, JAX mel-only engine) on one checkpoint."""
    from vae_npvc_tpu.serve import ConversionEngine as JaxEngine

    cfg, ck, stats = parts
    peng = _port(parts)
    jeng = JaxEngine(cfg, ck, stats, feature=FEAT, spk2spk_id=SPK,
                     vocoder="none", bucket_frames=32, batch_window_ms=30.0)
    yield peng, jeng
    peng.close()
    jeng.close()


def _stream(session_cls, eng, target, sr, wav, seed=0, **kw):
    """``(finish() pieces, frames_ready after each feed, converted_frames
    after each feed)`` of one session fed ``wav`` in ragged chunks."""
    s = session_cls(eng, target, sr, **kw)
    ready, conv = [], []
    for c in _ragged_chunks(wav, seed):
        s.feed(c)
        ready.append(s.frames_ready)
        conv.append(s.converted_frames)
    return list(s.finish()), ready, conv


def _jax_stream(jeng, target, sr, wav, seed=0, **kw):
    from vae_npvc_tpu.serve.streaming import StreamingSession as JaxSession

    (at, mel), = _stream(JaxSession, jeng, target, sr, wav, seed, **kw)[0]
    assert at == 0
    return mel


def test_streaming_mel_bit_identical_to_offline(engines):
    """Ragged feeding gives the offline mel bit for bit, frames accrue
    during feeding, and the mel is JAX's session's within 1e-3."""
    peng, jeng = engines
    wav = _wav(9000, 7)
    want, fs = peng.convert(wav, 8000, "B", return_mel=True)
    pieces, ready, _ = _stream(StreamingSession, peng, "B", 8000, wav,
                               block_frames=16)
    assert ready[-1] > 0, "no incremental frames before finish"
    (at, mel), = pieces
    assert at == 0 and fs == 8000
    np.testing.assert_array_equal(mel, want)
    ref = _jax_stream(jeng, "B", 8000, wav, block_frames=16)
    assert mel.shape == ref.shape
    np.testing.assert_allclose(mel, ref, atol=JAX_TOL)


def test_streaming_short_utterance_and_errors(engines):
    """Shorter than one block (every frame at finish); an empty session, a
    second finish, a feed after finish and an unknown target raise."""
    peng, jeng = engines
    wav = _wav(500, 3)
    want, _ = peng.convert(wav, 8000, 0, return_mel=True)
    s = StreamingSession(peng, 0, 8000, block_frames=64)
    s.feed(wav)
    assert s.frames_ready == 0
    (_, mel), = list(s.finish())
    np.testing.assert_array_equal(mel, want)
    np.testing.assert_allclose(
        mel, _jax_stream(jeng, 0, 8000, wav, block_frames=64), atol=JAX_TOL)
    with pytest.raises(RuntimeError, match="already finished"):
        s.feed(wav)
    with pytest.raises(RuntimeError, match="already finished"):
        s.finish()
    with pytest.raises(ValueError, match="empty waveform"):
        StreamingSession(peng, 0, 8000).finish()
    with pytest.raises(KeyError):
        StreamingSession(peng, "nope", 8000)


def test_streaming_resample_fallback(engines):
    """sr != the engine's: the whole signal is resampled at finish, as the
    offline path does, and no frame is computed before."""
    peng, jeng = engines
    wav = _wav(4000, 11)
    want, _ = peng.convert(wav, 16000, "A", return_mel=True)
    pieces, ready, _ = _stream(StreamingSession, peng, "A", 16000, wav,
                               seed=2, block_frames=16)
    assert ready[-1] == 0
    (_, mel), = pieces
    np.testing.assert_array_equal(mel, want)
    np.testing.assert_allclose(
        mel, _jax_stream(jeng, "A", 16000, wav, seed=2, block_frames=16),
        atol=JAX_TOL)


def test_streaming_gl_wav_matches_offline(parts):  # noqa: F811
    """A Griffin-Lim engine streams its wav in chunks at the stated
    offsets, concatenated equal to the one-shot conversion."""
    eng = _port(parts, vocoder="gl", gl_iters=2)
    try:
        wav = _wav(6000, 5)
        want, _ = eng.convert(wav, 8000, "B")
        pieces, _, _ = _stream(StreamingSession, eng, "B", 8000, wav, seed=1,
                               block_frames=16, out_chunk_frames=32)
        assert len(pieces) > 1
        assert [at for at, _ in pieces] == [i * 32 * 32
                                            for i in range(len(pieces))]
        np.testing.assert_array_equal(
            np.concatenate([w for _, w in pieces]), want)
    finally:
        eng.close()


def test_streaming_jpwg_chunks_match_offline(parts, tmp_path):  # noqa: F811
    """A ``jpwg`` engine emits audio chunk by chunk; the chunks equal the
    one-shot synthesis on the same noise within float noise (different
    window shapes). The vocoder checkpoint is the JAX trainer's."""
    from vae_npvc_tpu.train.pwg import PwgTrainer

    pwg_cfg = {"fs": 8000, "n_fft": 64, "n_shift": 32, "n_mels": 10,
               "layers": 4, "stacks": 2, "residual_channels": 8,
               "gate_channels": 16, "skip_channels": 8,
               "upsample_scales": [4, 8], "disc_layers": 3,
               "disc_channels": 8, "discriminator_train_start_steps": 0,
               "stft_loss_params": [[64, 16, 32]], "seed": 0}
    pwg = PwgTrainer(pwg_cfg)
    rng = np.random.default_rng(3)
    pwg.init_state((rng.normal(size=(2, 16 * 32)).astype(np.float32),
                    rng.normal(size=(2, 16, 10)).astype(np.float32)))
    voc_ck = tmp_path / "jpwg.ckpt"
    pwg.save_checkpoint(voc_ck)
    eng = _port(parts, vocoder="jpwg", voc_config=pwg_cfg,
                voc_checkpoint=voc_ck)
    try:
        from vae_npvc_tpu_torch.infer.vocoder import jpwg_receptive_frames

        assert eng._voc.halo == jpwg_receptive_frames(pwg_cfg) > 0
        wav = _wav(5000, 4)
        want, _ = eng.convert(wav, 8000, "A")
        s = StreamingSession(eng, "A", 8000, block_frames=16,
                             out_chunk_frames=32)
        s.feed(wav)
        pieces = list(s.finish())
        assert len(pieces) > 1, "jpwg output must stream in > 1 chunk"
        got = np.concatenate([w for _, w in pieces])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    finally:
        eng.close()


def test_streaming_over_bundle_backend(parts, tmp_path):  # noqa: F811
    """Sessions ride the port's exported bundle: exact mode equals the
    bundle engine's one-shot mel bit for bit; chunked mode picks only the
    bundle's buckets for its growing prefixes."""
    from vae_npvc_tpu_torch.infer.export_serving import export_bundle

    cfg, ck, stats = parts
    export_bundle(cfg, ck, tmp_path / "bundle", buckets=[32, 64],
                  batch_size=4, n_targets=1, device="cpu",
                  spk2spk_id={"A": 0, "B": 1})
    eng = ConversionEngine(None, None, stats, bundle=tmp_path / "bundle",
                           feature=FEAT, vocoder="none", bucket_frames=32,
                           batch_window_ms=30.0, device="cpu")
    seen = []
    pick = eng.bundle.pick_bucket
    eng.bundle.pick_bucket = lambda T: seen.append(pick(T)) or seen[-1]
    try:
        wav = _wav(1700, 13)
        want, _ = eng.convert(wav, 8000, "B", return_mel=True)
        (_, mel), = _stream(StreamingSession, eng, "B", 8000, wav, seed=3,
                            block_frames=16)[0]
        np.testing.assert_array_equal(mel, want)
        seen.clear()
        (_, approx), = _stream(StreamingSession, eng, "B", 8000, wav, seed=3,
                               block_frames=16, chunk_frames=16,
                               lookahead_frames=8)[0]
        assert approx.shape == want.shape and np.isfinite(approx).all()
        assert len(seen) >= 4 and set(seen) <= {32, 64}
    finally:
        eng.close()


class _Chunks(io.RawIOBase):
    """A body urllib sends with ``Transfer-Encoding: chunked``."""

    def __init__(self, data, n=777):
        self.view, self.i, self.n = memoryview(data), 0, n

    def readable(self):
        return True

    def readinto(self, b):
        k = min(len(b), self.n, len(self.view) - self.i)
        b[:k] = self.view[self.i:self.i + k]
        self.i += k
        return k


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.headers["Content-Type"], r.read()


def test_http_stream_route(parts, engines):  # noqa: F811
    """POST /stream with a chunked raw-PCM body: the chunked WAV answer's
    PCM equals /convert's (i16 and f32 bodies); a mel-only engine answers
    with /convert?mel=1's .npy (JAX's session's within 1e-3); bad targets,
    a missing sr, a bad format and bad chunk geometry are 400s."""
    from scipy.io import wavfile

    from vae_npvc_tpu_torch.bin.serve import serve

    peng, jeng = engines
    pcm = (np.sin(np.linspace(0, 80, 3000)) * 0.5 * 32767).astype("<i2")
    buf = io.BytesIO()
    wavfile.write(buf, 8000, pcm)
    gl = _port(parts, vocoder="gl", gl_iters=2)
    servers = []
    try:
        bases = []
        for eng in (gl, peng):
            httpd = serve(eng, "127.0.0.1", 0)
            th = threading.Thread(target=httpd.serve_forever, daemon=True)
            th.start()
            servers.append((httpd, th))
            bases.append(f"http://127.0.0.1:{httpd.server_address[1]}")
        base, mel_base = bases

        _, body = _post(f"{base}/convert?target=B", buf.getvalue())
        _, want = wavfile.read(io.BytesIO(body))
        ctype, body = _post(f"{base}/stream?target=B&sr=8000&format=i16",
                            _Chunks(pcm.tobytes()))
        assert ctype == "audio/wav"
        assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
        np.testing.assert_array_equal(np.frombuffer(body[44:], "<i2"), want)
        _, body = _post(
            f"{base}/stream?target=B&sr=8000&format=f32",
            (pcm.astype(np.float32) / 32768.0).astype("<f4").tobytes())
        np.testing.assert_array_equal(np.frombuffer(body[44:], "<i2"), want)

        _, body = _post(f"{mel_base}/convert?target=B&mel=1", buf.getvalue())
        want_mel = np.load(io.BytesIO(body))
        ctype, body = _post(f"{mel_base}/stream?target=B&sr=8000",
                            _Chunks(pcm.tobytes(), n=501))
        assert ctype == "application/octet-stream"
        mel = np.load(io.BytesIO(body))
        np.testing.assert_array_equal(mel, want_mel)
        np.testing.assert_allclose(
            mel, _jax_stream(jeng, "B", 8000, pcm.astype(np.float32)
                             / 32768.0), atol=JAX_TOL)

        for query in ("target=nope&sr=8000", "target=B", "target=B&sr=x",
                      "target=B&sr=8000&format=u8",
                      "target=B&sr=8000&chunk=-5",
                      "target=B&sr=8000&chunk=a"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/stream?{query}", b"\0\0" * 100)
            assert e.value.code == 400, query
        with urllib.request.urlopen(f"{base}/health", timeout=30) as r:
            assert r.status == 200            # the server kept serving
    finally:
        for httpd, th in servers:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=30)
        gl.close()
    assert not any(th.is_alive() for _, th in servers)


# ------------------------------------------------ approximate chunked mode
def test_chunked_mode_full_lookahead_is_exact(engines):
    """A lookahead past the utterance clips every prefix to it: the
    utterance's statistics, the offline mel exactly."""
    peng, jeng = engines
    wav = _wav(9000, 7)
    want, _ = peng.convert(wav, 8000, "B", return_mel=True)
    (at, mel), = _stream(StreamingSession, peng, "B", 8000, wav,
                         block_frames=16, chunk_frames=16,
                         lookahead_frames=10 ** 6)[0]
    assert at == 0
    np.testing.assert_array_equal(mel, want)


def test_chunked_mode_overlaps_ingest_and_bounded_deviation(engines):
    """A small lookahead converts chunks during feeding, gives the offline
    shape, deviates boundedly, ends with the offline rows (the last
    prefix is the utterance) and equals JAX's chunked session within
    1e-3."""
    peng, jeng = engines
    wav = _wav(12000, 8)
    want, _ = peng.convert(wav, 8000, "B", return_mel=True)
    kw = dict(block_frames=16, chunk_frames=32, lookahead_frames=16)
    pieces, _, conv = _stream(StreamingSession, peng, "B", 8000, wav, seed=3,
                              **kw)
    assert conv[-1] > 0, "no chunk converted during ingest"
    (_, mel), = pieces
    assert mel.shape == want.shape and np.isfinite(mel).all()
    dev = float(np.sqrt(np.mean((mel - want) ** 2)))
    assert dev < float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(mel[-8:], want[-8:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        mel, _jax_stream(jeng, "B", 8000, wav, seed=3, **kw), atol=JAX_TOL)


def test_chunked_mode_rejects_invalid_geometry(engines):
    peng, _ = engines
    with pytest.raises(ValueError, match="chunk_frames"):
        StreamingSession(peng, "B", 8000, chunk_frames=-5)
    with pytest.raises(ValueError, match="lookahead_frames"):
        StreamingSession(peng, "B", 8000, chunk_frames=16,
                         lookahead_frames=-1)
