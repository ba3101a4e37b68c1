"""PyTorch port serving path vs the JAX package on the CPU.

The port's ConversionEngine (``device="cpu"``) loads a checkpoint the JAX
Trainer wrote and converts the same wav as the JAX engine: mel within 1e-3
absolute (front-end, model and CMVN in fp32 on two frameworks). The port's
HTTP server then answers on an ephemeral localhost port.
"""

import io
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tests.toy_config import toy_config
from vae_npvc_tpu_torch.serve import ConversionEngine

torch.set_num_threads(1)

FEAT = {"fs": 8000, "n_fft": 128, "n_shift": 32, "n_mels": 10,
        "fmin": 0.0, "fmax": None, "win_length": None}
SPK = {"A": 0, "B": 1, "C": 2}


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """(config, JAX checkpoint path, CMVN stats)."""
    from vae_npvc_tpu.train.trainer import Trainer

    tmp = tmp_path_factory.mktemp("serve")
    cfg = toy_config()
    tr = Trainer(cfg)
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(2, 32, 10)).astype(np.float32),
             np.zeros((2,), np.int32))
    tr.init_state(batch)
    tr.train_step(batch)
    ck = tmp / "m.ckpt"
    tr.save_checkpoint(ck)
    stats = np.zeros((2, 11), np.float64)
    stats[0, :-1] = -3.0 * 1000
    stats[0, -1] = 1000
    stats[1, :-1] = (1.0 + 3.0 ** 2) * 1000
    return cfg, ck, stats


def _port_engine(parts, **kw):
    cfg, ck, stats = parts
    kw.setdefault("vocoder", "none")
    return ConversionEngine(cfg, ck, stats, feature=FEAT, spk2spk_id=SPK,
                            bucket_frames=32, batch_window_ms=30.0,
                            device="cpu", **kw)


def test_engine_matches_jax_engine(parts):
    from vae_npvc_tpu.serve import ConversionEngine as JaxEngine

    cfg, ck, stats = parts
    rng = np.random.default_rng(1)
    wav = rng.normal(size=(2000,)).astype(np.float32) * 0.1
    jeng = JaxEngine(cfg, ck, stats, feature=FEAT, spk2spk_id=SPK,
                     vocoder="none", bucket_frames=32)
    peng = _port_engine(parts)
    try:
        ref, fs_j = jeng.convert(wav, 8000, "B", return_mel=True)
        got, fs_p = peng.convert(wav, 8000, "B", return_mel=True)
        # resampled input too (16 kHz -> 8 kHz)
        ref2, _ = jeng.convert(wav, 16000, "C", return_mel=True)
        got2, _ = peng.convert(wav, 16000, "C", return_mel=True)
    finally:
        jeng.close()
        peng.close()
    assert fs_j == fs_p == 8000
    assert got.shape == ref.shape and got2.shape == ref2.shape
    np.testing.assert_allclose(got, ref, atol=1e-3)
    np.testing.assert_allclose(got2, ref2, atol=1e-3)


def test_engine_targets_batching_and_unported_options(parts):
    eng = _port_engine(parts, max_batch=8)
    try:
        with pytest.raises(KeyError):
            eng.resolve_target("nope")
        with pytest.raises(KeyError, match="out of range"):
            eng.resolve_target(99)
        assert eng.resolve_target("2") == 2
        eng.warmup(1)
        rng = np.random.default_rng(2)
        wavs = [rng.normal(size=(900,)).astype(np.float32) * 0.1
                for _ in range(4)]
        serial = [eng.convert(w, 8000, i % 3, return_mel=True)[0]
                  for i, w in enumerate(wavs)]
        eng.batcher.window_s = 0.4
        calls0 = eng.batcher.calls
        with ThreadPoolExecutor(4) as ex:
            outs = list(ex.map(lambda i: eng.convert(
                wavs[i], 8000, i % 3, return_mel=True)[0], range(4)))
        assert eng.batcher.calls - calls0 < 4       # requests coalesced
        for o, s in zip(outs, serial):
            np.testing.assert_allclose(o, s, rtol=1e-5, atol=1e-5)
        assert eng.stats_snapshot()["requests"] == 8
    finally:
        eng.close()
    # data_parallel serves (a mesh of the engine's one device here)
    dp = _port_engine(parts, data_parallel=True)
    try:
        assert dp.batcher.pad_multiple == 1
        np.testing.assert_allclose(
            dp.convert(wavs[0], 8000, 0, return_mel=True)[0], serial[0],
            rtol=1e-5, atol=1e-5)
    finally:
        dp.close()
    # bundles are served (tests/test_torch_port_export_serving.py); a
    # directory without bundle.json is refused
    with pytest.raises(FileNotFoundError, match="bundle.json"):
        _port_engine(parts, bundle="b")
    with pytest.raises(ValueError, match="voc_config"):
        _port_engine(parts, vocoder="jpwg")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ConversionEngine(parts[0], parts[1], parts[2])


def test_http_server_end_to_end(parts):
    from scipy.io import wavfile

    from vae_npvc_tpu_torch.bin.serve import serve

    eng = _port_engine(parts, vocoder="gl", gl_iters=2)
    httpd = serve(eng, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        rng = np.random.default_rng(3)
        wav = (rng.normal(size=(1500,)) * 0.1).astype(np.float32)
        buf = io.BytesIO()
        wavfile.write(buf, 8000, (wav * 32767).astype(np.int16))
        body = buf.getvalue()

        def post(query):
            req = urllib.request.Request(f"{base}/convert?{query}",
                                         data=body, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.read()

        sr, out = wavfile.read(io.BytesIO(post("target=A")))
        assert sr == 8000 and out.dtype == np.int16
        assert out.shape == ((1 + 1500 // 32) * 32,)
        mel = np.load(io.BytesIO(post("target=B&mel=1")))
        assert mel.shape == (1 + 1500 // 32, 10) and np.isfinite(mel).all()
        with pytest.raises(urllib.error.HTTPError) as e:
            post("target=nope")
        assert e.value.code == 400
        with urllib.request.urlopen(f"{base}/health", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        with urllib.request.urlopen(f"{base}/speakers", timeout=30) as r:
            assert json.loads(r.read()) == SPK
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            assert b"vae_npvc_requests 2" in r.read()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
        eng.close()
    assert not th.is_alive()
