"""The port's vocoder inference (``infer/vocoder.py``) and the engine's
``jpwg`` backend against the JAX package, on the CPU.

Noise is not compared across packages (the port draws it from a seeded
``torch.Generator``, JAX from ``jax.random``): each test rebuilds the
port's noise with :func:`decode_noise` or the engine's ``noise`` and feeds
the same array to the JAX generator. Tolerances: chunked against
full-length synthesis and the engine's wav against the generator run on
the same canvas and noise within 1e-5; decoded PCM within one LSB of the
JAX generator's on the same noise; receptive fields equal.
"""

import wave
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_optim_misc import _fake_exp_dir, _install_fake_pwg_package
from tests.test_pwg import PWG_CFG
from tests.test_torch_port_serve import FEAT, SPK, _port_engine
from tests.test_torch_port_serve import parts  # noqa: F401 (fixture)
from vae_npvc_tpu.infer import vocoder as jax_vocoder
from vae_npvc_tpu.models.pwg import PWGGenerator as JaxGen
from vae_npvc_tpu_torch.data import kaldi_io
from vae_npvc_tpu_torch.infer import vocoder

torch.set_num_threads(1)
HOP = 4
VOC_CFG = dict(PWG_CFG, seed=3)
# the engine's vocoder: the serving tests' front end (10 mels, hop 32)
ENGINE_VOC_CFG = dict(VOC_CFG, n_mels=10, n_shift=32, upsample_scales=[4, 8])


def _voc_ckpt(cfg, path):
    """A vocoder checkpoint of the port: seeded weights, one step."""
    from vae_npvc_tpu_torch.train.pwg import PwgTrainer

    tr = PwgTrainer(cfg, device="cpu")
    tr.init_state()
    hop = int(np.prod(cfg["upsample_scales"]))
    rng = np.random.default_rng(0)
    tr.train_step((rng.normal(size=(2, 24 * hop)).astype(np.float32) * 0.3,
                   rng.normal(size=(2, 24, cfg["n_mels"]))
                   .astype(np.float32)))
    tr.save_checkpoint(path)
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _voc_ckpt(VOC_CFG, tmp_path_factory.mktemp("voc") / "model")


def _params(path):
    from vae_npvc_tpu_torch.utils import msgpack_io

    return msgpack_io.msgpack_restore(Path(path).read_bytes())["generator"]


def _pcm(path):
    with wave.open(str(path)) as w:
        assert w.getframerate() == VOC_CFG["fs"]
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


@pytest.mark.parametrize("cfg", [
    {}, VOC_CFG, {"layers": 12, "stacks": 2, "kernel_size": 5,
                  "upsample_scales": [2, 3, 5]}])
def test_receptive_frames_equal_jax(cfg):
    assert vocoder.jpwg_receptive_frames(cfg) \
        == jax_vocoder.jpwg_receptive_frames(cfg)
    if not cfg:
        assert vocoder.jpwg_receptive_frames(cfg) == 16   # the recipe's


def test_chunked_synthesis_equals_the_full_pass(ckpt):
    gen = vocoder.load_generator(VOC_CFG, ckpt, 16, device="cpu")
    rng = np.random.default_rng(3)
    T = 70
    mel = rng.normal(size=(T, 16)).astype(np.float32)
    z = rng.normal(size=(T * HOP, 1)).astype(np.float32)
    halo = vocoder.jpwg_receptive_frames(VOC_CFG)
    with torch.no_grad():
        full = gen(torch.from_numpy(z[None]),
                   torch.from_numpy(mel[None]))[0, :, 0].numpy()
    chunked = vocoder.jpwg_synthesize_chunked(
        gen, mel, z, chunk_frames=16, halo_frames=halo, hop=HOP)
    assert np.abs(chunked - full).max() <= 1e-5 * np.abs(full).max()
    # the stream in order, cut early at a stop frame
    parts = list(vocoder.jpwg_synthesize_stream(
        gen, mel, z, chunk_frames=16, halo_frames=halo, hop=HOP,
        stop_frame=40))
    assert [a for a, _ in parts] == [0, 64, 128]
    got = np.concatenate([w for _, w in parts])
    assert got.size == 40 * HOP
    np.testing.assert_allclose(got, chunked[:40 * HOP], atol=1e-6)
    # and against JAX's chunked synthesis on the same weights and noise
    jax_gen = JaxGen(arch=VOC_CFG)
    want = jax_vocoder.jpwg_synthesize_chunked(
        jax_gen, _params(ckpt), mel, z, chunk_frames=16, halo_frames=halo,
        hop=HOP)
    assert np.abs(chunked - want).max() <= 1e-5 * np.abs(want).max()


def _feats_scp(tmp_path, frames):
    rng = np.random.default_rng(11)
    d = tmp_path / "denorm"
    d.mkdir()
    mats = {}
    with kaldi_io.ArkWriter(d / "feats.ark", d / "feats.scp") as w:
        for i, n in enumerate(frames):
            mats[f"u{i}"] = rng.normal(size=(n, 16)).astype(np.float32) - 2
            w.write(f"u{i}", mats[f"u{i}"])
    return d / "feats.scp", mats


@pytest.mark.parametrize("chunk", [None, 24])
def test_decode_scp_pcm_matches_the_jax_generator(ckpt, tmp_path, chunk):
    """Buckets of 16 frames, batches of up to 2 (a bucket's last one holds
    only its own utterances): every wav has ``frames * hop`` samples and
    equals, within one LSB, JAX's generator on the same zero-padded batch
    and the same noise draw."""
    frames = [9, 30, 14, 17, 33, 20]
    scp, mats = _feats_scp(tmp_path, frames)
    out = tmp_path / "wav"
    n = vocoder.jpwg_decode_scp(scp, out, VOC_CFG, ckpt, batch_size=2,
                                bucket=16, seed=4, chunk_frames=chunk,
                                device="cpu")
    assert n == len(frames)
    params = _params(ckpt)
    jgen = JaxGen(arch=VOC_CFG)
    halo = vocoder.jpwg_receptive_frames(VOC_CFG)
    items = list(mats.items())
    long = [it for it in items if chunk and it[1].shape[0] > chunk]
    short = [it for it in items if not (chunk and it[1].shape[0] > chunk)]
    want, draw = {}, 0
    for u, mel in long:
        z = vocoder.decode_noise(4, draw, (mel.shape[0] * HOP, 1),
                                 "cpu").numpy()
        draw += 1
        want[u] = jax_vocoder.jpwg_synthesize_chunked(
            jgen, params, mel, z, chunk_frames=chunk, halo_frames=halo,
            hop=HOP)
    buckets = {}
    for u, mel in short:
        buckets.setdefault(-(-mel.shape[0] // 16) * 16, []).append((u, mel))
    for T_pad in sorted(buckets):
        group = buckets[T_pad]
        for lo in range(0, len(group), 2):
            n_b = len(group[lo:lo + 2])
            c = np.zeros((n_b, T_pad, 16), np.float32)
            for b, (_, mel) in enumerate(group[lo:lo + 2]):
                c[b, :mel.shape[0]] = mel
            z = vocoder.decode_noise(4, draw, (n_b, T_pad * HOP, 1), "cpu")
            draw += 1
            wav = np.asarray(jgen.apply({"params": params},
                                        jnp.asarray(z.numpy()),
                                        jnp.asarray(c)))[..., 0]
            for b, (u, mel) in enumerate(group[lo:lo + 2]):
                want[u] = wav[b, :mel.shape[0] * HOP]
    assert len(want) == len(frames)
    for u, mel in mats.items():
        got = _pcm(out / f"{u}.wav")
        ref = (np.clip(want[u], -1, 1) * 32767).astype("<i2")
        assert got.size == mel.shape[0] * HOP
        assert np.abs(got.astype(np.int32) - ref).max() <= 1, u


def test_decode_scp_of_an_empty_scp_writes_nothing(ckpt, tmp_path):
    (tmp_path / "feats.scp").write_text("")
    assert vocoder.jpwg_decode_scp(tmp_path / "feats.scp", tmp_path / "o",
                                   VOC_CFG, ckpt, device="cpu") == 0


def test_decode_noise_is_seeded_per_draw():
    a = vocoder.decode_noise(1, 0, (3, 5), "cpu")
    assert torch.equal(a, vocoder.decode_noise(1, 0, (3, 5), "cpu"))
    assert not torch.equal(a, vocoder.decode_noise(1, 1, (3, 5), "cpu"))
    assert not torch.equal(a, vocoder.decode_noise(2, 0, (3, 5), "cpu"))


def test_write_wav_matches_jax(tmp_path):
    x = np.linspace(-1.5, 1.5, 101).astype(np.float32)
    vocoder._write_wav(tmp_path / "a.wav", x, 8000)
    jax_vocoder._write_wav(tmp_path / "b.wav", x, 8000)
    assert (tmp_path / "a.wav").read_bytes() \
        == (tmp_path / "b.wav").read_bytes()


def test_engine_jpwg_wav_matches_the_generator(parts, tmp_path):
    """``ConversionEngine(vocoder="jpwg")``: the served wav is the
    generator's one pass over the bucket's log-mel-silence canvas with the
    engine's noise, cut to the request's frames; JAX's generator on the
    same canvas and noise agrees. Without a vocoder config it raises."""
    from vae_npvc_tpu_torch.serve.engine import ConversionEngine

    ckpt = _voc_ckpt(ENGINE_VOC_CFG, tmp_path / "voc")
    for kw in ({}, {"voc_config": ENGINE_VOC_CFG},
               {"voc_checkpoint": ckpt}):
        with pytest.raises(ValueError, match="voc_config"):
            ConversionEngine(*parts, feature=FEAT, spk2spk_id=SPK,
                             vocoder="jpwg", device="cpu", **kw)
    eng = _port_engine(parts, vocoder="jpwg", voc_config=ENGINE_VOC_CFG,
                       voc_checkpoint=ckpt, seed=6)
    hop = 32
    try:
        rng = np.random.default_rng(1)
        wav = rng.normal(size=(2000,)).astype(np.float32) * 0.1
        out, fs = eng.convert(wav, 8000, "B")
        mel, _ = eng.convert(wav, 8000, "B", return_mel=True)
        T_pad = eng._pick_pad(mel.shape[0])
        canvas = eng._silence_canvas(mel, T_pad)
        z = eng._voc.noise(T_pad, 6)
        assert z.shape == (T_pad * hop, 1)
        with torch.no_grad():
            direct = eng._voc.gen(z[None], torch.from_numpy(canvas[None]))
        direct = direct[0, :mel.shape[0] * hop, 0].numpy()
        assert fs == 8000 and out.shape == direct.shape
        assert np.abs(out - direct).max() <= 1e-5 * np.abs(direct).max()
        want = np.asarray(JaxGen(arch=ENGINE_VOC_CFG).apply(
            {"params": _params(ckpt)}, jnp.asarray(z.numpy()[None]),
            jnp.asarray(canvas[None])))[0, :mel.shape[0] * hop, 0]
        assert np.abs(out - want).max() <= 1e-5 * np.abs(want).max()
        assert eng.stats_snapshot()["vocoder"] == "jpwg"
    finally:
        eng.close()


class TestExternalShim:
    """``external_decode_scp`` with a stand-in ``parallel_wavegan``
    package, as ``tests/test_optim_misc.py`` drives the JAX shim."""

    @pytest.mark.parametrize("gtype,bands", [
        ("ParallelWaveGANGenerator", 1), ("MultiBandMelGANGenerator", 4)])
    def test_writes_the_same_wavs_as_jax(self, monkeypatch, tmp_path, gtype,
                                         bands):
        scp, mats = _feats_scp(tmp_path, [20, 12])
        expdir = _fake_exp_dir(tmp_path, "exp", gtype, bands)
        calls = _install_fake_pwg_package(monkeypatch, 16, bands=bands)
        _record_devices(monkeypatch, calls)
        assert vocoder.external_decode_scp(scp, tmp_path / "p", expdir,
                                           device="cpu") == 2
        assert calls["model"] == gtype and calls.get("removed_wn")
        assert calls["devices"] == {("cpu", "cpu")}
        assert ("pqmf" in calls) == (bands > 1)
        assert jax_vocoder.external_decode_scp(scp, tmp_path / "j",
                                               expdir) == 2
        for u, mel in mats.items():
            a = (tmp_path / "p" / f"{u}.wav").read_bytes()
            assert a == (tmp_path / "j" / f"{u}.wav").read_bytes()
            assert _pcm_any(tmp_path / "p" / f"{u}.wav").size \
                == mel.shape[0] * HOP
        assert vocoder.pwg_decode_scp is vocoder.external_decode_scp

    def test_runs_on_the_card_by_default(self, monkeypatch, tmp_path):
        """With no ``device`` the shim asks for the GPU: here, without
        one, it raises instead of decoding on the CPU."""
        scp, _ = _feats_scp(tmp_path, [20])
        expdir = _fake_exp_dir(tmp_path, "exp", "ParallelWaveGANGenerator")
        calls = _install_fake_pwg_package(monkeypatch, 16)
        if torch.cuda.is_available():
            pytest.skip("a GPU is present; the cuda tests drive it")
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            vocoder.external_decode_scp(scp, tmp_path / "p", expdir)
        assert "model" not in calls

    def test_raises_without_the_package(self, tmp_path):
        with pytest.raises((ImportError, FileNotFoundError)) as ei:
            vocoder.pwg_decode_scp(tmp_path / "feats.scp", tmp_path / "wav",
                                   tmp_path / "pwg")
        assert "parallel_wavegan" in str(ei.value) \
            or "pkl" in str(ei.value)

    def test_missing_files_raise(self, monkeypatch, tmp_path):
        _install_fake_pwg_package(monkeypatch, 16)
        (tmp_path / "empty").mkdir()
        with pytest.raises(FileNotFoundError, match="pkl"):
            vocoder.external_decode_scp(tmp_path / "x.scp", tmp_path / "o",
                                        tmp_path / "empty")


def _record_devices(monkeypatch, calls):
    """Wrap the stand-in package's ``load_model`` so that each ``inference``
    call records (the model's device, its input's device) in
    ``calls["devices"]``."""
    import sys

    utils = sys.modules["parallel_wavegan.utils"]
    load = utils.load_model
    calls["devices"] = set()

    def load_model(ckpt, config):
        model = load(ckpt, config)
        model.register_buffer("probe", torch.zeros(1))
        inference = model.inference

        def probed(c):
            calls["devices"].add((model.probe.device.type, c.device.type))
            return inference(c)

        model.inference = probed
        return model

    monkeypatch.setattr(utils, "load_model", load_model)


def _pcm_any(path):
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def test_recipe_stage6_call_with_the_recipe_yaml(tmp_path):
    """Stage 6 with ``voc=JPWG`` as the recipes call it: the recipe's YAML
    path and a full-width checkpoint (on the CPU: one short utterance, a
    batch of one)."""
    import yaml

    from vae_npvc_tpu_torch.train.pwg import PwgTrainer

    conf = (Path(__file__).resolve().parents[1]
            / "egs/vcc20/vae1/conf/train_jpwg.yaml")
    tr = PwgTrainer(yaml.safe_load(conf.read_text()), device="cpu")
    tr.init_state()
    tr.save_checkpoint(tmp_path / "model.final")
    d = tmp_path / "denorm"
    d.mkdir()
    mel = np.random.default_rng(0).normal(size=(6, 80)).astype(np.float32)
    with kaldi_io.ArkWriter(d / "feats.ark", d / "feats.scp") as w:
        w.write("utt", mel - 4.0)
    assert vocoder.jpwg_decode_scp(d / "feats.scp", d / "wav", conf,
                                   tmp_path / "model.final", batch_size=1,
                                   bucket=8, device="cpu") == 1
    with wave.open(str(d / "wav" / "utt.wav")) as w:
        assert w.getframerate() == 24000
        assert w.getnframes() == 6 * 256
