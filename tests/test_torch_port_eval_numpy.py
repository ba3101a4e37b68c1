"""The PyTorch port's host-numpy evaluation modules against the JAX
package, on the CPU.

``eval/wer``, ``eval/lm``, ``eval/plda``, ``eval/mcd``, ``data/mfcc`` and
``data/pitch`` are the port's own copies (it imports nothing of the JAX
package), and ``ctc_prefix_beam_search`` is copied too: on the same seeded
inputs they give JAX's outputs exactly (``==`` on floats, no tolerance).
``mcd_from_scp`` reads through the port's ``data/kaldi_io``; the
similarity reports and ``write_scores`` are copied functions over numpy
embeddings. ``eval/rtf`` times the port's ``Converter`` (a number, not held
against JAX: it is a wall-clock time).
"""

import wave

import numpy as np
import pytest
import torch

from vae_npvc_tpu.eval import asr as jax_asr
from vae_npvc_tpu.eval import lm as jax_lm
from vae_npvc_tpu.eval import mcd as jax_mcd
from vae_npvc_tpu.eval import plda as jax_plda
from vae_npvc_tpu.eval import similarity as jax_sim
from vae_npvc_tpu.eval import wer as jax_wer
from vae_npvc_tpu.data import mfcc as jax_mfcc
from vae_npvc_tpu.data import pitch as jax_pitch
from vae_npvc_tpu_torch.data import kaldi_io, mfcc, pitch
from vae_npvc_tpu_torch.eval import asr, lm, mcd, plda, similarity, wer

torch.set_num_threads(1)

REFS = {"u1": "the cat sat", "u2": "a b c d", "u3": "hello world",
        "u4": "x"}
HYPS = {"u1": "the bat sat on", "u2": "a c d", "u3": "hello word",
        "u4": ""}


@pytest.mark.parametrize("level", ["word", "char"])
def test_wer_score_and_report_equal_jax(level, tmp_path):
    for r, h in zip(REFS.values(), HYPS.values()):
        toks = (wer.tokenize(r, level), wer.tokenize(h, level))
        assert toks == (jax_wer.tokenize(r, level),
                        jax_wer.tokenize(h, level))
        assert vars(wer.align(*toks)) == vars(jax_wer.align(*toks))
    got, s_err, per = wer.score(REFS, HYPS, level)
    want, s_err_j, per_j = jax_wer.score(REFS, HYPS, level)
    assert (vars(got), s_err) == (vars(want), s_err_j)
    assert {k: vars(v) for k, v in per.items()} \
        == {k: vars(v) for k, v in per_j.items()}
    wer.write_report(tmp_path / "p.txt", REFS, HYPS, level)
    jax_wer.write_report(tmp_path / "j.txt", REFS, HYPS, level)
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_char_ngram_lm_equals_jax():
    texts = ["abab", "abba", "ba", "cab", "abcabc"]
    assert (lm.BOS, lm.EOS) == (jax_lm.BOS, jax_lm.EOS)
    for order in (1, 2, 3):
        a, b = lm.CharNgramLM(texts, order), jax_lm.CharNgramLM(texts, order)
        assert a.vocab == b.vocab
        for ctx in ["", "a", "ab", "zz", "abab", "bca"]:
            for c in a.vocab + [lm.EOS, "q"]:
                assert a.logp(list(ctx), c) == b.logp(list(ctx), c)
            assert a.logp_eos(list(ctx)) == b.logp_eos(list(ctx))


def _embeddings(n_spk=6, n_utt=12, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_spk, dim)) * 3.0
    embs = np.concatenate([centers[s] + rng.normal(size=(n_utt, dim))
                           for s in range(n_spk)])
    return embs, [f"s{s}" for s in range(n_spk) for _ in range(n_utt)], rng


def test_plda_train_and_scores_equal_jax():
    embs, labels, rng = _embeddings()
    got, want = plda.plda_train(embs, labels), jax_plda.plda_train(embs,
                                                                   labels)
    for k in vars(want):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    tests = {f"t{i}": rng.normal(size=8) * 3 for i in range(4)}
    enroll = {f"s{s}": embs[12 * s:12 * s + 12].mean(0) for s in range(6)}
    counts = {s: 12 for s in enroll}
    trials = [(s, t) for s in ("s0", "s3") for t in tests]
    assert plda.plda_score_trials(got, enroll, counts, tests, trials) \
        == jax_plda.plda_score_trials(want, enroll, counts, tests, trials)
    for n in (1, 5):
        assert plda.plda_score(got, enroll["s1"], tests["t0"], n) \
            == jax_plda.plda_score(want, enroll["s1"], tests["t0"], n)


def test_similarity_reports_equal_jax(tmp_path):
    embs, labels, _ = _embeddings(seed=3)
    unit = {f"e{i}": e / np.linalg.norm(e) for i, e in enumerate(embs)}
    u2s = {f"e{i}": s for i, s in enumerate(labels)}
    conv = {f"c{i}": v for i, v in enumerate(list(unit.values())[::7])}
    u2t = {u: labels[(7 * i) % len(labels)] for i, u in enumerate(conv)}
    model = plda.plda_train(embs, labels)
    assert similarity.cosine_similarity_report(conv, unit, u2t, u2s) \
        == jax_sim.cosine_similarity_report(conv, unit, u2t, u2s)
    got = similarity.plda_similarity_report(model, conv, unit, u2t, u2s)
    assert got == jax_sim.plda_similarity_report(model, conv, unit, u2t, u2s)
    similarity.write_scores(tmp_path / "p", "TEF1", got[1], got[0])
    jax_sim.write_scores(tmp_path / "j", "TEF1", got[1], got[0])
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()


def test_mcd_from_scp_equals_jax(tmp_path):
    rng = np.random.default_rng(5)
    for name, shift in (("a", 0.0), ("b", 0.4)):
        with kaldi_io.ArkWriter(tmp_path / f"{name}.ark",
                                tmp_path / f"{name}.scp") as w:
            for i, T in enumerate((30, 41, 25)):
                base = np.random.default_rng(i).normal(size=(T, 20))
                w.write(f"u{i}", (base + shift * rng.normal(size=(T, 20)))
                        .astype(np.float32))
    got = mcd.mcd_from_scp(tmp_path / "a.scp", tmp_path / "b.scp")
    assert got == jax_mcd.mcd_from_scp(tmp_path / "a.scp",
                                       tmp_path / "b.scp")
    assert got[0] > 0
    a = rng.normal(size=(30, 20))
    assert mcd.mcd(a, a[::2], use_dtw=False) \
        == jax_mcd.mcd(a, a[::2], use_dtw=False)
    cost = np.abs(rng.normal(size=(9, 7)))
    assert list(map(tuple, mcd.dtw_path(cost))) \
        == list(map(tuple, jax_mcd.dtw_path(cost)))


def _tone(fs, f0, seconds, seed=0):
    t = np.arange(int(fs * seconds)) / fs
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * f0 * t)
            + 0.1 * np.sin(2 * np.pi * 2.3 * f0 * t)
            + 0.01 * rng.normal(size=len(t)))


def _write_wav(path, fs, x):
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes((x * 32767).astype("<i2").tobytes())


def test_wav_mcd_pieces_equal_jax(tmp_path):
    fs = 16000
    x, y = _tone(fs, 150.0, 0.4), _tone(fs, 120.0, 0.45, seed=1)
    f0 = mcd.estimate_f0(x, fs)
    np.testing.assert_array_equal(f0, jax_mcd.estimate_f0(x, fs))
    env = mcd.cheaptrick_envelope(x, fs, f0)
    np.testing.assert_array_equal(env, jax_mcd.cheaptrick_envelope(x, fs,
                                                                   f0))
    np.testing.assert_array_equal(mcd.mcep_from_wav(x, fs),
                                  jax_mcd.mcep_from_wav(x, fs))
    _write_wav(tmp_path / "conv" / "SEF1_E20001.wav", fs, x)
    _write_wav(tmp_path / "gt" / "E20001.wav", fs, y)
    got = mcd.mcd_from_wavdirs(tmp_path / "conv", tmp_path / "gt")
    assert got == jax_mcd.mcd_from_wavdirs(tmp_path / "conv",
                                           tmp_path / "gt")
    assert got[0] > 0


def test_mfcc_vad_and_pitch_equal_jax():
    fs = 16000
    x = np.concatenate([np.zeros(1600), _tone(fs, 180.0, 0.5),
                        np.zeros(800)]) * 32768.0
    feats, log_e = mfcc.mfcc(x, fs, high_freq=7600.0)
    want, want_e = jax_mfcc.mfcc(x, fs, high_freq=7600.0)
    np.testing.assert_array_equal(feats, want)
    np.testing.assert_array_equal(log_e, want_e)
    np.testing.assert_array_equal(mfcc.compute_vad(log_e),
                                  jax_mfcc.compute_vad(want_e))
    np.testing.assert_array_equal(mfcc.mfcc_vad(x, fs),
                                  jax_mfcc.mfcc_vad(x, fs))
    y = _tone(fs, 220.0, 0.6).astype(np.float32)
    np.testing.assert_array_equal(pitch.kaldi_pitch(y, fs),
                                  jax_pitch.kaldi_pitch(y, fs))
    np.testing.assert_array_equal(
        pitch.pitch_feats(y, fs, n_frames=61, frame_shift_ms=10.0),
        jax_pitch.pitch_feats(y, fs, n_frames=61, frame_shift_ms=10.0))


def test_mfcc_vad_scp_equals_jax(tmp_path):
    """The similarity front-end over a wav.scp, a 24 kHz file resampled."""
    lines = []
    for i, fs in enumerate((16000, 24000)):
        p = tmp_path / f"w{i}.wav"
        _write_wav(p, fs, np.concatenate([np.zeros(fs // 10),
                                          _tone(fs, 160.0 + 40 * i, 0.5)]))
        lines.append(f"w{i} {p}\n")
    (tmp_path / "wav.scp").write_text("".join(lines))
    got = similarity.mfcc_vad_scp(tmp_path / "wav.scp")
    want = jax_sim.mfcc_vad_scp(tmp_path / "wav.scp")
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _logprobs(T, V, seed):
    x = np.random.default_rng(seed).normal(size=(T, V)) * 2.0
    return x - np.log(np.exp(x).sum(axis=1, keepdims=True))


@pytest.mark.parametrize("beam", [1, 4, 10])
def test_prefix_beam_search_equals_jax(beam):
    texts = ["abc", "bca", "cab", "aabbc", "abcabc"]
    id2char = {1: "a", 2: "b", 3: "c"}
    for seed in range(3):
        lp = _logprobs(24, 4, seed)
        for lm_j, lm_p in ((None, None),
                           (jax_lm.CharNgramLM(texts, 3),
                            lm.CharNgramLM(texts, 3))):
            kw = dict(beam_size=beam, lm_weight=0.6, penalty=0.5,
                      id2char=id2char)
            assert asr.ctc_prefix_beam_search(lp, lm=lm_p, **kw) \
                == jax_asr.ctc_prefix_beam_search(lp, lm=lm_j, **kw)


def test_measure_rtf_on_the_port_converter(tmp_path):
    """``measure_rtf`` runs the port's model on its device (the CPU here)
    and returns consistent numbers: rtf * frames/s = the frame rate."""
    from tests.test_torch_port_golden import GOLDEN_CONFIG
    from vae_npvc_tpu_torch.eval.rtf import measure_rtf
    from vae_npvc_tpu_torch.infer.convert import Converter

    cv = Converter(GOLDEN_CONFIG, device="cpu")
    rng = np.random.default_rng(0)
    D = GOLDEN_CONFIG["encoder"]["in_channels"][0]
    feats = rng.normal(size=(2, 32, D)).astype(np.float32)
    rtf, fps = measure_rtf(cv, feats, np.array([32, 20]), np.array([1, 2]),
                           frame_rate_hz=93.75, warmup=1, repeats=2)
    assert np.isfinite(rtf) and rtf > 0 and fps > 0
    np.testing.assert_allclose(rtf * fps, 93.75, rtol=1e-6)
