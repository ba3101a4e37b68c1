"""The PyTorch port's speaker embedders and similarity CLIs against the JAX
package, on the CPU.

The same flax parameters (``utils/eval_fixture.numpy_params``) go into the
JAX module and the port's: the x-vectors and logits of both architectures
(``tdnn``, ``conv3``) agree within 1e-5 relative to their peak on ragged
batches; ``embed_scp`` gives JAX's unit embeddings within 1e-5; a six-step
``train_embedder`` lockstep on JAX's numpy batches keeps the losses within
1e-4 relative (JAX's are read from its log lines, printed to 4 decimals:
plus 5e-5) and the parameters within 1e-3 of each leaf's peak; embedder
checkpoints move both ways with the same bytes; ``bin/eval_similarity``
with ``--device cpu`` prints JAX's last line from JAX's checkpoint (mel and
MFCC + VAD front-ends) and its score files within 1e-5 relative;
``bin/extract_spk_emb`` writes unit embeddings and speaker means.
"""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_npvc_tpu.eval import similarity as jax_sim
from vae_npvc_tpu_torch.data import kaldi_io
from vae_npvc_tpu_torch.eval import similarity
from vae_npvc_tpu_torch.utils.bridge import _flatten, load_flax_params
from vae_npvc_tpu_torch.utils.eval_fixture import (char_corpus, numpy_params,
                                                   speaker_corpus)

torch.set_num_threads(1)

S, D = 3, 10


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(arch, width=16, emb=8, seed=0):
    model = jax_sim._embedder(S, emb, width, arch)
    tpl = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, D)))["params"]
    return model, numpy_params(_np(tpl), seed)


def _port(arch, params, width=16, emb=8):
    m = similarity._embedder(S, emb, width, arch, feat_dim=D)
    return m if params is None else load_flax_params(m, params)


@pytest.mark.parametrize("arch", ["tdnn", "conv3"])
def test_embedder_outputs_match_jax(arch):
    model, params = _params(arch, seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 30, D)).astype(np.float32)
    lens = np.array([30, 12, 1, 25], np.int32)
    apply = jax.jit(model.apply)
    for n in (lens, None):
        want = apply({"params": params}, jnp.asarray(x),
                     None if n is None else jnp.asarray(n))
        got = _port(arch, params)(torch.from_numpy(x),
                                  None if n is None else torch.from_numpy(n))
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


def test_embed_scp_matches_jax(tmp_path):
    speaker_corpus(tmp_path, S, 12, seed=3, dim=D, frames=(5, 300))
    model, params = _params("tdnn", seed=4)
    port = _port("tdnn", None)
    got = similarity.embed_scp(port, params, tmp_path / "feats.scp",
                               bucket=64, batch_size=4)
    want = jax_sim.embed_scp(model, params, tmp_path / "feats.scp",
                             bucket=64, batch_size=4)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["tdnn", "conv3"])
def test_train_embedder_six_step_lockstep(arch, tmp_path, monkeypatch,
                                          capsys):
    speaker_corpus(tmp_path, S, 15, seed=5, dim=D, frames=(20, 40))
    _, params = _params(arch, seed=6)
    orig = jax_sim._embedder

    class Injected:
        def __init__(self, inner):
            self.inner = inner

        def init(self, *a, **k):
            return {"params": params}

        def apply(self, *a, **k):
            return self.inner.apply(*a, **k)

    monkeypatch.setattr(jax_sim, "_embedder",
                        lambda *a, **k: Injected(orig(*a, **k)))
    cfg = {"crop_length": 24}
    kw = dict(steps=6, batch_size=8, emb_dim=8, width=16, arch=arch,
              log_every=1)
    _, want_params = jax_sim.train_embedder(tmp_path, cfg, **kw)
    want = [float(line.rsplit(" ", 1)[1]) for line in
            capsys.readouterr().out.splitlines()
            if line.startswith("spk-embedder step")]
    losses = []
    _, got_params = similarity.train_embedder(
        tmp_path, cfg, device="cpu", params=params, losses=losses,
        **dict(kw, log_every=0))
    assert len(want) == len(losses) == 6
    np.testing.assert_allclose(losses, want, rtol=1e-4, atol=5e-5)
    got, ref = {}, {}
    _flatten(got_params, "", got)
    _flatten(_np(want_params), "", ref)
    assert set(got) == set(ref)
    for k in ref:
        peak = float(np.abs(ref[k]).max())
        assert np.abs(got[k] - ref[k]).max() <= 1e-3 * peak, k


def test_embedder_checkpoints_move_both_ways(tmp_path):
    _, params = _params("tdnn", seed=7)
    meta = {"arch": "tdnn", "width": 16, "emb_dim": 8, "num_speakers": S,
            "feat_dim": D}
    jax_sim.save_embedder(tmp_path / "j.msgpack", meta, params)
    model, got, got_meta = similarity.load_embedder(tmp_path / "j.msgpack",
                                                    device="cpu")
    assert got_meta == meta
    similarity.save_embedder(tmp_path / "p.msgpack", got_meta,
                             similarity.params_to_flax(model.state_dict()))
    assert (tmp_path / "p.msgpack").read_bytes() \
        == (tmp_path / "j.msgpack").read_bytes()
    _, back, _ = jax_sim.load_embedder(tmp_path / "p.msgpack")
    a, b = {}, {}
    _flatten(_np(back), "", a)
    _flatten(params, "", b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def _sim_dirs(root):
    train, conv = root / "train", root / "conv"
    speaker_corpus(train, S, 18, seed=8, dim=D, frames=(20, 60))
    speaker_corpus(conv, S, 6, seed=8, dim=D, frames=(20, 60), prefix="c")
    (root / "trials").write_text("".join(
        f"c{i:02d} spk{(i + (i % 2)) % S}\n" for i in range(6)))
    (root / "conf.yaml").write_text("crop_length: 24\n")
    return train, conv


def _cli_args(root, train, conv, ckpt, extra=()):
    return ["-c", str(root / "conf.yaml"), "--train_dir", str(train),
            "--converted_scp", str(conv / "feats.scp"),
            "--trials", str(root / "trials"), "--enroll_dir", str(train),
            "--steps", "20", "--embedder_width", "16",
            "--embedder_ckpt", str(ckpt), *extra]


def _write_wav(path, fs, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes((x * 32767).astype("<i2").tobytes())


def _wav_scp(d, utts, seed):
    rng = np.random.default_rng(seed)
    lines = []
    for i, u in enumerate(utts):
        t = np.arange(8000) / 16000.0
        f0 = 110.0 + 60.0 * (i % S)
        x = (0.3 * np.sin(2 * np.pi * f0 * t)
             + 0.2 * np.sin(2 * np.pi * 3.1 * f0 * t)
             + 0.01 * rng.normal(size=len(t)))
        _write_wav(d / f"{u}.wav", 16000, x)
        lines.append(f"{u} {d}/{u}.wav\n")
    (d / "wav.scp").write_text("".join(lines))


@pytest.mark.parametrize("frontend", ["mel", "mfcc_vad"])
def test_eval_similarity_cli_prints_jax_last_line(frontend, tmp_path,
                                                  monkeypatch, capsys):
    import sys

    from vae_npvc_tpu.bin import eval_similarity as jax_cli
    from vae_npvc_tpu_torch.bin import eval_similarity

    train, conv = _sim_dirs(tmp_path)
    extra = ()
    if frontend == "mfcc_vad":
        _wav_scp(train, list(kaldi_io.read_scp(train / "feats.scp")), 9)
        _wav_scp(conv, list(kaldi_io.read_scp(conv / "feats.scp")), 10)
        extra = ("--frontend", "mfcc_vad", "--converted_wav_dir", str(conv))
    ckpt = tmp_path / "emb.msgpack"
    monkeypatch.setattr(sys, "argv", ["eval_similarity", "--output_dir",
                                      str(tmp_path / "j")]
                        + _cli_args(tmp_path, train, conv, ckpt, extra))
    jax_cli.main()
    want = capsys.readouterr().out.splitlines()[-1]
    eval_similarity.main(["--output_dir", str(tmp_path / "p"), "--device",
                          "cpu"] + _cli_args(tmp_path, train, conv, ckpt,
                                             extra))
    out = capsys.readouterr().out
    assert "loaded speaker embedder" in out
    assert out.splitlines()[-1] == want and want.startswith("PLDA: ")
    for f in sorted((tmp_path / "j").rglob("*_scores")):
        g = tmp_path / "p" / f.relative_to(tmp_path / "j")
        got_rows = [ln.split() for ln in g.read_text().splitlines()]
        want_rows = [ln.split() for ln in f.read_text().splitlines()]
        assert [r[:2] for r in got_rows] == [r[:2] for r in want_rows]
        np.testing.assert_allclose([float(r[2]) for r in got_rows],
                                   [float(r[2]) for r in want_rows],
                                   rtol=1e-5, atol=2e-6)


def test_extract_spk_emb_cli(tmp_path):
    from vae_npvc_tpu_torch.bin import extract_spk_emb

    train, _ = _sim_dirs(tmp_path)
    (tmp_path / "conf.json").write_text('{"crop_length": 24}')
    n = extract_spk_emb.main([
        "-c", str(tmp_path / "conf.json"), "--train_dir", str(train),
        "--data_dir", str(train), "--out", str(tmp_path / "out"),
        "--steps", "5", "--emb_dim", "8", "--spk_mean", "--device", "cpu"])
    assert n == 18
    embs = dict(kaldi_io.read_ark(tmp_path / "out" / "spk_emb.ark"))
    means = dict(kaldi_io.read_ark(tmp_path / "out" / "spk_emb_mean.ark"))
    assert sorted(means) == ["spk0", "spk1", "spk2"]
    for e in list(embs.values()) + list(means.values()):
        assert e.shape == (1, 8)
        np.testing.assert_allclose(np.linalg.norm(e), 1.0, rtol=1e-5)


def test_eval_clis_run_on_the_card_by_default(tmp_path):
    """Without ``--device`` the CLIs ask for the GPU, and raise without
    one (no silent CPU run)."""
    from vae_npvc_tpu_torch.bin import eval_asr, eval_similarity

    train, conv = _sim_dirs(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        eval_similarity.main(_cli_args(tmp_path, train, conv,
                                       tmp_path / "e.msgpack"))
    char = tmp_path / "c"
    char_corpus(char, 4, 0)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        eval_asr.main(["--train_dir", str(char), "--eval_scp",
                       str(char / "feats.scp"), "--ref_text",
                       str(char / "text"), "--output_dir",
                       str(tmp_path / "o"), "--steps", "1"])
