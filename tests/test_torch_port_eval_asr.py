"""The PyTorch port's CTC recognizer against the JAX package, on the CPU.

The same seeded numpy inputs and parameters (``utils/eval_fixture``) go
through the JAX module and the port's:

- both encoders' log-probs within 1e-5 and every parameter gradient within
  1e-4 of its leaf's peak (the key projection's bias, whose exact gradient
  is 0, within 1e-4 of the largest), at width 48 with 2 blocks, ragged lengths and an
  odd and an even T (flax's SAME padding of the stride-2 conv is 1 + 2 on an
  even T); the transformer's attention runs through JAX's Pallas kernel in
  interpret mode on the JAX side, the port's plain version here;
- the CTC loss against ``optax.ctc_loss`` on a batch with a row whose
  labels cannot be aligned: values within 1e-6 relative, the feasible
  rows' gradients within 1e-5 of their peak; the infeasible row (a loss of
  ~1e5, where float32 spacing is 2^-7) in float64 within 1e-9, and in
  float32 both packages within 2^-6 of the float64 gradient;
- SpecAugment with JAX's draws gives JAX's masks exactly;
- a six-step ``train_ctc`` lockstep (specaug off, injected parameters):
  losses within 1e-4 relative (JAX's are read from its log lines, printed
  to 4 decimals: plus 5e-5), final parameters within 1e-3 of each leaf's
  peak (Adam's first steps are ~lr per element whatever the gradient's
  size, so a rounding-level gradient of opposite sign moves an element by
  up to 2 lr; the key projection's bias, whose gradient is rounding noise,
  within 2 lr per step);
- transcripts, greedy and beam search with either LM, equal JAX's;
- checkpoints move both ways with the same bytes;
- ``bin/eval_asr`` with ``--device cpu`` prints JAX's last line from the
  same checkpoints.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_npvc_tpu.eval import asr as jax_asr
from vae_npvc_tpu.eval import lm as jax_lm
from vae_npvc_tpu.eval import neural_lm as jax_nlm
from vae_npvc_tpu.ops import attention_pallas
from vae_npvc_tpu_torch.eval import asr
from vae_npvc_tpu_torch.eval import lm as port_lm
from vae_npvc_tpu_torch.eval import neural_lm
from vae_npvc_tpu_torch.utils.bridge import _flatten, load_flax_params
from vae_npvc_tpu_torch.utils.eval_fixture import char_corpus, numpy_params

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(arch, V, D, width=48, blocks=3, seed=0, T=16, B=2):
    model = jax_asr._ctc_model(V, width, blocks=blocks, arch=arch)
    tpl = model.init(jax.random.PRNGKey(0), jnp.zeros((B, T, D)),
                     jnp.ones((B,), jnp.int32))["params"]
    return model, numpy_params(_np(tpl), seed)


def _port(arch, V, D, params, width=48, blocks=3):
    m = asr._ctc_model(V, width, blocks=blocks, arch=arch, feat_dim=D)
    return load_flax_params(m, params)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """JAX's 'auto' attention takes the Pallas kernel, in interpret mode."""
    monkeypatch.setattr(attention_pallas, "compiled_ok", lambda: True)
    kernel = attention_pallas.fused_attention

    def interpret(*a, interpret=False, **k):
        return kernel(*a, interpret=True, tile_q=128, **k)
    monkeypatch.setattr(attention_pallas, "fused_attention", interpret)


def _shift_invariant(name):
    """The key projection's bias adds q.b to every score of a query row:
    the softmax ignores it, its exact gradient is 0 and both packages give
    rounding noise (held to the largest gradient's scale instead)."""
    return name.endswith("mha.linear_k.bias")


def _peak_close(got, want, tol, what):
    peak = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= tol * peak, (what, err, peak)


@pytest.mark.parametrize("arch", ["conv", "transformer"])
def test_encoder_logprobs_and_gradients_match_jax(arch, pallas_interpret):
    rng = np.random.default_rng(1)
    V, D, B = 6, 10, 3
    for T, lens in ((37, [37, 20, 5]), (36, [36, 1, 17])):
        x = rng.normal(size=(B, T, D)).astype(np.float32)
        lens = np.array(lens, np.int32)
        model, params = _jax_params(arch, V, D, blocks=2, seed=T)
        cot = rng.normal(size=(B, (T + 1) // 2, V + 1)).astype(np.float32)

        def f(p):
            logits, _ = model.apply({"params": p}, jnp.asarray(x),
                                    jnp.asarray(lens))
            lp = jax.nn.log_softmax(logits, axis=-1)
            return jnp.sum(lp * cot), lp
        (_, want), grads = jax.value_and_grad(f, has_aux=True)(params)
        port = _port(arch, V, D, params, blocks=2)
        logits, out_len = port(torch.from_numpy(x), torch.from_numpy(lens))
        lp = torch.log_softmax(logits, dim=-1)
        (lp * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_array_equal(out_len.numpy(), (lens + 1) // 2)
        np.testing.assert_allclose(lp.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
        flat = {}
        _flatten(_np(grads), "", flat)
        got = dict(port.named_parameters())
        assert set(flat) == set(got)
        top = max(float(np.abs(g).max()) for g in flat.values())
        for k, g in flat.items():
            if _shift_invariant(k):
                assert np.abs(got[k].grad.numpy() - g).max() <= 1e-4 * top
            else:
                _peak_close(got[k].grad.numpy(), g, 1e-4, (arch, T, k))


def _ctc_batch():
    rng = np.random.default_rng(0)
    B, T, V, L = 4, 12, 5, 8
    logits = (rng.normal(size=(B, T, V)) * 2).astype(np.float32)
    olen = np.array([12, 9, 4, 7], np.int32)
    labels = rng.integers(1, V, size=(B, L)).astype(np.int32)
    labels[3, :3] = [2, 2, 2]                    # repeats need blanks
    llen = np.array([5, 3, 6, 3], np.int32)      # row 2: 6 labels, 4 frames
    return logits, olen, labels, llen


def _optax_ctc(logits, olen, labels, llen, dtype):
    T, L = logits.shape[1], labels.shape[1]
    pad = (jnp.arange(T)[None] >= olen[:, None]).astype(dtype)
    lpad = (jnp.arange(L)[None] >= llen[:, None]).astype(dtype)
    return optax.ctc_loss(logits, pad, labels, lpad, blank_id=0)


def test_ctc_loss_matches_optax_with_an_infeasible_row():
    logits, olen, labels, llen = _ctc_batch()
    feasible = asr.ctc_feasible(labels, llen, olen)
    assert feasible.tolist() == [True, True, False, True]
    w = np.arange(1.0, 5.0, dtype=np.float32)

    def jax_grad(dtype):
        f = lambda z: jnp.sum(_optax_ctc(z, olen, labels, llen, dtype) * w)
        z = jnp.asarray(logits, dtype)
        return (np.asarray(jax.jit(_optax_ctc, static_argnums=4)(
            z, olen, labels, llen, dtype)),
                np.asarray(jax.jit(jax.grad(f))(z)))

    want, want_g = jax_grad(jnp.float32)
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = asr.ctc_loss(x, torch.from_numpy(olen), torch.from_numpy(labels),
                        torch.from_numpy(llen))
    (loss * torch.from_numpy(w)).sum().backward()
    got, got_g = loss.detach().numpy(), x.grad.numpy()
    assert np.isfinite(got).all() and got[2] > 1e5     # optax's floor
    np.testing.assert_allclose(got, want, rtol=1e-6)
    ok = feasible
    _peak_close(got_g[ok], want_g[ok], 1e-5, "feasible rows")
    with jax.enable_x64(True):
        want64, want64_g = jax_grad(jnp.float64)
    x64 = torch.from_numpy(logits.astype(np.float64)).requires_grad_(True)
    l64 = asr._ctc_optax(torch.log_softmax(x64, -1),
                         torch.from_numpy(labels).long(),
                         torch.from_numpy(olen), torch.from_numpy(llen))
    (l64 * torch.from_numpy(w.astype(np.float64))).sum().backward()
    np.testing.assert_allclose(l64.detach().numpy(), want64, rtol=1e-12)
    np.testing.assert_allclose(x64.grad.numpy(), want64_g, rtol=0, atol=1e-9)
    for g in (got_g, want_g):      # each package's fp32 at a loss of ~1e5
        assert np.abs(g[2] - want64_g[2]).max() <= 2 ** -6 * w[2]
    # F.ctc_loss alone gives inf on that row
    lib = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1),
        torch.from_numpy(labels).long(), torch.from_numpy(olen).long(),
        torch.from_numpy(llen).long(), reduction="none")
    assert torch.isinf(lib[2]) and not torch.isinf(lib[ok]).any()


def test_spec_augment_with_jax_draws_equals_jax():
    B, T, D = 3, 50, 16
    feats = np.random.default_rng(2).normal(size=(B, T, D)).astype(
        np.float32)
    flens = np.array([50, 30, 10], np.int32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_asr.spec_augment(key, jnp.asarray(feats),
                                           jnp.asarray(flens)))
    # JAX's draws, split as spec_augment splits its key
    rng, time, freq = key, [], []
    for _ in range(2):
        rng, k1, k2 = jax.random.split(rng, 3)
        time.append((jax.random.randint(k1, (B, 1), 0, 21),
                     jax.random.uniform(k2, (B, 1))))
    for _ in range(2):
        rng, k1, k2 = jax.random.split(rng, 3)
        freq.append((jax.random.randint(k1, (B, 1), 0, 9),
                     jax.random.randint(k2, (B, 1), 0, D - 8)))
    draws = ([tuple(torch.from_numpy(np.array(a)) for a in d)
              for d in time],
             [tuple(torch.from_numpy(np.array(a)) for a in d)
              for d in freq])
    got = asr.spec_augment(None, torch.from_numpy(feats),
                           torch.from_numpy(flens), draws=draws)
    np.testing.assert_array_equal(got.numpy(), want)
    own = asr.spec_augment(torch.Generator().manual_seed(0),
                           torch.from_numpy(feats), torch.from_numpy(flens))
    assert ((own == 0) | (own == torch.from_numpy(feats))).all()


def _inject(monkeypatch, module, name, params):
    """Make ``module.name(...)``'s flax module ``init`` return ``params``."""
    orig = getattr(module, name)

    class Injected:
        def __init__(self, inner):
            self.inner = inner

        def init(self, *a, **k):
            return {"params": params}

        def apply(self, *a, **k):
            return self.inner.apply(*a, **k)

    monkeypatch.setattr(module, name,
                        lambda *a, **k: Injected(orig(*a, **k)))


def _logged(text, tag):
    return [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith(tag)]


@pytest.mark.parametrize("arch", ["conv", "transformer"])
def test_train_ctc_six_step_lockstep(arch, tmp_path, monkeypatch, capsys):
    texts = char_corpus(tmp_path / "d", n_utts=12, seed=3)
    V = len(asr.build_vocab(texts.values()))
    _, params = _jax_params(arch, V, 10, seed=7)
    _inject(monkeypatch, jax_asr, "_ctc_model", params)
    rec_j = jax_asr.train_ctc(tmp_path / "d", steps=6, batch_size=8,
                              width=48, seed=0, log_every=1, arch=arch)
    want = _logged(capsys.readouterr().out, "ctc step")
    monkeypatch.undo()
    losses = []
    rec = asr.train_ctc(tmp_path / "d", steps=6, batch_size=8, width=48,
                        seed=0, log_every=0, arch=arch, device="cpu",
                        params=params, losses=losses)
    assert len(want) == len(losses) == 6
    np.testing.assert_allclose(losses, want, rtol=1e-4, atol=5e-5)
    flat_j, flat_p = {}, {}
    _flatten(_np(rec_j.params), "", flat_j)
    _flatten(rec.params, "", flat_p)
    assert set(flat_j) == set(flat_p)
    for k in flat_j:
        if _shift_invariant(k):    # Adam moves noise by up to lr a step
            assert np.abs(flat_p[k] - flat_j[k]).max() <= 2 * 1e-3 * 6
        else:
            _peak_close(flat_p[k], flat_j[k], 1e-3, k)
    assert rec.vocab == rec_j.vocab and rec.arch == arch


def _ngram_and_neural(texts):
    itos, _ = jax_nlm._build_vocab(texts)
    j = jax_nlm.CharLstmLM(itos, embed=8, hidden=16, layers=2)
    tpl = j.net.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    j.params = numpy_params(_np(tpl["params"]), 11)
    p = neural_lm.CharLstmLM(itos, embed=8, hidden=16, layers=2,
                             device="cpu")
    p.params = j.params
    return ((jax_lm.CharNgramLM(texts, 3), port_lm.CharNgramLM(texts, 3)),
            (j, p))


def test_transcripts_equal_jax(tmp_path):
    texts = char_corpus(tmp_path / "d", n_utts=10, seed=4)
    vocab = asr.build_vocab(texts.values())
    model, params = _jax_params("transformer", len(vocab), 10, seed=5)
    rec_j = jax_asr.CTCRecognizer(model, params, vocab, arch="transformer")
    rec = asr.CTCRecognizer(_port("transformer", len(vocab), 10, params),
                            None, vocab, arch="transformer")
    scp = tmp_path / "d" / "feats.scp"
    kw = dict(batch_size=4, bucket=48)
    assert rec.transcribe_scp(scp, **kw) == rec_j.transcribe_scp(scp, **kw)
    for lm_j, lm_p in _ngram_and_neural(list(texts.values())):
        beam = dict(kw, beam_size=6, lm_weight=0.6)
        assert rec.transcribe_scp(scp, lm=lm_p, **beam) \
            == rec_j.transcribe_scp(scp, lm=lm_j, **beam)


def test_beam_search_with_each_lm_equals_jax():
    texts = ["abc", "bca", "cab", "aabbc", "abcabc", "ccab"]
    rng = np.random.default_rng(8)
    id2char = {1: "a", 2: "b", 3: "c"}
    for lm_j, lm_p in _ngram_and_neural(texts):
        for seed in range(4):
            x = rng.normal(size=(30, 4)) * 2.0
            lp = x - np.log(np.exp(x).sum(axis=1, keepdims=True))
            kw = dict(beam_size=10, lm_weight=0.6, id2char=id2char)
            assert asr.ctc_prefix_beam_search(lp, lm=lm_p, **kw) \
                == jax_asr.ctc_prefix_beam_search(lp, lm=lm_j, **kw)


@pytest.mark.parametrize("arch", ["conv", "transformer"])
def test_recognizer_checkpoints_move_both_ways(arch, tmp_path):
    vocab = {c: i + 1 for i, c in enumerate("abc ")}
    model, params = _jax_params(arch, len(vocab), 10, width=32, seed=9)
    jax_asr.CTCRecognizer(model, params, vocab, arch=arch).save(
        tmp_path / "j.msgpack")
    rec = asr.CTCRecognizer.load(tmp_path / "j.msgpack", device="cpu")
    assert (rec.arch, rec.vocab) == (arch, vocab)
    rec.save(tmp_path / "p.msgpack")
    assert (tmp_path / "p.msgpack").read_bytes() \
        == (tmp_path / "j.msgpack").read_bytes()
    back = jax_asr.CTCRecognizer.load(tmp_path / "p.msgpack")
    flat_j, flat_b = {}, {}
    _flatten(params, "", flat_j)
    _flatten(_np(back.params), "", flat_b)
    assert set(flat_j) == set(flat_b)
    for k in flat_j:
        np.testing.assert_array_equal(flat_b[k], flat_j[k])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        asr.CTCRecognizer.load(tmp_path / "j.msgpack")


def test_lm_checkpoints_move_both_ways(tmp_path):
    (_, _), (lm_j, lm_p) = _ngram_and_neural(["abc", "cab ba"])
    lm_j.save(tmp_path / "j.msgpack")
    lm_p.save(tmp_path / "p.msgpack")
    assert (tmp_path / "p.msgpack").read_bytes() \
        == (tmp_path / "j.msgpack").read_bytes()
    a = neural_lm.CharLstmLM.load(tmp_path / "j.msgpack", device="cpu")
    b = jax_nlm.CharLstmLM.load(tmp_path / "p.msgpack")
    for ctx in ("", "ab", "cab b"):
        for c in "abc ":
            assert abs(a.logp(ctx, c) - b.logp(ctx, c)) <= 1e-5
        assert abs(a.logp_eos(ctx) - b.logp_eos(ctx)) <= 1e-5


def test_eval_asr_cli_prints_jax_last_line(tmp_path, monkeypatch, capsys):
    """The JAX CLI trains and saves the recognizer and the neural LM; the
    port's CLI loads both and prints the same CER/WER line."""
    from vae_npvc_tpu.bin import eval_asr as jax_cli
    from vae_npvc_tpu_torch.bin import eval_asr

    char_corpus(tmp_path / "d", n_utts=16, seed=6)
    d = tmp_path / "d"
    args = ["--train_dir", str(d), "--eval_scp", str(d / "feats.scp"),
            "--ref_text", str(d / "text"),
            "--recognizer_ckpt", str(tmp_path / "ctc.msgpack"),
            "--steps", "25", "--width", "32", "--lm_type", "neural",
            "--lm_ckpt", str(tmp_path / "lm.msgpack"), "--lm_steps", "10",
            "--beam_size", "4"]
    monkeypatch.setattr(sys, "argv", ["eval_asr", "--output_dir",
                                      str(tmp_path / "j")] + args)
    jax_cli.main()
    want = capsys.readouterr().out.splitlines()[-1]
    eval_asr.main(["--output_dir", str(tmp_path / "p"), "--device", "cpu"]
                  + args)
    out = capsys.readouterr().out
    assert "loaded recognizer" in out and "loaded neural char LM" in out
    assert out.splitlines()[-1] == want and want.startswith("CER: ")
    for f in ("hyp.text", "result.txt", "result.wrd.txt"):
        assert (tmp_path / "p" / f).read_text() \
            == (tmp_path / "j" / f).read_text()
