"""The port's Tacotron2 token->mel family (``block_type: tacotron2``)
against the JAX package on the CPU, and the committed JAX fixture for GPU
hosts.

At test width (fp32): the teacher-forced loss, every ``detail`` key and
every parameter gradient against ``jax.grad`` of the flax model from
bridged weights, with int speaker ids and float speaker embeddings;
free-running ``infer`` (mel and ``mel_lens``) with r = 2 and r = 1 at a
``max_frames`` that is not a multiple of r; padded == unpadded; the
``tac2`` tree both ways byte for byte; the dropout and zoneout masks of
JAX's own draws (recorded with ``jax.debug.callback`` from a test-local
wrapper of ``jax.random.bernoulli``) handed to the port; the two
``Trainer``s in lockstep with checkpoints both ways; ``bin/train_tts`` and
``bin/decode_tts`` against JAX's ``infer``. Tolerances: loss and detail
1e-5 relative, gradients 1e-4 of each leaf's peak, mel 1e-5 absolute,
``mel_lens`` exact, per-step losses 1e-5 relative, parameters and Adam
moments 2e-5 + 1e-3*|x|.

``tests/torch_port_fixtures/tac2_golden*`` holds a synthesizer at the
widths of ``egs/aishell3/vc2/conf/train_token_tts_tacotron2_smoke.yaml``
(dropout and zoneout at 0, so a training step draws nothing) made by the
JAX package: the initial checkpoint, three training batches with JAX's
per-step detail, the final checkpoint, and a free-running ``infer`` with
its stop logits. The stop decision of every row lies at least
``STOP_MARGIN`` from 0 in logit (checked here at regeneration), so no
rounding difference moves ``mel_lens``. Regenerate with

    python -m tests.test_torch_port_tac2

(from the repo root, with JAX on the CPU at full matmul precision, as
``tests/conftest.py`` sets it).
"""

import json
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
FIXTURES = Path(__file__).resolve().parent / "torch_port_fixtures"
L, T, MEL, B = 10, 21, 6, 3
STEPS = 3
DETAIL_KEYS = ("Total", "X like", "X pre like", "STOP loss", "grad_norm",
               "skipped_nonfinite")
STOP_MARGIN = 0.1

TAC2_CONFIG = {
    "model_type": "vae_npvc.model.token_tts",
    "trainer_type": "vae_npvc.trainer.basic", "seed": 5,
    "token_num": 16, "y_num": 4, "mel_dim": MEL, "block_type": "tacotron2",
    "embed-dim": 16, "elayers": 1, "eunits": 16, "econv-layers": 2,
    "econv-chans": 16, "econv-filts": 5, "dlayers": 2, "dunits": 24,
    "prenet-layers": 2, "prenet-units": 8, "postnet-layers": 2,
    "postnet-chans": 8, "postnet-filts": 5, "atype": "location", "adim": 8,
    "aconv-chans": 4, "aconv-filts": 3, "cumulate-att-w": True,
    "use-concate": True, "bce-pos-weight": 3.0, "reduction-factor": 2,
    "dropout-rate": 0.0, "zoneout-rate": 0.0, "max_tokens": L,
    "max_frames": T, "batch_size": B, "optim_type": "Adam",
    "learning_rate": 1e-3, "max_grad_norm": 1.0, "lr_scheduler": "StepLR",
    "lr_param": {"step_size": 2, "gamma": 0.5},
}

# train_token_tts_tacotron2_smoke.yaml's model, rates at 0
GOLDEN_L, GOLDEN_T = 16, 32
TAC2_GOLDEN_CONFIG = {
    "model_type": "vae_npvc.model.token_tts",
    "trainer_type": "vae_npvc.trainer.basic", "seed": 7,
    "token_num": 64, "y_num": 16, "mel_dim": 40, "block_type": "tacotron2",
    "embed-dim": 64, "elayers": 1, "eunits": 64, "econv-layers": 2,
    "econv-chans": 64, "econv-filts": 5, "dlayers": 2, "dunits": 96,
    "prenet-layers": 2, "prenet-units": 32, "postnet-layers": 2,
    "postnet-chans": 32, "postnet-filts": 5, "atype": "location",
    "adim": 32, "aconv-chans": 8, "aconv-filts": 7, "cumulate-att-w": True,
    "use-concate": True, "bce-pos-weight": 3.0, "reduction-factor": 2,
    "dropout-rate": 0.0, "zoneout-rate": 0.0, "max_tokens": GOLDEN_L,
    "max_frames": GOLDEN_T, "use_spk_embed": True, "spk_embed_dim": 32,
    "batch_size": B, "optim_type": "Adam", "learning_rate": 5e-4,
    "max_grad_norm": 10, "lr_scheduler": "StepLR",
    "lr_param": {"step_size": 2, "gamma": 0.5},
}


def _config(spk="ids", **kw):
    cfg = dict(TAC2_CONFIG, **kw)
    if spk == "emb":
        cfg.update(use_spk_embed=True, spk_embed_dim=6)
    return cfg


def _batch(seed, cfg=TAC2_CONFIG, Bn=B):
    """(tokens, durations, mels, spks, tok_lens, mel_lens) padded to the
    config's (max_tokens, max_frames), as ``TokenMelDataset`` yields
    them; the durations are unused by this family."""
    Ln, Tn, D = cfg["max_tokens"], cfg["max_frames"], cfg["mel_dim"]
    rng = np.random.default_rng(seed)
    tok_lens = rng.integers(3, Ln + 1, size=Bn).astype(np.int32)
    tok_lens[0] = Ln
    mel_lens = rng.integers(4, Tn + 1, size=Bn).astype(np.int32)
    mel_lens[0] = Tn
    tokens = np.zeros((Bn, Ln), np.int32)
    mels = np.zeros((Bn, Tn, D), np.float32)
    for b in range(Bn):
        tokens[b, :tok_lens[b]] = rng.integers(0, cfg["token_num"],
                                               size=tok_lens[b])
        mels[b, :mel_lens[b]] = rng.normal(size=(mel_lens[b], D))
    if cfg.get("use_spk_embed"):
        spks = rng.normal(size=(Bn, cfg["spk_embed_dim"])).astype(np.float32)
    else:
        spks = rng.integers(0, cfg["y_num"], size=Bn).astype(np.int32)
    return tokens, np.ones((Bn, Ln), np.int32), mels, spks, tok_lens, \
        mel_lens


def _jax_model_and_params(cfg, batch, seed=0):
    """The flax model and a parameter tree (numpy) moved off its init:
    every bias away from 0."""
    import jax
    import jax.numpy as jnp

    from vae_npvc_tpu.models import build_model as jax_build_model

    jm = jax_build_model(cfg)
    v = jax.jit(lambda key, *a: jm.init({"params": key}, *a, train=False))(
        jax.random.PRNGKey(seed), *map(jnp.asarray, batch))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape))
        .astype(np.float32), v["params"])
    return jm, params


def _port_model(cfg, params):
    from vae_npvc_tpu_torch.models import build_model
    from vae_npvc_tpu_torch.utils.bridge import from_jax_variables

    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(from_jax_variables({"params": params}), strict=True)
    return pm


def _tensors(batch):
    return tuple(torch.as_tensor(a) for a in batch)


def _leaf_close(got, want, frac=1e-4, what=""):
    """Every leaf within ``frac`` of its own peak."""
    import jax

    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(np.asarray(g) - w).max())
        assert err <= frac * scale, (what, jax.tree_util.keystr(path), err,
                                     scale)


def _port_grads(pm):
    from vae_npvc_tpu_torch.utils.bridge import to_jax_variables

    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
          for k, p in pm.named_parameters()}
    sd.update((k, v) for k, v in pm.state_dict().items() if k not in sd)
    return to_jax_variables(sd)["params"]


@pytest.fixture(scope="module")
def models():
    """Per speaker mode: (cfg, batch, flax model, params, port model)."""
    out = {}
    for spk in ("ids", "emb"):
        cfg = _config(spk)
        batch = _batch(11, cfg)
        jm, params = _jax_model_and_params(cfg, batch)
        out[spk] = cfg, batch, jm, params, _port_model(cfg, params)
    return out


@pytest.mark.parametrize("spk", ["ids", "emb"])
def test_loss_detail_and_every_gradient_match_jax(models, spk):
    import jax
    import jax.numpy as jnp

    cfg, batch, jm, params, pm = models[spk]

    def loss_fn(p):
        _, loss, detail = jm.apply({"params": p}, *map(jnp.asarray, batch),
                                   train=True)
        return loss, detail

    (jl, jd), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    pm.zero_grad()
    _, pl, pd = pm(*_tensors(batch), True)
    assert set(pd) == set(jd) == {"X like", "X pre like", "STOP loss",
                                  "Total"}
    for k in jd:
        np.testing.assert_allclose(float(pd[k]), float(jd[k]), rtol=1e-5,
                                   err_msg=k)
    pl.backward()
    got = _port_grads(pm)
    want = jax.tree_util.tree_map(np.asarray, jg)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    _leaf_close(got, want, 1e-4, "grad")


@pytest.mark.parametrize("r", [2, 1])
def test_free_run_infer_matches_jax(models, r):
    import jax.numpy as jnp

    cfg = _config(**{"reduction-factor": r})
    batch = _batch(3, cfg)
    if r == 2:
        jm, params, pm = models["ids"][2:]
    else:
        jm, params = _jax_model_and_params(cfg, batch, seed=2)
        pm = _port_model(cfg, params)
    tokens, _, _, spks, tok_lens, _ = batch
    for frames in (T, 9):                     # odd: not a multiple of r
        jmel, jlens = jm.apply({"params": params}, jnp.asarray(tokens),
                               jnp.asarray(spks), jnp.asarray(tok_lens),
                               max_frames=frames, method="infer")
        with torch.no_grad():
            pmel, plens = pm.infer(*_tensors((tokens, spks, tok_lens)),
                                   max_frames=frames)
        np.testing.assert_array_equal(plens.numpy(), np.asarray(jlens))
        assert pmel.shape == (B, frames, MEL)
        np.testing.assert_allclose(pmel.numpy(), np.asarray(jmel), atol=1e-5)
        for b in range(B):
            assert not pmel[b, int(plens[b]):].any()


def test_padded_equals_unpadded(models):
    """Masked attention keys, the index-flipped BiLSTM and the masked
    postnet: each padded row's loss terms and outputs equal the row run
    alone at its own lengths (the extra decoder steps are causal)."""
    batch = _batch(7)
    pm = models["ids"][4]
    tokens, _, mels, spks, tok_lens, mel_lens = _tensors(batch)
    with torch.no_grad():
        mel, mel_pre, stop = pm.tac2(tokens, spks, tok_lens, mels=mels,
                                     mel_lens=mel_lens, train=False)
        for b in range(B):
            n, m = int(tok_lens[b]), int(mel_lens[b])
            alone = pm.tac2(tokens[b:b + 1, :n], spks[b:b + 1],
                            tok_lens[b:b + 1], mels=mels[b:b + 1, :m],
                            mel_lens=mel_lens[b:b + 1], train=False)
            for got, want in zip(alone, (mel, mel_pre, stop)):
                np.testing.assert_allclose(got[0].numpy(),
                                           want[b, :m].numpy(), atol=2e-6)
            assert not mel[b, m:].any()


def test_tac2_tree_crosses_byte_for_byte(models):
    """params -> port state_dict -> params is the identity, and the port's
    msgpack of the tree is flax's, byte for byte; the BiLSTM cells are
    directions, not layers."""
    from flax import serialization

    from vae_npvc_tpu_torch.utils import msgpack_io
    from vae_npvc_tpu_torch.utils.bridge import to_jax_variables

    for spk in ("ids", "emb"):
        cfg, _, _, params, pm = models[spk]
        back = to_jax_variables(pm.state_dict())
        assert back["ema"] == {}
        assert msgpack_io.msgpack_serialize({"params": back["params"]}) == \
            serialization.msgpack_serialize({"params": params})
    sd = models["ids"][4].state_dict()
    tac2 = models["ids"][3]["tac2"]
    np.testing.assert_array_equal(
        sd["tac2.OptimizedLSTMCell_1.weight_hh_l0"].numpy()[8:16].T,
        tac2["OptimizedLSTMCell_1"]["hf"]["kernel"])
    np.testing.assert_array_equal(
        sd["tac2.dec_cell.lstm_1.bias_hh_l0"].numpy()[72:],
        tac2["dec_cell"]["lstm_1"]["ho"]["bias"])
    net = models["ids"][4].tac2
    assert not net.OptimizedLSTMCell_0.bias_ih_l0.any()
    assert not net.dec_cell.lstm_0.bias_ih_l0.any()
    assert not any("bias_ih" in k for k in sd)
    assert not any("bias_ih" in k for k, _ in
                   models["ids"][4].named_parameters())
    assert "tok_embed.embedding" not in sd          # the NAR layers: none


def test_rates_on_with_jax_masks(models, monkeypatch):
    """Dropout 0.5 and zoneout 0.1 in training: JAX's own Bernoulli masks
    (the encoder convs', the prenet's and the zoneout's, in draw order),
    recorded from its forward, replayed by the port; the loss and every
    gradient then match. In ``infer`` a generator turns the prenet's
    dropout on and nothing else, as JAX's key does."""
    import jax
    import jax.numpy as jnp

    from vae_npvc_tpu.models import build_model as jax_build_model
    from vae_npvc_tpu_torch.models import token_tts

    cfg = _config(**{"dropout-rate": 0.5, "zoneout-rate": 0.1})
    batch = _batch(13, cfg)
    params = models["ids"][3]                 # the rates make no parameter
    jm = jax_build_model(cfg)
    pm = _port_model(cfg, params)
    key = jax.random.PRNGKey(42)
    recorded = []
    orig = jax.random.bernoulli

    def recording(k, p=0.5, shape=None, **kw):
        m = orig(k, p, shape, **kw)
        jax.debug.callback(lambda v: recorded.append(np.asarray(v)), m,
                           ordered=True)
        return m

    def loss_fn(p):
        _, loss, detail = jm.apply({"params": p}, *map(jnp.asarray, batch),
                                   train=True, rngs={"vq": key})
        return loss, detail

    monkeypatch.setattr(jax.random, "bernoulli", recording)
    loss_fn(params)[0].block_until_ready()
    jax.effects_barrier()
    monkeypatch.setattr(jax.random, "bernoulli", orig)
    Tr = (T + 1) // 2
    assert len(recorded) == 2 + Tr * (2 + 2 * 2)
    (jl, jd), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)

    masks = deque(recorded)

    def replay(gen, p, shape, device):
        m = masks.popleft()
        assert m.shape == tuple(shape)
        return torch.from_numpy(m)

    monkeypatch.setattr(token_tts, "bernoulli", replay)
    gen = torch.Generator().manual_seed(0)
    _, pl, pd = pm(*_tensors(batch), True, gen=gen)
    assert not masks
    for k in jd:
        np.testing.assert_allclose(float(pd[k]), float(jd[k]), rtol=1e-5,
                                   err_msg=k)
    pl.backward()
    _leaf_close(_port_grads(pm), jax.tree_util.tree_map(np.asarray, jg),
                1e-4, "grad")
    # valid (no generator): nothing is drawn
    monkeypatch.setattr(token_tts, "bernoulli", None)
    with torch.no_grad():
        pm(*_tensors(batch), False)
    # infer with a generator: the prenet's two masks per step only
    calls = []

    def counting(gen, p, shape, device):
        calls.append(p)
        return torch.ones(shape, dtype=torch.bool)

    monkeypatch.setattr(token_tts, "bernoulli", counting)
    tokens, _, _, spks, tok_lens, _ = _tensors(batch)
    with torch.no_grad():
        pm.tac2(tokens, spks, tok_lens, max_frames=T, train=False,
                free_run=True, gen=gen)
    assert calls == [0.5] * (2 * Tr)


def test_chip_smoke_configs_match_recipe_yamls():
    """The smoke's ``TAC2``, ``GAN`` and ``VAE`` (the GPU host has no
    YAML parser) are the recipes' files."""
    import yaml

    import chip_smoke

    root = Path(__file__).resolve().parent.parent / "egs"
    for got, path in (
            (chip_smoke.TAC2,
             "aishell3/vc2/conf/train_token_tts_tacotron2.yaml"),
            (chip_smoke.GAN, "vcc20/vae1/conf/train_vqvae_gan.yaml"),
            (chip_smoke.VAE, "vcc20/vae1/conf/train_vae.yaml")):
        with open(root / path) as f:
            assert got == yaml.safe_load(f), path


# ------------------------------------------------------------------ trainer
def make_jax_trainer(cfg=TAC2_CONFIG, seed=11, steps=STEPS):
    """The JAX ``Trainer`` at step 0 with perturbed parameters, and the
    batches."""
    import jax
    from jax.sharding import Mesh

    from vae_npvc_tpu.train.trainer import Trainer

    batches = [_batch(seed + i, cfg) for i in range(steps)]
    tr = Trainer(cfg, mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))
    tr.init_state(batches[0])
    _, params = _jax_model_and_params(cfg, batches[0], seed=seed)
    tr.state = tr.state.replace(params=jax.tree_util.tree_map(
        jax.numpy.asarray, params))
    return tr, batches


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_state_close(got_ckpt, want_ckpt, atol=2e-5, rtol=1e-3):
    from vae_npvc_tpu_torch.utils import msgpack_io

    a = _leaves(msgpack_io.msgpack_restore(got_ckpt))
    b = _leaves(msgpack_io.msgpack_restore(want_ckpt))
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def _assert_detail(pd, jd, keys=DETAIL_KEYS, rtol=1e-5):
    for k in keys:
        np.testing.assert_allclose(float(pd[k]), float(jd[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)


def test_trainers_in_lockstep_and_checkpoints_cross(tmp_path):
    """From one JAX checkpoint: three steps of both ``Trainer``s (the JAX
    trainer passes its key, the port its generator; the rates are 0, so
    neither draws), the final states, the port's checkpoint loaded by JAX
    and the next step taken together, and an unchanged state saved by the
    port with JAX's bytes."""
    from vae_npvc_tpu_torch.train import build_trainer

    jtr, batches = make_jax_trainer()
    jtr.save_checkpoint(tmp_path / "first")
    ptr = build_trainer(TAC2_CONFIG, device="cpu")
    assert ptr.load_checkpoint(tmp_path / "first") == 0
    ptr.save_checkpoint(tmp_path / "port0")
    assert (tmp_path / "port0").read_bytes() == \
        (tmp_path / "first").read_bytes()
    for b in batches:
        _assert_detail(ptr.train_step(b), jtr.train_step(b))
    jtr.save_checkpoint(tmp_path / "jax3")
    ptr.save_checkpoint(tmp_path / "port3")
    assert_state_close((tmp_path / "port3").read_bytes(),
                       (tmp_path / "jax3").read_bytes())
    assert jtr.load_checkpoint(tmp_path / "port3") == STEPS
    extra = _batch(99)
    _assert_detail(ptr.train_step(extra), jtr.train_step(extra))


def test_train_tts_and_decode_tts_clis(tmp_path):
    """``bin/train_tts`` trains the family from a token-mel dir (the
    durations read and unused), ``bin/decode_tts`` writes what JAX's
    ``infer`` gives on the same checkpoint."""
    import jax.numpy as jnp

    from vae_npvc_tpu.models import build_model as jax_build_model
    from vae_npvc_tpu_torch.bin import decode_tts, train_tts
    from vae_npvc_tpu_torch.data import kaldi_io, token_mel
    from vae_npvc_tpu_torch.infer.convert import read_checkpoint

    rng = np.random.default_rng(0)
    items = []
    for i in range(7):
        k = int(rng.integers(3, L + 1))
        durs = rng.integers(1, 3, size=k)
        items.append((f"utt{i}", rng.integers(0, 16, size=k), durs,
                      rng.normal(size=(int(durs.sum()), MEL))
                      .astype(np.float32), i % 4))
    token_mel.write_token_mel_dir(tmp_path / "train", items)
    cfg = dict(TAC2_CONFIG, max_iter=2, iters_per_log=1,
               iters_per_checkpoint=2)
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps(cfg))
    train_tts.main(["-c", str(conf), "--train_dir", str(tmp_path / "train"),
                    "--output_dir", str(tmp_path / "exp"), "--device",
                    "cpu"])
    ckpt = tmp_path / "exp" / "model.loss.best"
    (tmp_path / "text").write_text("a <1><5><3><3>\nb <2><7>\n")
    decode_tts.main(["-c", str(conf), "--checkpoint", str(ckpt), "--tokens",
                     str(tmp_path / "text"), "--spk", "2", "--output-dir",
                     str(tmp_path / "dec"), "--device", "cpu"])
    got = {u: kaldi_io.load_mat(rx) for u, rx in
           kaldi_io.load_dict_data(tmp_path / "dec" / "feats.scp").items()}
    _, variables = read_checkpoint(ckpt)
    jm = jax_build_model(cfg)
    for utt, toks in (("a", [1, 5, 3, 3]), ("b", [2, 7])):
        pad = np.zeros((1, L), np.int32)
        pad[0, :len(toks)] = toks
        mel, lens = jm.apply({"params": variables["params"]},
                             jnp.asarray(pad), jnp.asarray([2], jnp.int32),
                             jnp.asarray([len(toks)], jnp.int32),
                             method="infer")
        want = np.asarray(mel)[0, :int(lens[0])]
        assert got[utt].shape == want.shape
        np.testing.assert_allclose(got[utt], want, atol=1e-5)


# ------------------------------------------------------------------ fixture
def _stop_margin(logits, lens):
    """The smallest |logit| over each row's frames up to its stop decision
    (every frame when no row stops)."""
    return min(float(np.abs(lg[:n]).min()) for lg, n in zip(logits, lens))


def _golden_start():
    """The fixture's flax model, initial parameters and batches. The stop
    head is made steeper with chosen biases: one row of the first batch
    stops at frame 3, one at frame 6, one never, every logit up to its
    decision at least ``STOP_MARGIN`` from 0."""
    cfg = TAC2_GOLDEN_CONFIG
    batches = [_batch(70 + i, cfg) for i in range(STEPS)]
    jm, params = _jax_model_and_params(cfg, batches[0], seed=70)
    head = params["tac2"]["dec_cell"]["prob_out"]
    head["kernel"] = (12.0 * head["kernel"]).astype(np.float32)
    head["bias"] = np.array([-2.5, 0.5], np.float32)
    return jm, params, batches


def _golden_infer(jm, params, batch):
    import jax.numpy as jnp

    tokens, _, _, spks, tok_lens, _ = batch
    args = (jnp.asarray(tokens), jnp.asarray(spks), jnp.asarray(tok_lens))
    mel, lens = jm.apply({"params": params}, *args, method="infer")
    _, _, logits = jm.apply(
        {"params": params}, *args, max_frames=GOLDEN_T, train=False,
        free_run=True, method=lambda m, *a, **k: m.tac2(*a, **k))
    arrays = {"infer/mel": np.asarray(mel), "infer/mel_lens":
              np.asarray(lens), "infer/stop_logits": np.asarray(logits)}
    return arrays


def make_tac2_golden(tmp):
    """Run the fixture with JAX's ``Trainer``: (initial ckpt bytes, final
    ckpt bytes, arrays dict)."""
    import jax
    from jax.sharding import Mesh

    from vae_npvc_tpu.train.trainer import Trainer

    jm, params, batches = _golden_start()
    tr = Trainer(TAC2_GOLDEN_CONFIG,
                 mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))
    tr.init_state(batches[0])
    tr.state = tr.state.replace(params=jax.tree_util.tree_map(
        jax.numpy.asarray, params))
    first = Path(tmp) / "first"
    tr.save_checkpoint(first)
    arrays = _golden_infer(jm, params, batches[0])
    details = [tr.train_step(b) for b in batches]
    for i, b in enumerate(batches):
        for name, a in zip(("tokens", "durations", "mels", "spks",
                            "tok_lens", "mel_lens"), b):
            arrays[f"{name}_{i}"] = a
    for k in DETAIL_KEYS:
        arrays["detail/" + k] = np.asarray([float(d[k]) for d in details],
                                           np.float64)
    final = Path(tmp) / "final"
    tr.save_checkpoint(final)
    return first.read_bytes(), final.read_bytes(), arrays


def _without_optimizer(ckpt):
    """The checkpoint with an empty optimizer entry (a trainer loading it
    starts the moments at zero, as JAX's fresh state holds them)."""
    from vae_npvc_tpu_torch.utils import msgpack_io

    payload = msgpack_io.msgpack_restore(ckpt)
    payload["optimizer"] = {}
    return msgpack_io.msgpack_serialize(payload)


def write_tac2_golden(out_dir=FIXTURES):
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        first, final, arrays = make_tac2_golden(tmp)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "tac2_golden.msgpack").write_bytes(_without_optimizer(first))
    (out_dir / "tac2_golden_final.msgpack").write_bytes(final)
    np.savez_compressed(out_dir / "tac2_golden.npz", **arrays)
    (out_dir / "tac2_golden_config.json").write_text(
        json.dumps(TAC2_GOLDEN_CONFIG, indent=1) + "\n")


def load_fixture(fixtures=FIXTURES):
    """(config, batches, arrays) of the committed fixture."""
    cfg = json.loads((fixtures / "tac2_golden_config.json").read_text())
    g = np.load(fixtures / "tac2_golden.npz")
    batches = [tuple(g[f"{name}_{i}"] for name in (
        "tokens", "durations", "mels", "spks", "tok_lens", "mel_lens"))
        for i in range(STEPS)]
    return cfg, batches, g


def test_committed_tac2_fixture_matches_jax():
    """Regenerating the start with JAX reproduces the committed fixture's
    initial parameters, batches and ``infer``; the stop decisions lie
    clear of 0, and some rows stop and one does not. (JAX's training steps
    are held by the port's in ``test_port_tracks_tac2_fixture_on_cpu`` and
    by the lockstep above.)"""
    from vae_npvc_tpu_torch.utils import msgpack_io

    jm, params, batches = _golden_start()
    cfg, committed_batches, g = load_fixture()
    assert cfg == TAC2_GOLDEN_CONFIG
    for got, want in zip(batches, committed_batches):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    first = msgpack_io.msgpack_restore(
        (FIXTURES / "tac2_golden.msgpack").read_bytes())
    assert first["iteration"] == 0 and first["optimizer"] == {}
    want = _leaves(first["model"])
    got = _leaves(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-5,
                                   err_msg=k)
    for k, v in _golden_infer(jm, params, batches[0]).items():
        np.testing.assert_allclose(v, g[k], rtol=1e-5, atol=1e-6, err_msg=k)
    lens = g["infer/mel_lens"]
    assert _stop_margin(g["infer/stop_logits"], lens) >= STOP_MARGIN
    assert lens.min() < GOLDEN_T == lens.max()
    assert np.all(g["detail/skipped_nonfinite"] == 0)
    assert np.all(g["detail/grad_norm"] > cfg["max_grad_norm"])


def test_port_tracks_tac2_fixture_on_cpu(tmp_path):
    """The port's ``infer`` and ``Trainer`` on the CPU against the
    committed fixture, as the GPU smoke holds them."""
    from vae_npvc_tpu_torch.train import build_trainer

    cfg, batches, g = load_fixture()
    tr = build_trainer(cfg, device="cpu")
    assert tr.load_checkpoint(FIXTURES / "tac2_golden.msgpack") == 0
    tokens, _, _, spks, tok_lens, _ = _tensors(batches[0])
    with torch.no_grad():
        mel, lens = tr.model.infer(tokens, spks, tok_lens)
    np.testing.assert_array_equal(lens.numpy(), g["infer/mel_lens"])
    np.testing.assert_allclose(mel.numpy(), g["infer/mel"], atol=1e-5)
    for i, b in enumerate(batches):
        _assert_detail(tr.train_step(b),
                       {k: g["detail/" + k][i] for k in DETAIL_KEYS})
    tr.save_checkpoint(tmp_path / "final")
    assert_state_close((tmp_path / "final").read_bytes(),
                       (FIXTURES / "tac2_golden_final.msgpack").read_bytes())


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    write_tac2_golden()
