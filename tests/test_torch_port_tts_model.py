"""The port's token->mel synthesizer and its training against the JAX
package on the CPU, and the committed JAX fixture for GPU hosts.

``Model`` (``block_type: transformer`` and ``conv``; int speaker ids and
float speaker embeddings): training loss, every ``detail`` key and every
parameter gradient against ``jax.grad`` of the flax model from bridged
weights; ``infer`` (integer durations first, then mel and ``mel_lens``);
padded == unpadded. Then the two ``Trainer``s in lockstep over six steps
from one checkpoint, ``grad_accum``, and the checkpoint both ways. The JAX
side runs its attention kernel in interpret mode (``fused_attention:
interpret``); the port takes the plain version on the CPU. fp32.
Tolerances: loss and detail 1e-5 relative, gradients 1e-4 of the largest
gradient, mel 1e-4, per-step losses and ``grad_norm`` 1e-4 relative, final
parameters and Adam moments 2e-5 + 1e-3*|x|.

``tests/torch_port_fixtures/tts_golden*`` holds a tiny transformer
synthesizer made by the JAX package: the initial checkpoint (without
optimizer state), inputs and ``infer`` output, six training batches with
JAX's per-step detail, and the final checkpoint. A host with the port but
without JAX (``chip_smoke.py`` on a GPU machine) holds the port against
it. Regenerate with

    python -m tests.test_torch_port_tts_model

(from the repo root, with JAX on the CPU at full matmul precision, as
``tests/conftest.py`` sets it).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
FIXTURES = Path(__file__).resolve().parent / "torch_port_fixtures"
STEPS = 6
L, T, MEL = 12, 48, 10
DETAIL_KEYS = ("Total", "X like", "X pre like", "DUR loss", "PITCH loss",
               "ENERGY loss", "grad_norm", "skipped_nonfinite")

TTS_GOLDEN_CONFIG = {
    "model_type": "vae_npvc.model.token_tts",
    "trainer_type": "vae_npvc.trainer.basic",
    "compute_dtype": "float32", "seed": 11,
    "token_num": 16, "token_dim": 16, "y_num": 4, "y_dim": 8,
    "mel_dim": MEL, "block_type": "transformer", "adim": 16, "aheads": 2,
    "elayers": 2, "dlayers": 2, "eunits": 32, "dunits": 32,
    "fused_attention": "interpret",
    "dur_weight": 0.1, "var_weight": 0.1, "postnet_layers": 3,
    "variance_predictor": True, "max_tokens": L, "max_frames": T,
    "batch_size": 4, "optim_type": "Adam", "learning_rate": 1e-3,
    "max_grad_norm": 2.0, "lr_scheduler": "StepLR",
    "lr_param": {"step_size": 4, "gamma": 0.5},
}


def _config(block_type="transformer", spk="ids", **kw):
    cfg = dict(TTS_GOLDEN_CONFIG, block_type=block_type, **kw)
    if block_type == "conv":
        cfg.update(hidden=16, enc_stacks=2, dec_stacks=2)
    if spk == "emb":
        cfg.update(use_spk_embed=True, spk_embed_dim=6)
    return cfg


def _batch(seed, B=4, spk="ids"):
    """(tokens, durations, mels, spks, tok_lens, mel_lens), padded to
    (L, T), as ``TokenMelDataset`` yields them."""
    rng = np.random.default_rng(seed)
    tok_lens = rng.integers(4, L + 1, size=B).astype(np.int32)
    tok_lens[0] = L
    tokens = np.zeros((B, L), np.int32)
    durs = np.zeros((B, L), np.int32)
    mels = np.zeros((B, T, MEL), np.float32)
    mel_lens = np.zeros((B,), np.int32)
    for b, n in enumerate(tok_lens):
        tokens[b, :n] = rng.integers(0, 16, size=n)
        durs[b, :n] = rng.integers(1, 5, size=n)
        while durs[b].sum() > T:
            durs[b, np.argmax(durs[b])] -= 1
        mel_lens[b] = durs[b].sum()
        mels[b, :mel_lens[b]] = rng.normal(size=(mel_lens[b], MEL))
    spks = (rng.normal(size=(B, 6)).astype(np.float32) if spk == "emb"
            else rng.integers(0, 4, size=B).astype(np.int32))
    return tokens, durs, mels, spks, tok_lens, mel_lens


def _jax_model_and_params(cfg, batch, seed=0):
    """The flax model and a parameter tree (numpy) moved off its init:
    biases away from 0, LayerNorm scales away from 1, and a duration head
    that predicts a spread of durations."""
    import jax
    import jax.numpy as jnp

    from vae_npvc_tpu.models import build_model as jax_build_model

    jm = jax_build_model(cfg)
    v = jm.init({"params": jax.random.PRNGKey(seed)},
                *map(jnp.asarray, batch), train=True)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape))
        .astype(np.float32), v["params"])
    params["dur_1"]["b"] = np.array([0.9], np.float32)
    params["dur_1"]["g"] = np.array([1.5], np.float32)
    return jm, params


def _port_model(cfg, params):
    from vae_npvc_tpu_torch.models import build_model
    from vae_npvc_tpu_torch.utils.bridge import from_jax_variables

    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(from_jax_variables({"params": params}), strict=True)
    return pm


def _tensors(batch):
    return tuple(torch.from_numpy(np.array(a)) for a in batch)


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("block_type,spk", [
    ("transformer", "ids"), ("transformer", "emb"), ("conv", "ids"),
    ("conv", "emb")])
def test_model_loss_detail_and_gradients_match_jax(block_type, spk):
    import jax
    import jax.numpy as jnp

    from vae_npvc_tpu_torch.utils.bridge import _flatten

    cfg = _config(block_type, spk)
    batch = _batch(1, spk=spk)
    jm, params = _jax_model_and_params(cfg, batch)

    def loss_fn(p):
        mel, loss, detail = jm.apply({"params": p}, *map(jnp.asarray, batch),
                                     train=True)
        return loss, (mel, detail)

    (jloss, (jmel, jdetail)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    pm = _port_model(cfg, params)
    mel, loss, detail = pm(*_tensors(batch), True)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(loss, list(pm.parameters()))

    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(mel.detach().numpy(), np.asarray(jmel),
                               atol=1e-4)
    assert set(detail) == set(jdetail) == {
        "Total", "X like", "X pre like", "DUR loss", "PITCH loss",
        "ENERGY loss"}
    for k in detail:
        np.testing.assert_allclose(float(detail[k].detach()),
                                   float(jdetail[k]), rtol=1e-5, err_msg=k)
    flat = {}
    _flatten(jax.tree_util.tree_map(np.asarray, jgrads), "", flat)
    assert set(flat) == set(names)
    assert ("spk_emb_proj.kernel" in names) == (spk == "emb")
    assert ("spk_embed.embedding" in names) == (spk == "ids")
    peak = max(float(np.abs(g).max()) for g in flat.values())
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), flat[name], atol=1e-4 * peak,
                                   err_msg=name)


@pytest.mark.parametrize("block_type,spk", [("transformer", "ids"),
                                            ("conv", "emb")])
def test_model_infer_matches_jax_and_padding_does_not_matter(block_type,
                                                             spk):
    import jax.numpy as jnp

    cfg = _config(block_type, spk)
    batch = _batch(2, spk=spk)
    tokens, _, _, spks, tok_lens, _ = batch
    jm, params = _jax_model_and_params(cfg, batch)
    jmel, jlens = jm.apply({"params": params}, jnp.asarray(tokens),
                           jnp.asarray(spks), jnp.asarray(tok_lens),
                           method="infer")
    pm = _port_model(cfg, params).eval()
    tt, ts, tl = _tensors((tokens, spks, tok_lens))
    with torch.no_grad():
        # the rounded durations first: no prediction sits near a half
        out = pm._network(tt, torch.zeros_like(tt), ts, tl, T,
                          use_true_dur=False)
        raw = torch.expm1(out[2])
        valid = torch.arange(L)[None] < tl[:, None]
        assert float(((raw - torch.floor(raw) - 0.5).abs()[valid]).min()) \
            > 1e-3
        mel, lens = pm.infer(tt, ts, tl)
    assert lens.tolist() == np.asarray(jlens).tolist()
    assert len(set(lens.tolist())) > 1 and max(lens.tolist()) <= T
    assert mel.shape == (4, T, MEL) and mel.dtype == torch.float32
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), atol=1e-4)
    # padded == unpadded on the valid positions, row by row
    with torch.no_grad():
        for b in (1, 2):
            n, m = int(tok_lens[b]), int(lens[b])
            alone, alone_len = pm.infer(tt[b:b + 1, :n], ts[b:b + 1],
                                        tl[b:b + 1], max_frames=m)
            assert int(alone_len[0]) == m
            np.testing.assert_allclose(alone[0].numpy(), mel[b, :m].numpy(),
                                       atol=2e-5)
            assert not mel[b, m:].any()


def test_registry_tacotron2_and_speaker_modes():
    from vae_npvc_tpu_torch.models import (build_model, codebook_renorm_fn,
                                           get_model_cls)
    from vae_npvc_tpu_torch.models.token_tts import (Model, length_regulate,
                                                     mel_energy,
                                                     mel_pitch_proxy)

    assert get_model_cls("vae_npvc.model.token_tts") is Model
    assert get_model_cls("token_tts") is Model
    assert codebook_renorm_fn(_config()) is None
    from vae_npvc_tpu_torch.models.token_tts import Tacotron2Net

    tac = build_model(_config("tacotron2"), device="cpu")
    assert isinstance(tac.tac2, Tacotron2Net)
    assert all(k.startswith("tac2.") for k in tac.state_dict())
    with pytest.raises(ValueError, match="block_type"):
        build_model(_config("lstm"), device="cpu")
    pm = build_model(_config(), device="cpu").init_random(0)
    tokens, _, _, _, tok_lens, _ = _tensors(_batch(3))
    with pytest.raises(ValueError, match="use_spk_embed"):
        pm.infer(tokens, torch.zeros((4, 6)), tok_lens)
    pe = build_model(_config(spk="emb"), device="cpu").init_random(0)
    with pytest.raises(ValueError, match="float speaker embeddings"):
        pe.infer(tokens, torch.zeros((4,), dtype=torch.int32), tok_lens)

    import jax.numpy as jnp

    from vae_npvc_tpu.models import token_tts as jtts

    rng = np.random.default_rng(4)
    enc = rng.normal(size=(2, 5, 3)).astype(np.float32)
    durs = np.array([[2, 0, 3, 1, 0], [1, 1, 1, 1, 1]], np.int32)
    np.testing.assert_array_equal(
        length_regulate(torch.from_numpy(enc), torch.from_numpy(durs),
                        9).numpy(),
        np.asarray(jtts.length_regulate(jnp.asarray(enc), jnp.asarray(durs),
                                        9)))
    mel = rng.normal(size=(2, 7, MEL)).astype(np.float32)
    np.testing.assert_allclose(
        mel_pitch_proxy(torch.from_numpy(mel)).numpy(),
        np.asarray(jtts.mel_pitch_proxy(jnp.asarray(mel))), atol=1e-6)
    np.testing.assert_allclose(
        mel_energy(torch.from_numpy(mel)).numpy(),
        np.asarray(jtts.mel_energy(jnp.asarray(mel))), atol=1e-6)


# ------------------------------------------------------------------ trainer
def make_jax_trainer(cfg=TTS_GOLDEN_CONFIG, spk="ids"):
    """The JAX ``Trainer`` at step 0 with the perturbed parameters, and the
    six batches. The batch seeds are chosen so that no ReLU input of a
    feed-forward layer sits within rounding of zero on any step: such a gate
    opens in one framework and not in the other, and the gradients then
    differ by far more than the summation order explains."""
    import jax
    from jax.sharding import Mesh

    from vae_npvc_tpu.train.trainer import Trainer

    batches = [_batch(4242 + i, spk=spk) for i in range(STEPS)]
    tr = Trainer(cfg, mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))
    tr.init_state(batches[0])
    _, params = _jax_model_and_params(cfg, batches[0], seed=5)
    tr.state = tr.state.replace(params=jax.tree_util.tree_map(
        jax.numpy.asarray, params))
    return tr, batches


def _checkpoint_bytes(tr, tmp, name="state.ckpt"):
    path = Path(tmp) / name
    tr.save_checkpoint(path)
    return path.read_bytes()


def _without_optimizer(ckpt):
    from vae_npvc_tpu_torch.utils import msgpack_io

    payload = msgpack_io.msgpack_restore(ckpt)
    payload["optimizer"] = {}
    return msgpack_io.msgpack_serialize(payload)


def make_tts_golden(tr, batches, tmp):
    """Run the fixture with JAX: (initial ckpt bytes, final ckpt bytes,
    arrays dict)."""
    import jax.numpy as jnp

    first = _checkpoint_bytes(tr, tmp)
    tokens, _, _, spks, tok_lens, _ = batches[0]
    variables = {"params": tr.state.params}
    mel, lens = tr.model.apply(variables, jnp.asarray(tokens),
                               jnp.asarray(spks), jnp.asarray(tok_lens),
                               method="infer")
    arrays = {"infer/mel": np.asarray(mel), "infer/mel_lens": np.asarray(lens)}
    details = [tr.train_step(b) for b in batches]
    for i, b in enumerate(batches):
        for name, a in zip(("tokens", "durations", "mels", "spks",
                            "tok_lens", "mel_lens"), b):
            arrays[f"{name}_{i}"] = a
    for k in DETAIL_KEYS:
        arrays["detail/" + k] = np.asarray(
            [float(d[k]) for d in details], np.float64)
    return first, _checkpoint_bytes(tr, tmp), arrays


def write_tts_golden(out_dir=FIXTURES):
    import tempfile

    tr, batches = make_jax_trainer()
    with tempfile.TemporaryDirectory() as tmp:
        first, final, arrays = make_tts_golden(tr, batches, tmp)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "tts_golden.msgpack").write_bytes(_without_optimizer(first))
    (out_dir / "tts_golden_final.msgpack").write_bytes(final)
    np.savez_compressed(out_dir / "tts_golden.npz", **arrays)
    (out_dir / "tts_golden_config.json").write_text(
        json.dumps(TTS_GOLDEN_CONFIG, indent=1) + "\n")


def load_fixture(fixtures=FIXTURES):
    """(config, batches, arrays) of the committed fixture."""
    cfg = json.loads((fixtures / "tts_golden_config.json").read_text())
    g = np.load(fixtures / "tts_golden.npz")
    batches = [tuple(g[f"{name}_{i}"] for name in (
        "tokens", "durations", "mels", "spks", "tok_lens", "mel_lens"))
        for i in range(STEPS)]
    return cfg, batches, g


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# Parameters whose gradient is zero in exact arithmetic: a shift of all keys
# by linear_k's bias does not reach the softmax, and a weight-normalized
# 1-input-channel conv does not depend on the size of ``v``. Their computed
# gradients are rounding noise, which Adam turns into steps of the size of
# the learning rate in a direction that differs between frameworks; the
# loss does not see them. They are held to that random walk's reach.
FREE_SUFFIXES = ("mha/linear_k/bias", "pitch_proj/v", "energy_proj/v")
FREE_REACH = 2 * STEPS * TTS_GOLDEN_CONFIG["learning_rate"]


def assert_state_close(got_ckpt, want_ckpt, atol=2e-5, rtol=1e-3):
    from vae_npvc_tpu_torch.utils import msgpack_io

    a = _leaves(msgpack_io.msgpack_restore(got_ckpt))
    b = _leaves(msgpack_io.msgpack_restore(want_ckpt))
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        free = k.startswith("model/") and k.endswith(FREE_SUFFIXES)
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k,
                                   atol=FREE_REACH if free else atol)


def _port_trainer(ckpt_path, cfg=TTS_GOLDEN_CONFIG, **overrides):
    from vae_npvc_tpu_torch.train import build_trainer

    tr = build_trainer(dict(cfg, **overrides), device="cpu")
    assert tr.load_checkpoint(ckpt_path) == 0
    return tr


def _assert_detail(pd, jd, keys=DETAIL_KEYS, rtol=1e-4):
    for k in keys:
        np.testing.assert_allclose(float(pd[k]), float(jd[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """(JAX trainer after the fixture's six steps, batches, initial ckpt
    path, regenerated (first, final, arrays))."""
    tmp = tmp_path_factory.mktemp("tts_golden")
    tr, batches = make_jax_trainer()
    made = make_tts_golden(tr, batches, tmp)
    first = tmp / "first.ckpt"
    first.write_bytes(made[0])
    return tr, batches, first, made


def test_committed_tts_fixture_matches_jax(jax_side):
    _, _, _, (first, final, arrays) = jax_side
    cfg, _, committed = load_fixture()
    assert cfg == TTS_GOLDEN_CONFIG
    assert set(committed.files) == set(arrays)
    for k, v in arrays.items():
        if k.startswith("detail/"):
            np.testing.assert_allclose(v, committed[k], rtol=1e-5, err_msg=k)
        elif k == "infer/mel":
            np.testing.assert_allclose(v, committed[k], atol=1e-5)
        else:
            np.testing.assert_array_equal(v, committed[k])
    assert_state_close(_without_optimizer(first),
                       (FIXTURES / "tts_golden.msgpack").read_bytes(),
                       atol=1e-6, rtol=1e-5)
    assert_state_close(final, (FIXTURES / "tts_golden_final.msgpack")
                       .read_bytes(), atol=2e-6, rtol=1e-4)
    # the clip bites on every step, nothing is skipped, the predicted
    # lengths differ between rows
    assert np.all(committed["detail/grad_norm"]
                  > TTS_GOLDEN_CONFIG["max_grad_norm"])
    assert np.all(committed["detail/skipped_nonfinite"] == 0)
    assert len(set(committed["infer/mel_lens"].tolist())) > 1
    size = sum((FIXTURES / n).stat().st_size for n in (
        "tts_golden.msgpack", "tts_golden_final.msgpack", "tts_golden.npz",
        "tts_golden_config.json"))
    assert size < 300_000


def test_port_tracks_tts_fixture_on_cpu(tmp_path):
    """What ``chip_smoke.py`` checks on the card, here on the CPU: ``infer``
    from the committed checkpoint, then six ``Trainer`` steps."""
    cfg, batches, g = load_fixture()
    tr = _port_trainer(FIXTURES / "tts_golden.msgpack", cfg)
    assert not tr.has_ema and not tr.opt_state.mu.any()
    tokens, _, _, spks, tok_lens, _ = _tensors(batches[0])
    with torch.no_grad():
        mel, lens = tr.model.infer(tokens, spks, tok_lens)
    assert lens.tolist() == g["infer/mel_lens"].tolist()
    np.testing.assert_allclose(mel.numpy(), g["infer/mel"], atol=1e-4)
    for i, batch in enumerate(batches):
        detail = tr.train_step(batch)
        assert tr.iteration == i + 1
        _assert_detail(detail, {k: g["detail/" + k][i] for k in DETAIL_KEYS})
    tr.save_checkpoint(tmp_path / "final.ckpt")
    assert_state_close((tmp_path / "final.ckpt").read_bytes(),
                       (FIXTURES / "tts_golden_final.msgpack").read_bytes())


def test_trainers_in_lockstep_and_checkpoints_cross_with_equal_bytes(
        jax_side, tmp_path):
    from vae_npvc_tpu_torch.utils import msgpack_io

    jtr, batches, first, (first_bytes, _, arrays) = jax_side
    # JAX -> port -> the same bytes (parameters, empty ema, Adam moments,
    # counts), which JAX reads back
    ptr = _port_trainer(first)
    assert _checkpoint_bytes(ptr, tmp_path, "port.ckpt") == first_bytes
    assert msgpack_io.msgpack_restore(first_bytes)["ema"] == {}
    assert jtr.load_checkpoint(tmp_path / "port.ckpt") == 0
    for i, batch in enumerate(batches):
        pd, jd = ptr.train_step(batch), jtr.train_step(batch)
        _assert_detail(pd, jd)
        _assert_detail(pd, {k: arrays["detail/" + k][i]
                            for k in DETAIL_KEYS})
    assert_state_close(_checkpoint_bytes(ptr, tmp_path, "port6.ckpt"),
                       _checkpoint_bytes(jtr, tmp_path, "jax6.ckpt"))
    # port -> JAX after training: both take the same next step
    assert jtr.load_checkpoint(tmp_path / "port6.ckpt") == STEPS
    extra = _batch(99)
    _assert_detail(ptr.train_step(extra), jtr.train_step(extra))
    # K steps in one call, and validation
    ptr2 = _port_trainer(first)
    stacked = ptr2.train_steps(batches[:3])
    np.testing.assert_allclose(stacked["Total"].numpy(),
                               arrays["detail/Total"][:3], rtol=1e-4)
    pv, jv = ptr.valid(batches[:2]), jtr.valid(batches[:2])
    assert set(pv) == set(jv) and len(pv["Total"]) == 2
    for k in pv:
        np.testing.assert_allclose(pv[k], jv[k], rtol=1e-4, err_msg=k)


def test_grad_accum_tracks_jax_and_float_speakers_train(jax_side, tmp_path):
    jtr, batches, first, _ = jax_side
    jtr.load_checkpoint(first)
    ptr = _port_trainer(first, grad_accum=2)
    jtr.grad_accum = 2
    try:
        for batch in batches[:2]:
            _assert_detail(ptr.train_step(batch), jtr.train_step(batch))
    finally:
        jtr.grad_accum = 1
    with pytest.raises(ValueError, match="divisible"):
        _port_trainer(first, grad_accum=3).train_step(batches[0])
    # float (B, E) speaker embeddings through the port's trainer (the model
    # test holds that mode's gradients against JAX): a checkpoint written
    # and read back gives the same next step
    cfg = _config(spk="emb")
    from vae_npvc_tpu_torch.train import build_trainer
    a = build_trainer(cfg, device="cpu")
    a.init_state()
    emb = [_batch(50 + i, spk="emb") for i in range(3)]
    first_loss = float(a.train_step(emb[0])["Total"])
    assert "spk_emb_proj.kernel" in dict(a.layout) and np.isfinite(first_loss)
    a.save_checkpoint(tmp_path / "emb.ckpt")
    b = build_trainer(cfg, device="cpu")
    assert b.load_checkpoint(tmp_path / "emb.ckpt") == 1
    assert float(a.train_step(emb[1])["Total"]) \
        == float(b.train_step(emb[1])["Total"])


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    write_tts_golden()
