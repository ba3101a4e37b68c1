"""The port's Gaussian VAE and WGAN-GP trainer against the JAX package on
the CPU, and the committed JAX fixture for GPU hosts.

Gaussian VAE (``model_type: vae``): the loss, every ``detail`` key and
every gradient with the same reparameterization noise injected on both
sides (``gaussian_sample`` replaced in the test), ``infer`` on a padded
batch (a strided config too), three ``Trainer`` steps in lockstep, and
``Converter.decode``/``sweep`` and ``bin/decode`` on a VAE checkpoint
against JAX's ``Converter``. WGAN-GP (``trainer_type: wgan_gp``): the two
trainers in lockstep from one state through phase 1 -> 2 -> 3
(``pre_iter: 1``) with the penalty's interpolation weights and the
codebook's candidate rows injected: per-step losses (``DISC loss``,
``gradient_penalty``, ``ADV loss``, ``Total``), then generator and critic
parameters, both optimizers' moments and the EMA codebook; a critic step
leaves the EMA state as it was (a lazy init included); checkpoints both
ways with equal bytes for an unchanged state; fine-tuning from a basic
trainer's checkpoint; ``grad_accum`` refused; a GAN checkpoint decoded as
a flat model. Tolerances (fp32): losses 1e-5 relative, gradients 1e-4 of
each leaf's peak, ``infer`` and conversions 1e-5, final states 2e-5 +
1e-3*|x|.

``tests/torch_port_fixtures/gan_golden*`` holds a tiny GAN run made by the
JAX ``GanTrainer`` (initial checkpoint with a live codebook, four
iterations across the phases, the injected interpolation weights, JAX's
per-step detail and the final checkpoint) and ``vae_golden*`` a tiny VAE
run (three steps with their injected noise); ``chip_smoke.py`` holds the
card against them. Regenerate with

    python -m tests.test_torch_port_gan_vae

(from the repo root, with JAX on the CPU at full matmul precision, as
``tests/conftest.py`` sets it).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vae_npvc_tpu_torch.utils import offline_fixture as fx

torch.set_num_threads(1)
FIXTURES = Path(__file__).resolve().parent / "torch_port_fixtures"
B, T, D = 3, 16, 12
GAN_STEPS = 4
VAE_STEPS = 3
TOL = 1e-5

_ENCODER = {"in_channels": [D], "out_channels": [16], "kernel_size": 3,
            "downsample_scales": [1], "z_channels": 16, "dilation": True,
            "stack_kernel_size": 3, "stack_layers": 1, "stacks": [2],
            "use_weight_norm": True}
_DECODER = {"in_channels": [8], "out_channels": [16], "cond_channels": 8,
            "skip_channels": 8, "final_channels": D, "kernel_size": 3,
            "upsample_scales": [1], "dilation": True, "stack_kernel_size": 3,
            "stacks": [2], "use_weight_norm": True}

GAN_CONFIG = {
    "model_type": "vae_npvc.model.vqvae",
    "trainer_type": "vae_npvc.trainer.wgan_gp", "seed": 17,
    "compute_dtype": "float32", "batch_size": B, "crop_length": T,
    "pre_iter": 1, "gamma": 0.5, "gp_weight": 1.0,
    "generator_param": {"per_iteration": 1, "optim_type": "RAdam",
                        "learning_rate": 1e-3, "max_grad_norm": 10,
                        "lr_scheduler": {"step_size": 2, "gamma": 0.5}},
    "discriminator_param": {"per_iteration": 1, "optim_type": "RAdam",
                            "learning_rate": 5e-4, "max_grad_norm": 1,
                            "lr_scheduler": {"step_size": 2,
                                             "gamma": 0.5}},
    "discriminator": {"channels": [8, 16], "kernel_size": 5,
                      "strides": [2, 2]},
    "y_dim": 8, "y_num": 4, "z_dim": 16, "z_num": 8, "use_ema": True,
    "beta": 0.01, "mu": 0.9, "jitter_p": 0.0,
    "encoder": _ENCODER, "decoder": dict(_DECODER, in_channels=[16]),
    "decode_bucket_size": 16, "decode_batch_size": 4,
}

VAE_CONFIG = {
    "model_type": "vae_npvc.model.vae",
    "trainer_type": "vae_npvc.trainer.basic", "seed": 19,
    "compute_dtype": "float32", "batch_size": B, "crop_length": T,
    "optim_type": "Adam", "learning_rate": 1e-3, "max_grad_norm": 10,
    "lr_scheduler": "StepLR", "lr_param": {"step_size": 2, "gamma": 0.5},
    "y_dim": 8, "y_num": 4, "z_dim": 8, "kld_weight": 0.01,
    "encoder": _ENCODER, "decoder": _DECODER,
    "decode_bucket_size": 16, "decode_batch_size": 4,
}


def _batches(seed, n, Bn=B):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(Bn, T, D)).astype(np.float32),
             rng.integers(0, 4, size=Bn).astype(np.int32))
            for _ in range(n)]


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


def _assert_detail(pd, jd, keys=None, rtol=1e-5):
    for k in keys or jd:
        np.testing.assert_allclose(float(pd[k]), float(jd[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)


# ------------------------------------------------------- injected draws
def eps_like(shape):
    """The reparameterization noise both packages get in these tests."""
    return np.random.default_rng(123).normal(size=shape).astype(np.float32)


@pytest.fixture
def injected_noise(monkeypatch):
    """``gaussian_sample`` of both VAEs draws ``eps_like`` (torch cannot
    replay ``jax.random``; nothing in either package changes)."""
    import jax.numpy as jnp

    import vae_npvc_tpu.models.vae as jvae
    import vae_npvc_tpu_torch.models.vae as pvae

    monkeypatch.setattr(jvae, "gaussian_sample", lambda rng, mu, lv: mu + (
        jnp.exp(0.5 * lv) * jnp.asarray(eps_like(mu.shape))))
    monkeypatch.setattr(pvae, "gaussian_sample", lambda gen, mu, lv: mu + (
        torch.exp(0.5 * lv) * torch.from_numpy(eps_like(tuple(mu.shape)))))


ALPHAS = np.random.default_rng(5).uniform(size=(B, 1, 1)).astype(np.float32)
CANDIDATES = np.random.default_rng(99).normal(size=(8, 16)) \
    .astype(np.float32)


@pytest.fixture
def injected_gan_draws(monkeypatch):
    """The codebook's init/restart candidate rows and the penalty's
    interpolation weights, the same on both sides."""
    import jax
    import jax.numpy as jnp

    import vae_npvc_tpu.ops.vq as jvq
    import vae_npvc_tpu_torch.ops.vq as pvq
    import vae_npvc_tpu_torch.train.gan as pgan

    monkeypatch.setattr(jvq, "_tiled_candidates",
                        lambda rng, z, K: jnp.asarray(CANDIDATES[:K]))
    monkeypatch.setattr(pvq, "_tiled_candidates",
                        lambda gen, z, K: torch.from_numpy(CANDIDATES[:K]))
    monkeypatch.setattr(pgan, "gp_alpha",
                        lambda gen, shape, device: torch.from_numpy(ALPHAS))
    uniform = jax.random.uniform

    def alphas(key, shape=(), *a, **k):       # the GAN step's only uniform
        if tuple(shape) == ALPHAS.shape:
            return jnp.asarray(ALPHAS)
        return uniform(key, shape, *a, **k)

    monkeypatch.setattr(jax.random, "uniform", alphas)


# ------------------------------------------------------------------- VAE
def _jax_vae(cfg, batch):
    import jax
    import jax.numpy as jnp

    from vae_npvc_tpu.models import build_model as jax_build_model

    jm = jax_build_model(cfg)
    v = jm.init({"params": jax.random.PRNGKey(0), "vq":
                 jax.random.PRNGKey(1)}, *map(jnp.asarray, batch),
                train=True)
    rng = np.random.default_rng(7)
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


def test_vae_loss_detail_and_gradients_match_jax(injected_noise):
    import jax
    import jax.numpy as jnp

    from vae_npvc_tpu_torch.utils.bridge import to_jax_variables

    batch = _batches(1, 1)[0]
    jm, params = _jax_vae(VAE_CONFIG, batch)
    pm = _port_model(VAE_CONFIG, params)

    def loss_fn(p):
        _, loss, detail = jm.apply({"params": p}, *map(jnp.asarray, batch),
                                   train=True, rngs={"vq":
                                                     jax.random.PRNGKey(3)})
        return loss, detail

    (_, jd), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    _, pl, pd = pm(*map(torch.as_tensor, batch), True,
                   gen=torch.Generator())
    assert set(pd) == set(jd) == {"Total", "KLD loss", "X like"}
    _assert_detail(pd, jd)
    pl.backward()
    got = _leaves(to_jax_variables(
        {k: p.grad for k, p in pm.named_parameters()})["params"])
    want = _leaves(jax.tree_util.tree_map(np.asarray, jg))
    assert set(got) == set(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        assert float(np.abs(got[k] - want[k]).max()) <= 1e-4 * scale, k
    # evaluation takes the posterior mean
    with torch.no_grad():
        _, _, pe = pm(*map(torch.as_tensor, batch), False)
    _, _, je = jm.apply({"params": params}, *map(jnp.asarray, batch),
                        train=False)
    _assert_detail(pe, je)


@pytest.mark.parametrize("strided", [False, True])
def test_vae_infer_on_a_padded_batch_matches_jax(strided):
    import jax.numpy as jnp

    cfg = VAE_CONFIG
    if strided:
        cfg = dict(cfg, encoder=dict(_ENCODER, downsample_scales=[2]),
                   decoder=dict(_DECODER, upsample_scales=[2]))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 20, D)).astype(np.float32)
    lengths = np.array([20, 13, 6], np.int32)
    x[np.arange(20)[None, :] >= lengths[:, None]] = 0.0
    y = np.array([3, 0, 2], np.int32)
    jm, params = _jax_vae(cfg, (x, y))
    pm = _port_model(cfg, params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(y), jnp.asarray(lengths),
                               method="infer"))
    with torch.no_grad():
        got = pm.infer(torch.as_tensor(x), torch.as_tensor(y),
                       torch.as_tensor(lengths)).numpy()
    assert got.shape == want.shape
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=TOL)


def make_jax_vae_trainer(tmp):
    """The JAX ``Trainer`` of ``VAE_CONFIG`` at step 0 with perturbed
    parameters, its checkpoint path, and the batches."""
    import jax
    from jax.sharding import Mesh

    from vae_npvc_tpu.train.trainer import Trainer

    batches = _batches(2, VAE_STEPS)
    tr = Trainer(VAE_CONFIG, mesh=Mesh(np.array(jax.devices()[:1]),
                                       ("data",)))
    tr.init_state(batches[0])
    _, params = _jax_vae(VAE_CONFIG, batches[0])
    tr.state = tr.state.replace(params=jax.tree_util.tree_map(
        jax.numpy.asarray, params))
    path = Path(tmp) / "vae_first"
    tr.save_checkpoint(path)
    return tr, path, batches


def run_jax_vae(tmp):
    """JAX's VAE run with the noise injected: (first ckpt, final ckpt,
    batches, per-step detail)."""
    import jax.numpy as jnp

    import vae_npvc_tpu.models.vae as jvae

    mp = pytest.MonkeyPatch()
    mp.setattr(jvae, "gaussian_sample", lambda rng, mu, lv: mu + (
        jnp.exp(0.5 * lv) * jnp.asarray(eps_like(mu.shape))))
    try:
        tr, first, batches = make_jax_vae_trainer(tmp)
        details = [tr.train_step(b) for b in batches]
    finally:
        mp.undo()
    tr.save_checkpoint(tmp / "vae_final")
    return first, tmp / "vae_final", batches, details


@pytest.fixture(scope="module")
def vae_run(tmp_path_factory):
    return run_jax_vae(tmp_path_factory.mktemp("vae"))


def test_vae_trainers_in_lockstep(vae_run, injected_noise, tmp_path):
    from vae_npvc_tpu_torch.train import build_trainer

    first, final, batches, details = vae_run
    check_committed("vae", first.read_bytes(), final.read_bytes(),
                    vae_arrays(batches, details))
    tr = build_trainer(VAE_CONFIG, device="cpu")
    assert tr.load_checkpoint(first) == 0
    for b, jd in zip(batches, details):
        _assert_detail(tr.train_step(b), jd,
                       ("Total", "KLD loss", "X like", "grad_norm"))
    tr.save_checkpoint(tmp_path / "port")
    assert_state_close((tmp_path / "port").read_bytes(), final.read_bytes())


def test_vae_converter_and_bin_decode_match_jax(vae_run, tmp_path):
    """``Converter.decode`` and ``sweep`` (per target ``infer`` over the
    bucketed batches) and ``bin/decode`` on the VAE checkpoint."""
    from vae_npvc_tpu.infer.convert import Converter as JaxConverter
    from vae_npvc_tpu_torch.bin import decode
    from vae_npvc_tpu_torch.infer.convert import Converter

    final = vae_run[1]
    d = fx.offline_decode_dir(tmp_path / "dd", D)
    jcv = JaxConverter(VAE_CONFIG)
    jcv.load_checkpoint(final)
    pcv = Converter(VAE_CONFIG, device="cpu")
    assert pcv.load_checkpoint(final) == VAE_STEPS
    for mode in ("decode", "sweep"):
        want, got = [], []
        for cv, out in ((jcv, want), (pcv, got)):
            o = tmp_path / f"{mode}_{len(want) + len(got)}_{id(cv)}"
            if mode == "decode":
                cv.decode(d, o, compress=False)
            else:
                cv.sweep(d, o, fx.OFFLINE_TARGETS, compress=False)
            out.extend(fx.read_outputs(o))
        assert [k for k, _ in got] == [k for k, _ in want]
        for (k, a), (_, b) in zip(got, want):
            np.testing.assert_allclose(a, b, atol=TOL, err_msg=k)
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps(VAE_CONFIG))
    args = ["-c", str(conf), "--checkpoint", str(final), "--decode-dir",
            str(d), "--device", "cpu"]
    assert decode.main(args + ["--output-dir", str(tmp_path / "cli")]) == 8
    assert decode.main(args + ["--output-dir", str(tmp_path / "cli_sweep"),
                               "--all-targets", "spkB,spkC"]) == 16
    for name, mode in (("cli", "decode"), ("cli_sweep", "sweep")):
        o = tmp_path / f"j_{name}"
        if mode == "decode":
            jcv.decode(d, o, compress=False)
        else:
            jcv.sweep(d, o, fx.OFFLINE_TARGETS, compress=False)
        for (k, a), (_, b) in zip(fx.read_outputs(tmp_path / name),
                                  fx.read_outputs(o)):
            assert np.all(np.abs(a - b)
                          <= fx.compression_step(b)[None] + TOL), k


# ------------------------------------------------------------------- GAN
def make_jax_gan_trainer(tmp):
    """The JAX ``GanTrainer`` at iteration 0 and its checkpoint path; the
    codebook is already initialized from the encoder's outputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from vae_npvc_tpu.ops.vq import EmaVqState
    from vae_npvc_tpu.train.gan import GanTrainer

    batches = _batches(3, GAN_STEPS)
    tr = GanTrainer(GAN_CONFIG, mesh=Mesh(np.array(jax.devices()[:1]),
                                          ("data",)))
    tr.init_state(batches[0])
    z = np.asarray(tr.model.apply(
        {"params": tr.state.params, **tr.state.ema},
        jnp.asarray(batches[0][0]), method=lambda m, a: m.encoder(a)))
    K = GAN_CONFIG["z_num"]
    emb = z.reshape(-1, z.shape[-1])[::5][:K].copy()
    elem = np.full((K,), 8.0, np.float32)
    tr.state = tr.state.replace(ema={"ema": {"quantizer": EmaVqState(
        jnp.asarray(True), jnp.asarray(emb),
        jnp.asarray(emb * elem[:, None]), jnp.asarray(elem))}})
    path = Path(tmp) / "gan_first"
    tr.save_checkpoint(path)
    return tr, path, batches


def test_gan_trainers_in_lockstep_through_the_phases(injected_gan_draws,
                                                     tmp_path):
    from vae_npvc_tpu_torch.train import build_trainer
    from vae_npvc_tpu_torch.train.gan import GanTrainer

    jtr, first, batches = make_jax_gan_trainer(tmp_path)
    ptr = build_trainer(GAN_CONFIG, device="cpu")
    assert isinstance(ptr, GanTrainer) and not ptr.supports_steps_per_call
    assert ptr.load_checkpoint(first) == 0
    ptr.save_checkpoint(tmp_path / "port0")
    assert (tmp_path / "port0").read_bytes() == first.read_bytes()
    details = []
    for b in batches:
        jd, pd = jtr.train_step(b), ptr.train_step(b)
        assert set(jd) <= set(pd)
        _assert_detail(pd, jd)
        details.append(jd)
    assert ["ADV loss" in d for d in details] == [False, False, True, True]
    assert ptr.iteration == jtr.iteration == GAN_STEPS
    assert ptr.g_step == GAN_STEPS
    jtr.save_checkpoint(tmp_path / "jax")
    ptr.save_checkpoint(tmp_path / "port")
    assert_state_close((tmp_path / "port").read_bytes(),
                       (tmp_path / "jax").read_bytes())
    # the committed fixture is this run
    check_committed("gan", first.read_bytes(), (tmp_path / "jax")
                    .read_bytes(), gan_arrays(batches, details))
    # the port's checkpoint in JAX: the next iteration together
    assert jtr.load_checkpoint(tmp_path / "port") == GAN_STEPS
    extra = _batches(30, 1)[0]
    _assert_detail(ptr.train_step(extra), jtr.train_step(extra))


def test_critic_step_leaves_the_codebook_and_generator(injected_gan_draws,
                                                       tmp_path):
    """A critic step moves the critic only: the EMA state (a pending lazy
    init included) and the generator's parameters and moments stay."""
    from vae_npvc_tpu_torch.train import build_trainer

    batch = _batches(4, 1)[0]
    tr = build_trainer(dict(GAN_CONFIG, pre_iter=0), device="cpu")
    tr.init_state()
    assert not bool(tr.model.quantizer.initted)
    state = [t.clone() for t in tr.model.quantizer.state()]
    flat, mu = tr.flat.clone(), tr.opt_state.mu.clone()
    d_flat = tr.d_flat.clone()
    detail = tr._disc_step(*tr._to_device(batch))
    assert set(detail) == {"DISC loss", "gradient_penalty"}
    assert tr.model.pending_ema is None
    for a, b in zip(tr.model.quantizer.state(), state):
        assert torch.equal(a, b)
    assert torch.equal(tr.flat, flat) and torch.equal(tr.opt_state.mu, mu)
    assert not torch.equal(tr.d_flat, d_flat)
    assert int(tr.d_opt_state.count) == 1 and tr.g_step == 0


def test_fine_tuning_from_a_basic_checkpoint_and_grad_accum(tmp_path):
    """A basic trainer's checkpoint (``optimizer``, no critic) loads with
    a fresh critic and fresh optimizers, as in JAX; its iteration is the
    host iteration, so the schedule goes on from there."""
    from vae_npvc_tpu_torch.train import build_trainer
    from vae_npvc_tpu_torch.utils import msgpack_io

    basic = build_trainer(dict(GAN_CONFIG, trainer_type="basic"),
                          device="cpu")
    basic.init_state()
    basic.train_step(_batches(5, 1)[0])
    basic.train_step(_batches(6, 1)[0])
    basic.save_checkpoint(tmp_path / "basic")
    tr = build_trainer(GAN_CONFIG, device="cpu")
    assert tr.load_checkpoint(tmp_path / "basic") == 2
    assert tr.g_step == 2 and int(tr.opt_state.count) == 0
    fresh = build_trainer(GAN_CONFIG, device="cpu")
    fresh.init_state()
    assert torch.equal(tr.d_flat, fresh.d_flat)
    assert torch.equal(tr.flat, basic.flat)
    detail = tr.train_step(_batches(7, 1)[0])     # iteration 2 > pre_iter
    assert {"DISC loss", "ADV loss", "Total"} <= set(detail)
    tr.save_checkpoint(tmp_path / "gan")
    payload = msgpack_io.msgpack_restore((tmp_path / "gan").read_bytes())
    assert payload["iteration"] == 3 and payload["host_iteration"] == 3
    assert set(payload) == {"wn_axis_format", "model", "discriminator", "ema",
                            "optimizer_G", "optimizer_D", "iteration",
                            "host_iteration"}
    with pytest.raises(ValueError, match="grad_accum"):
        build_trainer(dict(GAN_CONFIG, grad_accum=2), device="cpu")


def test_gan_checkpoint_decodes_as_a_flat_model(injected_gan_draws,
                                                tmp_path):
    """``Converter`` and the engine read a GAN checkpoint's ``model`` (a
    flat VQ-VAE): the port's decode equals JAX's."""
    from vae_npvc_tpu.infer.convert import Converter as JaxConverter
    from vae_npvc_tpu_torch.infer.convert import Converter

    _, first, _ = make_jax_gan_trainer(tmp_path)
    d = fx.offline_decode_dir(tmp_path / "dd", D)
    jcv = JaxConverter(GAN_CONFIG)
    jcv.load_checkpoint(first)
    jcv.decode(d, tmp_path / "j", compress=False)
    pcv = Converter(GAN_CONFIG, device="cpu")
    pcv.load_checkpoint(first)
    pcv.decode(d, tmp_path / "p", compress=False)
    for (k, a), (_, b) in zip(fx.read_outputs(tmp_path / "p"),
                              fx.read_outputs(tmp_path / "j")):
        np.testing.assert_allclose(a, b, atol=TOL, err_msg=k)


# ------------------------------------------------------------------ fixture
GAN_DETAIL_KEYS = ("DISC loss", "gradient_penalty", "ADV loss", "Total",
                   "X like", "VQ loss", "usage", "skipped_nonfinite")
VAE_DETAIL_KEYS = ("Total", "KLD loss", "X like", "grad_norm",
                   "skipped_nonfinite")


def _detail_arrays(details, keys):
    """Per key, the per-step values (NaN where a step's phase has none)."""
    return {"detail/" + k: np.asarray([float(d[k]) if k in d else np.nan
                                       for d in details], np.float64)
            for k in keys}


def gan_arrays(batches, details):
    arrays = {"alphas": ALPHAS, "candidates": CANDIDATES}
    for i, (x, y) in enumerate(batches):
        arrays[f"feats_{i}"], arrays[f"spks_{i}"] = x, y
    arrays.update(_detail_arrays(details, GAN_DETAIL_KEYS))
    return arrays


def vae_arrays(batches, details):
    arrays = {"eps": eps_like((B, T, VAE_CONFIG["z_dim"]))}
    for i, (x, y) in enumerate(batches):
        arrays[f"feats_{i}"], arrays[f"spks_{i}"] = x, y
    arrays.update(_detail_arrays(details, VAE_DETAIL_KEYS))
    return arrays


def check_committed(name, first, final, arrays):
    """The committed ``<name>_golden*`` fixture equals this JAX run."""
    cfg = {"gan": GAN_CONFIG, "vae": VAE_CONFIG}[name]
    assert json.loads((FIXTURES / f"{name}_golden_config.json")
                      .read_text()) == cfg
    g = np.load(FIXTURES / f"{name}_golden.npz")
    assert set(g.files) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_allclose(v, g[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert_state_close(first, (FIXTURES / f"{name}_golden.msgpack")
                       .read_bytes(), atol=1e-7, rtol=1e-6)
    assert_state_close(final, (FIXTURES / f"{name}_golden_final.msgpack")
                       .read_bytes(), atol=1e-6, rtol=1e-5)


def write_gan_vae_golden(out_dir=FIXTURES):
    """Run both fixtures with JAX (the draws injected as in the tests)."""
    import tempfile

    import jax
    import jax.numpy as jnp

    import vae_npvc_tpu.ops.vq as jvq

    mp = pytest.MonkeyPatch()
    mp.setattr(jvq, "_tiled_candidates",
               lambda rng, z, K: jnp.asarray(CANDIDATES[:K]))
    uniform = jax.random.uniform
    mp.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: (
        jnp.asarray(ALPHAS) if tuple(shape) == ALPHAS.shape
        else uniform(key, shape, *a, **k)))
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tr, first, batches = make_jax_gan_trainer(tmp)
        details = [tr.train_step(b) for b in batches]
        tr.save_checkpoint(tmp / "gan_final")
        runs = {"gan": (first, tmp / "gan_final",
                        gan_arrays(batches, details))}
        mp.undo()
        first, final, batches, details = run_jax_vae(tmp)
        runs["vae"] = (first, final, vae_arrays(batches, details))
        for name, (first, final, arrays) in runs.items():
            (out_dir / f"{name}_golden.msgpack").write_bytes(
                first.read_bytes())
            (out_dir / f"{name}_golden_final.msgpack").write_bytes(
                final.read_bytes())
            np.savez_compressed(out_dir / f"{name}_golden.npz", **arrays)
            (out_dir / f"{name}_golden_config.json").write_text(json.dumps(
                {"gan": GAN_CONFIG, "vae": VAE_CONFIG}[name], indent=1)
                + "\n")


def load_fixture(name, fixtures=FIXTURES):
    """(config, batches, arrays) of a committed fixture."""
    cfg = json.loads((fixtures / f"{name}_golden_config.json").read_text())
    g = np.load(fixtures / f"{name}_golden.npz")
    n = sum(1 for k in g.files if k.startswith("feats_"))
    return cfg, [(g[f"feats_{i}"], g[f"spks_{i}"]) for i in range(n)], g


def test_port_tracks_gan_and_vae_fixtures_on_cpu(monkeypatch, tmp_path):
    """The port's trainers on the CPU against the committed fixtures with
    their stored draws, as the GPU smoke holds them."""
    import vae_npvc_tpu_torch.models.vae as pvae
    import vae_npvc_tpu_torch.ops.vq as pvq
    import vae_npvc_tpu_torch.train.gan as pgan
    from vae_npvc_tpu_torch.train import build_trainer

    for name, keys in (("gan", GAN_DETAIL_KEYS), ("vae", VAE_DETAIL_KEYS)):
        cfg, batches, g = load_fixture(name)
        if name == "gan":
            monkeypatch.setattr(pvq, "_tiled_candidates", lambda gen, z, K:
                                torch.from_numpy(g["candidates"][:K]))
            monkeypatch.setattr(pgan, "gp_alpha", lambda gen, shape, dev:
                                torch.from_numpy(g["alphas"]))
        else:
            monkeypatch.setattr(pvae, "gaussian_sample", lambda gen, mu, lv:
                                mu + torch.exp(0.5 * lv)
                                * torch.from_numpy(g["eps"]))
        tr = build_trainer(cfg, device="cpu")
        assert tr.load_checkpoint(FIXTURES / f"{name}_golden.msgpack") == 0
        for i, b in enumerate(batches):
            d = tr.train_step(b)
            want = {k: g["detail/" + k][i] for k in keys
                    if not np.isnan(g["detail/" + k][i])}
            _assert_detail(d, want)
        tr.save_checkpoint(tmp_path / name)
        assert_state_close((tmp_path / name).read_bytes(),
                           (FIXTURES / f"{name}_golden_final.msgpack")
                           .read_bytes())


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    write_gan_vae_golden()


def test_vae_checkpoint_in_a_bundle_and_the_engine(tmp_path):
    """``bin/export_serving``'s exporter and ``ConversionEngine`` take a
    VAE checkpoint: the bundle converts as the live ``Converter`` does."""
    from vae_npvc_tpu_torch.infer.convert import Converter
    from vae_npvc_tpu_torch.infer.export_serving import (ServingBundle,
                                                         export_bundle)
    from vae_npvc_tpu_torch.serve import ConversionEngine

    ckpt = FIXTURES / "vae_golden_final.msgpack"
    meta = export_bundle(VAE_CONFIG, ckpt, tmp_path / "bundle",
                         buckets=[16], batch_size=2, device="cpu")
    assert meta["model_type"] == "vae_npvc.model.vae"
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(2, 16, D)).astype(np.float32)
    lengths = np.array([16, 9], np.int32)
    feats[1, 9:] = 0.0
    tgts = np.array([1, 3], np.int32)
    live = Converter(VAE_CONFIG, device="cpu")
    live.load_checkpoint(ckpt)
    want = live.infer(feats, tgts, lengths)
    got = ServingBundle(tmp_path / "bundle", device="cpu").infer(
        feats, tgts, lengths)
    np.testing.assert_allclose(got[0], want[0], atol=TOL)
    np.testing.assert_allclose(got[1, :9], want[1, :9], atol=TOL)
    stats = np.zeros((2, D + 1), np.float64)
    stats[0, :-1] = -3.0 * 1000
    stats[0, -1] = 1000
    stats[1, :-1] = (1.0 + 3.0 ** 2) * 1000
    feature = {"fs": 8000, "n_fft": 128, "n_shift": 32, "n_mels": D,
               "fmin": 0, "fmax": 4000}
    engine = ConversionEngine(VAE_CONFIG, ckpt, stats, feature=feature,
                              vocoder="none", device="cpu")
    try:
        wav = np.sin(np.arange(4000) / 7.0).astype(np.float32) * 0.3
        mel, _ = engine.convert(wav, 8000, 2)
        assert mel.ndim == 2 and mel.shape[1] == D
        assert np.isfinite(mel).all()
    finally:
        engine.close()
