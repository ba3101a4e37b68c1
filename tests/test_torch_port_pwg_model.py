"""The port's Parallel WaveGAN modules, STFT loss and optimizers against the
JAX package, on the CPU.

Tolerances: the generator and the discriminator in fp32 within 1e-5 of the
output's peak; with ``compute_dtype: bfloat16`` (fp32 parameters) within
2^-6 of the peak (the port folds the weight norm into the bf16 weights
before the product, JAX scales the bf16 product: a few bf16 roundings
apart). ``multi_stft_loss`` within 1e-6 relative, its gradient within 1e-4
of the peak (the two FFTs round differently, and the log-magnitude term's
gradient is 1/|X| at small bins). RAdam, PlainRAdam and warmup AdamW
against the optax chains (jitted, as the trainers run them) within 1e-6
over 24 steps with the clip and StepLR.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from vae_npvc_tpu.models.pwg import PWGDiscriminator as JaxDisc
from vae_npvc_tpu.models.pwg import PWGGenerator as JaxGen
from vae_npvc_tpu.ops import stft_loss as jax_stft
from vae_npvc_tpu.train.optim import build_optimizer as jax_build_optimizer
from vae_npvc_tpu_torch.models.pwg import PWGDiscriminator, PWGGenerator
from vae_npvc_tpu_torch.ops import stft_loss
from vae_npvc_tpu_torch.train.optim import (AdamW, RAdam, build_optimizer)
from vae_npvc_tpu_torch.utils.bridge import optimizer_to_jax, to_jax_variables

torch.set_num_threads(1)

ARCH = {"layers": 6, "stacks": 2, "residual_channels": 8,
        "gate_channels": 16, "skip_channels": 8, "kernel_size": 3,
        "upsample_scales": [2, 4], "n_mels": 10, "disc_layers": 4,
        "disc_channels": 8}
# an uneven stack split (5 layers in 2 stacks: dilations 1, 2, 1, 2, 1),
# three upsampling stages, kernel 5
ARCH_ODD = dict(ARCH, layers=5, kernel_size=5, upsample_scales=[2, 3, 2],
                disc_layers=3, disc_kernel_size=5)
RES = ((64, 16, 32), (128, 32, 64), (32, 8, 16))


def _inputs(arch, B=2, T=12, seed=0):
    hop = int(np.prod(arch["upsample_scales"]))
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T * hop, 1)).astype(np.float32)
    mel = rng.normal(size=(B, T, arch["n_mels"])).astype(np.float32)
    return z, mel


def _peak_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("arch", [ARCH, ARCH_ODD], ids=["even", "odd"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2 ** -6)])
def test_generator_and_discriminator_match_flax(arch, dtype, tol):
    cfg = dict(arch, compute_dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    gen = PWGGenerator(cfg).init_random(3)
    disc = PWGDiscriminator(cfg).init_random(4)
    z, mel = _inputs(cfg)
    gp = to_jax_variables(gen.state_dict())["params"]
    dp = to_jax_variables(disc.state_dict())["params"]
    # the parameter trees are flax's own
    ref = JaxGen(arch=cfg).init(jax.random.PRNGKey(0), z, mel)["params"]
    assert (jax.tree_util.tree_map(np.shape, ref)
            == jax.tree_util.tree_map(np.shape, gp))
    assert "in" in gp and gp["in"]["v"].shape == (1, 1, 8)
    want = np.asarray(JaxGen(arch=cfg, dtype=jdt).apply({"params": gp}, z,
                                                        mel))
    with torch.no_grad():
        got = gen(torch.from_numpy(z), torch.from_numpy(mel))
        logits = disc(torch.from_numpy(want.copy()))
    assert got.dtype == torch.float32 and got.shape == z.shape
    assert _peak_err(got.numpy(), want) <= tol
    jl = JaxDisc(arch=cfg, dtype=jdt).apply({"params": dp}, want)
    assert logits.dtype == torch.float32
    assert _peak_err(logits.numpy(), jl) <= tol


def test_generator_rejects_a_noise_of_another_length():
    gen = PWGGenerator(ARCH).init_random(0)
    z, mel = _inputs(ARCH)
    with pytest.raises(ValueError, match="noise length"):
        gen(torch.from_numpy(z[:, :-8]), torch.from_numpy(mel))


def _stft_pair(zero_tail):
    rng = np.random.default_rng(7)
    t = np.arange(512) / 8000.0
    y = (0.4 * np.sin(2 * np.pi * 440 * t)[None]
         + 0.05 * rng.normal(size=(2, 512))).astype(np.float32)
    x = (y + 0.1 * rng.normal(size=(2, 512))).astype(np.float32)
    if zero_tail:
        # a zero-padded tail: several frames of every resolution see only
        # zeros, so |X| = 0 there
        x[1, -200:] = 0.0
        y[1, -200:] = 0.0
    return x, y


@pytest.mark.parametrize("zero_tail", [False, True])
def test_multi_stft_loss_and_gradient_match_jax(zero_tail):
    x, y = _stft_pair(zero_tail)
    if zero_tail:
        mx = stft_loss.stft_magnitude(torch.from_numpy(x), 32, 8, 16)
        assert bool((mx[1, -5:] == 0).all())     # whole frames of zeros

    def jax_loss(a):
        return jax_stft.multi_stft_loss(a, y, RES)

    jsc, jmag = jax_loss(jnp.asarray(x))
    jgrad = jax.jit(jax.grad(lambda a: sum(jax_loss(a))))(jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    sc, mag = stft_loss.multi_stft_loss(xt, torch.from_numpy(y), RES)
    (sc + mag).backward()
    np.testing.assert_allclose(sc.item(), float(jsc), rtol=1e-6)
    np.testing.assert_allclose(mag.item(), float(jmag), rtol=1e-6)
    g = xt.grad.numpy()
    assert np.isfinite(g).all()
    assert _peak_err(g, jgrad) <= 1e-4
    if zero_tail:
        # samples that only all-zero frames of every resolution read get
        # no gradient, in both
        np.testing.assert_array_equal(np.asarray(jgrad)[1, -40:], 0.0)
        np.testing.assert_array_equal(g[1, -40:], 0.0)


def test_stft_loss_defaults_are_the_published_resolutions():
    assert stft_loss.DEFAULT_RESOLUTIONS == jax_stft.DEFAULT_RESOLUTIONS
    rng = np.random.default_rng(1)
    y = rng.normal(size=(1, 4096)).astype(np.float32) * 0.3
    x = (y + 0.05 * rng.normal(size=(1, 4096))).astype(np.float32)
    want = jax_stft.multi_stft_loss(jnp.asarray(x), jnp.asarray(y))
    got = stft_loss.multi_stft_loss(torch.from_numpy(x), torch.from_numpy(y))
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


OPT_CASES = {
    "radam_steplr": {"optim_type": "RAdam", "learning_rate": 1e-2,
                     "betas": (0.9, 0.999), "max_grad_norm": 1.0,
                     "lr_scheduler": "StepLR",
                     "lr_param": {"step_size": 7, "gamma": 0.5}},
    "radam_const": {"optim_type": "RAdam", "learning_rate": 1e-2,
                    "betas": (0.5, 0.999), "max_grad_norm": 0},
    "plainradam": {"optim_type": "PlainRAdam", "learning_rate": 3e-3,
                   "max_grad_norm": 2.0, "lr_scheduler": "StepLR",
                   "lr_param": {"step_size": 5, "gamma": 0.7}},
    "adamw_warmup": {"optim_type": "AdamW", "learning_rate": 1e-2,
                     "max_grad_norm": 1.0, "warmup": 6,
                     "weight_decay": 0.05},
    "adamw_steplr": {"optim_type": "AdamW", "learning_rate": 1e-2,
                     "max_grad_norm": 1.0, "lr_scheduler": "StepLR",
                     "lr_param": {"step_size": 5, "gamma": 0.5},
                     "optim_param": {"weight_decay": 0.1,
                                     "betas": (0.8, 0.99)}},
    "adamw_const": {"optim_type": "AdamW", "learning_rate": 1e-2,
                    "max_grad_norm": 1.0},
}


@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_optimizers_match_optax(name):
    """24 steps; the clip bites on every third (large-gradient) step, the
    RAdam rectification switches on at step 6, StepLR crosses boundaries,
    the warmup ends at step 6. The state crosses to the JAX tree."""
    cfg = OPT_CASES[name]
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (3.0 if i % 3 == 0 else 0.05))
              .astype(np.float32) for k, s in shapes.items()}
             for i in range(24)]

    def flat(tree):
        return torch.from_numpy(np.concatenate(
            [np.asarray(tree[k]).reshape(-1) for k in shapes]))

    jtx = jax_build_optimizer(cfg)

    @jax.jit
    def jstep(p, s, g):
        u, s = jtx.update(g, s, p)
        return jax.tree_util.tree_map(lambda a, b: a + b, p, u), s

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    ptx = build_optimizer(cfg)
    assert isinstance(ptx, AdamW if "adamw" in name else RAdam)
    pp = flat(params)
    pstate = ptx.init(pp)
    for g in grads:
        jp, jstate = jstep(jp, jstate, {k: jnp.asarray(v)
                                        for k, v in g.items()})
        pu, pstate = ptx.update(flat(g), pstate, pp)
        pp = pp + pu
        np.testing.assert_allclose(pp.numpy(), flat(jp).numpy(), atol=1e-6,
                                   rtol=1e-6)
    layout = [(k, s) for k, s in shapes.items()]
    got = optimizer_to_jax(pstate, layout, ptx.clips, ptx.decoupled)
    want = serialization.to_state_dict(jax.device_get(jstate))
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))


@pytest.mark.parametrize("kind", ["RAdam", "AdamW"])
def test_vc_trainer_takes_each_optimizer(kind, tmp_path):
    """The VQ-VAE ``Trainer`` with RAdam (past its rectification switch) or
    AdamW (decay, StepLR) tracks the JAX ``Trainer`` for seven steps from
    one state, the EMA codebook's candidate rows injected on both sides;
    its checkpoint carries the optimizer tree JAX writes, byte for byte."""
    from jax.sharding import Mesh

    from tests.toy_config import toy_config
    from vae_npvc_tpu.ops import vq as jax_vq
    from vae_npvc_tpu.train.trainer import Trainer as JaxTrainer
    from vae_npvc_tpu_torch.ops import vq as port_vq
    from vae_npvc_tpu_torch.train import build_trainer

    cfg = dict(toy_config(), optim_type=kind, lr_scheduler="StepLR",
               lr_param={"step_size": 3, "gamma": 0.5})
    if kind == "AdamW":
        cfg["weight_decay"] = 0.01
    rng = np.random.default_rng(3)
    batches = [(rng.normal(size=(2, 32, 10)).astype(np.float32),
                rng.integers(0, 3, size=(2,)).astype(np.int32))
               for _ in range(7)]
    rows = rng.normal(size=(16, 8)).astype(np.float32)
    port = build_trainer(cfg, device="cpu")
    port.init_state()
    port.save_checkpoint(tmp_path / "seed")

    def jax_trainer(ckpt):
        tr = JaxTrainer(cfg, mesh=Mesh(np.array(jax.devices()[:1]),
                                       ("data",)))
        tr.init_state(batches[0])
        tr.load_checkpoint(ckpt)
        return tr

    jtr = jax_trainer(tmp_path / "seed")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vq, "_tiled_candidates",
                   lambda key, z, K: jnp.asarray(rows[:K]))
        mp.setattr(port_vq, "_tiled_candidates",
                   lambda gen, z, K: torch.from_numpy(rows[:K]))
        for b in batches:
            pd, jd = port.train_step(b), jtr.train_step(b)
            for k in ("Total", "X like", "grad_norm"):
                np.testing.assert_allclose(float(pd[k]), float(jd[k]),
                                           rtol=1e-4, err_msg=k)
    port.save_checkpoint(tmp_path / "port")
    again = jax_trainer(tmp_path / "port")
    again.save_checkpoint(tmp_path / "jax")
    assert (tmp_path / "jax").read_bytes() \
        == (tmp_path / "port").read_bytes()
