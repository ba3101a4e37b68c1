"""PyTorch port layers and flat VQ-VAE vs the JAX package on the CPU.

The flax modules are initialized with JAX; their parameters go through the
port's bridge into the port's modules; the same numpy inputs go through
both. fp32 throughout. Tolerances: layers 1e-5 absolute, model mel 1e-4
absolute (ten layers of summation-order differences), code ids exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_npvc_tpu.models import build_model as jax_build_model
from vae_npvc_tpu.nn import blocks as jb
from vae_npvc_tpu.ops.vq import EmaVqState
from vae_npvc_tpu_torch.infer.convert import Converter, read_checkpoint
from vae_npvc_tpu_torch.models import build_model, get_model_cls
from vae_npvc_tpu_torch.nn import blocks as pb
from vae_npvc_tpu_torch.utils.bridge import (from_jax_variables,
                                             to_jax_variables)

torch.set_num_threads(1)


def _load(module, params):
    module.load_state_dict(from_jax_variables({"params": params}),
                           strict=True)
    return module


def _np_params(variables):
    return jax.tree_util.tree_map(np.asarray, variables["params"])


@pytest.mark.parametrize("wn_dim,dilation,stride,padding", [
    ("out", 1, 1, "SAME_TORCH"), ("in", 2, 1, "SAME_TORCH"),
    ("out", 2, 1, "SAME_TORCH"), ("out", 1, 2, (1, 1))])
def test_wnconv1d_matches_flax(wn_dim, dilation, stride, padding):
    rng = np.random.default_rng(dilation * 10 + stride)
    x = rng.normal(size=(2, 21, 6)).astype(np.float32)
    jm = jb.WNConv1d(10, 3, stride=stride, dilation=dilation,
                     padding=padding, wn_dim=wn_dim)
    params = _np_params(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params["g"] = params["g"] * 1.3     # g away from ||v||
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    pm = _load(pb.WNConv1d(6, 10, 3, stride=stride, dilation=dilation,
                           padding=padding, wn_dim=wn_dim), params)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_conv_res_stack_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 20, 12)).astype(np.float32)
    lengths = np.array([20, 11, 3], np.int32)
    jm = jb.ConvResStack(12, 3, layers=2, dilation=2)
    mask = jb.length_mask(jnp.asarray(lengths), 20)
    params = _np_params(jm.init(jax.random.PRNGKey(1), jnp.asarray(x), mask))
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), mask))
    pm = _load(pb.ConvResStack(12, 3, layers=2, dilation=2), params)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_glu_res_skip_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 20, 8)).astype(np.float32)
    c = rng.normal(size=(3, 1, 6)).astype(np.float32)
    lengths = np.array([20, 9, 1], np.int32)
    jm = jb.GLUResSkip(8, 6, 5, 3, dilation=2)
    mask = jb.length_mask(jnp.asarray(lengths), 20)
    params = _np_params(jm.init(jax.random.PRNGKey(2), jnp.asarray(x),
                                jnp.asarray(c), mask))
    params["norm"]["scale"] = rng.normal(1.0, 0.2, 16).astype(np.float32)
    params["norm"]["bias"] = rng.normal(0.0, 0.2, 16).astype(np.float32)
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(c), mask)
    pm = _load(pb.GLUResSkip(8, 6, 5, 3, dilation=2), params)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(c),
                 torch.from_numpy(lengths))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("normalize", [False, True])
def test_conditions_matches_flax(normalize):
    idx = np.array([3, 0, 4], np.int32)
    jm = jb.Conditions(5, 7, normalize=normalize)
    params = _np_params(jm.init(jax.random.PRNGKey(3), jnp.asarray(idx)))
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(idx)))
    pm = _load(pb.Conditions(5, 7, normalize=normalize), params)
    with torch.no_grad():
        got = pm(torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _tiny_config():
    return {
        "model_type": "vae_npvc.model.vqvae", "compute_dtype": "float32",
        "y_dim": 16, "y_num": 8, "z_dim": 16, "z_num": 32, "use_ema": True,
        "encoder": {"in_channels": [12], "out_channels": [24],
                    "kernel_size": 3, "downsample_scales": [1],
                    "z_channels": 16, "dilation": True,
                    "stack_kernel_size": 3, "stack_layers": 2,
                    "stacks": [2], "use_weight_norm": True},
        "decoder": {"in_channels": [16], "out_channels": [24],
                    "cond_channels": 16, "skip_channels": 16,
                    "final_channels": 12, "kernel_size": 3,
                    "upsample_scales": [1], "dilation": True,
                    "stack_kernel_size": 3, "stacks": [2],
                    "use_weight_norm": True},
    }


@pytest.fixture(scope="module")
def tiny_pair():
    """(config, JAX model, JAX variables, port model, inputs)."""
    cfg = _tiny_config()
    rng = np.random.default_rng(11)
    B, T = 3, 40
    x = rng.normal(size=(B, T, 12)).astype(np.float32)
    lengths = np.array([40, 23, 4], np.int32)
    x[np.arange(T)[None, :] >= lengths[:, None]] = 0.0
    y = np.array([1, 7, 2], np.int32)
    jm = jax_build_model(cfg)
    v = jm.init({"params": jax.random.PRNGKey(0),
                 "vq": jax.random.PRNGKey(1)}, jnp.asarray(x),
                jnp.asarray(y), train=True)
    params = _np_params(v)
    z = np.asarray(jm.apply(
        {"params": params, "ema": v["ema"]}, jnp.asarray(x),
        jnp.asarray(lengths), method=lambda m, a, n: m.encoder(a, n)))
    emb = (rng.normal(size=(32, 16)) * z.std()).astype(np.float32)
    q = {"initted": np.array(True), "emb": emb, "emb_sum": emb.copy(),
         "emb_elem": np.ones(32, np.float32)}
    jvars = {"params": params, "ema": {"quantizer": EmaVqState(**q)}}
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(from_jax_variables(
        {"params": params, "ema": {"quantizer": q}}), strict=True)
    return cfg, jm, jvars, pm.eval(), (x, y, lengths)


def test_model_encode_decode_infer_match_jax(tiny_pair):
    cfg, jm, jvars, pm, (x, y, lengths) = tiny_pair
    ids_j = np.array(jm.apply(jvars, jnp.asarray(x), jnp.asarray(lengths),
                              method="encode"))
    mel_j = np.asarray(jm.apply(jvars, jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(lengths), method="infer"))
    dec_j = np.asarray(jm.apply(jvars, jnp.asarray(ids_j), jnp.asarray(y),
                                jnp.asarray(lengths), method="decode"))
    with torch.no_grad():
        ids_p = pm.encode(torch.from_numpy(x),
                          torch.from_numpy(lengths)).numpy()
        mel_p = pm.infer(torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(lengths)).numpy()
        dec_p = pm.decode(torch.from_numpy(ids_j), torch.from_numpy(y),
                          torch.from_numpy(lengths)).numpy()
    assert len(np.unique(ids_j)) > 3        # the codebook is really used
    for b, n in enumerate(lengths):
        np.testing.assert_array_equal(ids_p[b, :n], ids_j[b, :n])
        np.testing.assert_allclose(mel_p[b, :n], mel_j[b, :n], atol=1e-4)
        np.testing.assert_allclose(dec_p[b, :n], dec_j[b, :n], atol=1e-4)
    # a padded row equals its unpadded run
    with torch.no_grad():
        solo = pm.infer(torch.from_numpy(x[1:2, :lengths[1]]),
                        torch.from_numpy(y[1:2]),
                        torch.from_numpy(lengths[1:2])).numpy()
    np.testing.assert_allclose(solo[0], mel_p[1, :lengths[1]], atol=1e-5)


def test_bridge_round_trip(tiny_pair):
    _, _, jvars, pm, _ = tiny_pair
    v = to_jax_variables(pm.state_dict())
    sd = from_jax_variables(v)
    assert list(sd) == list(pm.state_dict())
    for k, t in pm.state_dict().items():
        assert torch.equal(sd[k], t)
    np.testing.assert_array_equal(v["ema"]["quantizer"]["emb"],
                                  np.asarray(jvars["ema"]["quantizer"].emb))
    assert set(v["params"]) == set(jvars["params"])


def test_registry_and_unported_families():
    from vae_npvc_tpu_torch.models.vqvae import Model

    assert get_model_cls("vae_npvc.model.vqvae") is Model
    assert get_model_cls("vqvae") is Model
    from vae_npvc_tpu_torch.models.token_tts import Model as TtsModel

    assert get_model_cls("vae_npvc.model.token_tts") is TtsModel
    from vae_npvc_tpu_torch.models import vqvae2, vqvae2b

    assert get_model_cls("vae_npvc.model.vqvae2") is vqvae2.Model
    assert get_model_cls("vqvae2b") is vqvae2b.Model
    from vae_npvc_tpu_torch.models import vae

    # the Gaussian VAE is ported: no family of the JAX package is refused
    assert get_model_cls("vae_npvc.model.vae") is vae.Model
    assert get_model_cls("vae") is vae.Model
    with pytest.raises(KeyError):
        get_model_cls("nope")
    # a strided flat model (x2 down in the encoder, x2 up in the decoder)
    # builds and matches JAX on a padded batch
    cfg = _tiny_config()
    cfg["encoder"] = dict(cfg["encoder"], downsample_scales=[2])
    cfg["decoder"] = dict(cfg["decoder"], upsample_scales=[2])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 40, 12)).astype(np.float32)
    lengths = np.array([40, 23, 4], np.int32)
    x[np.arange(40)[None, :] >= lengths[:, None]] = 0.0
    y = np.array([1, 7, 2], np.int32)
    jm = jax_build_model(cfg)
    v = jm.init({"params": jax.random.PRNGKey(0),
                 "vq": jax.random.PRNGKey(1)}, jnp.asarray(x),
                jnp.asarray(y), train=True)
    emb = rng.normal(0.0, 0.3, size=(32, 16)).astype(np.float32)
    q = {"initted": np.array(True), "emb": emb, "emb_sum": emb.copy(),
         "emb_elem": np.ones(32, np.float32)}
    params = _np_params(v)
    jvars = {"params": params, "ema": {"quantizer": EmaVqState(**q)}}
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(from_jax_variables(
        {"params": params, "ema": {"quantizer": q}}), strict=True)
    ids = jm.apply(jvars, jnp.asarray(x), jnp.asarray(lengths),
                   method=jm.encode)
    mel = jm.apply(jvars, jnp.asarray(x), jnp.asarray(y),
                   jnp.asarray(lengths), method=jm.infer)
    with torch.no_grad():
        pids = pm.encode(torch.from_numpy(x), torch.from_numpy(lengths))
        pmel = pm.infer(torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(lengths))
    assert pids.shape == (3, 20) and pmel.shape == (3, 40, 12)
    zl = np.array([20, 11, 2])
    for b in range(3):
        np.testing.assert_array_equal(pids[b, :zl[b]].numpy(),
                                      np.asarray(ids)[b, :zl[b]])
    np.testing.assert_allclose(pmel.numpy(), np.asarray(mel), atol=1e-4)


def test_entry_points_need_a_gpu_unless_asked_for_cpu():
    """No silent CPU run: the default device is the GPU, and this host has
    none."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Converter(_tiny_config())
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_model(_tiny_config())
    assert Converter(_tiny_config(), device="cpu").device.type == "cpu"


def test_old_checkpoint_format_is_refused(tmp_path):
    from vae_npvc_tpu_torch.utils import msgpack_io

    p = tmp_path / "old.msgpack"
    p.write_bytes(msgpack_io.msgpack_serialize(
        {"model": {}, "ema": {}, "iteration": 3, "wn_axis_format": 1}))
    with pytest.raises(ValueError, match="migrate.py"):
        read_checkpoint(p)
