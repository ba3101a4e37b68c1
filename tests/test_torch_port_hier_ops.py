"""The hierarchical families' layers in the port against the JAX package.

``nearest_upsample`` and ``nearest_upsample_masked`` (exact), the strided
``WNConv1d`` and ``WNConvTranspose1d`` (forward and gradients), the strided
``Encoder`` with lengths and ``return_hidden``, its length arithmetic, and
the ``Decoder`` with an upsampling scale, from the same numpy inputs and
bridged parameters. fp32 on the CPU; tolerance 1e-5 of each output's peak
(summation order only), gradients 1e-4 of each gradient's peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model_vqvae2 import enc_cfg
from vae_npvc_tpu.models.vqvae import Decoder as JaxDecoder
from vae_npvc_tpu.models.vqvae import Encoder as JaxEncoder
from vae_npvc_tpu.nn import blocks as jblocks
from vae_npvc_tpu.ops import upsample as jup
from vae_npvc_tpu_torch.models.vqvae import Decoder, Encoder
from vae_npvc_tpu_torch.nn.blocks import WNConv1d, WNConvTranspose1d
from vae_npvc_tpu_torch.ops import upsample as pup
from vae_npvc_tpu_torch.utils.bridge import from_jax_variables

torch.set_num_threads(1)


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    peak = max(float(np.abs(b).max()), 1e-12)
    assert float(np.abs(a - b).max()) <= tol * peak, \
        float(np.abs(a - b).max()) / peak


def _init(module, *args):
    v = module.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))
    return jax.tree_util.tree_map(np.asarray, v)


def _load(pm, variables):
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return pm


@pytest.mark.parametrize("T,target", [(4, 16), (5, 16), (3, 2), (7, 7),
                                      (1, 9)])
def test_nearest_upsample_matches_jax(T, target):
    z = np.random.default_rng(T).normal(size=(2, T, 3)).astype(np.float32)
    want = np.asarray(jup.nearest_upsample(jnp.asarray(z), target))
    got = pup.nearest_upsample(torch.from_numpy(z), target).numpy()
    np.testing.assert_array_equal(got, want)


def test_nearest_upsample_masked_matches_jax_and_unpadded_runs():
    rng = np.random.default_rng(1)
    z = rng.normal(size=(4, 6, 3)).astype(np.float32)
    in_len = np.array([6, 3, 1, 5], np.int32)
    out_len = np.array([24, 13, 2, 20], np.int32)
    want = np.asarray(jup.nearest_upsample_masked(
        jnp.asarray(z), 24, jnp.asarray(in_len), jnp.asarray(out_len)))
    got = pup.nearest_upsample_masked(torch.from_numpy(z), 24,
                                      torch.from_numpy(in_len),
                                      torch.from_numpy(out_len)).numpy()
    np.testing.assert_array_equal(got, want)
    # each row's real frames equal the unpadded run of that row
    for b in range(4):
        one = pup.nearest_upsample(torch.from_numpy(z[b:b + 1, :in_len[b]]),
                                   int(out_len[b])).numpy()
        np.testing.assert_array_equal(got[b:b + 1, :out_len[b]], one)


@pytest.mark.parametrize("s", [2, 3, 4])
def test_strided_conv_and_transposed_conv_match_jax(s):
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, 17, 6)).astype(np.float32)
    p = s // 2 + s % 2
    cases = [
        (jblocks.WNConv1d(5, 2 * s, stride=s, padding=(p, p)),
         WNConv1d(6, 5, 2 * s, stride=s, padding=(p, p))),
        (jblocks.WNConvTranspose1d(5, s), WNConvTranspose1d(6, 5, s)),
        (jblocks.WNConvTranspose1d(5, s, wn_dim="out"),
         WNConvTranspose1d(6, 5, s, wn_dim="out")),
    ]
    for jm, pm in cases:
        v = _init(jm, x)
        _load(pm, v)
        want, vjp = jax.vjp(lambda p, a: jm.apply(p, a), v, jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        got = pm(xt)
        if isinstance(pm, WNConvTranspose1d):
            assert got.shape[1] == 17 * s
        else:
            assert got.shape[1] == (17 + 2 * p - 2 * s) // s + 1
        # channels-first, as the convolution hands it over: the GroupNorm
        # kernel reads such a view in place
        assert got.stride(1) == 1
        _close(got.detach().numpy(), want)
        ct = rng.normal(size=want.shape).astype(np.float32)
        jg, jgx = vjp(jnp.asarray(ct))
        grads = torch.autograd.grad(got, [xt] + list(pm.parameters()),
                                    torch.from_numpy(ct))
        _close(grads[0].numpy(), jgx, 1e-4)
        jflat = from_jax_variables(jax.tree_util.tree_map(np.asarray, jg))
        for (name, _), g in zip(pm.named_parameters(), grads[1:]):
            _close(g.numpy(), jflat[name].numpy(), 1e-4)


ENC = {"in_channels": [10, 16], "out_channels": [16, 12], "kernel_size": 3,
       "downsample_scales": [2, 4], "z_channels": 8, "dilation": True,
       "stack_kernel_size": 3, "stack_layers": 2, "stacks": [2, 1],
       "use_weight_norm": True}


def test_strided_encoder_with_lengths_and_hidden_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 40, 10)).astype(np.float32)
    lengths = np.array([40, 23, 9], np.int32)
    jm = JaxEncoder(ENC, return_hidden=True)
    v = _init(jm, x)
    pm = _load(Encoder(ENC, return_hidden=True), v)
    for n in (None, lengths):
        jz, jh = jm.apply(v, jnp.asarray(x),
                          None if n is None else jnp.asarray(n))
        pz, ph = pm(torch.from_numpy(x),
                    None if n is None else torch.from_numpy(n))
        assert pz.shape == (3, 5, 8) and ph.shape == (3, 5, 12)
        _close(pz.detach().numpy(), jz)
        _close(ph.detach().numpy(), jh)
    # masked rows: beyond each downsampled length the latents are zero,
    # and a padded row equals its unpadded run
    zl = Encoder.out_lengths(ENC, lengths)
    np.testing.assert_array_equal(zl, np.asarray(
        JaxEncoder.out_lengths(ENC, jnp.asarray(lengths))))
    assert list(zl) == [5, 2, 1]
    for b in range(3):
        one, _ = pm(torch.from_numpy(x[b:b + 1, :lengths[b]]))
        _close(pz[b, :zl[b]].detach().numpy(), one[0, :zl[b]].detach()
               .numpy())
        assert not pz[b, zl[b]:].any()
    # without return_hidden the encoder returns the latents alone
    plain = _load(Encoder(ENC), v)
    assert torch.equal(plain(torch.from_numpy(x)), pm(torch.from_numpy(x))[0])


def test_encoder_length_chain_and_minimum_input():
    chain = [enc_cfg(80, 1), dict(enc_cfg(512, 2), downsample_scales=[2, 2]),
             dict(enc_cfg(512, 4), downsample_scales=[4, 4])]
    assert Encoder.min_input_frames(chain) == \
        JaxEncoder.min_input_frames(chain) == 64
    n = np.array([0, 1, 3, 63, 64, 65, 256, 1000], np.int32)
    for arch in chain:
        np.testing.assert_array_equal(
            Encoder.out_lengths(arch, n),
            np.asarray(JaxEncoder.out_lengths(arch, jnp.asarray(n))))
        np.testing.assert_array_equal(
            Encoder.out_lengths(arch, torch.from_numpy(n)).numpy(),
            Encoder.out_lengths(arch, n))
        n = Encoder.out_lengths(arch, n)
    # a level that would shrink to 0 frames raises, with the JAX message
    pm = Encoder(chain[2], return_hidden=True)
    with pytest.raises(ValueError, match="min_input_frames"):
        pm(torch.zeros(1, 2, 512))


def test_decoder_with_upsampling_matches_jax():
    arch = {"in_channels": [8, 16], "out_channels": [16, 12],
            "upsample_scales": [2, 1], "cond_channels": 4,
            "skip_channels": 8, "final_channels": 10, "kernel_size": 3,
            "dilation": False, "stack_kernel_size": 3, "stacks": [1, 2],
            "use_weight_norm": True}
    rng = np.random.default_rng(3)
    z = rng.normal(size=(3, 11, 8)).astype(np.float32)
    c = rng.normal(size=(3, 1, 4)).astype(np.float32)
    lengths = np.array([11, 6, 1], np.int32)
    jm = JaxDecoder(arch)
    v = _init(jm, z, c)
    pm = _load(Decoder(arch), v)
    for n in (None, lengths):
        want = jm.apply(v, jnp.asarray(z), jnp.asarray(c),
                        None if n is None else jnp.asarray(n))
        got = pm(torch.from_numpy(z), torch.from_numpy(c),
                 None if n is None else torch.from_numpy(n))
        assert got.shape == (3, 22, 10)
        _close(got.detach().numpy(), want)
    assert list(Decoder.out_lengths(arch, lengths)) == [22, 12, 2]
    assert not got[1, 12:].any() and not got[2, 2:].any()
