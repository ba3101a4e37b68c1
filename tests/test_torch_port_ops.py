"""PyTorch port ops vs the JAX package on the CPU (plain versions).

GroupNorm(+GLU) with masked statistics against ``nn/blocks.group_norm``
and the Pallas kernel in interpret mode; the fused VQ against
``vq_fused(..., interpret=True)`` and ``nearest_code``. Inputs are made
with numpy from a seed and fed to both. Tolerances: fp32 normalization
1e-5 absolute (summation order only); VQ ids and gathered codes exact,
cluster sums within 1e-6 of the summed magnitudes, counts exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_npvc_tpu.nn.blocks import group_norm as jax_group_norm
from vae_npvc_tpu.nn.blocks import length_mask as jax_length_mask
from vae_npvc_tpu.ops.groupnorm_pallas import fused_group_norm as jax_fused_gn
from vae_npvc_tpu.ops.vq import nearest_code as jax_nearest_code
from vae_npvc_tpu.ops.vq_pallas import vq_fused as jax_vq_fused
from vae_npvc_tpu_torch.nn.blocks import group_norm, length_mask
from vae_npvc_tpu_torch.ops import vq as port_vq
from vae_npvc_tpu_torch.ops.groupnorm import (fused_group_norm,
                                              group_norm_plain)
from vae_npvc_tpu_torch.ops.vq_fused import vq_fused, vq_fused_plain

torch.set_num_threads(1)


def _gn_inputs(seed, B=3, T=24, C=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.5, 2.0, size=(B, T, C)).astype(np.float32)
    scale = rng.normal(1.0, 0.3, size=C).astype(np.float32)
    bias = rng.normal(0.0, 0.3, size=C).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("G,glu", [(1, False), (2, False), (2, True),
                                   (1, True)])
def test_group_norm_matches_jax(G, glu, masked):
    x, scale, bias = _gn_inputs(G * 10 + glu)
    lengths = np.array([24, 13, 0], np.int32) if masked else None
    ref = jax_group_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), G,
        mask=None if lengths is None else jax_length_mask(
            jnp.asarray(lengths), x.shape[1]),
        glu=glu)
    got = group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                     torch.from_numpy(bias), G,
                     lengths=None if lengths is None
                     else torch.from_numpy(lengths), glu=glu)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    if masked:      # the all-masked row is zeros, not NaN
        assert np.all(got.numpy()[2] == 0.0)


@pytest.mark.parametrize("G,glu", [(1, False), (2, True)])
def test_group_norm_matches_pallas_interpret(G, glu):
    # the Pallas kernel's layout: C/G a multiple of 128, T a multiple of 16
    x, scale, bias = _gn_inputs(7, B=2, T=16, C=256)
    ref = jax_fused_gn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                       G, glu=glu, interpret=True)
    got = group_norm_plain(torch.from_numpy(x), torch.from_numpy(scale),
                           torch.from_numpy(bias), G, glu=glu)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_group_norm_wrapper_takes_plain_on_cpu():
    x, scale, bias = _gn_inputs(3)
    n0 = fused_group_norm.launches
    args = (torch.from_numpy(x), torch.from_numpy(scale),
            torch.from_numpy(bias), 2)
    lengths = torch.tensor([24, 5, 1])
    got = fused_group_norm(*args, lengths=lengths, glu=True)
    ref = group_norm_plain(*args, lengths=lengths, glu=True)
    assert torch.equal(got, ref)
    assert fused_group_norm.launches == n0     # no kernel on the CPU


def test_length_mask_matches_jax():
    lengths = np.array([5, 0, 9], np.int32)
    np.testing.assert_array_equal(
        length_mask(torch.from_numpy(lengths), 7).numpy(),
        np.asarray(jax_length_mask(jnp.asarray(lengths), 7)))


@pytest.mark.parametrize("N", [256, 700])
def test_vq_fused_plain_matches_pallas_interpret(N):
    rng = np.random.default_rng(N)
    z = rng.normal(size=(N, 32)).astype(np.float32)
    emb = rng.normal(size=(64, 32)).astype(np.float32)
    idx, zq, bsum, bcnt = (np.asarray(a) for a in jax_vq_fused(
        jnp.asarray(z), jnp.asarray(emb), interpret=True))
    got = vq_fused_plain(torch.from_numpy(z), torch.from_numpy(emb))
    np.testing.assert_array_equal(got.idx.numpy(), idx)
    np.testing.assert_array_equal(got.z_q.numpy(), zq)
    # sums: rtol 1e-6 of the summed magnitudes (a sum that cancels to ~0
    # keeps the rounding of its large terms, whatever the order)
    scale = np.eye(64, dtype=np.float64)[idx].T @ np.abs(z).astype(np.float64)
    assert np.all(np.abs(got.batch_sum.numpy() - bsum) <= 1e-6 * scale)
    np.testing.assert_array_equal(got.batch_elem.numpy(), bcnt)
    np.testing.assert_array_equal(
        got.idx.numpy(),
        np.asarray(jax_nearest_code(jnp.asarray(z), jnp.asarray(emb))))
    ids_only = vq_fused(torch.from_numpy(z), torch.from_numpy(emb),
                        stats=False)
    np.testing.assert_array_equal(ids_only.idx.numpy(), idx)
    assert ids_only.z_q is None and ids_only.batch_sum is None


def test_vq_ties_break_to_lowest_index():
    emb = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    z = torch.tensor([[0.5, 0.5], [2.0, 0.0]])
    assert vq_fused(z, emb, stats=False).idx.tolist() == [0, 0]


def test_ema_vq_encode_decode_match_jax():
    from vae_npvc_tpu.ops import vq as jvq

    rng = np.random.default_rng(5)
    z = rng.normal(size=(2, 9, 8)).astype(np.float32)
    emb = rng.normal(size=(16, 8)).astype(np.float32)
    jstate = jvq.EmaVqState(jnp.asarray(True), jnp.asarray(emb),
                            jnp.asarray(emb), jnp.ones((16,)))
    pstate = port_vq.EmaVqState(torch.tensor(True), torch.from_numpy(emb),
                                torch.from_numpy(emb), torch.ones(16))
    ids = port_vq.ema_vq_encode(pstate, torch.from_numpy(z))
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jvq.ema_vq_encode(jstate, jnp.asarray(z))))
    np.testing.assert_array_equal(
        port_vq.ema_vq_decode(pstate, ids).numpy(),
        np.asarray(jvq.ema_vq_decode(jstate, jnp.asarray(ids.numpy()))))
    for normalize in (False, True):
        pid = port_vq.vq_encode(torch.from_numpy(emb), torch.from_numpy(z),
                                normalize=normalize)
        np.testing.assert_array_equal(pid.numpy(), np.asarray(jvq.vq_encode(
            jnp.asarray(emb), jnp.asarray(z), normalize=normalize)))
        np.testing.assert_allclose(
            port_vq.vq_decode(torch.from_numpy(emb), pid,
                              normalize=normalize).numpy(),
            np.asarray(jvq.vq_decode(jnp.asarray(emb),
                                     jnp.asarray(pid.numpy()),
                                     normalize=normalize)), atol=1e-6)
