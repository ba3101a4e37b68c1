"""PyTorch port attention op and transformer building blocks vs the JAX
package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
the port. The JAX side runs the Pallas attention kernel as its own tests do,
in interpret mode (``fused_attention(..., tile_q=128, interpret=True)``,
``fused="interpret"``); the port's wrapper takes its plain version, as it
does for every CPU tensor. Tolerances are the JAX tests' own
(``tests/test_attention_pallas.py``): fp32 forward 2e-5, gradients 3e-5
(summation order only), bf16 forward 2e-2 and gradients 5e-2 of the fp32
oracle; modules 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_npvc_tpu.models.token_tts import TransformerBlock as JaxBlock
from vae_npvc_tpu.nn import blocks as jblocks
from vae_npvc_tpu.nn import gst as jgst
from vae_npvc_tpu.ops.attention_pallas import fused_attention as jax_fused
from vae_npvc_tpu.ops.attention_pallas import reference_attention
from vae_npvc_tpu_torch.models.token_tts import TransformerBlock
from vae_npvc_tpu_torch.nn import blocks, gst
from vae_npvc_tpu_torch.ops.attention import (attention_backward_plain,
                                              attention_plain,
                                              fused_attention,
                                              fused_attention_backward)
from vae_npvc_tpu_torch.utils.bridge import _flatten, from_jax_variables

torch.set_num_threads(1)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_attn(q, k, v, lengths, dtype=jnp.float32):
    n = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    return jax_fused(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)), n,
                     tile_q=128, interpret=True)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _lengths(lengths):
    return None if lengths is None else torch.tensor(lengths,
                                                     dtype=torch.int32)


# ------------------------------------------------------------- attention op
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("B,H,T,d", [(2, 2, 64, 32), (1, 4, 100, 96),
                                     (3, 1, 257, 48)])
def test_attention_forward_matches_jax_interpret(B, H, T, d, masked):
    q, k, v = (_rand((B, H, T, d), s) for s in (0, 1, 2))
    lengths = (np.random.default_rng(3).integers(1, T + 1, size=(B,))
               .tolist() if masked else None)
    want = np.asarray(_jax_attn(q, k, v, lengths))
    n0 = fused_attention.launches
    got = fused_attention(_t(q), _t(k), _t(v), _lengths(lengths))
    assert fused_attention.launches == n0        # the CPU launches nothing
    assert got.shape == (B, H, T, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_attention_takes_strided_views_and_clamps_lengths():
    """(B, H, T, d) views of a (B, T, H*d) projection, and a length of 0,
    which counts as 1 as in the JAX wrapper."""
    B, H, T, d = 2, 2, 40, 16
    q, k, v = (_rand((B, T, H * d), s) for s in (40, 41, 42))
    views = [_t(a).reshape(B, T, H, d).transpose(1, 2) for a in (q, k, v)]
    jviews = [a.reshape(B, T, H, d).transpose(0, 2, 1, 3) for a in (q, k, v)]
    want = np.asarray(_jax_attn(*jviews, [0, 33]))
    got = fused_attention(*views, _lengths([0, 33]))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # one valid key: every query row is that key's value row
    np.testing.assert_allclose(got[0].numpy(),
                               np.broadcast_to(jviews[2][0][:, :1],
                                               (H, T, d)), atol=1e-6)


def test_attention_gradients_match_jax_interpret():
    B, H, T, d = 2, 2, 96, 32
    q, k, v, w = (_rand((B, H, T, d), s) for s in (7, 8, 9, 10))
    lengths = [50, 96]
    qmask = (np.arange(T)[None, None, :, None]
             < np.asarray(lengths)[:, None, None, None]).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(_jax_attn(q, k, v, lengths) * w * qmask)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = fused_attention(tq, tk, tv, _lengths(lengths))
    got = torch.autograd.grad((out * _t(w * qmask)).sum(), (tq, tk, tv))
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-5,
                                   atol=3e-5, err_msg=f"d{name}")
    # masked keys get no gradient
    assert not got[1][0, :, 50:].any() and not got[2][0, :, 50:].any()


def test_attention_bf16_tracks_jax_and_the_fp32_oracle():
    B, H, T, d = 2, 2, 64, 32
    q, k, v, w = (_rand((B, H, T, d), s) for s in (30, 31, 32, 33))
    lengths = [40, 64]
    qmask = (np.arange(T)[None, None, :, None]
             < np.asarray(lengths)[:, None, None, None]).astype(np.float32)
    bq, bk, bv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    f32 = [np.asarray(a.astype(jnp.float32)) for a in (bq, bk, bv)]
    oracle = np.asarray(reference_attention(*map(jnp.asarray, f32),
                                            jnp.asarray(lengths)))
    g_oracle = jax.grad(lambda q, k, v: jnp.sum(reference_attention(
        q, k, v, jnp.asarray(lengths)) * w * qmask), argnums=(0, 1, 2))(
            *map(jnp.asarray, f32))

    def loss(q, k, v):
        return jnp.sum(jax_fused(q, k, v, jnp.asarray(lengths, jnp.int32),
                                 tile_q=128, interpret=True)
                       .astype(jnp.float32) * w * qmask)

    jout = np.asarray(jax_fused(bq, bk, bv, jnp.asarray(lengths, jnp.int32),
                                tile_q=128, interpret=True)
                      .astype(jnp.float32))
    jgrads = jax.grad(loss, argnums=(0, 1, 2))(bq, bk, bv)

    tq, tk, tv = (_t(a, torch.bfloat16).requires_grad_(True) for a in f32)
    out = fused_attention(tq, tk, tv, _lengths(lengths))
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad((out.float() * _t(w * qmask)).sum(),
                                (tq, tk, tv))
    got = out.detach().float().numpy()
    np.testing.assert_allclose(got, oracle, rtol=2e-2, atol=2e-2)
    # against the JAX kernel in bf16: the same rounding points, so one bf16
    # ulp (2^-7 relative) at most
    np.testing.assert_allclose(got, jout, rtol=2 ** -7, atol=2 ** -9)
    for a, b, c, name in zip(grads, g_oracle, jgrads, "qkv"):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   rtol=5e-2, atol=5e-2, err_msg=f"d{name}")
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(c.astype(jnp.float32)),
            rtol=2 ** -6, atol=2 ** -7, err_msg=f"d{name} vs JAX bf16")


def test_attention_huge_scores_stay_finite():
    q = _rand((1, 1, 128, 32), 14) * 1e16
    k, v = _rand((1, 1, 128, 32), 15), _rand((1, 1, 128, 32), 16)
    want = np.asarray(_jax_attn(q, k, v, None))
    tq = _t(q).requires_grad_(True)
    out = fused_attention(tq, _t(k), _t(v))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.detach().numpy(), want, atol=2e-5)
    (g,) = torch.autograd.grad(out.sum(), (tq,))
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("lengths", [[17, 48, 1], None])
def test_attention_backward_plain_equals_autograd(lengths):
    B, H, T, d = 3, 2, 48, 16
    q, k, v, do = (_t(_rand((B, H, T, d), s)) for s in (50, 51, 52, 53))
    n = _lengths(lengths)
    qa, ka, va = (a.clone().requires_grad_(True) for a in (q, k, v))
    o, lse = attention_plain(qa, ka, va, n)
    want = torch.autograd.grad(o, (qa, ka, va), do)
    got = attention_backward_plain(q, k, v, o.detach(), lse.detach(), do, n)
    also = fused_attention_backward(q, k, v, o.detach(), lse.detach(), do, n)
    for a, b, c in zip(got, want, also):
        torch.testing.assert_close(a, b, atol=2e-6, rtol=1e-5)
        assert torch.equal(a, c)
    # the saved log-sum-exp is that of the masked scores
    s = (q @ k.transpose(-1, -2)) / d ** 0.5
    if lengths is not None:
        keep = torch.arange(T)[None, :] < torch.tensor(lengths)[:, None]
        s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
    torch.testing.assert_close(lse.detach().reshape(B, H, T),
                               torch.logsumexp(s, dim=-1), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------------ modules
def test_sinusoidal_positions_match_jax():
    for length, dim in ((24, 32), (96, 48), (5, 6)):
        got = blocks.sinusoidal_positions(length, dim)
        want = np.asarray(jblocks.sinusoidal_positions(length, dim))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # sin on the even columns, cos on the odd ones
    assert float(got[0, 0]) == 0.0 and float(got[0, 1]) == 1.0


def _load(module, params):
    """Bridge a flax parameter tree (numpy) into a port module."""
    module.load_state_dict(from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, params)}), strict=True)
    return module


def _perturbed(params, seed):
    """The flax init leaves biases at 0 and LayerNorm scales at 1: move
    every leaf so a swapped or dropped parameter shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape))
        .astype(np.float32), params)


def test_layer_norm_and_dense_and_embed_match_flax():
    import flax.linen as nn

    x = _rand((3, 7, 32), 60) * 3 + 1
    ln = nn.LayerNorm(dtype=jnp.float32)
    p = _perturbed(ln.init(jax.random.PRNGKey(0), x)["params"], 61)
    want = np.asarray(ln.apply({"params": p}, x))
    mod = _load(blocks.LayerNorm(32), p)
    assert mod.eps == 1e-6
    np.testing.assert_allclose(mod(_t(x)).detach().numpy(), want, atol=1e-5)
    # bf16 input: statistics and output stay fp32
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = ln.apply({"params": p}, xb)
    gb = mod(_t(np.asarray(xb.astype(jnp.float32)), torch.bfloat16))
    assert gb.dtype == torch.float32 and wb.dtype == jnp.float32
    np.testing.assert_allclose(gb.detach().numpy(), np.asarray(wb), atol=1e-5)

    dense = nn.Dense(20)
    p = _perturbed(dense.init(jax.random.PRNGKey(1), x)["params"], 62)
    mod = _load(blocks.Dense(32, 20), p)
    np.testing.assert_allclose(mod(_t(x)).detach().numpy(),
                               np.asarray(dense.apply({"params": p}, x)),
                               atol=1e-5)
    idx = np.array([[0, 3, 9], [9, 9, 1]], np.int32)
    emb = nn.Embed(10, 6)
    p = jax.tree_util.tree_map(np.asarray, emb.init(jax.random.PRNGKey(2),
                                                    idx)["params"])
    mod = _load(blocks.Embed(10, 6), p)
    np.testing.assert_array_equal(mod(torch.from_numpy(idx)).detach().numpy(),
                                  np.asarray(emb.apply({"params": p}, idx)))


@pytest.mark.parametrize("route", ["fused", "never", "mask", "cross"])
def test_multi_headed_attention_routes_match_jax(route):
    B, T, F = 2, 24, 32
    x = _rand((B, T, F), 70)
    lengths = np.array([24, 9], np.int32)
    fused = "never" if route == "never" else "interpret"
    jm = jgst.MultiHeadedAttention(2, F, fused=fused)
    kw, pkw, mem = {}, {}, x
    if route in ("fused", "never"):
        kw = {"lengths": jnp.asarray(lengths)}
        pkw = {"lengths": torch.from_numpy(lengths)}
    elif route == "mask":
        m = np.arange(T)[None, None, :] < lengths[:, None, None]
        kw, pkw = {"mask": jnp.asarray(m)}, {"mask": torch.from_numpy(m)}
    else:                   # distinct key length: the stock math, unmasked
        mem = _rand((B, 10, F), 71)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), x, mem, mem,
                           **kw)["params"], 72)
    want = np.asarray(jm.apply({"params": p}, x, mem, mem, **kw))
    pm = _load(gst.MultiHeadedAttention(2, F, fused="never" if route == "never"
                                        else "auto"), p)
    got = pm(_t(x), _t(mem), _t(mem), **pkw)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4)
    with pytest.raises(ValueError, match="fused"):
        gst.MultiHeadedAttention(2, F, fused="sometimes")


def test_style_token_layer_matches_jax():
    ref = _rand((3, 16), 80)
    jm = jgst.StyleTokenLayer(ref_embed_dim=16, gst_tokens=5,
                              gst_token_dim=32, gst_heads=4)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), ref)["params"], 81)
    want = np.asarray(jm.apply({"params": p}, ref))
    pm = _load(gst.StyleTokenLayer(16, 5, 32, 4), p)
    got = pm(_t(ref))
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4)


@pytest.mark.parametrize("fused", ["interpret", "never"])
def test_transformer_block_output_and_gradients_match_jax(fused):
    B, T, D = 2, 40, 32
    lengths = jnp.asarray([25, 40], jnp.int32)
    mask = np.asarray(jblocks.length_mask(lengths, T))
    x = _rand((B, T, D), 90) * mask
    w = _rand((B, T, D), 91) * mask
    jm = JaxBlock(D, 2, 64, fused_attention=fused)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), x, mask)["params"], 92)

    def loss(p, x):
        return jnp.sum(jm.apply({"params": p}, x, mask) * w)

    want = np.asarray(jm.apply({"params": p}, x, mask))
    jg, jgx = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))
    pm = _load(TransformerBlock(D, 2, 64, fused_attention="never"
                                if fused == "never" else "auto"), p)
    tx = _t(x).requires_grad_(True)
    out = pm(tx, _t(mask))
    np.testing.assert_allclose(out.detach().numpy() * mask, want * mask,
                               atol=1e-4)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad((out * _t(w)).sum(),
                                [tx] + list(pm.parameters()))
    flat = {}
    _flatten(jax.tree_util.tree_map(np.asarray, jg), "", flat)
    assert set(flat) == set(names) and len(names) == 16
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), atol=1e-4)
    # relative to the largest gradient: the key bias's gradient is zero in
    # exact arithmetic (a softmax does not see a shift of its scores)
    peak = max(float(np.abs(v).max()) for v in flat.values())
    for name, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), flat[name], atol=1e-4 * peak,
                                   err_msg=name)
