"""GroupNorm(+GLU) of the port on channels-first views, against JAX.

The convolutions hand GroupNorm a (B, T, C) view of (B, C, T) memory
(``WNConv1d`` computes ``F.conv1d(...).transpose(1, 2)``), and the
cotangent comes back in that layout or contiguous. The port's GroupNorm
reads both in place and returns the output and ``dx`` in x's memory order.
These tests feed such views to ``fused_group_norm`` and
``fused_group_norm_backward`` on the CPU (their plain versions) and hold
them against the JAX package's ``group_norm`` and against ``jax.grad`` of
its Pallas kernel in interpret mode, on the same numpy inputs. The last
test keeps the GroupNorm timing tool's source patch in step with the
kernel source.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_npvc_tpu.nn.blocks import group_norm as jax_group_norm
from vae_npvc_tpu.nn.blocks import length_mask as jax_length_mask
from vae_npvc_tpu.ops.groupnorm_pallas import fused_group_norm as jax_fused_gn
from vae_npvc_tpu_torch.ops.groupnorm import (fused_group_norm,
                                              fused_group_norm_backward)

torch.set_num_threads(1)


def _inputs(seed, B, T, C, glu):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 2.0, size=(B, T, C)).astype(np.float32)
    scale = rng.normal(1.0, 0.3, size=C).astype(np.float32)
    bias = rng.normal(0.0, 0.3, size=C).astype(np.float32)
    g = rng.normal(size=(B, T, C // 2 if glu else C)).astype(np.float32)
    return x, scale, bias, g


def _channels_first(a, dtype=torch.float32):
    """(B, T, C) values as a view of (B, C, T) memory, with the strides
    ``WNConv1d`` gives its output."""
    t = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1))).to(dtype)
    v = t.transpose(1, 2)
    B, T, C = v.shape
    assert v.stride() == (C * T, 1, T)
    return v


def _is_channels_first(t):
    B, T, C = t.shape
    return t.stride() == (C * T, 1, T)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("G,glu", [(1, False), (2, True), (3, False)])
def test_forward_on_channels_first_x_matches_jax(G, glu, masked):
    B, T, C = 3, 20, 12
    x, scale, bias, _ = _inputs(10 * G + glu, B, T, C, glu)
    lengths = np.array([20, 7, 0], np.int32) if masked else None
    mask = None if lengths is None else jax_length_mask(
        jnp.asarray(lengths), T)
    want = jax_group_norm(jnp.asarray(x), jnp.asarray(scale),
                          jnp.asarray(bias), G, mask=mask, glu=glu)
    got = fused_group_norm(
        _channels_first(x), torch.from_numpy(scale), torch.from_numpy(bias),
        G, lengths=None if lengths is None else torch.from_numpy(lengths),
        glu=glu)
    assert _is_channels_first(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("G,glu", [(1, False), (2, True)])
def test_channels_first_matches_pallas_interpret(G, glu):
    # the Pallas kernel's layout: C/G a multiple of 128, T a multiple of 16
    x, scale, bias, g = _inputs(G, 2, 16, 256, glu)
    js, jb = jnp.asarray(scale), jnp.asarray(bias)
    want = jax_fused_gn(jnp.asarray(x), js, jb, G, glu=glu, interpret=True)

    def f(x, s, b):
        y = jax_fused_gn(x, s, b, G, glu=glu, interpret=True)
        return jnp.sum(y * jnp.asarray(g))

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), js, jb)
    tx, tg = _channels_first(x), _channels_first(g)
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    out = fused_group_norm(tx, ts, tb, G, glu=glu)
    assert _is_channels_first(out)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)
    got = fused_group_norm_backward(tx, ts, tb, tg, G, glu=glu)
    assert _is_channels_first(got[0])
    for a, w in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5)


@pytest.mark.parametrize("g_channels_first", [False, True])
@pytest.mark.parametrize("G,glu", [(1, False), (2, True)])
def test_backward_layouts_match_jax_grad(G, glu, g_channels_first):
    """Channels-first x with a cotangent in either layout (a contiguous one
    is what ``ConvResStack``'s last norm receives), masked."""
    B, T, C = 3, 20, 12
    x, scale, bias, g = _inputs(7 + G, B, T, C, glu)
    lengths = np.array([20, 7, 0], np.int32)
    mask = jax_length_mask(jnp.asarray(lengths), T)

    def f(x, s, b):
        y = jax_group_norm(x, s, b, G, mask=mask, glu=glu)
        return jnp.sum(y * jnp.asarray(g))

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                         jnp.asarray(bias))
    tg = _channels_first(g) if g_channels_first else torch.from_numpy(g)
    got = fused_group_norm_backward(
        _channels_first(x), torch.from_numpy(scale), torch.from_numpy(bias),
        tg, G, lengths=torch.from_numpy(lengths), glu=glu)
    assert _is_channels_first(got[0])
    for a, w in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5)
    assert np.all(got[0].numpy()[1, 7:] == 0.0)
    assert np.all(got[0].numpy()[2] == 0.0)


def test_autograd_through_channels_first_bf16_keeps_the_layout():
    """bf16 autograd through the Function: output and dx in x's memory
    order, close to ``jax.grad`` of the stock ``group_norm``."""
    x, scale, bias, g = _inputs(4, 2, 16, 32, True)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    gb = jnp.asarray(g).astype(jnp.bfloat16)

    def f(x, s, b):
        y = jax_group_norm(x, s, b, 2, glu=True)
        return jnp.sum((y * gb).astype(jnp.float32))

    ref = jax.grad(f, argnums=(0, 1, 2))(xb, jnp.asarray(scale),
                                         jnp.asarray(bias))
    tx = _channels_first(x, torch.bfloat16).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    y = fused_group_norm(tx, ts, tb, 2, glu=True)
    assert _is_channels_first(y) and y.dtype == torch.bfloat16
    got = torch.autograd.grad(y, (tx, ts, tb), _channels_first(g, y.dtype))
    assert _is_channels_first(got[0])
    for a, w in zip(got, ref):
        w = np.asarray(w.astype(jnp.float32))
        assert np.abs(a.float().numpy() - w).max() <= 5e-2 * np.abs(w).max()


def test_timing_tool_patterns_are_in_the_kernel_source():
    """``tools/torch_gn_time.py --without-barriers`` builds a copy of
    ``csrc/groupnorm.cu`` by replacing these strings; each must still be
    there."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "torch_gn_time", root / "tools" / "torch_gn_time.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (root / "vae_npvc_tpu_torch" / "csrc" / "groupnorm.cu").read_text()
    assert tool.NO_BARRIER
    for old, _ in tool.NO_BARRIER:
        assert old in src, old
