"""The product rounding of the attention kernels' fp32 route (3xTF32),
emulated on the CPU inside the port's plain versions, against the JAX
package.

On the card, ``csrc/attention.cu`` runs an fp32 product on the tensor
cores as three TF32 products: each operand x is split into
``hi = rna_tf32(x)`` and ``lo = rna_tf32(x - hi)`` (round to nearest, ties
away from zero, 10 mantissa bits) and ``lo*hi + hi*lo + hi*hi`` is summed in
fp32. Here every matrix product of ``attention_plain`` and
``attention_backward_plain`` is taken that way (a ``TorchFunctionMode``
swaps them in), and the result is held against JAX's
``fused_attention(..., interpret=True)`` at the card's tolerances (fp32
forward 2e-5, gradients 3e-5, as
``tests/test_torch_port_tts_ops.py``). One TF32 product misses them,
which is why the kernel takes three.

What this shows is the split's arithmetic, not the card's margin: the
emulation sums in fp32 by the CPU's order and rounding, not the tensor
cores', and comes closer to JAX here than the card comes to the plain
version in ``chip_smoke.py``'s attention cases (up to 1.1e-5 of the peak).
The card's margin is that reading.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from vae_npvc_tpu.ops.attention_pallas import fused_attention as jax_fused
from vae_npvc_tpu_torch.ops.attention import (attention_backward_plain,
                                              attention_plain)

torch.set_num_threads(1)

FWD_TOL, GRAD_TOL = 2e-5, 3e-5


def rna_tf32(x):
    """fp32 -> TF32 as ``cvt.rna.tf32.f32``: add half of the 13 dropped
    bits' range to the magnitude (sign-magnitude, so ties go away from
    zero), then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mm_3xtf32(a, b):
    """``a @ b`` as the kernel's fp32 route: three TF32 products, small
    terms first, each exact in fp32 and summed in fp32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a, b):
    """One TF32 product: what the kernel would give without the split."""
    return rna_tf32(a) @ rna_tf32(b)


class Products(TorchFunctionMode):
    """Takes every ``@`` (``Tensor.matmul``) and ``torch.matmul`` by
    ``mm`` (the mode is off inside, so ``mm``'s own products are plain)."""

    def __init__(self, mm):
        super().__init__()
        self.mm = mm

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.matmul, torch.matmul):
            return self.mm(*args)
        return func(*args, **(kwargs or {}))


def _run(q, k, v, w, n, scale, mm):
    with Products(mm):
        o, lse = attention_plain(q, k, v, n, scale)
        return o, attention_backward_plain(q, k, v, o, lse, w, n, scale)


@pytest.fixture(scope="module")
def case():
    """The synthesizer's head dim (d = 96) with ragged lengths including 1,
    and JAX's output and gradients for a random cotangent."""
    B, H, T, d = 3, 2, 80, 96
    lengths = [80, 1, 37]
    rng = np.random.default_rng(4)
    q, k, v, w = (rng.normal(size=(B, H, T, d)).astype(np.float32)
                  for _ in range(4))
    n = jnp.asarray(lengths, jnp.int32)
    o, vjp = jax.vjp(lambda q, k, v: jax_fused(q, k, v, n, tile_q=128,
                                               interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(w))
    return {"inputs": [torch.from_numpy(a) for a in (q, k, v, w)]
            + [torch.tensor(lengths, dtype=torch.int32), 1.0 / np.sqrt(d)],
            "o": np.asarray(o), "grads": [np.asarray(g) for g in grads]}


def test_tf32_split_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 3.0e16,
                      -7.1e-20, 0.0], dtype=torch.float32)
    hi, lo = split_tf32(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    # a tie rounds away from zero; below half an ulp rounds down
    assert hi[0] == 1 + 2 ** -10 and hi[1] == -(1 + 2 ** -10)
    assert hi[2] == 1.0
    assert bool(((x - hi).abs() <= 2 ** -11 * x.abs()).all())
    # x - hi is exact in fp32, and lo keeps it to 11 significant bits
    y = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    yh, yl = split_tf32(y)
    err = (y.double() - yh.double() - yl.double()).abs()
    assert bool((err <= 2 ** -22 * y.double().abs()).all())


def test_3xtf32_forward_matches_jax_interpret(case):
    o, _ = _run(*case["inputs"], mm_3xtf32)
    np.testing.assert_allclose(o.numpy(), case["o"], rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_3xtf32_gradients_match_jax_interpret(case):
    _, grads = _run(*case["inputs"], mm_3xtf32)
    for a, b, name in zip(grads, case["grads"], "qkv"):
        np.testing.assert_allclose(a.numpy(), b, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name}")
    # masked keys get no gradient
    for g in grads[1:]:
        assert not g[1, :, 1:].any() and not g[2, :, 37:].any()


def test_single_tf32_misses_the_tolerance(case):
    o, grads = _run(*case["inputs"], mm_tf32)
    assert np.abs(o.numpy() - case["o"]).max() > 10 * FWD_TOL
    for a, b in zip(grads, case["grads"]):
        assert np.abs(a.numpy() - b).max() > 10 * GRAD_TOL


def test_3xtf32_huge_scores_stay_finite():
    rng = np.random.default_rng(14)
    q, k, v, w = (torch.from_numpy(rng.normal(size=(2, 2, 64, 32))
                                   .astype(np.float32)) for _ in range(4))
    n = torch.tensor([64, 1], dtype=torch.int32)
    scale = float(1.0 / np.sqrt(32))
    o, grads = _run(q * 1e16, k, v, w, n, scale, mm_3xtf32)
    assert torch.isfinite(o).all()
    assert all(torch.isfinite(g).all() for g in grads)
    # one-hot softmax rows: the plain version's value rows, to 22 bits
    want, _ = attention_plain(q * 1e16, k, v, n, scale)
    torch.testing.assert_close(o, want, atol=2e-5, rtol=0)
    torch.testing.assert_close(o[1], v[1, :, :1].expand_as(o[1]), atol=2e-5,
                               rtol=0)


def test_exact_products_give_the_plain_versions_bit_for_bit(case):
    """The mode changes the products and nothing else."""
    q, k, v, w, n, scale = case["inputs"]
    o, grads = _run(q, k, v, w, n, scale, torch.matmul)
    want_o, want_lse = attention_plain(q, k, v, n, scale)
    assert torch.equal(o, want_o)
    want = attention_backward_plain(q, k, v, want_o, want_lse, w, n, scale)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
