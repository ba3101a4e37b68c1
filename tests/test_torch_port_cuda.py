"""Port kernels against their plain PyTorch versions on the GPU.

These tests need a CUDA card and ``nvcc``; elsewhere they skip. They import
no JAX, so on a GPU host without JAX run them without the JAX test
configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import contextlib

import numpy as np
import pytest
import torch

from vae_npvc_tpu_torch.ops.attention import (attention_backward_plain,
                                              attention_plain,
                                              fused_attention,
                                              fused_attention_backward)
from vae_npvc_tpu_torch.ops.groupnorm import (fused_group_norm,
                                              fused_group_norm_backward,
                                              group_norm_backward_plain,
                                              group_norm_plain,
                                              group_norm_split_apply,
                                              group_norm_split_stats,
                                              group_norm_split_stats_plain,
                                              plan)
from vae_npvc_tpu_torch.ops.vq_fused import vq_fused, vq_fused_plain

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _near_tie_free(z, emb, rel=1e-5):
    """Rows whose two best distances differ by more than ``rel``*|d|."""
    d = ((emb.double() ** 2).sum(1)[None] - 2 * z.double() @ emb.double().T)
    if d.shape[1] < 2:
        return torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
    top2 = torch.topk(d, 2, dim=1, largest=False).values
    return (top2[:, 1] - top2[:, 0]) > rel * top2[:, 0].abs().clamp(min=1.0)


@pytest.mark.parametrize("N,stats", [(2048, False), (4096, False),
                                     (256, False), (32768, True),
                                     (1000, True), (65, True)])
def test_vq_kernel_matches_plain(dev, N, stats):
    rng = np.random.default_rng(N)
    z = torch.tensor(rng.normal(size=(N, 128)), dtype=torch.float32,
                     device=dev)
    emb = torch.tensor(rng.normal(size=(512, 128)), dtype=torch.float32,
                       device=dev)
    got = vq_fused(z, emb, stats=stats)
    ref = vq_fused_plain(z, emb, stats=stats)
    torch.cuda.synchronize()
    ok = _near_tie_free(z, emb)
    assert torch.equal(got.idx[ok], ref.idx[ok])
    if stats:
        same = got.idx == ref.idx
        assert torch.equal(got.z_q[same], ref.z_q[same])
        # counts are exact; sums differ only by summation order
        ids = got.idx.long()
        cnt = torch.bincount(ids, minlength=512).float()
        assert torch.equal(got.batch_elem, cnt)
        abs_sum = torch.zeros_like(got.batch_sum).index_add_(0, ids, z.abs())
        ref_sum = torch.zeros_like(got.batch_sum, dtype=torch.float64) \
            .index_add_(0, ids, z.double())
        assert ((got.batch_sum.double() - ref_sum).abs()
                <= 1e-5 * abs_sum.double() + 1e-6).all()


def _vq_case(N, K, D, seed, kind="random"):
    """numpy inputs of the K1 tests: ``random`` rows and codes;
    ``near_tie`` rows at the midpoint of a code and its nearest other
    code, nudged by a few ulps (the two best distances within fp32
    rounding); ``duplicate`` codebooks whose rows repeat (twice, and one
    row three times), rows near the repeated codes (exact ties)."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(K, D)).astype(np.float32)
    if kind == "random":
        return rng.normal(size=(N, D)).astype(np.float32), emb
    if kind == "duplicate":
        emb[K // 2:] = emb[:K - K // 2]
        emb[K - 1] = emb[0]
        a = rng.integers(0, K, size=N)
        a[::7] = 0
        z = emb[a] + 0.05 * rng.normal(size=(N, D)).astype(np.float32)
        return z.astype(np.float32), emb
    e64 = emb.astype(np.float64)
    d = ((e64[:, None] - e64[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    a = rng.integers(0, K, size=N)
    mid = ((e64[a] + e64[d[a].argmin(1)]) / 2).astype(np.float32)
    ulps = rng.integers(-3, 4, size=(N, D)).astype(np.float32)
    z = mid + ulps * np.spacing(np.abs(mid)).astype(np.float32)
    return z.astype(np.float32), emb


def _vq_margin(z, emb):
    """The kernel's re-scoring margin per row (csrc/vq.cu): a bound on the
    fp32 rounding of a distance, used here as the tolerance on the fp64
    distance a near-tie choice may lose."""
    D = z.shape[1]
    emax = float(emb.double().norm(dim=1).max())
    return 2.0 ** -20 * ((D + 8) * z.double().norm(dim=1) * emax + emax ** 2)


def _vq_check(dev, z, emb, stats):
    """Run the kernel twice; hold it against the plain version and fp64
    distances; return the first result."""
    got = vq_fused(z, emb, stats=stats)
    res = vq_fused.rescored.clone()
    again = vq_fused(z, emb, stats=stats)
    ref = vq_fused_plain(z, emb, stats=stats)
    torch.cuda.synchronize()
    assert torch.equal(vq_fused.rescored, res)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    N, K = z.shape[0], emb.shape[0]
    d64 = ((emb.double() ** 2).sum(1)[None]
           - 2 * z.double() @ emb.double().T)
    rows = torch.arange(N, device=dev)
    assert bool(((got.idx >= 0) & (got.idx < K)).all())
    lost = d64[rows, got.idx.long()] - d64.min(1).values
    assert bool((lost <= _vq_margin(z, emb)).all()), float(lost.max())
    ok = _near_tie_free(z, emb)
    assert torch.equal(got.idx[ok], ref.idx[ok])
    if stats:
        assert torch.equal(got.z_q, emb[got.idx.long()])
        ids = got.idx.long()
        assert torch.equal(got.batch_elem,
                           torch.bincount(ids, minlength=K).float())
        exact = torch.zeros((K, z.shape[1]), dtype=torch.float64,
                            device=dev).index_add_(0, ids, z.double())
        scale = torch.zeros_like(exact).index_add_(0, ids, z.double().abs())
        assert bool(((got.batch_sum.double() - exact).abs()
                     <= 1e-5 * scale + 1e-6).all())
    else:
        assert got.z_q is None and got.batch_sum is None
    return got, int(res[0].sum())


# the recipes' codebooks (egs/*/*/conf/*.yaml), a ragged N, N = 1, K not a
# multiple of a rank's share, D that needs padding to the MMA's k step
VQ_SHAPES = [(512, 128), (128, 128), (64, 32), (100, 128), (3, 8), (1, 16),
             (77, 37), (300, 20)]


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("K,D", VQ_SHAPES)
@pytest.mark.parametrize("N", [1, 130, 4099])
def test_vq_kernel_shapes(dev, N, K, D, stats):
    z, emb = (torch.from_numpy(a).to(dev)
              for a in _vq_case(N, K, D, N + K + D))
    _vq_check(dev, z, emb, stats)


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("K,D", [(512, 128), (128, 128), (64, 32)])
def test_vq_kernel_near_ties(dev, K, D, stats):
    """Rows within a few ulps of the midpoint of two codes: the kernel
    re-scores them in exact fp32 and loses at most fp32 rounding of the
    fp64 best distance."""
    z, emb = (torch.from_numpy(a).to(dev)
              for a in _vq_case(2048, K, D, K + D, "near_tie"))
    _, rescored = _vq_check(dev, z, emb, stats)
    assert rescored > 0


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("K,D", [(512, 128), (128, 128), (64, 32)])
def test_vq_kernel_duplicate_codes_take_the_lowest_index(dev, K, D, stats):
    z, emb = (torch.from_numpy(a).to(dev)
              for a in _vq_case(3000, K, D, K * D, "duplicate"))
    got, rescored = _vq_check(dev, z, emb, stats)
    # every code equals a lower-indexed one from K - K//2 on
    assert int(got.idx.max()) < K - K // 2
    assert rescored >= int((got.idx == 0).sum())


def test_vq_kernel_refuses_what_it_does_not_take(dev):
    z = torch.ones((4, 8), device=dev)
    with pytest.raises(TypeError):
        vq_fused(z.double(), z.double())
    with pytest.raises(ValueError, match="does not fit"):
        vq_fused(torch.ones((4, 4096), device=dev),
                 torch.ones((8, 4096), device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("C,G,glu", [(512, 1, False), (1024, 2, True),
                                     (96, 3, False)])
def test_groupnorm_kernel_matches_plain(dev, dtype, masked, C, G, glu):
    rng = np.random.default_rng(C + G)
    B, T = 8, 256
    x = torch.tensor(rng.normal(2.0, 3.0, size=(B, T, C)), device=dev) \
        .to(dtype)
    scale = torch.tensor(rng.normal(1.0, 0.2, size=C), dtype=torch.float32,
                         device=dev)
    bias = torch.tensor(rng.normal(0.0, 0.2, size=C), dtype=torch.float32,
                        device=dev)
    lengths = (torch.tensor([256, 1, 0, 17, 100, 255, 128, 200],
                            dtype=torch.int32, device=dev)
               if masked else None)
    got = fused_group_norm(x, scale, bias, G, lengths=lengths, glu=glu)
    ref = group_norm_plain(x, scale, bias, G, lengths=lengths, glu=glu)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    else:
        # two bf16 roundings may land one ulp apart (2^-8 relative)
        torch.testing.assert_close(got.float(), ref.float(), atol=2 ** -7,
                                   rtol=2 ** -6)


@pytest.mark.parametrize("B,C,G,glu,lengths", [
    (8, 1024, 2, True, [512, 300, 511, 257, 1, 450, 512, 512]),
    (1, 512, 1, False, [397])])
def test_groupnorm_kernel_512_bucket(dev, B, C, G, glu, lengths):
    """The serving path's 512-frame bucket: 64 statistics chunks a row."""
    rng = np.random.default_rng(B + C)
    T = 512
    x = torch.tensor(rng.normal(2.0, 3.0, size=(B, T, C)), device=dev) \
        .to(torch.bfloat16)
    scale = torch.tensor(rng.normal(1.0, 0.2, size=C), dtype=torch.float32,
                         device=dev)
    bias = torch.tensor(rng.normal(0.0, 0.2, size=C), dtype=torch.float32,
                        device=dev)
    n = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = fused_group_norm(x, scale, bias, G, lengths=n, glu=glu)
    ref = group_norm_plain(x, scale, bias, G, lengths=n, glu=glu)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    torch.testing.assert_close(got.float(), ref.float(), atol=2 ** -7,
                               rtol=2 ** -6)


def _assert_gn_backward(got, ref, dtype):
    """Tolerances relative to each output's peak: fp32 differs from the
    plain version by summation order only (dx 2e-5, the 32k-frame parameter
    sums 1e-4); bf16 dx may also land one bf16 ulp (2^-7 relative) apart."""
    for name, a, b in zip(("dx", "dscale", "dbias"), got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        a, b = a.float(), b.float()
        peak = float(b.abs().max()) or 1.0
        if name == "dx" and dtype == torch.bfloat16:
            tol = 1e-4 * peak + 2 ** -7 * b.abs()
        else:
            tol = (2e-5 if name == "dx" else 1e-4) * peak
        assert bool(((a - b).abs() <= tol).all()), (
            name, float((a - b).abs().max()), peak)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C,G,glu,lengths", [
    (128, 256, 512, 1, False, None),
    (128, 256, 1024, 2, True, None),
    (8, 512, 1024, 2, True, [512, 300, 511, 257, 1, 450, 0, 512]),
    (1, 512, 512, 1, False, [397]),
    (3, 77, 96, 3, False, [77, 5, 40]),
    (3, 77, 96, 1, True, None)])
def test_groupnorm_backward_kernel_matches_plain(dev, dtype, B, T, C, G, glu,
                                                 lengths):
    rng = np.random.default_rng(B + T + C)
    x = torch.tensor(rng.normal(0.5, 2.0, size=(B, T, C)), device=dev) \
        .to(dtype)
    scale = torch.tensor(rng.normal(1.0, 0.2, size=C), dtype=torch.float32,
                         device=dev)
    bias = torch.tensor(rng.normal(0.0, 0.2, size=C), dtype=torch.float32,
                        device=dev)
    # a non-contiguous cotangent, as a conv's backward hands over
    g = torch.tensor(rng.normal(size=(B, C // 2 if glu else C, T)),
                     device=dev).to(dtype).transpose(1, 2)
    n = (torch.tensor(lengths, dtype=torch.int32, device=dev)
         if lengths else None)
    n0 = fused_group_norm_backward.launches
    got = fused_group_norm_backward(x, scale, bias, g, G, lengths=n, glu=glu)
    again = fused_group_norm_backward(x, scale, bias, g, G, lengths=n,
                                      glu=glu)
    ref = group_norm_backward_plain(x, scale, bias, g, G, lengths=n, glu=glu)
    torch.cuda.synchronize()
    assert fused_group_norm_backward.launches == n0 + 2
    _assert_gn_backward(got, ref, dtype)
    for a, b in zip(got, again):        # fixed summation order: same bits
        assert torch.equal(a, b)
    if n is not None:
        pad = torch.arange(T, device=dev)[None] >= n[:, None]
        assert bool((got[0][pad] == 0).all())


def test_groupnorm_function_backward_on_the_card(dev):
    """autograd through the wrapper launches K2 then K3 and agrees with the
    plain analytic backward."""
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.normal(size=(4, 64, 256)), dtype=torch.float32,
                     device=dev, requires_grad=True)
    scale = torch.tensor(rng.normal(1.0, 0.2, size=256), dtype=torch.float32,
                         device=dev, requires_grad=True)
    bias = torch.zeros(256, device=dev, requires_grad=True)
    f0, b0 = fused_group_norm.launches, fused_group_norm_backward.launches
    y = fused_group_norm(x, scale, bias, 2, glu=True)
    g = torch.tensor(rng.normal(size=tuple(y.shape)), dtype=torch.float32,
                     device=dev)
    got = torch.autograd.grad(y, (x, scale, bias), g)
    assert fused_group_norm.launches == f0 + 1
    assert fused_group_norm_backward.launches == b0 + 1
    ref = group_norm_backward_plain(x.detach(), scale.detach(), bias.detach(),
                                    g, 2, glu=True)
    _assert_gn_backward(got, ref, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("glu", [False, True])
def test_groupnorm_sum_backward_takes_a_stride0_cotangent(dev, dtype, glu):
    """``.sum().backward()`` hands the backward a cotangent with all
    strides 0; the Function makes it contiguous and launches K3. Held
    against autograd through the plain version, except bf16 with the GLU,
    where autograd takes the gate's derivative from the bf16-rounded y and
    the contract (ops/groupnorm.py) from the unrounded one: there against
    the plain analytic backward for a cotangent of ones."""
    rng = np.random.default_rng(11)
    B, T, C = 3, 40, 64
    x0 = torch.tensor(rng.normal(1.0, 2.0, size=(B, T, C)), device=dev) \
        .to(dtype)
    s0 = torch.tensor(rng.normal(1.0, 0.2, size=C), dtype=torch.float32,
                      device=dev)
    b0 = torch.tensor(rng.normal(0.0, 0.2, size=C), dtype=torch.float32,
                      device=dev)
    n = torch.tensor([40, 17, 1], dtype=torch.int32, device=dev)
    grads = []
    for fn in (fused_group_norm, group_norm_plain):
        x, s, b = (t.clone().requires_grad_(True) for t in (x0, s0, b0))
        k0 = fused_group_norm_backward.launches
        fn(x, s, b, 2, lengths=n, glu=glu).sum().backward()
        if fn is fused_group_norm:
            assert fused_group_norm_backward.launches == k0 + 1
        grads.append((x.grad, s.grad, b.grad))
    if dtype == torch.bfloat16 and glu:
        ones = torch.ones((B, T, C // 2), dtype=dtype, device=dev)
        grads[1] = group_norm_backward_plain(x0, s0, b0, ones, 2, lengths=n,
                                             glu=True)
    torch.cuda.synchronize()
    _assert_gn_backward(*grads, dtype)


def test_wrappers_count_launches(dev):
    x = torch.ones((1, 16, 8), device=dev)
    s = torch.ones(8, device=dev)
    n0 = fused_group_norm.launches
    fused_group_norm(x, s, s * 0, 1)
    assert fused_group_norm.launches == n0 + 1
    v0 = vq_fused.launches
    vq_fused(torch.ones((4, 8), device=dev), torch.ones((3, 8), device=dev),
             stats=False)
    assert vq_fused.launches == v0 + 1


def test_wrappers_record_spans_when_on(dev):
    from vae_npvc_tpu_torch.utils import spans

    x = torch.randn((2, 16, 8), device=dev, requires_grad=True)
    s = torch.ones(8, device=dev)
    rng = np.random.default_rng(7)
    z = torch.tensor(rng.normal(size=(1000, 128)), dtype=torch.float32,
                     device=dev)
    emb = torch.tensor(rng.normal(size=(512, 128)), dtype=torch.float32,
                       device=dev)
    spans.drain()
    spans.enable(True, device=True)
    try:
        with spans.span("step"):
            fused_group_norm(x, s, s * 0, 1).sum().backward()
            vq_fused(z, emb, stats=True)
        torch.cuda.synchronize()
        got = spans.drain()
    finally:
        spans.enable(False)
    by = {sp.name: sp for sp in got["spans"]}
    assert set(by) == {"step", "op.gn_fwd", "op.gn_bwd", "op.vq"}
    # K3 runs on autograd's device thread, under the enabling thread's span
    assert all(by[n].parent == by["step"].id for n in by if n != "step")
    ((name, ms, rescored),) = got["device"]
    assert name == "dev.vq" and ms > 0
    assert rescored == int(vq_fused.rescored.sum())
    assert got["drops"] == 0


# ------------------------------------------- K2's split statistics
def _split_row(x, lengths, R):
    """The (B, T, C) row cut into R pieces along T, each with its local
    valid lengths."""
    T = x.shape[1]
    edges = [T * r // R for r in range(R + 1)]
    out = []
    for a, b in zip(edges[:-1], edges[1:]):
        n = None if lengths is None else (lengths - a).clamp(0, b - a) \
            .to(torch.int32)
        out.append((x[:, a:b], n))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("C,G,glu", [(512, 1, False), (1024, 2, True),
                                     (1024, 2, False)])
@pytest.mark.parametrize("R,cf", [(2, False), (3, True)])
def test_groupnorm_split_matches_the_whole_row(dev, dtype, masked, C, G, glu,
                                               R, cf):
    """Partials of R pieces of a row, merged in order by the apply
    kernel, against the plain two-pass GroupNorm of the whole row."""
    rng = np.random.default_rng(C + G + R)
    B, T = 2, 1536
    x = torch.tensor(rng.normal(2.0, 3.0, size=(B, T, C)), device=dev) \
        .to(dtype)
    if cf:
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    scale = torch.tensor(rng.normal(1.0, 0.2, size=C), dtype=torch.float32,
                         device=dev)
    bias = torch.tensor(rng.normal(0.0, 0.2, size=C), dtype=torch.float32,
                        device=dev)
    lengths = (torch.tensor([T, 700], dtype=torch.int32, device=dev)
               if masked else None)
    pieces = _split_row(x, lengths, R)
    parts = [group_norm_split_stats(xp, G, n) for xp, n in pieces]
    for (xp, n), p in zip(pieces, parts):
        ref_p = group_norm_split_stats_plain(xp, G, n)
        torch.testing.assert_close(p[..., 0], ref_p[..., 0], atol=0, rtol=0)
        torch.testing.assert_close(p[..., 1:], ref_p[..., 1:], atol=1e-4,
                                   rtol=1e-5)
    gathered = torch.stack(parts, dim=2)                 # (B, G, R, 3)
    got = torch.cat([group_norm_split_apply(xp, scale, bias, gathered, G,
                                            lengths=n, glu=glu)
                     for xp, n in pieces], dim=1)
    ref = group_norm_plain(x, scale, bias, G, lengths=lengths, glu=glu)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=2 ** -7,
                                   rtol=2 ** -6)


def _split_stats_f64(x, G, lengths):
    """(B, G, 3) count, mean and centred sum of squares in float64."""
    B, T, C = x.shape
    xf = x.double().reshape(B, T, G, C // G)
    n = torch.full((B,), T, device=x.device) if lengths is None else lengths
    m = (torch.arange(T, device=x.device)[None] < n[:, None]).double()
    m = m[:, :, None, None]
    cnt = (m.sum(dim=(1, 3)) * (C // G)).expand(B, G)
    mean = (xf * m).sum(dim=(1, 3)) / cnt.clamp(min=1)
    m2 = ((xf - mean[:, None, :, None]).square() * m).sum(dim=(1, 3))
    return cnt, mean, m2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,G,glu", [(256, 1, False), (512, 2, True),
                                     (512, 2, False)])
@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("cf", [False, True])
@pytest.mark.parametrize("T", [1024, 1003])
def test_groupnorm_split_pair_against_float64_and_itself(dev, dtype, C, G,
                                                         glu, R, cf, T):
    """The one-launch statistics and the streamed apply: B = 3 rows with
    ragged lengths and one row without a valid frame (so a rank of R = 4
    holds none of row 1's), T = 1,003 not a multiple of any vector width,
    both layouts. Each rank's statistics against float64 (counts exact,
    mean within 1e-5, M2 within 1e-5 of itself), the row's
    output against the plain GroupNorm of the whole row (K2's tolerances),
    and two calls of each kernel equal bit for bit."""
    rng = np.random.default_rng(C + 7 * R + T)
    B = 3
    x = torch.tensor(rng.normal(2.0, 3.0, size=(B, T, C)), device=dev) \
        .to(dtype)
    if cf:
        x = _channels_first(x)
    scale = torch.tensor(rng.normal(1.0, 0.2, size=C), dtype=torch.float32,
                         device=dev)
    bias = torch.tensor(rng.normal(0.0, 0.2, size=C), dtype=torch.float32,
                        device=dev)
    lengths = torch.tensor([T, T * 3 // 5, 0], dtype=torch.int32, device=dev)
    pieces = _split_row(x, lengths, R)
    parts = []
    for xp, n in pieces:
        p = group_norm_split_stats(xp, G, n)
        again = group_norm_split_stats(xp, G, n)
        cnt, mean, m2 = _split_stats_f64(xp, G, n)
        torch.cuda.synchronize()
        assert torch.equal(p, again)
        assert torch.equal(p[..., 0].double(), cnt)
        torch.testing.assert_close(p[..., 1].double(), mean, atol=1e-5,
                                   rtol=0)
        torch.testing.assert_close(p[..., 2].double(), m2, atol=1e-6,
                                   rtol=1e-5)
        assert torch.equal(p[2], torch.zeros_like(p[2]))
        parts.append(p)
    assert any(float(p[1, :, 0].sum()) == 0 for p in parts) == (R == 4)
    gathered = torch.stack(parts, dim=2)                 # (B, G, R, 3)
    outs = []
    for xp, n in pieces:
        o = group_norm_split_apply(xp, scale, bias, gathered, G, lengths=n,
                                   glu=glu)
        assert torch.equal(o, group_norm_split_apply(
            xp, scale, bias, gathered, G, lengths=n, glu=glu))
        assert o.stride(1) == 1 if cf else o.stride(2) == 1
        outs.append(o)
    got = torch.cat(outs, dim=1)
    ref = group_norm_plain(x, scale, bias, G, lengths=lengths, glu=glu)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=2 ** -7,
                                   rtol=2 ** -6)


def test_groupnorm_split_pair_is_one_kernel_each(dev):
    """One device kernel a call for each entry point, by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    x = _channels_first(torch.randn((1, 2048, 1024), device=dev))
    s, z = torch.ones(1024, device=dev), torch.zeros(1024, device=dev)
    p = group_norm_split_stats(x, 2)[:, :, None]
    group_norm_split_apply(x, s, z, p, 2, glu=True)
    torch.cuda.synchronize()
    for call in (lambda: group_norm_split_stats(x, 2),
                 lambda: group_norm_split_apply(x, s, z, p, 2, glu=True)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1, [e.name for e in kernels]


def test_groupnorm_split_counts_and_refuses_gradients(dev):
    x = torch.ones((1, 16, 8), device=dev)
    s = torch.ones(8, device=dev)
    n0, a0 = group_norm_split_stats.launches, group_norm_split_apply.launches
    p = group_norm_split_stats(x, 1)
    group_norm_split_apply(x, s, s * 0, p[:, :, None], 1)
    assert group_norm_split_stats.launches == n0 + 1
    assert group_norm_split_apply.launches == a0 + 1
    with pytest.raises(ValueError, match="forward only"):
        group_norm_split_stats(x.requires_grad_(), 1)


def test_psum_group_norm_refuses_a_mask_on_the_card(dev):
    from vae_npvc_tpu_torch.parallel.halo import psum_group_norm

    x = torch.ones((1, 16, 8), device=dev)
    s = torch.ones(8, device=dev)
    n0 = group_norm_split_stats.launches
    with pytest.raises(ValueError, match="valid_mask"):
        psum_group_norm(x, s, s * 0, 1, "data",
                        valid_mask=torch.ones((1, 16, 1), device=dev))
    assert group_norm_split_stats.launches == n0


# ----------------------------------------------------- GroupNorm layouts
def _channels_first(t):
    """The same values as a (B, T, C) view of (B, C, T) memory, as
    ``F.conv1d(...).transpose(1, 2)`` hands them over."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def _order(t):
    return "channels-last" if t.stride(2) == 1 else "channels-first"


def _gn_layout_inputs(dev, dtype, B, T, C, glu, seed, x_cf, g_cf):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(0.5, 2.0, size=(B, T, C)), device=dev) \
        .to(dtype)
    g = torch.tensor(rng.normal(size=(B, T, C // 2 if glu else C)),
                     device=dev).to(dtype)
    scale = torch.tensor(rng.normal(1.0, 0.2, size=C), dtype=torch.float32,
                         device=dev)
    bias = torch.tensor(rng.normal(0.0, 0.2, size=C), dtype=torch.float32,
                        device=dev)
    return (_channels_first(x) if x_cf else x, scale, bias,
            _channels_first(g) if g_cf else g)


def _check_gn_both(x, scale, bias, g, G, glu, n, dtype):
    """Forward and backward kernels against the plain versions: values,
    x's memory order kept, reruns bit-equal, zero beyond the lengths."""
    T = x.shape[1]
    out = fused_group_norm(x, scale, bias, G, lengths=n, glu=glu)
    out2 = fused_group_norm(x, scale, bias, G, lengths=n, glu=glu)
    ref = group_norm_plain(x, scale, bias, G, lengths=n, glu=glu)
    got = fused_group_norm_backward(x, scale, bias, g, G, lengths=n, glu=glu)
    again = fused_group_norm_backward(x, scale, bias, g, G, lengths=n,
                                      glu=glu)
    bref = group_norm_backward_plain(x, scale, bias, g, G, lengths=n,
                                     glu=glu)
    torch.cuda.synchronize()
    assert _order(out) == _order(x) and _order(got[0]) == _order(x)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=2 ** -7,
                                   rtol=2 ** -6)
    _assert_gn_backward(got, bref, dtype)
    assert torch.equal(out, out2)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if n is not None:
        pad = torch.arange(T, device=x.device)[None] >= n[:, None]
        assert bool((out[pad] == 0).all()) and bool((got[0][pad] == 0).all())


GN_LAYOUT_CASES = [
    # B, T, C, G, glu, lengths, x channels-first, g channels-first
    (128, 256, 512, 1, False, None, True, True),
    (128, 256, 1024, 2, True, None, True, True),
    # ConvResStack's last norm: channels-first x, contiguous cotangent
    (16, 256, 512, 1, False, "spread", True, False),
    (8, 256, 1024, 2, True, "spread", False, True),
    (8, 512, 1024, 2, True, [512, 300, 511, 257, 1, 450, 0, 512], True,
     True),
    # odd T: one-element loads along T
    (3, 77, 96, 3, False, [77, 5, 40], True, False),
    (3, 77, 96, 1, True, None, True, True),
    (4, 64, 512, 32, False, [64, 1, 33, 17], True, True),
    (1, 256, 512, 1, False, [0], True, True),
    # rows too long for a cluster: the streaming path
    (2, 4096, 1024, 2, True, [4096, 2500], True, True),
    (2, 4096, 512, 1, False, None, False, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C,G,glu,lengths,x_cf,g_cf", GN_LAYOUT_CASES)
def test_groupnorm_kernels_read_layouts_in_place(dev, dtype, B, T, C, G, glu,
                                                 lengths, x_cf, g_cf):
    x, scale, bias, g = _gn_layout_inputs(dev, dtype, B, T, C, glu,
                                          B + T + C + G, x_cf, g_cf)
    if lengths == "spread":
        lengths = np.linspace(T, 1, B).round().astype(np.int32).tolist()
    n = (torch.tensor(lengths, dtype=torch.int32, device=dev)
         if lengths else None)
    if T == 4096:
        assert plan(x, glu) == 0 and plan(x, glu, backward=True) == 0
    elif B >= 8:
        assert plan(x, glu) > 0 and plan(x, glu, backward=True) > 0
    _check_gn_both(x, scale, bias, g, G, glu, n, dtype)


# the vae2 recipe's hierarchy (egs/vcc20/vae2/conf/train_vqvae2.yaml): its
# strided levels give rows of 128, 64, 16 and 4 frames, channels-first as
# the strided convs hand them over; at T = 16 and 4 most ranks of a
# cluster hold no frame, and in serving a row may have one valid frame
HIER_GN_CASES = [
    # B, T, C, G, glu, lengths
    (96, 128, 512, 1, False, None),
    (96, 64, 512, 1, False, None),
    (96, 16, 512, 1, False, None),
    (96, 4, 512, 1, False, None),
    (96, 64, 1024, 2, True, None),
    (8, 16, 512, 1, False, "spread"),
    (8, 4, 512, 1, False, "spread"),
    (8, 4, 1024, 2, True, [4, 1, 2, 1, 3, 4, 1, 2]),
    (1, 4, 512, 1, False, [1]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C,G,glu,lengths", HIER_GN_CASES)
def test_groupnorm_kernels_short_hierarchy_rows(dev, dtype, B, T, C, G, glu,
                                                lengths):
    x, scale, bias, g = _gn_layout_inputs(dev, dtype, B, T, C, glu,
                                          B + T + C, True, True)
    if lengths == "spread":
        lengths = np.linspace(T, 1, B).round().astype(np.int32).tolist()
    n = (torch.tensor(lengths, dtype=torch.int32, device=dev)
         if lengths else None)
    assert plan(x, glu) > 0 and plan(x, glu, backward=True) > 0
    _check_gn_both(x, scale, bias, g, G, glu, n, dtype)


@pytest.mark.parametrize("N", [96 * 64, 96 * 256, 8 * 64, 8 * 256])
def test_vq_kernel_ids_on_unit_norm_rows_and_codes(dev, N):
    """The normalized plain codebooks' search (ids mode): unit-norm rows
    and codes, where every distance is 2 - 2 z.e; the hierarchy's training
    rows (96 x 64, 96 x 256) and serving rows (8 x 64, 8 x 256)."""
    rng = np.random.default_rng(N)
    z = rng.normal(size=(N, 128))
    emb = rng.normal(size=(512, 128))
    z = torch.tensor(z / np.linalg.norm(z, axis=1, keepdims=True),
                     dtype=torch.float32, device=dev)
    emb = torch.tensor(emb / np.linalg.norm(emb, axis=1, keepdims=True),
                       dtype=torch.float32, device=dev)
    _vq_check(dev, z, emb, False)
    from vae_npvc_tpu_torch.ops.vq_fused import nearest_code

    n0 = vq_fused.launches
    assert torch.equal(nearest_code(z, emb), vq_fused(z, emb,
                                                      stats=False).idx)
    assert vq_fused.launches == n0 + 2


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("side", ["below", "above"])
def test_groupnorm_cluster_path_boundary(dev, backward, side):
    """The longest row the cluster path takes, and one frame-tile longer
    (the streaming path)."""
    B, C, G, glu, dtype = 2, 1024, 2, True, torch.bfloat16

    def probe(T):
        return plan(torch.empty((B, T, C), dtype=dtype, device=dev), glu,
                    backward)

    T = 8
    while probe(T + 8) > 0:
        T += 8
    if side == "above":
        T += 8
    assert (probe(T) > 0) == (side == "below")
    x, scale, bias, g = _gn_layout_inputs(dev, dtype, B, T, C, glu, T, True,
                                          True)
    n = torch.tensor([T, T - 3], dtype=torch.int32, device=dev)
    _check_gn_both(x, scale, bias, g, G, glu, n, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_kernels_take_a_storage_offset_view(dev, dtype):
    """A view one element into its storage is not 16-byte aligned: the
    kernels read it one element at a time."""
    rng = np.random.default_rng(5)
    B, T, C = 4, 128, 256
    base = torch.tensor(rng.normal(size=(B, C, T + 1)), device=dev).to(dtype)
    x = base[:, :, 1:].transpose(1, 2)
    gbase = torch.tensor(rng.normal(size=(B, T, C + 1)), device=dev) \
        .to(dtype)
    g = gbase[:, :, 1:]
    assert x.data_ptr() % 16 and g.data_ptr() % 16
    scale = torch.tensor(rng.normal(1.0, 0.2, size=C), dtype=torch.float32,
                         device=dev)
    bias = torch.zeros(C, device=dev)
    n = torch.tensor([128, 100, 1, 64], dtype=torch.int32, device=dev)
    _check_gn_both(x, scale, bias, g, 2, False, n, dtype)


def test_groupnorm_wrapper_refuses_other_strides(dev):
    x = torch.randn((2, 16, 64), device=dev)
    s = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="unit stride"):
        fused_group_norm(x[:, :, ::2], s[:32], s[:32], 1)
    g = torch.ones((), device=dev).expand(2, 16, 64)
    with pytest.raises(ValueError, match="unit stride"):
        fused_group_norm_backward(x, s, s, g, 1)


# ---------------------------------------------------------------- attention
ATTN_CASES = [
    # B, H, T, d, lengths
    (2, 2, 64, 32, [50, 64]),
    (1, 4, 100, 96, [77]),
    (3, 1, 257, 48, [257, 1, 130]),
    (2, 4, 192, 96, [192, 101]),
    (2, 4, 768, 96, [700, 768]),
    (1, 4, 768, 96, None),
    (2, 1, 130, 128, [64, 65]),
    (2, 2, 96, 64, None),
    # head dims that are not multiples of 16: zero-padded in shared memory
    (2, 2, 64, 8, [64, 1]),
    (2, 3, 100, 40, [100, 33]),
    # small grids: 72 and 4 blocks of 64 queries on 132 SMs
    (3, 4, 384, 64, [384, 200, 1]),
    (1, 2, 130, 96, [129]),
    # fp32: 128-query blocks (warps of 32 rows), B*H*ceil(T/128) >= 132
    (12, 4, 384, 96, [384, 1, 200, 383, 64, 65, 128, 129, 300, 17, 384, 250]),
    (17, 4, 256, 128, None),
]


def _attn_inputs(dev, dtype, B, H, T, d, seed, q_scale=1.0):
    """q, k, v as (B, H, T, d) views of (B, T, H*d) projections, and a
    cotangent of the same layout."""
    rng = np.random.default_rng(seed)
    return tuple(
        (torch.tensor(rng.normal(size=(B, T, H * d)), dtype=torch.float32,
                      device=dev) * s).to(dtype).reshape(B, T, H, d)
        .transpose(1, 2) for s in (q_scale, 1.0, 1.0, 1.0))


def _assert_attn_close(got, ref, dtype, fp32_tol, what):
    """fp32: summation order only, within ``fp32_tol`` of the peak; bf16: one
    bf16 ulp (2^-7 relative) plus 2^-8 of the peak where values cancel."""
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    a, b = got.float(), ref.float()
    assert bool(torch.isfinite(a).all()), what
    peak = float(b.abs().max()) or 1.0
    tol = fp32_tol * peak if dtype == torch.float32 \
        else 2 ** -7 * b.abs() + 2 ** -8 * peak
    assert bool(((a - b).abs() <= tol).all()), (
        what, float((a - b).abs().max()), peak)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,d,lengths", ATTN_CASES)
def test_attention_kernels_match_plain(dev, dtype, B, H, T, d, lengths):
    _check_attention(dev, dtype, B, H, T, d, lengths)


# the CTC recognizer (eval/asr.py, width 192, 4 heads of 48, fp32): a
# training batch of B = 16 at T' = 600 with ragged lengths down to one
# frame (forward and backward), and transcribe batches at the longest
# 256-frame bucket (T' = 1536) whose unused rows are padded to length 1
# (inference: the forward only)
RECOGNIZER_STEP = (16, 4, 600, 48, [600, 1, 599, 300, 1, 451, 64, 65, 600,
                                    128, 129, 17, 2, 333, 500, 1])
RECOGNIZER_TRANSCRIBE = [[1500, 1411, 1290, 1] + [1] * 12,
                         [1496] + [1] * 15]


def test_attention_kernels_at_the_recognizer_step_shape(dev):
    _check_attention(dev, torch.float32, *RECOGNIZER_STEP)


@pytest.mark.parametrize("lengths", RECOGNIZER_TRANSCRIBE)
def test_attention_forward_at_the_recognizer_transcribe_shape(dev, lengths):
    q, k, v, _ = _attn_inputs(dev, torch.float32, 16, 4, 1536, 48, 1536)
    n = torch.tensor(lengths, dtype=torch.int32, device=dev)
    f0 = fused_attention.launches
    with torch.inference_mode():
        o = fused_attention(q, k, v, n)
    ref_o, _ = attention_plain(q, k, v, n)
    torch.cuda.synchronize()
    assert fused_attention.launches == f0 + 1
    _assert_attn_close(o, ref_o, torch.float32, 2e-5, "o")


def _check_attention(dev, dtype, B, H, T, d, lengths):
    q, k, v, do = _attn_inputs(dev, dtype, B, H, T, d, B * T + d)
    n = (torch.tensor(lengths, dtype=torch.int32, device=dev)
         if lengths else None)
    f0, b0 = fused_attention.launches, fused_attention_backward.launches
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = fused_attention(qg, kg, vg, n)
    dq, dk, dv = torch.autograd.grad(o, (qg, kg, vg), do)
    ref_o, ref_lse = attention_plain(q, k, v, n)
    ref = attention_backward_plain(q, k, v, ref_o, ref_lse, do, n)
    torch.cuda.synchronize()
    assert fused_attention.launches == f0 + 1
    assert fused_attention_backward.launches == b0 + 1
    _assert_attn_close(o.detach(), ref_o, dtype, 2e-5, "o")
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        _assert_attn_close(a, b, dtype, 3e-5, name)
    if n is not None:     # masked keys get no gradient
        pad = (torch.arange(T, device=dev)[None] >= n[:, None])[:, None, :,
                                                                 None]
        assert bool((dk.masked_select(pad) == 0).all())
        assert bool((dv.masked_select(pad) == 0).all())
    # fixed summation order: a second run gives the same bits
    o2 = fused_attention(qg, kg, vg, n)
    again = torch.autograd.grad(o2, (qg, kg, vg), do)
    assert torch.equal(o2, o)
    for a, b in zip((dq, dk, dv), again):
        assert torch.equal(a, b)


def test_attention_kernel_lse_and_contiguous_inputs(dev):
    q, k, v, do = (t.contiguous() for t in _attn_inputs(
        dev, torch.float32, 2, 2, 100, 96, 5))
    n = torch.tensor([100, 37], dtype=torch.int32, device=dev)
    ref_o, ref_lse = attention_plain(q, k, v, n)
    from vae_npvc_tpu_torch.ops.attention import _forward
    o, lse = _forward(q, k, v, n, 1.0 / 96 ** 0.5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    got = fused_attention_backward(q, k, v, o, lse, do, n)
    ref = attention_backward_plain(q, k, v, ref_o, ref_lse, do, n)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        _assert_attn_close(a, b, torch.float32, 3e-5, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_huge_scores_stay_finite(dev, dtype):
    q, k, v, _ = _attn_inputs(dev, dtype, 2, 2, 96, 32, 11, q_scale=1e16)
    n = torch.tensor([96, 1], dtype=torch.int32, device=dev)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = fused_attention(qg, kg, vg, n)
    ref, _ = attention_plain(q, k, v, n)
    assert bool(torch.isfinite(o).all())
    # both backward kernels' scores must round as the forward's did:
    # exp(s - lse) of a score that is off by half an ulp of 1e16 is infinite
    grads = torch.autograd.grad(o, (qg, kg, vg), torch.ones_like(o))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    o = o.detach()
    # a single valid key: the output is that key's value row
    torch.testing.assert_close(o[1], v[1, :, :1].expand_as(o[1]))
    # one-hot softmax rows (score gaps ~1e16): the same argmax on both sides
    torch.testing.assert_close(o, ref, atol=1e-5 * float(ref.abs().max()),
                               rtol=0)


def test_attention_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x = torch.zeros((1, 1, 8, 12), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention(x, x, x)
    x = torch.zeros((1, 1, 8, 136), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention(x, x, x)
    x = torch.zeros((1, 1, 8, 16), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fused_attention(x, x, x)


# ---------------------------------------------- the vocoder (no kernel)
# The Parallel WaveGAN path reaches no hand-written kernel: its
# convolutions are cuDNN's. These hold the card against the CPU on the same
# weights and inputs in fp32.
PWG_SMALL = {"layers": 6, "stacks": 2, "residual_channels": 16,
             "gate_channels": 32, "skip_channels": 16, "kernel_size": 3,
             "upsample_scales": [4, 4], "n_mels": 12, "disc_layers": 4,
             "disc_channels": 16}


def _pwg_nets(cfg, dev):
    from vae_npvc_tpu_torch.models.pwg import PWGDiscriminator, PWGGenerator

    return (PWGGenerator(cfg).init_random(1).to(dev),
            PWGDiscriminator(cfg).init_random(2).to(dev))


@pytest.mark.parametrize("width,dtype,tol", [
    ("small", "float32", 1e-5), ("recipe", "float32", 1e-5),
    ("small", "bfloat16", 2 ** -5)])
def test_pwg_generator_and_discriminator_match_the_cpu(dev, width, dtype,
                                                      tol):
    cfg = dict(PWG_SMALL if width == "small" else {}, compute_dtype=dtype)
    T = 24 if width == "small" else 8
    hop = 16 if width == "small" else 256
    aux = cfg.get("n_mels", 80)
    rng = np.random.default_rng(0)
    z = torch.tensor(rng.normal(size=(2, T * hop, 1)), dtype=torch.float32)
    mel = torch.tensor(rng.normal(size=(2, T, aux)), dtype=torch.float32)
    outs = {}
    for d in ("cpu", dev):
        gen, disc = _pwg_nets(cfg, d)
        with torch.no_grad():
            wav = gen(z.to(d), mel.to(d))
            # the discriminator reads the CPU's wav on both sides
            wav_in = outs["cpu"][0].to(d) if "cpu" in outs else wav
            outs[str(d)] = (wav.cpu(), disc(wav_in).cpu())
    (wc, lc), (wg, lg) = outs["cpu"], outs[str(dev)]
    torch.testing.assert_close(wg, wc, rtol=0,
                               atol=tol * float(wc.abs().max()))
    torch.testing.assert_close(lg, lc, rtol=0,
                               atol=tol * float(lc.abs().max()))


def test_pwg_stft_loss_and_gradient_match_the_cpu(dev):
    from vae_npvc_tpu_torch.ops.stft_loss import multi_stft_loss

    rng = np.random.default_rng(1)
    t = np.arange(8192) / 24000.0
    y = (0.3 * np.sin(2 * np.pi * 220 * t)[None]
         + 0.02 * rng.normal(size=(2, 8192))).astype(np.float32)
    x = (y + 0.05 * rng.normal(size=(2, 8192))).astype(np.float32)
    x[1, -3000:] = y[1, -3000:] = 0.0          # a zero-padded tail
    res = {}
    for d in ("cpu", dev):
        xt = torch.tensor(x, device=d, requires_grad=True)
        sc, mag = multi_stft_loss(xt, torch.tensor(y, device=d))
        (sc + mag).backward()
        res[str(d)] = (sc.item(), mag.item(), xt.grad.cpu())
    (sc_c, mag_c, g_c), (sc_g, mag_g, g_g) = res["cpu"], res[str(dev)]
    assert abs(sc_g - sc_c) <= 1e-5 * sc_c
    assert abs(mag_g - mag_c) <= 1e-5 * mag_c
    assert bool(torch.isfinite(g_g).all())
    torch.testing.assert_close(g_g, g_c, rtol=0,
                               atol=1e-3 * float(g_c.abs().max()))


def test_pwg_trainer_steps_match_the_cpu(dev, tmp_path):
    """Four steps across the adversary's start from one state with the same
    noise: losses within 1e-4 relative, discriminator parameters within
    2e-5 + 1e-3 |x|."""
    from vae_npvc_tpu_torch.train.pwg import PwgTrainer

    cfg = dict(PWG_SMALL, discriminator_train_start_steps=2,
               stft_loss_params=[[64, 16, 32], [128, 32, 64]])
    rng = np.random.default_rng(2)
    batches = [((rng.normal(size=(2, 384)) * 0.3).astype(np.float32),
                rng.normal(size=(2, 24, 12)).astype(np.float32))
               for _ in range(4)]
    zs = [rng.normal(size=(2, 384, 1)).astype(np.float32) for _ in range(4)]
    seed = PwgTrainer(cfg, device="cpu")
    seed.init_state()
    seed.save_checkpoint(tmp_path / "seed")
    runs = {}
    for d in ("cpu", dev):
        tr = PwgTrainer(cfg, device=d)
        tr.load_checkpoint(tmp_path / "seed")
        runs[str(d)] = ([{k: float(v) for k, v in tr.train_step(b, z).items()}
                         for b, z in zip(batches, zs)], tr.D.flat.cpu())
    (dc, fc), (dg, fg) = runs["cpu"], runs[str(dev)]
    for a, b in zip(dg, dc):
        for k in b:
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]) + 1e-7, k
    torch.testing.assert_close(fg, fc, atol=2e-5, rtol=1e-3)


def test_external_vocoder_shim_runs_on_the_card(dev, tmp_path, monkeypatch):
    """``external_decode_scp`` with stand-ins for the ``parallel_wavegan``
    package and PyYAML (neither is on a GPU host without them): the model
    and every mel it is given sit on the card, and each wav has ``frames *
    hop`` samples."""
    import json
    import sys
    import types
    import wave

    from vae_npvc_tpu_torch.data import kaldi_io
    from vae_npvc_tpu_torch.infer.vocoder import external_decode_scp

    seen = set()

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("scale", torch.ones(1))

        def remove_weight_norm(self):
            pass

        def inference(self, c):
            seen.add((self.scale.device.type, c.device.type))
            return (c[:, :1] * self.scale).repeat_interleave(4, 0) * 0.0

    utils = types.ModuleType("parallel_wavegan.utils")
    utils.load_model = lambda ckpt, config: Model()
    utils.read_hdf5 = lambda path, key: (np.zeros(8) if key == "mean"
                                         else np.ones(8))
    pkg = types.ModuleType("parallel_wavegan")
    pkg.utils = utils
    fake_yaml = types.ModuleType("yaml")
    fake_yaml.safe_load = json.load
    monkeypatch.setitem(sys.modules, "parallel_wavegan", pkg)
    monkeypatch.setitem(sys.modules, "parallel_wavegan.utils", utils)
    monkeypatch.setitem(sys.modules, "yaml", fake_yaml)
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "checkpoint-1steps.pkl").write_bytes(b"stand-in")
    (exp / "stats.h5").write_bytes(b"stand-in")
    (exp / "config.yml").write_text(json.dumps({"sampling_rate": 8000}))
    frames = {"a": 20, "b": 7}
    rng = np.random.default_rng(0)
    with kaldi_io.ArkWriter(tmp_path / "f.ark", tmp_path / "f.scp") as w:
        for u, n in frames.items():
            w.write(u, rng.normal(size=(n, 8)).astype(np.float32))
    assert external_decode_scp(tmp_path / "f.scp", tmp_path / "wav",
                               exp) == 2
    assert seen == {("cuda", "cuda")}
    for u, n in frames.items():
        with wave.open(str(tmp_path / "wav" / f"{u}.wav")) as wv:
            assert wv.getnframes() == n * 4


# ------------------------------------------ long rows against float64 (K4/K5)
K4_TOL, K5_TOL = 2e-5, 3e-5    # of the float64 output's peak, as in the smoke


def _attention64(q, k, v, do, scale):
    """o, dq, dk, dv in float64 (every key valid)."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    p = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    o = p @ v
    ds = p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True))
    return o, ds @ k * scale, ds.transpose(-1, -2) @ q * scale, \
        p.transpose(-1, -2) @ do


@pytest.mark.parametrize("d", [48, 96])
def test_attention_fp32_at_long_rows_against_float64(dev, d):
    """T = 3,072: each 64-key (query) tile's product is summed in a fresh
    fragment and added to the running sum rounded to nearest, so the error
    stays a tile's worth instead of growing with T."""
    q, k, v, do = _attn_inputs(dev, torch.float32, 4, 4, 3072, d, 3072 + d)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = fused_attention(qg, kg, vg)
    got = (o.detach(),) + torch.autograd.grad(o, (qg, kg, vg), do)
    exact = _attention64(q, k, v, do, d ** -0.5)
    torch.cuda.synchronize()
    for name, a, e, tol in zip(("o", "dq", "dk", "dv"), got, exact,
                               (K4_TOL, K5_TOL, K5_TOL, K5_TOL)):
        peak = float(e.abs().max())
        err = float((a.double() - e).abs().max()) / peak
        assert err <= tol, (name, err)


# --------------------------------------- registered operators in a program
def _toy_flat(dev):
    from vae_npvc_tpu_torch.models import build_model

    cfg = {"model_type": "vae_npvc.model.vqvae", "y_dim": 8, "y_num": 3,
           "z_dim": 8, "z_num": 16, "use_ema": True,
           "encoder": {"in_channels": [10], "out_channels": [12],
                       "kernel_size": 3, "downsample_scales": [1],
                       "z_channels": 8, "dilation": False,
                       "stack_kernel_size": 3, "stack_layers": 1,
                       "stacks": [1], "use_weight_norm": True},
           "decoder": {"in_channels": [8], "out_channels": [12],
                       "cond_channels": 8, "skip_channels": 8,
                       "final_channels": 10, "kernel_size": 3,
                       "upsample_scales": [1], "dilation": False,
                       "stack_kernel_size": 3, "stacks": [1],
                       "use_weight_norm": True}}
    model = build_model(cfg, dev).eval().init_random(0)
    with torch.no_grad():
        model.quantizer.emb.copy_(torch.randn(
            16, 8, generator=torch.Generator().manual_seed(3)))
    return model


def _program_args(model, dev):
    from vae_npvc_tpu_torch.infer.export_serving import _Program

    gen = torch.Generator().manual_seed(1)
    args = (dict(sorted(model.state_dict().items())),
            torch.randn(2, 32, 10, generator=gen).to(dev),
            torch.tensor([[1], [2]], dtype=torch.int32, device=dev),
            torch.tensor([32, 20], dtype=torch.int32, device=dev))
    return _Program(model), args


def _run_counted(module, args):
    v0, g0 = vq_fused.launches, fused_group_norm.launches
    with torch.inference_mode():
        out = module(*args)
    torch.cuda.synchronize()
    return out, (vq_fused.launches - v0, fused_group_norm.launches - g0)


def test_exported_program_launches_the_registered_kernels(dev):
    model = _toy_flat(dev)
    program, args = _program_args(model, dev)
    with torch.no_grad():
        exported = torch.export.export(program, args, strict=False)
    ops = {str(n.target) for n in exported.graph.nodes
           if n.op == "call_function"}
    assert {"vae_npvc_torch.nearest_code.default",
            "vae_npvc_torch.group_norm.default"} <= ops
    assert not any("argmin" in op for op in ops)
    out, counts = _run_counted(exported.module(), args)
    live, live_counts = _run_counted(model.infer, args[1:])
    assert counts == live_counts == (1, 2)
    assert torch.equal(out, live)


def test_cpu_exported_program_moved_to_the_card(dev, tmp_path):
    """A program traced on the CPU launches both kernels once moved to the
    card. It records the CPU's memory layouts (a ``.contiguous()`` that was
    a no-op there is not in the graph), so on the card a kernel may read
    other strides and sum in another order than the card-traced program:
    the output is held within fp32 rounding of it (1e-5 of the peak), not
    bit for bit."""
    from torch.export.passes import move_to_device_pass

    cpu = torch.device("cpu")
    program, args = _program_args(_toy_flat(cpu), cpu)
    with torch.no_grad():
        exported = torch.export.export(program, args, strict=False)
    torch.export.save(exported, str(tmp_path / "b.pt2"))
    moved = move_to_device_pass(torch.export.load(str(tmp_path / "b.pt2")),
                                dev)
    on_card = tuple({k: v.to(dev) for k, v in args[0].items()}
                    if isinstance(a, dict) else a.to(dev) for a in args)
    out, counts = _run_counted(moved.module(), on_card)
    card_program, card_args = _program_args(_toy_flat(dev), dev)
    want, _ = _run_counted(card_program, card_args)
    assert counts == (1, 2) and out.device.type == "cuda"
    torch.testing.assert_close(out, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


# ------------------------------------------------------ the WGAN-GP trainer
def _gan_config():
    enc = {"in_channels": [12], "out_channels": [32], "kernel_size": 3,
           "downsample_scales": [1], "z_channels": 16, "dilation": True,
           "stack_kernel_size": 3, "stack_layers": 1, "stacks": [2],
           "use_weight_norm": True}
    dec = {"in_channels": [16], "out_channels": [32], "cond_channels": 8,
           "skip_channels": 8, "final_channels": 12, "kernel_size": 3,
           "upsample_scales": [1], "dilation": True, "stack_kernel_size": 3,
           "stacks": [2], "use_weight_norm": True}
    return {"model_type": "vqvae", "trainer_type": "wgan_gp", "seed": 3,
            "compute_dtype": "float32", "pre_iter": -1, "gamma": 0.5,
            "discriminator": {"channels": [16, 32], "kernel_size": 5,
                              "strides": [2, 2]},
            "y_dim": 8, "y_num": 4, "z_dim": 16, "z_num": 8,
            "use_ema": True, "encoder": enc, "decoder": dec}


@pytest.fixture
def gan_draws(monkeypatch):
    """The same codebook candidates and interpolation weights on the
    card and on the CPU (the generators' streams differ by device)."""
    import vae_npvc_tpu_torch.ops.vq as pvq
    import vae_npvc_tpu_torch.train.gan as pgan

    rows = np.random.default_rng(9).normal(size=(8, 16)).astype(np.float32)
    alphas = np.random.default_rng(8).uniform(size=(4, 1, 1)) \
        .astype(np.float32)
    monkeypatch.setattr(pvq, "_tiled_candidates", lambda gen, z, K:
                        torch.as_tensor(rows[:K], device=z.device))
    monkeypatch.setattr(pgan, "gp_alpha", lambda gen, shape, device:
                        torch.as_tensor(alphas, device=device))


def _gan_batch():
    rng = np.random.default_rng(1)
    return (rng.normal(size=(4, 32, 12)).astype(np.float32),
            np.array([0, 3, 1, 2], np.int32))


def test_gan_generator_step_runs_k3_on_the_critic_cotangent(dev, gan_draws):
    """One iteration (critic step, then generator step) on the card and on
    the CPU from the same weights: the generator's gradient reaches the
    GroupNorm backward kernel through the fp32 critic, and the updates
    agree with the plain versions'."""
    from vae_npvc_tpu_torch.train import build_trainer

    trainers = {}
    for name in ("cpu", "cuda"):
        tr = build_trainer(_gan_config(), device=name)
        tr.init_state()
        trainers[name] = tr
    # the same weights (the weight norms' g = |v| of the seeded init are
    # computed on each device)
    flat0 = trainers["cpu"].flat.clone()
    d_flat0 = trainers["cpu"].d_flat.clone()
    with torch.no_grad():
        trainers["cuda"].flat.copy_(flat0)
        trainers["cuda"].d_flat.copy_(d_flat0)
    d_cpu = trainers["cpu"].train_step(_gan_batch())
    before = fused_group_norm_backward.launches, fused_group_norm.launches
    d_gpu = trainers["cuda"].train_step(_gan_batch())
    torch.cuda.synchronize()
    # 2 + 2 GroupNorms: the critic step's generator forward and the
    # generator step's forward, and the generator step's backward
    assert fused_group_norm.launches - before[1] == 8
    assert fused_group_norm_backward.launches - before[0] == 4
    for k in ("DISC loss", "gradient_penalty", "ADV loss", "Total",
              "grad_norm"):
        np.testing.assert_allclose(float(d_gpu[k]), float(d_cpu[k]),
                                   rtol=1e-4, err_msg=k)
    # each network's update against its step's peak
    for a, b, start in ((trainers["cuda"].flat.cpu(), trainers["cpu"].flat,
                         flat0),
                        (trainers["cuda"].d_flat.cpu(),
                         trainers["cpu"].d_flat, d_flat0)):
        peak = float((b - start).abs().max())
        assert peak > 0
        assert float((a - b).abs().max()) <= 1e-3 * peak


def test_critic_step_leaves_the_codebook_on_the_card(dev, gan_draws):
    from vae_npvc_tpu_torch.train import build_trainer

    tr = build_trainer(dict(_gan_config(), pre_iter=0), device="cuda")
    tr.init_state()
    state = [t.clone() for t in tr.model.quantizer.state()]
    counts = (vq_fused.launches, fused_group_norm.launches,
              fused_group_norm_backward.launches)
    tr._disc_step(*tr._to_device(_gan_batch()))
    torch.cuda.synchronize()
    assert (vq_fused.launches - counts[0], fused_group_norm.launches
            - counts[1], fused_group_norm_backward.launches - counts[2]) \
        == (1, 4, 0)
    assert tr.model.pending_ema is None
    for a, b in zip(tr.model.quantizer.state(), state):
        assert torch.equal(a, b)
    assert not bool(tr.model.quantizer.initted)


# ------------------------------------------------------- streaming (/stream)
@pytest.fixture(scope="module")
def flagship_engine(dev, tmp_path_factory):
    """A mel-only ``ConversionEngine`` of the flagship flat model
    (``chip_smoke.FLAGSHIP``: ``train_vqvae.yaml`` widths, bf16, seeded
    random weights)."""
    import chip_smoke as S
    from vae_npvc_tpu_torch.serve import ConversionEngine

    ckpt = tmp_path_factory.mktemp("flagship") / "flagship.msgpack"
    S._random_checkpoint(torch, ckpt)
    eng = ConversionEngine(S.FLAGSHIP, ckpt, S._cmvn_stats(),
                           vocoder="none", device="cuda")
    yield eng
    eng.close()


def _streamed(eng, x, sr, target):
    """An exact-mode session fed ``x`` in ragged pieces: (its raw log-mel
    rows, its converted mel)."""
    from vae_npvc_tpu_torch.serve import StreamingSession

    s = StreamingSession(eng, target, sr)
    rng = np.random.default_rng(x.size)
    i = 0
    while i < x.size:
        n = int(rng.choice([1, 7, 333, 1024, 4800]))
        s.feed(x[i:i + n])
        i += n
    (_, mel), = s.finish()
    return np.concatenate(s._mel_blocks), mel


@pytest.mark.parametrize("seconds", [2.0, 5.3, 9.7])
def test_streamed_front_end_equals_offline_on_the_card(flagship_engine,
                                                       seconds):
    """Streamed 64-frame blocks against the offline canvas: every log-mel
    row bit for bit (both run the engine's fixed-shape front end)."""
    import chip_smoke as S
    from vae_npvc_tpu_torch.data import features

    eng = flagship_engine
    x = S._speechlike(int(seconds * eng.fs), eng.fs, int(seconds * 10))
    T = features.num_frames(x.size, eng.n_shift)
    xp = np.zeros((1, eng._pick_pad(T) * eng.n_shift - 1), np.float32)
    xp[0, :x.size] = x
    offline = eng._mel_batch(xp)[0][:T]
    rows, _ = _streamed(eng, x, eng.fs, 0)
    assert np.array_equal(rows[:T], offline)


@pytest.mark.parametrize("seconds,sr", [(2.0, 24000), (6.1, 24000),
                                        (3.3, 16000)])
def test_exact_stream_k1_ids_equal_convert(flagship_engine, seconds, sr):
    """One request at a time (one batch shape): the exact stream's K1 ids
    and converted mel equal ``convert``'s."""
    import chip_smoke as S

    eng = flagship_engine
    x = S._speechlike(int(seconds * sr), sr, 7)
    want, want_ids = S._k1_ids(
        lambda: eng.convert(x, sr, 5, return_mel=True)[0])
    (_, got), ids = S._k1_ids(lambda: _streamed(eng, x, sr, 5))
    assert len(ids) == len(want_ids) == 1
    assert torch.equal(ids[0], want_ids[0])
    assert np.array_equal(got, want)


# ------------------------------------------------------------ trainer rest
def test_iid_crops_on_the_card_equal_get_at(dev, tmp_path):
    """``train_steps_device``'s draws gathered from the corpus staged on
    the card equal the windows read from disk, bit for bit, and the draws
    stay in range; a step on them trains."""
    from vae_npvc_tpu_torch.data import kaldi_io
    from vae_npvc_tpu_torch.data.dataset import UttMelSpkDataset
    from vae_npvc_tpu_torch.train import build_trainer

    rng = np.random.default_rng(5)
    lens = [30, 9, 45, 60, 22, 38, 51, 40, 16, 3]
    with kaldi_io.ArkWriter(tmp_path / "f.ark", tmp_path / "feats.scp",
                            compression_method=1) as w:
        for i, n in enumerate(lens):
            w.write(f"u{i}", rng.normal(size=(n, 10)).astype(np.float32))
    (tmp_path / "utt2num_frames").write_text(
        "".join(f"u{i} {n}\n" for i, n in enumerate(lens)))
    (tmp_path / "utt2spk_id").write_text(
        "".join(f"u{i} {i % 3}\n" for i in range(len(lens))))
    cfg = {"model_type": "vae_npvc.model.vqvae", "seed": 7, "y_dim": 8,
           "y_num": 3, "z_dim": 8, "z_num": 16, "use_ema": True,
           "beta": 0.01, "mu": 0.9, "jitter_p": 0.0, "optim_type": "Adam",
           "learning_rate": 1e-3, "max_grad_norm": 10, "crop_length": 16,
           "compute_dtype": "float32",
           "encoder": {"in_channels": [10], "out_channels": [12],
                       "kernel_size": 3, "downsample_scales": [1],
                       "z_channels": 8, "dilation": False,
                       "stack_kernel_size": 3, "stack_layers": 1,
                       "stacks": [1], "use_weight_norm": True},
           "decoder": {"in_channels": [8], "out_channels": [12],
                       "cond_channels": 8, "skip_channels": 8,
                       "final_channels": 10, "kernel_size": 3,
                       "upsample_scales": [1], "dilation": False,
                       "stack_kernel_size": 3, "stacks": [1],
                       "use_weight_norm": True}}
    ds = UttMelSpkDataset(tmp_path, cfg)
    assert ds.native is not None
    tr = build_trainer(cfg, device="cuda")
    tr.init_state()
    tr.stage_dataset(ds, 8)
    for step in range(6):
        idx, starts = tr._sample_iid(step)
        assert idx.device.type == "cuda"
        hi = np.maximum(np.asarray(lens)[idx.cpu().numpy()] - 16, 0)
        s = starts.cpu().numpy()
        assert np.all(s >= 0) and np.all(s <= hi)
        feats, _ = tr._gather(idx, starts)
        want = np.stack([ds.get_at(i, st)[0] for i, st in
                         zip(idx.tolist(), s.tolist())])
        assert np.array_equal(feats.cpu().numpy(), want)
    d = tr.train_steps_device(2)
    assert tr.iteration == 2 and bool(torch.isfinite(d["Total"]).all())


def test_prefetch_to_device_side_stream_equals_a_synchronous_copy(dev):
    from vae_npvc_tpu_torch.data.dataset import prefetch_to_device

    rng = np.random.default_rng(2)
    batches = [(rng.normal(size=(128, 256, 80)).astype(np.float32),
                rng.integers(0, 14, size=(128,)).astype(np.int32))
               for _ in range(6)]
    got = []
    for feats, spks in prefetch_to_device(iter(batches), size=2,
                                          device="cuda"):
        assert feats.device.type == "cuda" and spks.dtype == torch.int32
        # work queued on the consumer's stream right after the wait
        got.append(((feats * 2).cpu(), spks.cpu()))
    assert len(got) == len(batches)
    for (gf, gs), (f, s) in zip(got, batches):
        sync = torch.as_tensor(f, device="cuda") * 2
        assert torch.equal(gf, sync.cpu())
        assert np.array_equal(gs.numpy(), s)


def test_doctor_compile_cache_and_devices_on_the_card(dev):
    from vae_npvc_tpu_torch.bin import doctor

    status, detail = doctor._check_devices("cuda", 120)
    assert status == "ok", detail
    status, detail = doctor._check_cache("cuda", 600)
    assert status == "ok", detail
    assert "3 kernel libraries" in detail and "ark_loader-" in detail


# ------------------------------------------- data-parallel steps, world 1
@pytest.fixture
def nccl_mesh(dev, tmp_path):
    """A ``data`` mesh over an NCCL group of one rank (the card)."""
    import torch.distributed as dist

    from vae_npvc_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/nccl",
                            rank=0, world_size=1)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def _hier_config():
    def enc(cin, ds):
        return {"in_channels": [cin], "out_channels": [32], "kernel_size": 3,
                "downsample_scales": [ds], "z_channels": 8,
                "dilation": False, "stack_kernel_size": 3,
                "stack_layers": 1, "stacks": [2], "use_weight_norm": True}

    def dec(cin, cond, final):
        return {"in_channels": [cin], "out_channels": [32],
                "cond_channels": cond, "skip_channels": 8,
                "final_channels": final, "kernel_size": 3,
                "upsample_scales": [1], "dilation": False,
                "stack_kernel_size": 3, "stacks": [2],
                "use_weight_norm": True}

    q = {"z_dim": 8, "z_num": 16, "mu": 0.9}
    return {"model_type": "vqvae2", "seed": 4, "levels": 3, "y_dim": 8,
            "y_num": 4, "beta": 0.01, "use_gst": True, "use_ema": True,
            "compute_dtype": "float32", "encoder.0": enc(10, 1),
            "encoder.1": enc(32, 2), "encoder.2": enc(32, 4),
            "decoder.0": dec(24, 8, 10), "decoder.1": dec(8, 16, 8),
            "decoder.2": dec(8, 8, 8), "quantizer.0": q, "quantizer.1": q,
            "quantizer.2": {"ref_embed_dim": 8, "gst_tokens": 4,
                            "gst_token_dim": 8, "gst_heads": 2}}


def _tts_config():
    return {"model_type": "token_tts", "seed": 2, "token_num": 16,
            "token_dim": 16, "y_num": 4, "y_dim": 8, "mel_dim": 10,
            "block_type": "transformer", "adim": 32, "aheads": 2,
            "elayers": 2, "dlayers": 2, "eunits": 64, "dunits": 64,
            "max_tokens": 16, "max_frames": 64, "compute_dtype": "float32"}


def _tts_batch():
    rng = np.random.default_rng(6)
    B, L, T = 4, 16, 64
    tok_lens = np.array([16, 11, 5, 8], np.int32)
    tokens = np.zeros((B, L), np.int32)
    durs = np.zeros((B, L), np.int32)
    for b, n in enumerate(tok_lens):
        tokens[b, :n] = rng.integers(0, 16, size=n)
        durs[b, :n] = rng.integers(1, 5, size=n)
    mel_lens = durs.sum(axis=1).astype(np.int32)
    mels = rng.normal(size=(B, T, 10)).astype(np.float32)
    mels *= (np.arange(T)[None, :, None] < mel_lens[:, None, None])
    return tokens, durs, mels, rng.integers(0, 4, size=B).astype(
        np.int32), tok_lens, mel_lens


def _hier_batch():
    rng = np.random.default_rng(7)
    return (rng.normal(size=(4, 64, 10)).astype(np.float32),
            np.array([0, 3, 1, 2], np.int32))


@pytest.mark.parametrize("family", ["hierarchy", "gan", "synthesizer"])
def test_dp_step_at_world_size_one_equals_the_plain_step(nccl_mesh, family,
                                                         monkeypatch):
    """The data-parallel step over NCCL at world size 1 (the EMA
    hierarchy's pooled candidates and summed statistics, the GAN's
    critic and generator steps, the synthesizer's frame counts) equals the
    plain step bit for bit on the card, with the same kernel launches.
    cuDNN takes its deterministic algorithms here: its default
    weight-gradient algorithms add with atomics, and a step would not
    repeat itself bit for bit."""
    from vae_npvc_tpu_torch.ops.attention import fused_attention
    from vae_npvc_tpu_torch.train import build_trainer

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)

    cfg, batch = {"hierarchy": (_hier_config(), _hier_batch()),
                  "gan": (_gan_config(), _gan_batch()),
                  "synthesizer": (_tts_config(), _tts_batch())}[family]
    fns = (vq_fused, fused_group_norm, fused_group_norm_backward,
           fused_attention, fused_attention_backward)
    trainers = [build_trainer(cfg, device="cuda",
                              **({"mesh": mesh} if mesh else {}))
                for mesh in (None, nccl_mesh)]
    for tr in trainers:
        tr.init_state()
    with torch.no_grad():   # the same weights, whatever the init rounds
        trainers[1].flat.copy_(trainers[0].flat)
        if hasattr(trainers[0], "d_flat"):
            trainers[1].d_flat.copy_(trainers[0].d_flat)
    runs = []
    for tr in trainers:
        before = [f.launches for f in fns]
        details = [{k: float(v) for k, v in tr.train_step(batch).items()}
                   for _ in range(3)]
        torch.cuda.synchronize()
        runs.append((tr, details, [f.launches - b for f, b in
                                   zip(fns, before)]))
    (plain, want, n_plain), (dp, got, n_dp) = runs
    assert got == want
    assert n_dp == n_plain and sum(n_dp) > 0, n_dp
    if family == "synthesizer":
        assert n_dp[3] == n_dp[4] == 3 * 4
    a, b = plain.model.state_dict(), dp.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(plain.opt_state.mu, dp.opt_state.mu)


# ------------------------------------------- the windowed step as a graph
def _graph_flat_config():
    """A reduced flat EMA VQ-VAE in bf16: the flagship's 512 codes over
    fewer rows than codes, so every step restarts codes (from candidates
    tiled with noise)."""
    enc = {"in_channels": [16], "out_channels": [64], "kernel_size": 3,
           "downsample_scales": [1], "z_channels": 32, "dilation": False,
           "stack_kernel_size": 3, "stack_layers": 1, "stacks": [2],
           "use_weight_norm": True}
    dec = {"in_channels": [32], "out_channels": [64], "cond_channels": 16,
           "skip_channels": 16, "final_channels": 16, "kernel_size": 3,
           "upsample_scales": [1], "dilation": False, "stack_kernel_size": 3,
           "stacks": [2], "use_weight_norm": True}
    return {"model_type": "vae_npvc.model.vqvae", "seed": 5, "y_dim": 16,
            "y_num": 4, "z_dim": 32, "z_num": 512, "use_ema": True,
            "beta": 0.01, "mu": 0.9, "jitter_p": 0.0, "optim_type": "Adam",
            "learning_rate": 1e-3, "max_grad_norm": 10, "crop_length": 32,
            "lr_scheduler": "StepLR",
            "lr_param": {"step_size": 6, "gamma": 0.5},
            "compute_dtype": "bfloat16", "encoder": enc, "decoder": dec}


class _GraphCorpus:
    """Twelve utterances of ``D`` channels; frame 3 of utterance 0 is
    infinite, so a step that takes its first window is skipped."""

    def __init__(self, D, crop):
        self.D, self.crop_length = D, crop

    def padded_arrays(self):
        rng = np.random.default_rng(11)
        n = rng.integers(self.crop_length, 3 * self.crop_length, size=12)
        feats = rng.normal(size=(12, int(n.max()), self.D)) \
            .astype(np.float32)
        feats[0, 3, 1] = np.inf
        return feats, n.astype(np.int32), \
            (np.arange(12) % 4).astype(np.int32)


def _graph_windows(rng, n_steps, B, bad_step):
    """(idx, starts) of ``n_steps`` steps of B distinct utterances, none
    of them the infinite one but at ``bad_step`` (its first window)."""
    idx = np.stack([1 + rng.permutation(11)[:B] for _ in range(n_steps)])
    starts = rng.integers(0, 8, size=idx.shape)
    idx[bad_step, 0], starts[bad_step, 0] = 0, 0
    return idx, starts


def _bits(t):
    t = t.detach()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _state(tr):
    """Every tensor the step updates, by name."""
    out = {"flat": tr.flat}
    out.update({f"opt.{k}": v for k, v in tr.opt_state._asdict().items()
                if v is not None})
    for n, q in tr.ema.items():
        out.update({f"{n}.{k}": v for k, v in q.state()._asdict().items()})
    return out


def _largest_gap(a, b):
    """(name, largest |a - b|) over two dicts of tensors."""
    gaps = {k: float((a[k].double() - b[k].double()).abs().nan_to_num(
        float("inf")).max()) for k in a}
    name = max(gaps, key=gaps.get)
    return name, gaps[name]


def _graph_plain_hier_config():
    """The hierarchy with plain normalized codebooks (the recipe's
    vqvae2): the codebooks renormalized before each step, the code
    perplexity counted on the device."""
    cfg = dict(_hier_config(), use_ema=False)
    for i in (0, 1):
        cfg[f"quantizer.{i}"] = {"z_dim": 8, "z_num": 16, "normalize": True}
    return cfg


@pytest.mark.parametrize("family", ["flat", "hierarchy", "plain_hierarchy"])
def test_graphed_windowed_step_equals_the_eager_step(dev, family,
                                                     monkeypatch):
    """16 windowed steps replayed from a CUDA graph equal the eager steps
    bit for bit: parameters, Adam's state, the EMA codebooks and every
    detail value, through the lazy init (step 0, eager on both), code
    restarts and a step the guard skips (the plain hierarchy: its
    codebooks renormalized each step, no EMA state). The first step runs
    eager, the second captures: 1 capture, 15 replays. The kernel wrappers
    count the calls of the eager step and of the capture, as many a step
    as the eager trainer's, and none of a replay. Re-staging the corpus
    captures again; so does ``init_state``, whose next step runs the lazy
    init inside the graph. cuDNN takes its
    deterministic algorithms (its default weight gradients add with
    atomics)."""
    from vae_npvc_tpu_torch.train import build_trainer
    from vae_npvc_tpu_torch.train.trainer import Trainer
    from vae_npvc_tpu_torch.utils import spans

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    if family == "flat":
        cfg, B = _graph_flat_config(), 8
        D = cfg["encoder"]["in_channels"][0]
    else:
        cfg = (_hier_config() if family == "hierarchy"
               else _graph_plain_hier_config())
        cfg, B = dict(cfg, crop_length=64), 8
        D = cfg["encoder.0"]["in_channels"][0]
    corpus = _GraphCorpus(D, cfg["crop_length"])
    eager, graphed = (build_trainer(cfg, device="cuda") for _ in range(2))
    assert graphed._graphed()
    with Trainer.eager_steps():         # the eager reference's steps
        assert not eager._graphed()
    if family == "hierarchy":
        assert graphed.level_gens
    if family == "plain_hierarchy":
        assert graphed._renorm is not None and not graphed.has_ema

    def start():
        for tr in (eager, graphed):
            tr.init_state()
            tr.stage_dataset(corpus, B)
        with torch.no_grad():   # the same weights, whatever the init rounds
            graphed.flat.copy_(eager.flat)

    def run(idx, starts, calls):
        """Both trainers through the calls; returns the details."""
        fns = (vq_fused, fused_group_norm, fused_group_norm_backward)
        out = []
        for tr in (eager, graphed):
            before = [f.launches for f in fns]
            c0, r0 = Trainer.graph_captures, Trainer.graph_replays
            got, at = [], 0
            with (Trainer.eager_steps() if tr is eager
                  else contextlib.nullcontext()):
                for k in calls:
                    got.append(tr.train_steps_indices(idx[at:at + k],
                                                      starts[at:at + k]))
                    at += k
            torch.cuda.synchronize()
            # the steps that called the wrappers: the eager ones and the
            # captures
            called = sum(calls) - (Trainer.graph_replays - r0) \
                + (Trainer.graph_captures - c0)
            out.append((got, [f.launches - b for f, b in zip(fns, before)],
                        called))
        (want, n_eager, s_eager), (got, n_graphed, s_graphed) = out
        assert s_eager == sum(calls) and s_graphed < s_eager
        assert n_eager[0] > 0 and [n * s_graphed for n in n_eager] == \
            [n * s_eager for n in n_graphed], (n_eager, n_graphed)
        for w, g in zip(want, got):
            assert set(w) == set(g)
            for k in w:
                assert torch.equal(_bits(w[k]), _bits(g[k])), \
                    (k, w[k], g[k])
        a, b = _state(eager), _state(graphed)
        assert all(torch.equal(_bits(a[k]), _bits(b[k])) for k in a), \
            _largest_gap(a, b)
        return [d for c in want for d in
                ({k: v[i] for k, v in c.items()}
                 for i in range(len(c["grad_norm"])))]

    rng = np.random.default_rng(3)
    start()
    c0, r0 = Trainer.graph_captures, Trainer.graph_replays
    idx, starts = _graph_windows(rng, 16, B, bad_step=5)
    spans.drain()
    spans.enable(True, device=True)
    try:
        steps = run(idx, starts, [1, 1, 6, 8])
        torch.cuda.synchronize()
        rec = spans.drain()
    finally:
        spans.enable(False)
    assert (Trainer.graph_captures - c0, Trainer.graph_replays - r0) == \
        (1, 15)
    assert [float(s["skipped_nonfinite"]) for s in steps] == \
        [float(i == 5) for i in range(16)]
    if family == "flat":
        # fewer rows than codes: codes restart on every step after the init
        assert all(float(s["usage"]) < cfg["z_num"] for s in steps[1:])
    names = [s.name for s in rec["spans"]]
    # the eager reference's 16 steps, the graphed trainer's eager step and
    # its capture run the Python step; each replay is one span
    assert names.count("step.replay") == 15
    assert names.count("step.update") == 16 + 2
    # K1's timing events: none recorded while capturing
    n_vq = {"flat": 1, "hierarchy": 2, "plain_hierarchy": 2}[family]
    assert len(rec["device"]) == (16 + 1) * n_vq

    # a re-staged corpus: the graph is dropped and captured again
    for tr in (eager, graphed):
        tr.stage_dataset(corpus, B)
    idx, starts = _graph_windows(rng, 3, B, bad_step=1)
    run(idx, starts, [3])
    assert (Trainer.graph_captures - c0, Trainer.graph_replays - r0) == \
        (2, 18)

    # a fresh state: the lazy init runs inside the captured step
    start()
    idx, starts = _graph_windows(rng, 2, B, bad_step=1)
    run(idx, starts, [2])
    assert (Trainer.graph_captures - c0, Trainer.graph_replays - r0) == \
        (3, 20)
