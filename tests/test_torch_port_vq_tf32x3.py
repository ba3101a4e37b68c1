"""The fused VQ kernel's selection rule (3xTF32 distances, fp32 re-scoring
of near ties), emulated on the CPU, against the JAX package.

On the card, ``csrc/vq.cu`` takes ``dot = z.e`` on the tensor cores as
three TF32 products (each operand split into ``hi = rna_tf32(x)`` and
``lo = rna_tf32(x - hi)``; ``lo*hi + hi*lo + hi*hi``), keeps each row's
best four distances ``||e||^2 - 2 dot`` by (distance, index), and
re-scores a row in exact fp32 (sequential FMA over d) where its second
best lies within the margin ``M = 2^-20 ((D + 8) ||z|| max||e|| +
max||e||^2)`` of its best: the two or three codes within it, or all K
where the fourth lies within it too. Here the same rule runs in
numpy/PyTorch (the products summed in the CPU's order, each FMA as an fp64
product and sum rounded once to fp32) and is held against
``vq_fused(..., interpret=True)`` and the port's ``vq_fused_plain`` at
the recipes' codebook shapes, on random
rows, rows at the midpoint of a code and its nearest other code moved by
a few steps of 2^-17 of each component toward one of them, rows exactly at
such midpoints, and codebooks with repeated rows.

- With the rule, ids equal the exact-FMA argmin on every row, and JAX's and
  the plain version's on every row but the exact midpoints, where JAX's
  rounding decides; there the chosen code loses at most the margin
  against the fp64 best.
- 3xTF32 without re-scoring resolves the moved midpoints too; one TF32
  product does not: it flips some of them, which is why the kernel takes
  three and why the test has teeth.

It shows the rule's arithmetic, not the card's (the tensor cores sum in
another order); ``tests/test_torch_port_cuda.py`` holds the kernel. The
file also holds ``fused_group_norm(...).sum().backward()`` on the CPU (a
cotangent with all strides 0) against ``jax.grad`` of the Pallas kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_npvc_tpu.ops.groupnorm_pallas import fused_group_norm as jax_fused_gn
from vae_npvc_tpu.ops.vq_pallas import vq_fused as jax_vq_fused
from vae_npvc_tpu_torch.ops.groupnorm import fused_group_norm
from vae_npvc_tpu_torch.ops.vq_fused import vq_fused_plain

torch.set_num_threads(1)

SHAPES = [(512, 128), (128, 128), (64, 32)]   # the recipes' (K, D)
STEPS = (-3, -2, -1, 1, 2, 3)                 # moves of the near ties


def rna_tf32(x):
    """fp32 -> TF32 as ``cvt.rna.tf32.f32`` (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def dot_3xtf32(z, emb):
    zh, zl = split_tf32(z)
    eh, el = split_tf32(emb)
    return (zl @ eh.T + zh @ el.T) + zh @ eh.T


def dot_tf32(z, emb):
    return rna_tf32(z) @ rna_tf32(emb).T


def fma_dist(z, emb):
    """The kernel's exact fp32 distances: ``e2`` and the dot each by a
    sequential FMA over d, ``e2 - 2 dot`` rounded once. (N, K) float32."""
    z64, e64 = z.double(), emb.double()
    acc = torch.zeros((z.shape[0], emb.shape[0]), dtype=torch.float32)
    e2 = torch.zeros((emb.shape[0],), dtype=torch.float32)
    for d in range(z.shape[1]):
        acc = (z64[:, d:d + 1] * e64[None, :, d] + acc.double()).float()
        e2 = (e64[:, d] * e64[:, d] + e2.double()).float()
    return (e2.double()[None] - 2.0 * acc.double()).float()


def margin(z, emb):
    D = z.shape[1]
    emax = float(emb.double().norm(dim=1).max())
    return 2.0 ** -20 * ((D + 8) * z.double().norm(dim=1) * emax
                         + emax ** 2)


def first_argmin(dist):
    """argmin with ties to the lowest index, as the kernel orders."""
    return torch.sort(dist, dim=1, stable=True).indices


def select(z, emb, dot, rescore=True, keep=4):
    """The kernel's ids and the number of rows it re-scores: ``keep`` best
    distances a row; those within the margin of the best are re-scored,
    all K where the last kept one is within it too."""
    e2 = fma_dist(torch.zeros((1, z.shape[1])), emb)[0]
    dist = (e2.double()[None] - 2.0 * dot(z, emb).double()).float()
    order = first_argmin(dist)
    ids = order[:, 0].clone()
    if not rescore:
        return ids, 0
    keep = min(keep, emb.shape[0])
    best = torch.gather(dist, 1, order[:, :keep]).double()
    within = ~(best - best[:, :1] > margin(z, emb)[:, None])
    near = within.sum(1)
    for r in torch.nonzero(near > 1).flatten().tolist():
        cand = (torch.arange(emb.shape[0]) if near[r] == keep
                else torch.sort(order[r, :int(near[r])]).values)
        exact = fma_dist(z[r:r + 1], emb[cand])
        ids[r] = cand[first_argmin(exact)[0, 0]]
    return ids, int((near > 1).sum())


def make_case(K, D, seed):
    """Rows by kind: random, moved midpoints, exact midpoints, and rows
    near a codebook's repeated rows (a second codebook)."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(K, D)).astype(np.float32)
    e64 = emb.astype(np.float64)
    d = ((e64[:, None] - e64[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    n = 96
    a = rng.integers(0, K, size=n)
    b = d[a].argmin(1)
    mid = ((e64[a] + e64[b]) / 2).astype(np.float32)
    toward = np.sign(e64[a] - e64[b]).astype(np.float32)
    steps = np.array(STEPS * (n // len(STEPS)), np.float32)[:, None]
    moved = mid + steps * toward * 2.0 ** -17 * np.abs(mid)
    dup = emb.copy()
    dup[K // 2:] = dup[:K - K // 2]
    dup[K - 1] = dup[0]
    c = rng.integers(0, K, size=n)
    c[::4] = 0
    near_dup = dup[c] + 0.05 * rng.normal(size=(n, D)).astype(np.float32)
    rows = {"random": rng.normal(size=(n, D)).astype(np.float32),
            "moved": moved.astype(np.float32), "midpoint": mid}
    return emb, dup, rows, near_dup.astype(np.float32)


def jax_ids(z, emb):
    idx, _, _, _ = jax_vq_fused(jnp.asarray(z), jnp.asarray(emb),
                                interpret=True)
    return torch.from_numpy(np.asarray(idx).astype(np.int64))


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"K{s[0]}D{s[1]}")
def case(request):
    K, D = request.param
    emb, dup, rows, near_dup = make_case(K, D, K + D)
    out = {"K": K, "D": D, "sets": {}}
    for kind, z in list(rows.items()) + [("duplicate", near_dup)]:
        e = dup if kind == "duplicate" else emb
        zt, et = torch.from_numpy(z), torch.from_numpy(e)
        out["sets"][kind] = {
            "z": zt, "emb": et, "jax": jax_ids(z, e),
            "plain": vq_fused_plain(zt, et, stats=False).idx.long(),
            "fma": first_argmin(fma_dist(zt, et))[:, 0]}
    return out


def test_tf32_split_keeps_22_bits():
    y = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    hi, lo = split_tf32(y)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    err = (y.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2 ** -22 * y.double().abs()).all())


def test_rule_gives_the_exact_fp32_ids_on_every_row(case):
    for kind, s in case["sets"].items():
        ids, _ = select(s["z"], s["emb"], dot_3xtf32)
        assert torch.equal(ids, s["fma"]), kind


def test_rule_matches_jax_and_plain_off_the_exact_midpoints(case):
    for kind, s in case["sets"].items():
        ids, _ = select(s["z"], s["emb"], dot_3xtf32)
        if kind == "midpoint":
            continue
        assert torch.equal(ids, s["jax"]), kind
        assert torch.equal(ids, s["plain"]), kind


def test_rule_at_exact_midpoints_loses_at_most_the_margin(case):
    s = case["sets"]["midpoint"]
    ids, rescored = select(s["z"], s["emb"], dot_3xtf32)
    assert rescored > 0
    z64, e64 = s["z"].double(), s["emb"].double()
    d64 = (e64 ** 2).sum(1)[None] - 2 * z64 @ e64.T
    rows = torch.arange(len(ids))
    lost = d64[rows, ids] - d64.min(1).values
    assert bool((lost <= margin(s["z"], s["emb"])).all())
    # JAX's choice is one of the two codes of each midpoint as well
    assert bool((d64[rows, s["jax"]] - d64.min(1).values
                 <= margin(s["z"], s["emb"])).all())


def test_rule_rescores_repeated_codes_and_takes_the_lowest_index(case):
    s = case["sets"]["duplicate"]
    K = case["K"]
    ids, rescored = select(s["z"], s["emb"], dot_3xtf32)
    assert int(ids.max()) < K - K // 2
    assert rescored >= int((ids == 0).sum()) > 0


def test_3xtf32_without_rescoring_resolves_the_moved_midpoints(case):
    for kind in ("random", "moved", "duplicate"):
        s = case["sets"][kind]
        ids, _ = select(s["z"], s["emb"], dot_3xtf32, rescore=False)
        assert torch.equal(ids, s["jax"]), kind


def test_single_tf32_flips_a_moved_midpoint(case):
    s = case["sets"]["moved"]
    ids, _ = select(s["z"], s["emb"], dot_tf32, rescore=False)
    assert int((ids != s["jax"]).sum()) >= 1


@pytest.mark.parametrize("G,glu", [(1, False), (2, True)])
def test_group_norm_sum_backward_takes_a_stride0_cotangent(G, glu):
    """``.sum()`` hands the backward a cotangent with strides (0, 0, 0);
    the gradients equal ``jax.grad`` of the Pallas kernel's sum."""
    rng = np.random.default_rng(3 + G)
    x = rng.normal(1.0, 2.0, size=(2, 16, 256)).astype(np.float32)
    s = rng.normal(1.0, 0.2, size=256).astype(np.float32)
    b = rng.normal(0.0, 0.2, size=256).astype(np.float32)
    ref = jax.grad(
        lambda x, s, b: jnp.sum(jax_fused_gn(x, s, b, G, glu=glu,
                                             interpret=True)),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    xt, st, bt = (torch.tensor(a, requires_grad=True) for a in (x, s, b))
    y = fused_group_norm(xt, st, bt, G, glu=glu)
    seen = []
    y.register_hook(lambda g: seen.append(g.stride()))
    y.sum().backward()
    assert seen == [(0, 0, 0)]
    for got, want in zip((xt.grad, st.grad, bt.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
