"""PyTorch port training ops vs the JAX package on the CPU.

The GroupNorm(+GLU) backward (plain analytic version and the autograd
Function) against ``jax.grad`` of the Pallas kernel in interpret mode and of
the stock ``nn.blocks.group_norm``; the VQ training half, the losses, the
jitter gather and the optimizer against their JAX counterparts. Inputs are
made with numpy from a seed and fed to both. Tolerances: fp32 gradients
2e-5 absolute (summation order only); bf16 gradients 5e-2 of the peak (the
analytic backward does not round y before the GLU's derivative, autograd
through the bf16 forward does); VQ ids exact, losses and EMA state 1e-5;
optimizer parameters 1e-6 after 10 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_npvc_tpu.nn.blocks import group_norm as jax_group_norm
from vae_npvc_tpu.nn.blocks import length_mask as jax_length_mask
from vae_npvc_tpu.ops import jitter as jax_jitter
from vae_npvc_tpu.ops import losses as jax_losses
from vae_npvc_tpu.ops import vq as jvq
from vae_npvc_tpu.ops.groupnorm_pallas import fused_group_norm as jax_fused_gn
from vae_npvc_tpu.train.optim import build_optimizer as jax_build_optimizer
from vae_npvc_tpu_torch.ops import losses as port_losses
from vae_npvc_tpu_torch.ops import vq as pvq
from vae_npvc_tpu_torch.ops.groupnorm import (fused_group_norm,
                                              fused_group_norm_backward,
                                              group_norm_backward_plain)
from vae_npvc_tpu_torch.ops.jitter import jitter, jitter_gather
from vae_npvc_tpu_torch.train.optim import build_optimizer

torch.set_num_threads(1)


def _gn_inputs(seed, B, T, C, glu):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 2.0, size=(B, T, C)).astype(np.float32)
    scale = rng.normal(1.0, 0.3, size=C).astype(np.float32)
    bias = rng.normal(0.0, 0.3, size=C).astype(np.float32)
    g = rng.normal(size=(B, T, C // 2 if glu else C)).astype(np.float32)
    return x, scale, bias, g


def _port_grads(x, scale, bias, g, G, glu, lengths=None, dtype=torch.float32):
    """(analytic plain backward, autograd through the Function)."""
    tx = torch.from_numpy(x).to(dtype)
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    tg = torch.from_numpy(g).to(dtype)
    n = None if lengths is None else torch.from_numpy(lengths)
    plain = group_norm_backward_plain(tx, ts, tb, tg, G, lengths=n, glu=glu)
    wrapped = fused_group_norm_backward(tx, ts, tb, tg, G, lengths=n,
                                        glu=glu)
    for a, b in zip(plain, wrapped):        # the CPU wrapper is the plain
        assert torch.equal(a, b)
    leaves = [t.clone().requires_grad_(True) for t in (tx, ts, tb)]
    y = fused_group_norm(*leaves, G, lengths=n, glu=glu)
    auto = torch.autograd.grad(y, leaves, tg)
    for a, b in zip(plain, auto):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert plain[0].dtype == dtype and plain[1].dtype == torch.float32
    return [p.float().numpy() for p in plain]


@pytest.mark.parametrize("G,glu", [(1, False), (2, True)])
def test_group_norm_backward_matches_pallas_interpret(G, glu):
    # the Pallas kernel's layout: C/G a multiple of 128, T a multiple of 16
    x, scale, bias, g = _gn_inputs(G, 2, 16, 256, glu)

    def f(x, s, b):
        y = jax_fused_gn(x, s, b, G, glu=glu, interpret=True)
        return jnp.sum(y * jnp.asarray(g))

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                         jnp.asarray(bias))
    for got, want in zip(_port_grads(x, scale, bias, g, G, glu), ref):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("G,glu", [(1, False), (3, False), (2, True),
                                   (1, True)])
def test_group_norm_backward_matches_stock_jax_grad(G, glu, masked):
    x, scale, bias, g = _gn_inputs(10 * G + glu, 3, 20, 12, glu)
    lengths = np.array([20, 7, 0], np.int32) if masked else None
    mask = None if lengths is None else jax_length_mask(
        jnp.asarray(lengths), 20)

    def f(x, s, b):
        y = jax_group_norm(x, s, b, G, mask=mask, glu=glu)
        return jnp.sum(y * jnp.asarray(g))

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                         jnp.asarray(bias))
    got = _port_grads(x, scale, bias, g, G, glu, lengths)
    for a, want in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(want), atol=2e-5)
    if masked:      # nothing flows into the padding or the empty row
        assert np.all(got[0][1, 7:] == 0.0) and np.all(got[0][2] == 0.0)


@pytest.mark.parametrize("G,glu", [(1, False), (2, True)])
def test_group_norm_backward_bf16_close_to_jax_grad(G, glu):
    x, scale, bias, g = _gn_inputs(5, 2, 16, 32, glu)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    gb = jnp.asarray(g).astype(jnp.bfloat16)

    def f(x, s, b):
        y = jax_group_norm(x, s, b, G, glu=glu)
        return jnp.sum((y * gb).astype(jnp.float32))

    ref = jax.grad(f, argnums=(0, 1, 2))(xb, jnp.asarray(scale),
                                         jnp.asarray(bias))
    got = _port_grads(x, scale, bias, g, G, glu, dtype=torch.bfloat16)
    for a, want in zip(got, ref):
        want = np.asarray(want.astype(jnp.float32))
        assert np.abs(a - want).max() <= 5e-2 * np.abs(want).max()


# ------------------------------------------------------------------ the VQ
def _states(emb, emb_sum, emb_elem, initted=True):
    j = jvq.EmaVqState(jnp.asarray(initted), jnp.asarray(emb),
                       jnp.asarray(emb_sum), jnp.asarray(emb_elem))
    p = pvq.EmaVqState(torch.tensor(initted), torch.from_numpy(emb),
                       torch.from_numpy(emb_sum), torch.from_numpy(emb_elem))
    return j, p


def _assert_ema_equal(p_out, j_out, atol=1e-5):
    (pz, pq, pe, pstate, pd), (jz, jq, je, jstate, jd) = p_out, j_out
    np.testing.assert_allclose(pz.detach().numpy(), np.asarray(jz), atol=atol)
    np.testing.assert_allclose(float(pe.detach()), float(je), rtol=1e-5)
    assert float(pq) == float(jq) == 0.0
    assert bool(pstate.initted) == bool(jstate.initted)
    for a, b in zip(pstate[1:], jstate[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)
    assert set(pd) == set(jd)
    for k in pd:
        np.testing.assert_allclose(float(pd[k]), float(jd[k]), rtol=1e-4,
                                   atol=1e-6)


@pytest.fixture
def injected_candidates(monkeypatch):
    """The same restart/init candidate rows on both sides: torch cannot
    replay ``jax.random``, so ``_tiled_candidates`` is replaced in the test
    (nothing in either package changes)."""
    rows = np.random.default_rng(99).normal(size=(16, 8)).astype(np.float32)
    monkeypatch.setattr(jvq, "_tiled_candidates",
                        lambda rng, z, K: jnp.asarray(rows[:K]))
    monkeypatch.setattr(pvq, "_tiled_candidates",
                        lambda gen, z, K: torch.from_numpy(rows[:K]))
    return rows


@pytest.mark.parametrize("case", ["all_used", "restart", "lazy_init",
                                  "eval"])
def test_ema_vq_forward_matches_jax(case, injected_candidates):
    rng = np.random.default_rng(3)
    K, D = 16, 8
    z = rng.normal(size=(2, 24, D)).astype(np.float32)
    emb = z.reshape(-1, D)[:K].copy()           # every code has a frame
    elem = np.full((K,), 5.0, np.float32)
    if case == "restart":
        emb[3] = 50.0                           # no frame: count falls < 1
        elem[3] = 1.0
    jstate, pstate = _states(emb, emb * elem[:, None], elem,
                             initted=case != "lazy_init")
    train = case != "eval"
    j_out = jvq.ema_vq_forward(jstate, jnp.asarray(z), jax.random.PRNGKey(0),
                               training=train, update=train)
    zt = torch.from_numpy(z).requires_grad_(True)
    p_out = pvq.ema_vq_forward(pstate, zt, None, training=train,
                               update=train)
    _assert_ema_equal(p_out, j_out)
    if case == "all_used":
        assert float(p_out[4]["usage"]) == K
    if case == "restart":
        assert float(p_out[4]["usage"]) == K - 1
        np.testing.assert_array_equal(p_out[3].emb[3].numpy(),
                                      injected_candidates[3])
    if case == "lazy_init":
        assert bool(p_out[3].initted)
    # straight-through: the decoder's gradient reaches z unchanged, plus
    # the commitment term
    gj = jax.grad(lambda a: jnp.sum(jvq.ema_vq_forward(
        jstate, a, jax.random.PRNGKey(0), training=train,
        update=train)[0] ** 2))(jnp.asarray(z))
    (gp,) = torch.autograd.grad((p_out[0] ** 2).sum(), zt)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), atol=1e-5)


def test_ema_vq_forward_legacy_and_parallel_axis():
    rng = np.random.default_rng(4)
    z = rng.normal(size=(1, 12, 8)).astype(np.float32)
    emb = rng.normal(size=(4, 8)).astype(np.float32)
    jstate, pstate = _states(emb, emb.copy(), np.ones(4, np.float32))
    j = jvq.ema_vq_forward(jstate, jnp.asarray(z), jax.random.PRNGKey(0),
                           training=False, update=False, legacy_no_ste=True)
    p = pvq.ema_vq_forward(pstate, torch.from_numpy(z), training=False,
                           update=False, legacy_no_ste=True)
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0]))
    # a data axis must be bound (parallel.comm.bind) to be used
    with pytest.raises(ValueError, match="'data' is not bound"):
        pvq.ema_vq_forward(pstate, torch.from_numpy(z), axis_name="data")


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("reduction", ["frame_mean", "sum", "none"])
def test_vq_forward_matches_jax(normalize, reduction):
    rng = np.random.default_rng(6)
    z = rng.normal(size=(2, 10, 8)).astype(np.float32)
    emb = rng.normal(size=(12, 8)).astype(np.float32)
    jz, jq, je, jd = jvq.vq_forward(jnp.asarray(emb), jnp.asarray(z),
                                    normalize=normalize, reduction=reduction)
    te = torch.from_numpy(emb).requires_grad_(True)
    tz = torch.from_numpy(z).requires_grad_(True)
    pz, pq, pe, pd = pvq.vq_forward(te, tz, normalize=normalize,
                                    reduction=reduction)
    for a, b in ((pz, jz), (pq, jq), (pe, je), (pd["entropy"],
                                               jd["entropy"])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5)

    def loss(e, a):
        out = jvq.vq_forward(e, a, normalize=normalize, reduction=reduction)
        return jnp.sum(out[0] ** 2) + jnp.sum(out[1]) + 0.3 * jnp.sum(out[2])

    ge, gz = jax.grad(loss, argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(z))
    pge, pgz = torch.autograd.grad(
        (pz ** 2).sum() + pq.sum() + 0.3 * pe.sum(), (te, tz))
    np.testing.assert_allclose(pge.numpy(), np.asarray(ge), atol=1e-5)
    np.testing.assert_allclose(pgz.numpy(), np.asarray(gz), atol=1e-5)
    bypass = pvq.vq_forward(te, tz, quantize=False)
    assert bypass[0] is tz and float(bypass[1]) == 0.0


def test_perplexity_sparsity_and_init_match_jax():
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 9, size=(3, 11)).astype(np.int32)
    np.testing.assert_allclose(
        float(pvq.codebook_perplexity(torch.from_numpy(idx), 12)),
        float(jvq.codebook_perplexity(jnp.asarray(idx), 12)), rtol=1e-6)
    emb = rng.normal(size=(6, 5)).astype(np.float32)
    np.testing.assert_allclose(
        float(pvq.sparsity_loss(torch.from_numpy(emb))),
        float(jvq.sparsity_loss(jnp.asarray(emb))), rtol=1e-5)
    for a, b in zip(pvq.ema_vq_init(5, 3), jvq.ema_vq_init(5, 3)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_tiled_candidates_draws_rows_of_z():
    gen = torch.Generator().manual_seed(0)
    z = torch.arange(40.0).reshape(10, 4)
    many = pvq._tiled_candidates(gen, z, 6)     # N >= K: a permutation of z
    assert many.shape == (6, 4)
    rows = {tuple(r.tolist()) for r in z}
    assert all(tuple(r.tolist()) in rows for r in many)
    assert len({tuple(r.tolist()) for r in many}) == 6
    few = pvq._tiled_candidates(gen, z[:3], 8)  # N < K: tiled, with noise
    assert few.shape == (8, 4)
    nearest = torch.cdist(few, z[:3]).min(dim=1).values
    assert float(nearest.max()) < 0.1 and float(nearest.min()) > 0.0


# --------------------------------------------------------- losses, jitter
@pytest.mark.parametrize("reduction", ["frame_mean", "sum", "mean",
                                       "batch_mean", "none"])
def test_log_loss_matches_jax(reduction):
    rng = np.random.default_rng(8)
    x, xhat = (rng.normal(size=(2, 7, 5)).astype(np.float32)
               for _ in range(2))
    np.testing.assert_allclose(
        port_losses.log_loss(torch.from_numpy(xhat), torch.from_numpy(x),
                             reduction).numpy(),
        np.asarray(jax_losses.log_loss(jnp.asarray(xhat), jnp.asarray(x),
                                       reduction)), rtol=1e-6)


def test_gaussian_toolkit_matches_jax():
    rng = np.random.default_rng(9)
    a, b, c, d = (rng.normal(size=(3, 6)).astype(np.float32) * 0.5
                  for _ in range(4))
    t = [torch.from_numpy(v) for v in (a, b, c, d)]
    j = [jnp.asarray(v) for v in (a, b, c, d)]
    for name, n in (("gaussian_kld", 4), ("gaussian_log_density", 3),
                    ("kl_loss", 2), ("skl_loss", 4)):
        np.testing.assert_allclose(
            getattr(port_losses, name)(*t[:n]).numpy(),
            np.asarray(getattr(jax_losses, name)(*j[:n])), rtol=2e-5,
            atol=1e-6)
    gen = torch.Generator().manual_seed(1)
    s = port_losses.gaussian_sample(gen, torch.zeros(4000),
                                    torch.full((4000,), np.log(4.0)))
    assert abs(float(s.std()) - 2.0) < 0.1 and abs(float(s.mean())) < 0.15
    with pytest.raises(ValueError):
        port_losses.log_loss(t[0], t[1], "nope")


@pytest.mark.parametrize("per_batch", [True, False])
def test_jitter_gather_matches_jax_given_its_draws(per_batch):
    rng = np.random.default_rng(10)
    x = rng.normal(size=(3, 9, 4)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax_jitter.jitter(key, jnp.asarray(x), 0.5,
                                       per_batch=per_batch))
    # JAX's own draws (ops/jitter.py: split, bernoulli(p), bernoulli(0.5))
    shape = (3, 9) if per_batch else (1, 9)
    r_replace, r_dir = jax.random.split(key)
    replace = np.array(jax.random.bernoulli(r_replace, 0.5, shape))
    forward = np.array(jax.random.bernoulli(r_dir, 0.5, shape))
    got = jitter_gather(torch.from_numpy(x), torch.from_numpy(replace),
                        torch.from_numpy(forward))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert replace.any() and not replace.all()
    tx = torch.from_numpy(x)
    assert jitter(None, tx, 0.0) is tx
    drawn = jitter(torch.Generator().manual_seed(0), tx, 1.0,
                   per_batch=per_batch)
    # every frame replaced by a neighbour: the ends by their only one
    np.testing.assert_array_equal(drawn[:, 0].numpy(), x[:, 1])
    np.testing.assert_array_equal(drawn[:, -1].numpy(), x[:, -2])


# ------------------------------------------------------------ the optimizer
@pytest.mark.parametrize("scheduled", [True, False])
def test_adam_matches_optax_chain(scheduled):
    """10 steps; the clip bites on the large-gradient steps and the StepLR
    boundary (step_size 4) is crossed twice."""
    cfg = {"optim_type": "Adam", "learning_rate": 1e-2, "max_grad_norm": 1.0}
    if scheduled:
        cfg.update(lr_scheduler="StepLR",
                   lr_param={"step_size": 4, "gamma": 0.5})
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (3.0 if i % 3 == 0 else 0.05))
              .astype(np.float32) for k, s in shapes.items()}
             for i in range(10)]

    def flat(tree):
        return torch.from_numpy(np.concatenate(
            [tree[k].reshape(-1) for k in shapes]))

    jtx = jax_build_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    ptx = build_optimizer(cfg)
    pp = flat(params)
    pstate = ptx.init(pp)
    clipped = 0
    for g in grads:
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        pu, pstate = ptx.update(flat(g), pstate)
        pp = pp + pu
        clipped += float(torch.linalg.vector_norm(flat(g))) > 1.0
        np.testing.assert_allclose(
            pp.numpy(), flat({k: np.asarray(v) for k, v in jp.items()}),
            atol=1e-6)
    assert 0 < clipped < 10
    assert int(pstate.count) == 10
    assert (pstate.sched_count is None) == (not scheduled)


@pytest.mark.parametrize("kind", ["RAdam", "PlainRAdam", "AdamW"])
def test_unported_optimizers_raise(kind):
    """The optimizers this test once found unported now build (each is
    held against optax in tests/test_torch_port_pwg_model.py); AdamW's
    checkpoint tree has the decay's slot."""
    tx = build_optimizer({"optim_type": kind})
    params = torch.ones(3)
    update, state = tx.update(torch.full((3,), 0.5), tx.init(params),
                              params)
    assert bool(torch.isfinite(update).all()) and int(state.count) == 1
    assert tx.decoupled == (kind == "AdamW")
