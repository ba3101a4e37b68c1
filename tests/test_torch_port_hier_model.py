"""The hierarchical VQ-VAEs (vqvae2, vqvae2a, vqvae2b) in the port against
the JAX package.

Per configuration, from the port's seeded weights carried across by
``utils/bridge.py`` and the same numpy inputs: the training forward's loss
and every detail key, every parameter gradient against ``jax.grad``, the
EMA banks' updated states (restart and lazy-init candidates injected on
both sides: torch cannot replay ``jax.random``), ``encode`` (ids and the
GST style) and ``infer`` of a padded batch with lengths; then, in the port
alone, the padded batch against unpadded per-utterance runs. fp32 on the
CPU. Tolerances: loss and detail 1e-5 relative, gradients 1e-4 of each
gradient's peak, ids equal, style 1e-5 and mel 1e-4 of the peak.

The JAX side runs as one jitted function per configuration (eager JAX
takes ~30 s for one gradient of these models on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model_vqvae2 import make_cfg
from tests.test_model_vqvae2ab import cfg_2a, cfg_2b, dec_cfg
from vae_npvc_tpu.models import build_model as jax_build_model
from vae_npvc_tpu.ops import vq as jvq
from vae_npvc_tpu.ops.vq import EmaVqState
from vae_npvc_tpu_torch.models import build_model, get_model_cls
from vae_npvc_tpu_torch.ops import vq as pvq
from vae_npvc_tpu_torch.utils.bridge import (from_jax_variables,
                                             is_ema_root, to_jax_variables)

torch.set_num_threads(1)
B, T, D = 3, 32, 10
LENGTHS = np.array([32, 21, 9], np.int32)


def _2a_upsample_last():
    """vqvae2a decoding each level at its own rate, then upsampling (the
    decoders keep their rate: a resampling decoder's speaker condition
    would not match its frames in either package)."""
    cfg = cfg_2a(use_gst=False, use_ema=False)
    cfg.update({"pooling_last": False, "upsample_last": True})
    return cfg


def _2b_gst_ema():
    cfg = cfg_2b()
    cfg.update({"levels": 3, "use_gst": True, "use_ema": True,
                "encoder.2": dict(cfg["encoder.1"], in_channels=[16]),
                "decoder.2": dec_cfg(8, 8, 8),
                "final_decoder": dec_cfg(24, 0, 10),
                "quantizer.2": {"ref_embed_dim": 8, "gst_tokens": 4,
                                "gst_token_dim": 8, "gst_heads": 2}})
    return cfg


CASES = {
    "vqvae2_gst_plain": lambda: make_cfg(use_gst=True, use_ema=False),
    "vqvae2_vq_ema": lambda: make_cfg(use_gst=False, use_ema=True),
    "vqvae2_gst_ema": lambda: make_cfg(use_gst=True, use_ema=True),
    "vqvae2a_gst_embeds": lambda: cfg_2a(use_gst=True, use_ema=False),
    "vqvae2a_shared_ema": lambda: cfg_2a(use_gst=False, use_ema=True,
                                         use_quantizers=False,
                                         use_embeds=False),
    "vqvae2a_upsample_last": _2a_upsample_last,
    "vqvae2b_pooled": cfg_2b,
    "vqvae2b_gst_ema": _2b_gst_ema,
}
# the injected restart / lazy-init candidate rows (K = 16, D = 8)
CAND = np.random.default_rng(99).normal(size=(16, 8)).astype(np.float32)


def _ema_states(pm, rng):
    """Initted EMA banks with some codes below the restart threshold; the
    shared bank of vqvae2a starts uninitialized (lazy init)."""
    states = {}
    for name, m in pm.named_children():
        if not is_ema_root(name):
            continue
        K, Dz = m.emb.shape
        emb = rng.normal(0.0, 0.2, size=(K, Dz)).astype(np.float32)
        elem = np.where(np.arange(K) % 3 == 0, 0.5, 2.0).astype(np.float32)
        initted = name != "quantizer"
        states[name] = (np.array(initted), emb, emb * elem[:, None], elem)
    return states


def _to_jax_ema(states):
    return {n: EmaVqState(*(jnp.asarray(a) for a in s))
            for n, s in states.items()}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    x[np.arange(T)[None] >= LENGTHS[:, None]] = 0.0
    y = rng.integers(0, 4, size=(B,)).astype(np.int32)
    return x, y


def _jax_run(cfg, params, ema, x, y):
    """One jitted JAX call: (loss, detail, grads, new ema, encode, mel)."""
    jm = jax_build_model(cfg)
    mutable = ["ema"] if ema else False

    def loss_fn(p):
        v = {"params": p, **({"ema": ema} if ema else {})}
        out = jm.apply(v, x, y, train=True, mutable=mutable,
                       rngs={"vq": jax.random.PRNGKey(3)})
        (_, loss, detail), new = out if ema else (out, {})
        return loss, (detail, new)

    def run(p, x, y, n):
        (loss, (detail, new)), g = jax.value_and_grad(
            loss_fn, has_aux=True)(p)
        v = {"params": p, **({"ema": ema} if ema else {})}
        enc = jm.apply(v, x, n, method=jm.encode)
        mel = jm.apply(v, x, y, n, method=jm.infer)
        return loss, detail, g, new, enc, mel

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvq, "_tiled_candidates",
                   lambda rng, z, K: jnp.asarray(CAND[:K]))
        out = jax.jit(run)(params, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(LENGTHS))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(name, config, port model, JAX results, inputs, initial EMA)."""
    name = request.param
    cfg = dict(CASES[name](), compute_dtype="float32")
    pm = build_model(cfg, device="cpu").init_random(7)
    rng = np.random.default_rng(11)
    ema = _ema_states(pm, rng)
    sd = pm.state_dict()
    for n, s in ema.items():
        for key, a in zip(("initted", "emb", "emb_sum", "emb_elem"), s):
            sd[f"{n}.{key}"] = torch.from_numpy(np.array(a))
    pm.load_state_dict(sd)
    params = to_jax_variables(sd)["params"]
    x, y = _inputs(5)
    got = _jax_run(cfg, params, _to_jax_ema(ema) if ema else None, x, y)
    return name, cfg, pm, got, (x, y), ema


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    peak = max(float(np.abs(b).max()), 1e-12)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol * peak, f"{what}: {err / peak:.3g} of the peak"


def test_registry_resolves_every_family():
    from vae_npvc_tpu_torch.models import vqvae2, vqvae2a, vqvae2b

    for short, mod in (("vqvae2", vqvae2), ("vqvae2a", vqvae2a),
                       ("vqvae2b", vqvae2b)):
        assert get_model_cls(short) is mod.Model
        assert get_model_cls(f"vae_npvc.model.{short}") is mod.Model


def test_forward_loss_detail_gradients_and_ema_match_jax(case):
    name, cfg, pm, (jloss, jdetail, jgrads, jnew, _, _), (x, y), ema = case
    pm.zero_grad()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pvq, "_tiled_candidates",
                   lambda gen, z, K: torch.from_numpy(CAND[:K]))
        gen = torch.Generator().manual_seed(0)
        _, loss, detail = pm(torch.from_numpy(x), torch.from_numpy(y), True,
                             gen=gen)
    assert set(detail) == set(jdetail), name
    for k, v in jdetail.items():
        np.testing.assert_allclose(float(detail[k].detach()), float(v),
                                   rtol=1e-5,
                                   atol=1e-7, err_msg=f"{name} {k}")
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(loss, list(pm.parameters()),
                                allow_unused=True)
    want = from_jax_variables({"params": jgrads})
    assert set(want) == set(names)
    top = max(float(w.abs().max()) for w in want.values())
    for n, g in zip(names, grads):
        g = torch.zeros_like(want[n]) if g is None else g
        if n == "gst.mha.linear_k.bias":
            # zero in exact arithmetic (it shifts every score of a softmax
            # row alike): both sides hold rounding noise
            assert float(g.abs().max()) <= 1e-6 * top, n
            continue
        _close(g.numpy(), want[n].numpy(), 1e-4, f"{name} grad {n}")
    # the updated EMA banks, not yet committed to the buffers
    if ema:
        new = jnew["ema"]
        assert set(pm.pending_ema) == set(new) == set(ema)
        for n, state in pm.pending_ema.items():
            assert bool(state.initted)
            for key, a, b in zip(("emb", "emb_sum", "emb_elem"), state[1:],
                                 tuple(new[n])[1:]):
                _close(a.numpy(), b, 1e-5, f"{name} {n}.{key}")
            np.testing.assert_array_equal(getattr(pm, n).emb.numpy(),
                                          ema[n][1])
    else:
        assert not pm.pending_ema


def test_encode_and_infer_of_a_padded_batch_match_jax(case):
    name, cfg, pm, (_, _, _, _, jenc, jmel), (x, y), _ = case
    n = torch.from_numpy(LENGTHS)
    with torch.no_grad():
        enc = pm.encode(torch.from_numpy(x), n)
        mel = pm.infer(torch.from_numpy(x), torch.from_numpy(y), n)
    if name.startswith("vqvae2_"):
        (ids, style), (jids, jstyle) = enc, jenc
        assert (style is None) == (jstyle is None)
        if style is not None:
            _close(style.numpy(), jstyle, 1e-5, f"{name} style")
    else:
        ids, jids = enc, jenc
    assert len(ids) == len(jids)
    for a, b in zip(ids, jids):
        if b.dtype.kind == "f":        # vqvae2a/2b's GST entry
            _close(a.numpy(), b, 1e-5, f"{name} style")
        else:
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    valid = np.arange(T)[None] < LENGTHS[:, None]
    _close(mel.numpy()[valid], jmel[valid], 1e-4, f"{name} mel")
    if not cfg.get("upsample_last"):
        # the last decoder masks its output (with upsample_last the last
        # step is the upsampling, which repeats the last real frame)
        assert not mel.numpy()[~valid].any()


def test_padded_batch_equals_unpadded_runs(case):
    name, cfg, pm, _, (x, y), _ = case
    with torch.no_grad():
        mel = pm.infer(torch.from_numpy(x), torch.from_numpy(y),
                       torch.from_numpy(LENGTHS)).numpy()
        for b, n in enumerate(LENGTHS):
            one = pm.infer(torch.from_numpy(x[b:b + 1, :n]),
                           torch.from_numpy(y[b:b + 1])).numpy()
            _close(mel[b:b + 1, :n], one, 1e-5, f"{name} row {b}")


def test_bf16_compute_keeps_the_gst_in_fp32():
    """Under bf16 compute the GST level (parameters, attention, output) and
    ``gst_in_rms`` stay fp32, as the JAX package pins them."""
    cfg = dict(make_cfg(use_gst=True, use_ema=False),
               compute_dtype="bfloat16")
    pm = build_model(cfg, device="cpu").init_random(0)
    assert pm.gst.dtype == torch.float32 and pm.gst.mha.dtype == torch.float32
    x, y = _inputs(1)
    _, loss, detail = pm(torch.from_numpy(x), torch.from_numpy(y), True)
    assert detail["gst_in_rms"].dtype == torch.float32
    assert np.isfinite(float(loss))
    ids, style = pm.encode(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    assert style.dtype == torch.float32 and len(ids) == 2
