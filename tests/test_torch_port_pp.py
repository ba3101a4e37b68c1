"""The port's pipelined decoder stack (``parallel/pp.py``) against the
sequential stack and against the JAX package's ``pipeline_decoder_stack``.

Two ranks (gloo) are spawned once; they run the pipeline for (stages,
microbatches) in {(2, 2), (2, 4)} over the flat decoder's GLU res-skip
stack with JAX-initialized weights, the sequential stack on the same
inputs, and the gradient of a loss over the pipeline's output with respect
to every stacked parameter (each rank holds its stage's; the others'
are 0 there). Tolerances (fp32): outputs within 1e-6 of the sequential
stack and 1e-5 of JAX's; every gradient leaf within 1e-5 of its peak from
the sequential stack's and JAX's pipeline's.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vae_npvc_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

WIDTH, SKIP, COND, L, T = 12, 8, 6, 4, 16
CASES = ((2, 2), (2, 4))
CFG = {
    "model_type": "vae_npvc.model.vqvae",
    "y_dim": COND, "y_num": 3, "z_dim": 8, "z_num": 16,
    "use_ema": False, "beta": 0.01, "use_pallas_vq": False,
    "encoder": {"in_channels": [10], "out_channels": [WIDTH],
                "kernel_size": 3, "downsample_scales": [1],
                "z_channels": 8, "dilation": False,
                "stack_kernel_size": 3, "stack_layers": 1, "stacks": [1],
                "use_weight_norm": True},
    "decoder": {"in_channels": [8], "out_channels": [WIDTH],
                "cond_channels": COND, "skip_channels": SKIP,
                "final_channels": 10, "kernel_size": 3,
                "upsample_scales": [1], "dilation": False,
                "stack_kernel_size": 3, "stacks": [L],
                "use_weight_norm": True},
}


def _inputs(M):
    rng = np.random.default_rng(M)
    B = 2 * M
    return (rng.normal(size=(B, T, WIDTH)).astype(np.float32),
            rng.normal(size=(B, 1, COND)).astype(np.float32),
            rng.normal(size=(B, T, SKIP)).astype(np.float32))


def _unflatten(npz, prefix):
    tree = {}
    for k in npz.files:
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = npz[k]
    return tree


def _port_model(params):
    from vae_npvc_tpu_torch.models import build_model
    from vae_npvc_tpu_torch.utils.bridge import from_jax_variables

    m = build_model(CFG, device="cpu")
    m.load_state_dict(from_jax_variables({"params": params}), strict=True)
    return m


def _loss(h, skip, tgt):
    return ((skip - tgt) ** 2).mean() + 0.5 * (h ** 2).mean()


def _ranks(rank, world, out):
    from vae_npvc_tpu_torch.parallel import pp
    from vae_npvc_tpu_torch.parallel.mesh import Mesh

    out = Path(out)
    m = _port_model(_unflatten(np.load(out / "params.npz"), ""))
    names = pp.decoder_stack_names(CFG["decoder"])
    res, meta = {}, {}
    for P, M in CASES:
        mesh = Mesh({"pipe": P})
        stacked = {k: v.detach().clone().requires_grad_() for k, v in
                   pp.stack_layer_params(pp.decoder_layer_params(
                       m.decoder, names), names).items()}
        h, c, tgt = (torch.from_numpy(a) for a in _inputs(M))
        hp, sp = pp.pipeline_decoder_stack(CFG, stacked, h, c, mesh,
                                           microbatches=M)
        grads = torch.autograd.grad(_loss(hp, sp, tgt),
                                    list(stacked.values()))
        # this rank's layers, gathered over the pipe axis
        full = [g.clone() for g in grads]
        for g in full:
            torch.distributed.all_reduce(g)
        res[f"{P}_{M}/h"], res[f"{P}_{M}/skip"] = (hp.detach().numpy(),
                                                   sp.detach().numpy())
        for k, g in zip(stacked, full):
            res[f"{P}_{M}/grad/{k}"] = g.numpy()
        # zero outside this stage's layers
        k = L // P
        meta[f"{P}_{M}_own"] = all(
            float(g[j].abs().max()) == 0 for g in grads for j in range(L)
            if not rank * k <= j < (rank + 1) * k)
        # the sequential stack on the same inputs
        hs, ss = h, torch.zeros(h.shape[:2] + (SKIP,))
        seq_params = [p for n in names
                      for p in getattr(m.decoder, n).parameters()]
        for n in names:
            hs, s = getattr(m.decoder, n)(hs, c)
            ss = ss + s
        gs = torch.autograd.grad(_loss(hs, ss, tgt), seq_params)
        res[f"{P}_{M}/seq_h"], res[f"{P}_{M}/seq_skip"] = (
            hs.detach().numpy(), ss.detach().numpy())
        per = len(gs) // L
        for i, key in enumerate(stacked):
            res[f"{P}_{M}/seq_grad/{key}"] = torch.stack(
                [gs[j * per + i] for j in range(L)]).numpy()
    if rank == 0:
        np.savez(out / "port.npz", **res)
        (out / "port.json").write_text(json.dumps(meta))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from vae_npvc_tpu.models import build_model

    out = tmp_path_factory.mktemp("pp")
    model = build_model(CFG)
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "vq": jax.random.PRNGKey(1)},
                           jnp.zeros((2, T, 10)), jnp.zeros((2,), jnp.int32),
                           train=True)
    params = jax.device_get(variables["params"])

    def flat(tree, prefix=""):
        o = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                o.update(flat(v, f"{prefix}{k}/"))
            else:
                o[prefix + k] = np.asarray(v)
        return o

    np.savez(out / "params.npz", **flat(dict(params)))
    spawn(_ranks, 2, args=(str(out),), timeout=240)
    return (params, dict(np.load(out / "port.npz")),
            json.loads((out / "port.json").read_text()))


def _jax_pipeline(params, P, M):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from vae_npvc_tpu.nn.blocks import GLUResSkip
    from vae_npvc_tpu.parallel import pp as jpp

    h, c, tgt = (jnp.asarray(a) for a in _inputs(M))
    mesh = Mesh(np.array(jax.devices()[:P]), ("pipe",))
    names = jpp.decoder_stack_names(CFG["decoder"])
    stacked = jpp.stack_layer_params(params["decoder"], names)
    blk = GLUResSkip(WIDTH, COND, SKIP, 3, dilation=1, use_weight_norm=True)

    def block_apply(p, carry):
        hh, skip, cc = carry
        h2, s = blk.apply({"params": p}, hh, cc)
        return (h2, skip + s, cc)

    split = lambda x: x.reshape((M, x.shape[0] // M) + x.shape[1:])  # noqa

    skip0 = jnp.zeros(h.shape[:2] + (SKIP,))

    def loss(sp):
        hh, skip, _ = jpp.pipeline_stack(
            block_apply, sp, (split(h), split(skip0), split(c)), mesh)
        join = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
        hh, skip = join(hh), join(skip)
        return (jnp.mean((skip - tgt) ** 2) + 0.5 * jnp.mean(hh ** 2),
                (hh, skip))

    (_, (hh, skip)), g = jax.value_and_grad(loss, has_aux=True)(stacked)
    return np.asarray(hh), np.asarray(skip), jax.device_get(g)


def _flat_grads(tree, prefix=""):
    o = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            o.update(_flat_grads(v, f"{prefix}{k}."))
        else:
            o[prefix + k] = np.asarray(v)
    return o


@pytest.mark.parametrize("P,M", CASES)
def test_pipeline_matches_sequential_stack(run, P, M):
    _, res, meta = run
    key = f"{P}_{M}"
    np.testing.assert_allclose(res[key + "/h"], res[key + "/seq_h"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(res[key + "/skip"], res[key + "/seq_skip"],
                               rtol=0, atol=1e-6)
    assert meta[key + "_own"]          # gradients stay with their stage
    grads = [k for k in res if k.startswith(key + "/grad/")]
    assert grads
    for k in grads:
        ref = res[k.replace("/grad/", "/seq_grad/")]
        peak = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(res[k], ref, rtol=0, atol=1e-5 * peak,
                                   err_msg=k)


@pytest.mark.parametrize("P,M", CASES)
def test_pipeline_matches_jax_pipeline(run, P, M):
    from vae_npvc_tpu_torch.utils.bridge import params_from_flax

    params, res, _ = run
    key = f"{P}_{M}"
    hh, skip, g = _jax_pipeline(params, P, M)
    np.testing.assert_allclose(res[key + "/h"], hh, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res[key + "/skip"], skip, rtol=0, atol=1e-5)
    # JAX's stacked gradient tree, under the port's parameter names
    want = {k: np.asarray(v) for k, v in params_from_flax(g).items()}
    for name, ref in want.items():
        got = res[f"{key}/grad/{name}"]
        peak = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * peak,
                                   err_msg=name)


def test_dilated_stack_is_refused():
    from vae_npvc_tpu_torch.parallel import pp

    with pytest.raises(ValueError, match="dilated"):
        pp.decoder_stack_names({"stacks": [4], "dilation": True})
    with pytest.raises(ValueError, match="identical layers"):
        pp.stack_layer_params({"a": {"v": torch.zeros(3, 2, 4)},
                               "b": {"v": torch.zeros(3, 4, 4)}}, ["a", "b"])
