"""The port's parallel slice against the JAX package's, on the CPU.

Four ranks are spawned once for the whole file (``parallel/launch.spawn``,
gloo); they run every case and write the results, and one test per case
compares them with the JAX package run here on ``tests/conftest.py``'s
virtual devices. The ranks import only the port. Two-rank cases run on the
``data`` axis of a ``{"data": 2, "rep": 2}`` mesh: the two ``rep`` rows
repeat the same computation.

Candidates: the EMA codebook's lazy-init and restart candidates are
injected on both sides (one fixed (K, D) array from every rank's draw, and
the first K rows of the gathered pool), so the data-parallel steps, the
JAX ``make_shard_map_step``, the JAX GSPMD trainer and one process on the
global batch all see the same codebook. One case runs without injection
and checks that the ranks still commit the same codebook.

Tolerances (fp32): the explicit DP step's parameters and codebook within
rtol 2e-5, atol 2e-6 and "X like" within 1e-5, the bounds of
``tests/test_parallel.py``; the TP step's loss within rtol 2e-5 of the DP
step's and of the JAX TP trainer's; the halo conv and the sequence-parallel
output within 1e-5 (ids equal); the sharded GroupNorm within rtol 1e-4,
atol 1e-5.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vae_npvc_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_compiles():
    """The JAX references compile afresh in this module: an executable
    loaded from the persistent compilation cache can round apart from a
    fresh one, and a VQ near tie then picks another code (seen as a 2.5e-4
    step of "X like" between two runs of the same JAX step). JAX decides
    once per process whether it uses the cache, so the flag alone is too
    late after an earlier module compiled: the cache is reset with it."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


TINY = {
    "model_type": "vae_npvc.model.vqvae",
    "seed": 7,
    "y_dim": 8, "y_num": 3, "z_dim": 8, "z_num": 16,
    "use_ema": True, "beta": 0.01, "mu": 0.9, "jitter_p": 0.0,
    "optim_type": "Adam", "learning_rate": 1e-3, "max_grad_norm": 10,
    "use_pallas_vq": False, "use_native_loader": False,
    "encoder": {"in_channels": [10], "out_channels": [12], "kernel_size": 3,
                "downsample_scales": [1], "z_channels": 8, "dilation": False,
                "stack_kernel_size": 3, "stack_layers": 1, "stacks": [1],
                "use_weight_norm": True},
    "decoder": {"in_channels": [8], "out_channels": [12], "cond_channels": 8,
                "skip_channels": 8, "final_channels": 10, "kernel_size": 3,
                "upsample_scales": [1], "dilation": False,
                "stack_kernel_size": 3, "stacks": [1],
                "use_weight_norm": True},
}
TP = {**TINY, "tp_min_param_size": 64}
NORM = {**TINY, "use_ema": False, "quantizer": {"normalize": True}}
SEQ = {**TINY,
       "encoder": dict(TINY["encoder"], dilation=True, stacks=[2]),
       "decoder": dict(TINY["decoder"], dilation=True, stacks=[2])}
STEPS = 3


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(8, 16, 10)).astype(np.float32),
            np.arange(8, dtype=np.int32) % 3)


def _candidates():
    return np.random.default_rng(11).normal(size=(16, 8)).astype(np.float32)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _ckpt_leaves(path):
    from vae_npvc_tpu_torch.utils import msgpack_io

    return _leaves(msgpack_io.msgpack_restore(Path(path).read_bytes()))


# ------------------------------------------------------------------ ranks
def _inject_port():
    from vae_npvc_tpu_torch.ops import vq

    C = torch.from_numpy(_candidates())
    vq._tiled_candidates = lambda gen, z, K: C.clone().to(z.device)
    vq._pick = lambda gen, n, K, device: torch.arange(K, device=device)


def _steps(trainer, batch, n=STEPS):
    return [{k: float(v) for k, v in trainer.train_step(batch).items()}
            for _ in range(n)]


def _halo_cases(mesh, ins, res):
    from vae_npvc_tpu_torch.parallel import comm, halo

    ax = mesh.axis("data")
    with comm.bind(mesh, ("data",)):
        def local(x):
            T = x.shape[1] // ax.size
            return torch.from_numpy(x[:, ax.index * T:(ax.index + 1) * T])

        def whole(y):
            return torch.cat(list(comm.all_gather(y.contiguous(), "data")),
                             dim=1).numpy()

        w, b = torch.from_numpy(ins["conv_w"]), torch.from_numpy(ins["conv_b"])
        res["conv"] = whole(halo.sharded_conv1d(
            local(ins["conv_x"]), w, b, halo.receptive_halo(3, [2]), "data",
            dilation=2))
        for masked in (False, True):
            m = local(ins["gn_mask"]) if masked else None
            res[f"gn_{masked}"] = whole(halo.psum_group_norm(
                local(ins["gn_x"]), torch.from_numpy(ins["gn_scale"]),
                torch.from_numpy(ins["gn_bias"]), 2, "data", valid_mask=m))
        # each row's valid prefix as local lengths: K2's split path
        T = ins["gn_x"].shape[1] // ax.size
        n = torch.from_numpy(np.clip(
            ins["gn_lengths"] - ax.index * T, 0, T).astype(np.int32))
        for glu in (False, True):
            res[f"gn_lengths_{glu}"] = whole(halo.psum_group_norm(
                local(ins["gn_x"]), torch.from_numpy(ins["gn_scale"]),
                torch.from_numpy(ins["gn_bias"]), 2, "data", lengths=n,
                glu=glu))


def _seq_case(mesh, ins, res):
    from vae_npvc_tpu_torch.parallel import comm
    from vae_npvc_tpu_torch.parallel.seq_infer import (
        sequence_parallel_infer, sequence_parallel_model)
    from vae_npvc_tpu_torch.utils.bridge import from_jax_variables

    state = from_jax_variables(_unflatten(ins, "seq_var/"))
    x, y = ins["seq_x"], ins["seq_y"]
    model = sequence_parallel_model(SEQ, state, "cpu")
    res["seq_out"] = sequence_parallel_infer(SEQ, state, x, y, mesh,
                                             device="cpu",
                                             model=model).numpy()
    ax = mesh.axis("data")
    T = x.shape[1] // ax.size
    with comm.bind(mesh, ("data",)), torch.no_grad():
        ids = model.encode(torch.from_numpy(
            x[:, ax.index * T:(ax.index + 1) * T]))
        res["seq_ids"] = torch.cat(list(comm.all_gather(ids, "data")),
                                   dim=1).numpy()


def _unflatten(ins, prefix):
    tree = {}
    for k in ins.files:
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = ins[k]
    return tree


def _ranks(rank, world, out, inputs):
    from vae_npvc_tpu_torch.parallel import comm
    from vae_npvc_tpu_torch.parallel.mesh import Mesh, make_mesh
    from vae_npvc_tpu_torch.train.trainer import Trainer

    out = Path(out)
    ins = np.load(inputs)
    res, meta = {}, {}
    m2 = Mesh({"data": 2, "rep": 2})
    _halo_cases(m2, ins, res)
    _seq_case(m2, ins, res)
    batch = (ins["feats"], ins["spks"])

    # without injection: the ranks still commit one codebook
    t = Trainer(TINY, device="cpu", mesh=m2)
    t.load_checkpoint(out / "init.ckpt")
    _steps(t, batch, 2)
    with comm.bind(m2):
        embs = comm.all_gather(t.ema["quantizer"].emb, "data")
    meta["free_emb_equal"] = bool(torch.equal(embs[0], embs[1]))

    _inject_port()
    for name, cfg, ck in (("dp", TINY, "init.ckpt"),
                          ("norm", NORM, "norm_init.ckpt")):
        t = Trainer(cfg, device="cpu", mesh=m2)
        t.load_checkpoint(out / ck)
        meta[name] = _steps(t, batch)
        t.save_checkpoint(out / f"{name}.ckpt")

    m22 = make_mesh(2, 2)
    t = Trainer(TP, device="cpu", mesh=m22)
    t.load_checkpoint(out / "init.ckpt")
    meta["tp_split"] = sorted(k for k, s in t._tp.specs.items() if s)
    meta["tp_local"] = int(t._opt_vector().numel())
    meta["tp"] = _steps(t, batch)
    t.save_checkpoint(out / "tp.ckpt")
    t2 = Trainer(TP, device="cpu", mesh=m22)
    assert t2.load_checkpoint(out / "tp.ckpt") == STEPS
    meta["tp_reload_flat"] = bool(torch.equal(t2.flat, t.flat))
    meta["tp_reload_mu"] = bool(torch.equal(t2.opt_state.mu,
                                            t.opt_state.mu))
    t2.save_checkpoint(out / "tp_again.ckpt")
    meta["tp_next"] = _steps(t2, batch, 1)[0]["Total"]
    if rank == 0:
        np.savez(out / "port.npz", **res)
        (out / "port.json").write_text(json.dumps(meta))


# ------------------------------------------------------------------- JAX
def _jax_inputs(out):
    """The seq-infer variables (random codebook), the halo and GroupNorm
    inputs and the JAX-initialized checkpoints the ranks start from."""
    import jax
    import jax.numpy as jnp

    from vae_npvc_tpu.models import build_model
    from vae_npvc_tpu.train.trainer import Trainer

    ins = {}
    rng = np.random.default_rng(1)
    ins["conv_x"] = rng.normal(size=(2, 64, 6)).astype(np.float32)
    ins["conv_w"] = (rng.normal(size=(3, 6, 8)) * 0.2).astype(np.float32)
    ins["conv_b"] = rng.normal(size=(8,)).astype(np.float32)
    ins["gn_x"] = rng.normal(2.0, 3.0, size=(2, 64, 8)).astype(np.float32)
    ins["gn_scale"] = rng.normal(size=(8,)).astype(np.float32)
    ins["gn_bias"] = rng.normal(size=(8,)).astype(np.float32)
    ins["gn_mask"] = (rng.random((2, 64, 1)) > 0.3).astype(np.float32)
    # one row ends in the first rank's half: the second holds none of it
    ins["gn_lengths"] = np.array([50, 20], np.int32)

    model = build_model(SEQ)
    x = rng.normal(size=(1, 128, 10)).astype(np.float32)
    y = np.zeros((1,), np.int32)
    variables = jax.device_get(model.init(
        {"params": jax.random.PRNGKey(0), "vq": jax.random.PRNGKey(1)},
        jnp.asarray(x), jnp.asarray(y), train=True))
    variables = {"params": variables["params"],
                 "ema": jax.tree_util.tree_map(np.asarray, variables["ema"])}
    q = variables["ema"]["quantizer"]
    variables["ema"]["quantizer"] = q._replace(
        emb=rng.normal(size=np.shape(q.emb)).astype(np.float32))
    ins["seq_x"], ins["seq_y"] = x, y
    for k, v in _leaves({"params": variables["params"]}).items():
        ins["seq_var/" + k] = v
    for k, v in _leaves({"ema": {"quantizer": variables["ema"][
            "quantizer"]._asdict()}}).items():
        ins["seq_var/" + k] = v
    ins["feats"], ins["spks"] = _batch()
    np.savez(out / "inputs.npz", **ins)
    for cfg, name in ((TINY, "init.ckpt"), (NORM, "norm_init.ckpt")):
        t = Trainer(cfg)
        t.init_state(_batch())
        t.save_checkpoint(str(out / name))
    return variables


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(output dir, JAX seq variables) after the ranks ran every case."""
    out = tmp_path_factory.mktemp("parallel")
    variables = _jax_inputs(out)
    spawn(_ranks, 4, args=(str(out), str(out / "inputs.npz")), timeout=300)
    return out, variables


@pytest.fixture(scope="module")
def port(run):
    out, _ = run
    return (dict(np.load(out / "port.npz")),
            json.loads((out / "port.json").read_text()))


def _two_devices():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:2]), ("data",))


def _jax_candidates(mp):
    """Inject the fixed candidates into the JAX step (every shard's draw)
    and take the first K rows of a gathered pool."""
    import jax
    import jax.numpy as jnp

    from vae_npvc_tpu.ops import vq as jvq

    C = _candidates()
    mp.setattr(jvq, "_tiled_candidates",
               lambda rng, z, K: jnp.asarray(C, z.dtype))
    mp.setattr(jax.random, "permutation",
               lambda key, n, *a, **k: jnp.arange(n))


# ------------------------------------------------------------------ tests
def test_make_mesh_errors_match_jax():
    import jax

    from vae_npvc_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from vae_npvc_tpu_torch.parallel.mesh import make_mesh

    one = jax.devices()[:1]
    for kw in ({"n_data": 3, "n_model": 2}, {"n_model": 2}):
        with pytest.raises(ValueError) as want:
            jax_make_mesh(devices=one, **kw)
        with pytest.raises(ValueError) as got:
            make_mesh(**kw)
        assert str(got.value) == str(want.value)
    m = make_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.axis("data").size == 1


def test_param_spec_matches_jax():
    from vae_npvc_tpu.parallel.tp import param_spec as jax_spec
    from vae_npvc_tpu_torch.parallel.tp import param_spec

    cases = [((3, 512, 512), 2, 1024), ((3, 512, 1024), 2, 1024),
             ((8,), 2, 1024), ((3, 5, 7), 2, 0), ((3, 512, 512), 1, 0),
             ((512, 1024), 4, 64), ((1024,), 2, 64), ((6, 6), 3, 0)]
    for shape, n, size in cases:
        assert param_spec(shape, n, size) == tuple(jax_spec(shape, n, size))


def test_shard_params_match_the_trainers_layout():
    """``shard_params`` cuts each parameter as ``TpLayout`` lays the slices
    out in the flat vector; ``constrain_params`` takes whole parameters or
    slices and refuses any other shape."""
    from types import SimpleNamespace

    from vae_npvc_tpu_torch.models import build_model
    from vae_npvc_tpu_torch.parallel.tp import (TpLayout, constrain_params,
                                                param_partition_specs,
                                                shard_params)

    model = build_model(TP, device="cpu").init_random(0)
    params = dict(model.named_parameters())
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    flat = torch.cat([v.detach().reshape(-1) for v in params.values()])
    for r in range(2):
        mesh = SimpleNamespace(shape={"data": 1, "model": 2},
                               coords={"data": 0, "model": r})
        specs = param_partition_specs(params, mesh, 64)
        local = shard_params(params, mesh, 64)
        layout = TpLayout(list(shapes.items()), 2, r, 64)
        split = [k for k, s in specs.items() if s]
        assert split and layout.specs == specs
        want = torch.cat([local[k].reshape(-1) for k in split]
                         + [local[k].reshape(-1) for k in params
                            if k not in split])
        assert torch.equal(layout.local(flat), want.detach())
        pinned = constrain_params({**params, **{k: local[k] for k in
                                                split[:1]}}, mesh, shapes, 64)
        assert all(torch.equal(pinned[k], local[k]) for k in params)
        with pytest.raises(ValueError, match="neither"):
            constrain_params({split[0]: params[split[0]][..., :1]}, mesh,
                             shapes, 64)


def test_halo_conv_and_sharded_group_norm_match_jax(run, port):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from vae_npvc_tpu.parallel import halo as jhalo

    out, _ = run
    res, _ = port
    ins = np.load(out / "inputs.npz")
    mesh = _two_devices()
    spec = P(None, "data", None)
    w, b = jnp.asarray(ins["conv_w"]), jnp.asarray(ins["conv_b"])
    conv = shard_map(lambda x: jhalo.sharded_conv1d(
        x, w, b, jhalo.receptive_halo(3, [2]), "data", dilation=2),
        mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
    np.testing.assert_allclose(res["conv"],
                               np.asarray(conv(jnp.asarray(ins["conv_x"]))),
                               rtol=1e-5, atol=1e-5)
    for masked in (False, True):
        def gn(x, m):
            return jhalo.psum_group_norm(
                x, jnp.asarray(ins["gn_scale"]), jnp.asarray(ins["gn_bias"]),
                2, "data", valid_mask=m if masked else None)

        want = shard_map(gn, mesh=mesh, in_specs=(spec, spec),
                         out_specs=spec, check_vma=False)(
            jnp.asarray(ins["gn_x"]), jnp.asarray(ins["gn_mask"]))
        np.testing.assert_allclose(res[f"gn_{masked}"], np.asarray(want),
                                   rtol=1e-4, atol=1e-5, err_msg=str(masked))
    del jax


def test_sharded_group_norm_with_lengths_matches_jax(run, port):
    """Local lengths (K2's split path) against JAX's ``psum_group_norm``
    with the prefix as its mask; the port zeros the output past the
    lengths, before the GLU (rtol 1e-4, atol 1e-5, as above)."""
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from vae_npvc_tpu.parallel import halo as jhalo

    out, _ = run
    res, _ = port
    ins = np.load(out / "inputs.npz")
    B, T, C = ins["gn_x"].shape
    mask = (np.arange(T)[None, :, None]
            < ins["gn_lengths"][:, None, None]).astype(np.float32)
    spec = P(None, "data", None)
    want = shard_map(lambda x, m: jhalo.psum_group_norm(
        x, jnp.asarray(ins["gn_scale"]), jnp.asarray(ins["gn_bias"]), 2,
        "data", valid_mask=m), mesh=_two_devices(), in_specs=(spec, spec),
        out_specs=spec, check_vma=False)(jnp.asarray(ins["gn_x"]),
                                         jnp.asarray(mask))
    want = np.asarray(want) * mask
    np.testing.assert_allclose(res["gn_lengths_False"], want, rtol=1e-4,
                               atol=1e-5)
    H = C // 2
    glu = np.tanh(want[..., :H]) / (1.0 + np.exp(-want[..., H:]))
    np.testing.assert_allclose(res["gn_lengths_True"], glu, rtol=1e-4,
                               atol=1e-5)


def test_sequence_parallel_infer_matches_jax(run, port):
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from vae_npvc_tpu.models import build_model
    from vae_npvc_tpu.parallel.seq_infer import sequence_parallel_infer

    out, variables = run
    res, _ = port
    ins = np.load(out / "inputs.npz")
    mesh = _two_devices()
    x, y = jnp.asarray(ins["seq_x"]), jnp.asarray(ins["seq_y"])
    want = sequence_parallel_infer(SEQ, variables, x, y, mesh)
    np.testing.assert_allclose(res["seq_out"], np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    seq_model = build_model({**SEQ, "seq_axis": "data"})
    ids = shard_map(lambda xs: seq_model.apply(variables, xs,
                                               method="encode"),
                    mesh=mesh, in_specs=P(None, "data"),
                    out_specs=P(None, "data"), check_vma=False)(x)
    np.testing.assert_array_equal(res["seq_ids"], np.asarray(ids))
    # and the single-device infer of the whole utterance
    model = build_model(SEQ)
    whole = model.apply(variables, x, y, method="infer")
    np.testing.assert_allclose(res["seq_out"], np.asarray(whole), rtol=1e-5,
                               atol=1e-5)


def _jax_shard_map_run(cfg, ckpt, tmp):
    """STEPS explicit shard_map steps on two devices from ``ckpt``; the
    per-step detail and the final checkpoint's leaves."""
    import jax

    from vae_npvc_tpu.parallel.shard import make_shard_map_step
    from vae_npvc_tpu.train.trainer import Trainer

    batch = _batch()
    t = Trainer(cfg, mesh=_two_devices())
    t.load_checkpoint(str(ckpt), example_batch=batch)
    step = make_shard_map_step(t)
    state, details = t.state, []
    for _ in range(STEPS):
        feats, spks = t.shard_batch(batch)
        state, detail = step(state, feats, spks, t.base_rng)
        details.append({k: float(v) for k, v in
                        jax.device_get(detail).items()})
    t.state, t._host_iter = state, STEPS
    t.save_checkpoint(str(tmp / "jax.ckpt"))
    return details, _ckpt_leaves(tmp / "jax.ckpt")


def _assert_state(got, want, what):
    for k, v in want.items():
        if k.startswith(("model/", "ema/")):
            np.testing.assert_allclose(got[k], v, rtol=2e-5, atol=2e-6,
                                       err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name,cfg,ckpt", [
    ("dp", TINY, "init.ckpt"), ("norm", NORM, "norm_init.ckpt")])
def test_dp_step_matches_jax_shard_map_step(run, port, name, cfg, ckpt,
                                            tmp_path):
    out, _ = run
    _, meta = port
    with pytest.MonkeyPatch.context() as mp:
        _jax_candidates(mp)
        details, want = _jax_shard_map_run(cfg, out / ckpt, tmp_path)
    for i, (got, ref) in enumerate(zip(meta[name], details)):
        np.testing.assert_allclose(got["X like"], ref["X like"], rtol=1e-5,
                                   err_msg=f"step {i}")
    got = _ckpt_leaves(out / f"{name}.ckpt")
    assert set(got) == set(want)
    _assert_state(got, want, name)


def test_dp_ranks_commit_one_codebook_without_injection(port):
    _, meta = port
    assert meta["free_emb_equal"]


def test_tp_step_matches_dp_and_jax_tp_trainer(run, port):
    import jax

    from vae_npvc_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from vae_npvc_tpu.train.trainer import Trainer

    out, _ = run
    _, meta = port
    # at least one parameter is really split, and the local vector is
    # smaller than the whole
    assert meta["tp_split"], meta["tp_split"]
    flat = _ckpt_leaves(out / "tp.ckpt")
    n_params = sum(v.size for k, v in flat.items() if k.startswith("model/"))
    assert meta["tp_local"] < n_params
    for got, want in zip(meta["tp"], meta["dp"]):
        np.testing.assert_allclose(got["Total"], want["Total"], rtol=2e-5)
    with pytest.MonkeyPatch.context() as mp:
        _jax_candidates(mp)
        t = Trainer(TP, mesh=jax_make_mesh(n_data=4, n_model=2))
        t.load_checkpoint(str(out / "init.ckpt"), example_batch=_batch())
        totals = [float(jax.device_get(t.train_step(_batch())["Total"]))
                  for _ in range(STEPS)]
    for got, want in zip(meta["tp"], totals):
        np.testing.assert_allclose(got["Total"], want, rtol=2e-5)
    _assert_state(flat, _ckpt_leaves(out / "dp.ckpt"), "tp vs dp")


def test_tp_checkpoint_round_trip(run, port):
    out, _ = run
    _, meta = port
    assert meta["tp_reload_flat"] and meta["tp_reload_mu"]
    assert (out / "tp.ckpt").read_bytes() == (out / "tp_again.ckpt") \
        .read_bytes()
    assert np.isfinite(meta["tp_next"])
