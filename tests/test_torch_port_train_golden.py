"""The port's ``Trainer`` in lockstep with the JAX ``Trainer``, and the
committed JAX training fixture.

``tests/torch_port_fixtures/train_golden*`` holds a tiny fp32 flat EMA
VQ-VAE run made by the JAX ``Trainer`` on the CPU: the initial checkpoint in
the JAX format (codebook initialized from the encoder's outputs, every code
alive, so no step draws restart candidates), six batches, JAX's per-step
detail, and the final checkpoint (parameters, EMA state, Adam moments). A
host with the port but without JAX (``chip_smoke.py`` on a GPU machine)
holds the port's ``Trainer`` against it. Regenerate with

    python -m tests.test_torch_port_train_golden

(from the repo root, with JAX on the CPU at full matmul precision, as
``tests/conftest.py`` sets it).

One module-scoped JAX ``Trainer`` serves every test here: the fixture's
regeneration, ``grad_accum``, the non-finite guard and the checkpoints both
ways. Tolerances (fp32, CPU against CPU): per-step losses and ``grad_norm``
1e-5 relative, parameters, EMA state and Adam moments 2e-6 absolute +
1e-4 relative after six steps (summation order only; the gradient clip
bites on every step and the StepLR boundary is crossed at step 4).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
FIXTURES = Path(__file__).resolve().parent / "torch_port_fixtures"
STEPS = 6
DETAIL_KEYS = ("Total", "VQ loss", "X like", "grad_norm", "usage",
               "skipped_nonfinite")

TRAIN_GOLDEN_CONFIG = {
    "model_type": "vae_npvc.model.vqvae",
    "trainer_type": "vae_npvc.trainer.basic",
    "compute_dtype": "float32", "seed": 7,
    "y_dim": 8, "y_num": 3, "z_dim": 8, "z_num": 8,
    "use_ema": True, "beta": 0.01, "mu": 0.9, "jitter_p": 0.0,
    "optim_type": "Adam", "learning_rate": 1e-3, "max_grad_norm": 0.5,
    "lr_scheduler": "StepLR", "lr_param": {"step_size": 4, "gamma": 0.5},
    "use_pallas_vq": False, "use_native_loader": False,
    "encoder": {"in_channels": [10], "out_channels": [16], "kernel_size": 3,
                "downsample_scales": [1], "z_channels": 8, "dilation": False,
                "stack_kernel_size": 3, "stack_layers": 1, "stacks": [2],
                "use_weight_norm": True},
    "decoder": {"in_channels": [8], "out_channels": [16], "cond_channels": 8,
                "skip_channels": 8, "final_channels": 10, "kernel_size": 3,
                "upsample_scales": [1], "dilation": False,
                "stack_kernel_size": 3, "stacks": [2],
                "use_weight_norm": True},
}


def _batches():
    rng = np.random.default_rng(20261017)
    return [(rng.normal(size=(4, 32, 10)).astype(np.float32),
             rng.integers(0, 3, size=(4,)).astype(np.int32))
            for _ in range(STEPS)]


def make_jax_trainer():
    """The JAX ``Trainer`` at step 0 with the fixture's initial state, and
    that state's checkpoint bytes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from vae_npvc_tpu.ops.vq import EmaVqState
    from vae_npvc_tpu.train.trainer import Trainer

    cfg = TRAIN_GOLDEN_CONFIG
    tr = Trainer(cfg, mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))
    batches = _batches()
    tr.init_state(batches[0])
    # codebook from the encoder's own outputs, large counts: every code
    # stays above the restart threshold for the whole run
    z = np.asarray(tr.model.apply(
        {"params": tr.state.params, **tr.state.ema},
        jnp.asarray(batches[0][0]), method=lambda m, a: m.encoder(a)))
    K = cfg["z_num"]
    emb = z.reshape(-1, z.shape[-1])[::16][:K].copy()
    elem = np.full((K,), 8.0, np.float32)
    ema = {"ema": {"quantizer": EmaVqState(
        jnp.asarray(True), jnp.asarray(emb), jnp.asarray(emb * elem[:, None]),
        jnp.asarray(elem))}}
    tr.state = tr.state.replace(ema=ema)
    return tr, batches


def _checkpoint_bytes(tr, tmp):
    path = Path(tmp) / "state.ckpt"
    tr.save_checkpoint(path)
    return path.read_bytes()


def make_train_golden(tr, batches, tmp):
    """Run the fixture with JAX: (initial ckpt bytes, final ckpt bytes,
    arrays dict)."""
    first = _checkpoint_bytes(tr, tmp)
    details = [tr.train_step(b) for b in batches]
    arrays = {f"feats_{i}": b[0] for i, b in enumerate(batches)}
    arrays.update({f"spks_{i}": b[1] for i, b in enumerate(batches)})
    for k in DETAIL_KEYS:
        arrays["detail/" + k] = np.asarray(
            [float(d[k]) for d in details], np.float64)
    return first, _checkpoint_bytes(tr, tmp), arrays


def write_train_golden(out_dir=FIXTURES):
    import tempfile

    tr, batches = make_jax_trainer()
    with tempfile.TemporaryDirectory() as tmp:
        first, final, arrays = make_train_golden(tr, batches, tmp)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "train_golden.msgpack").write_bytes(first)
    (out_dir / "train_golden_final.msgpack").write_bytes(final)
    np.savez_compressed(out_dir / "train_golden.npz", **arrays)
    (out_dir / "train_golden_config.json").write_text(
        json.dumps(TRAIN_GOLDEN_CONFIG, indent=1) + "\n")


# ------------------------------------------------------------------ helpers
def load_fixture(fixtures=FIXTURES):
    """(config, batches, per-step detail dict) of the committed fixture."""
    cfg = json.loads((fixtures / "train_golden_config.json").read_text())
    g = np.load(fixtures / "train_golden.npz")
    batches = [(g[f"feats_{i}"], g[f"spks_{i}"]) for i in range(STEPS)]
    return cfg, batches, {k: g["detail/" + k] for k in DETAIL_KEYS}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_state_close(got_ckpt, want_ckpt, atol=2e-6, rtol=1e-4):
    """Two checkpoint payloads: same trees, every leaf close."""
    from vae_npvc_tpu_torch.utils import msgpack_io

    a = _leaves(msgpack_io.msgpack_restore(got_ckpt))
    b = _leaves(msgpack_io.msgpack_restore(want_ckpt))
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def _port_trainer(ckpt_path, **overrides):
    from vae_npvc_tpu_torch.train import build_trainer

    tr = build_trainer(dict(TRAIN_GOLDEN_CONFIG, **overrides), device="cpu")
    assert tr.load_checkpoint(ckpt_path) == 0
    return tr


def _assert_detail(pd, jd, keys=DETAIL_KEYS):
    for k in keys:
        np.testing.assert_allclose(float(pd[k]), float(jd[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """(JAX trainer after the fixture's six steps, batches, initial ckpt
    path, regenerated (first, final, arrays))."""
    tmp = tmp_path_factory.mktemp("train_golden")
    tr, batches = make_jax_trainer()
    made = make_train_golden(tr, batches, tmp)
    first = tmp / "first.ckpt"
    first.write_bytes(made[0])
    return tr, batches, first, made


# -------------------------------------------------------------------- tests
def test_committed_train_fixture_matches_jax(jax_side):
    """Regenerating with JAX reproduces the committed fixture."""
    _, _, _, (first, final, arrays) = jax_side
    assert json.loads((FIXTURES / "train_golden_config.json").read_text()) \
        == TRAIN_GOLDEN_CONFIG
    committed = np.load(FIXTURES / "train_golden.npz")
    assert set(committed.files) == set(arrays)
    for k, v in arrays.items():
        if k.startswith("detail/"):
            np.testing.assert_allclose(v, committed[k], rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(v, committed[k])
    assert_state_close(first, (FIXTURES / "train_golden.msgpack")
                       .read_bytes(), atol=1e-6, rtol=1e-5)
    assert_state_close(final, (FIXTURES / "train_golden_final.msgpack")
                       .read_bytes())
    # every code alive on every step (no restart draws), the clip bites,
    # nothing skipped
    assert np.all(committed["detail/usage"] == TRAIN_GOLDEN_CONFIG["z_num"])
    assert np.all(committed["detail/grad_norm"]
                  > TRAIN_GOLDEN_CONFIG["max_grad_norm"])
    assert np.all(committed["detail/skipped_nonfinite"] == 0)
    size = sum((FIXTURES / n).stat().st_size for n in (
        "train_golden.msgpack", "train_golden_final.msgpack",
        "train_golden.npz"))
    assert size < 2_000_000


def test_port_trainer_tracks_fixture_on_cpu(tmp_path):
    """Lockstep over six steps from the JAX checkpoint: per-step detail,
    then parameters, EMA state, Adam moments and counts."""
    cfg, batches, want = load_fixture()
    assert cfg == TRAIN_GOLDEN_CONFIG
    tr = _port_trainer(FIXTURES / "train_golden.msgpack")
    for i, batch in enumerate(batches):
        detail = tr.train_step(batch)
        assert tr.iteration == i + 1
        _assert_detail(detail, {k: want[k][i] for k in DETAIL_KEYS})
    tr.save_checkpoint(tmp_path / "final.ckpt")
    assert_state_close((tmp_path / "final.ckpt").read_bytes(),
                       (FIXTURES / "train_golden_final.msgpack").read_bytes())
    # K sequential steps in one call are the same six steps
    tr2 = _port_trainer(FIXTURES / "train_golden.msgpack")
    stacked = tr2.train_steps(batches)
    assert stacked["Total"].shape == (STEPS,)
    np.testing.assert_allclose(stacked["Total"].numpy(), want["Total"],
                               rtol=1e-5)
    assert torch.equal(tr2.flat, tr.flat)


def test_grad_accum_and_nonfinite_guard_track_jax(jax_side):
    jtr, batches, first, _ = jax_side
    jtr.load_checkpoint(first)
    ptr = _port_trainer(first, grad_accum=2)
    jtr.grad_accum = 2
    try:
        for batch in batches[:2]:
            _assert_detail(ptr.train_step(batch), jtr.train_step(batch))
    finally:
        jtr.grad_accum = 1
    ptr.grad_accum = 1
    # a batch with an infinite frame: both skip the update and keep the
    # parameters, the moments and the EMA codebook
    bad = (batches[2][0].copy(), batches[2][1])
    bad[0][1, 5, 3] = np.inf
    before = ptr.flat.clone(), ptr.opt_state, ptr.model.quantizer.emb.clone()
    import jax
    jparams = jax.tree_util.tree_map(np.asarray, jtr.state.params)  # donated
    pd, jd = ptr.train_step(bad), jtr.train_step(bad)
    assert float(pd["skipped_nonfinite"]) == float(jd["skipped_nonfinite"]) \
        == 1.0
    assert torch.equal(ptr.flat, before[0])
    assert torch.equal(ptr.opt_state.mu, before[1].mu)
    assert int(ptr.opt_state.count) == int(before[1].count) == 2
    assert torch.equal(ptr.model.quantizer.emb, before[2])
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(
        jax.tree_util.tree_leaves(jtr.state.params),
        jax.tree_util.tree_leaves(jparams)))
    assert ptr.iteration == jtr.iteration == 3
    # and both carry on together
    _assert_detail(ptr.train_step(batches[3]), jtr.train_step(batches[3]))
    with pytest.raises(ValueError, match="divisible"):
        _port_trainer(first, grad_accum=3).train_step(batches[0])


def test_checkpoints_load_both_ways(jax_side, tmp_path):
    jtr, batches, first, _ = jax_side
    # JAX -> port is the lockstep test's start; here port -> JAX: the port
    # trains three steps and saves, JAX loads and both take the next step
    ptr = _port_trainer(first)
    for batch in batches[:3]:
        ptr.train_step(batch)
    path = tmp_path / "iter.3"
    ptr.save_checkpoint(path)
    assert jtr.load_checkpoint(path) == 3
    _assert_detail(ptr.train_step(batches[3]), jtr.train_step(batches[3]))
    # the port's own file restores its own state exactly
    ptr2 = _port_trainer(first)
    assert ptr2.load_checkpoint(path) == 3 and ptr2.iteration == 3
    ptr3 = _port_trainer(first)
    for batch in batches[:3]:
        ptr3.train_step(batch)
    assert torch.equal(ptr2.flat, ptr3.flat)
    assert torch.equal(ptr2.opt_state.nu, ptr3.opt_state.nu)
    assert int(ptr2.opt_state.sched_count) == 3
    # a checkpoint without optimizer state re-initializes the moments
    import jax

    from vae_npvc_tpu_torch.utils import msgpack_io
    from vae_npvc_tpu_torch.utils.bridge import to_jax_variables
    payload = msgpack_io.msgpack_restore(path.read_bytes())
    payload["optimizer"] = {}
    (tmp_path / "bare").write_bytes(msgpack_io.msgpack_serialize(payload))
    ptr2.load_checkpoint(tmp_path / "bare")
    assert int(ptr2.opt_state.count) == 0 and not ptr2.opt_state.mu.any()
    # weight-norm axis format 1 is migrated as the JAX trainer migrates it
    # (this tree already has the new layout, so no layer changes)
    payload["wn_axis_format"] = 1
    (tmp_path / "old").write_bytes(msgpack_io.msgpack_serialize(payload))
    assert ptr2.load_checkpoint(tmp_path / "old") == 3
    assert jtr.load_checkpoint(tmp_path / "old") == 3
    assert torch.equal(ptr2.flat, ptr3.flat)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        jax.tree_util.tree_leaves(jtr.state.params),
        jax.tree_util.tree_leaves(to_jax_variables(
            ptr2.model.state_dict())["params"])))


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    write_train_golden()
