"""Two processes joined by ``initialize_multihost`` over a localhost
``tcp://`` rendezvous (gloo), training the toy flat EMA VQ-VAE
data-parallel; the counterpart of ``tests/test_multihost.py``.

Both ranks must report the same losses, equal to one process on the global
batch (the port's ``Trainer`` without a mesh, and the JAX trainer on a
four-device mesh); the restart candidates are injected on every side (one
fixed array, the first K rows of the gathered pool). Validation streams of
unequal length (rank 0: batches of 4 and 3 rows, rank 1: one of 4) are
assembled into the same two global batches (4 + 4 rows, then 3) on both
ranks, equal to the single process's. Tolerance 1e-4 absolute on the
losses, as the JAX test holds its hosts to its oracle; the two ranks agree
exactly.
"""

import json
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.toy_config import toy_config
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



def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _data():
    config = toy_config()
    rng = np.random.default_rng(123)
    feats = rng.normal(size=(8, 16, 10)).astype(np.float32)
    spks = (np.arange(8) % config["y_num"]).astype(np.int32)
    vfeats = rng.normal(size=(11, 12, 10)).astype(np.float32)
    vspks = (np.arange(11) % config["y_num"]).astype(np.int32)
    return feats, spks, vfeats, vspks


def _inject():
    from vae_npvc_tpu_torch.ops import vq

    C = torch.from_numpy(np.random.default_rng(5).normal(size=(16, 8))
                         .astype(np.float32))
    vq._tiled_candidates = lambda gen, z, K: C.clone()
    vq._pick = lambda gen, n, K, device: torch.arange(K)


def _workload(trainer, rank=None):
    """Three steps, one two-step call, and validation: this rank's local
    stream (or, without a rank, the global batches)."""
    feats, spks, vfeats, vspks = _data()
    trainer.init_state((feats[:1], spks[:1]))
    totals = [float(trainer.train_step((feats, spks))["Total"])
              for _ in range(3)]
    scan = [float(x) for x in
            trainer.train_steps([(feats, spks), (feats, spks)])["Total"]]
    if rank is None:
        stream = [(vfeats[0:8], vspks[0:8]), (vfeats[8:11], vspks[8:11])]
    elif rank == 0:
        stream = [(vfeats[0:4], vspks[0:4]), (vfeats[8:11], vspks[8:11])]
    else:
        stream = [(vfeats[4:8], vspks[4:8])]
    valid = trainer.valid(stream)
    return {"totals": totals, "scan": scan, "valid": valid["Total"],
            "n_valid": len(valid["Total"])}


def _rank(rank, world, port, out):
    from vae_npvc_tpu_torch.parallel.mesh import (initialize_multihost,
                                                  make_mesh)
    from vae_npvc_tpu_torch.train.trainer import Trainer

    got = initialize_multihost(f"localhost:{port}", world, rank,
                               backend="gloo")
    assert got == (rank, world)
    _inject()
    trainer = Trainer(toy_config(), device="cpu", mesh=make_mesh())
    res = _workload(trainer, rank)
    Path(out, f"rank{rank}.json").write_text(json.dumps(res))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    try:
        port = _free_port()
    except OSError as e:  # pragma: no cover - env forbids sockets
        pytest.skip(f"environment forbids localhost sockets: {e}")
    out = tmp_path_factory.mktemp("multihost")
    spawn(_rank, 2, args=(port, str(out)), backend=None, timeout=240)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]


@pytest.fixture(scope="module")
def oracle():
    """One process on the global batches, candidates injected."""
    from vae_npvc_tpu_torch.ops import vq
    from vae_npvc_tpu_torch.train.trainer import Trainer

    saved = vq._tiled_candidates, vq._pick
    try:
        _inject()
        return _workload(Trainer(toy_config(), device="cpu"))
    finally:
        vq._tiled_candidates, vq._pick = saved


def test_ranks_agree_with_each_other(ranks):
    r0, r1 = ranks
    assert r0 == r1


def test_ranks_match_one_process_on_the_global_batch(ranks, oracle):
    r0 = ranks[0]
    for key in ("totals", "scan"):
        np.testing.assert_allclose(r0[key], oracle[key], rtol=0, atol=1e-4,
                                   err_msg=key)


def test_ragged_validation_streams_are_assembled(ranks, oracle):
    for r in ranks:
        assert r["n_valid"] == 2
        np.testing.assert_allclose(r["valid"], oracle["valid"], rtol=0,
                                   atol=1e-4)


def test_ranks_match_the_jax_trainer(ranks, tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from vae_npvc_tpu.ops import vq as jvq
    from vae_npvc_tpu.train.trainer import Trainer as JaxTrainer

    feats, spks, _, _ = _data()
    C = np.random.default_rng(5).normal(size=(16, 8)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvq, "_tiled_candidates",
                   lambda rng, z, K: jnp.asarray(C, z.dtype))
        t = JaxTrainer(toy_config(),
                       mesh=Mesh(np.asarray(jax.devices()[:4]), ("data",)))
        t.init_state((feats[:1], spks[:1]))
        # the port's seeded initial state
        from vae_npvc_tpu_torch.train.trainer import Trainer

        p = Trainer(toy_config(), device="cpu")
        p.init_state()
        path = tmp_path / "init"
        p.save_checkpoint(path)
        t.load_checkpoint(str(path))
        totals = [float(t.train_step((feats, spks))["Total"])
                  for _ in range(3)]
    np.testing.assert_allclose(ranks[0]["totals"], totals, rtol=0,
                               atol=1e-4)
