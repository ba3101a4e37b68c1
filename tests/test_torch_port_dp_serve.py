"""Data-parallel serving and the data-parallel vocoder trainer, on the CPU.

- ``Converter(mesh=...)`` on a local mesh of two CPU replicas converts a
  batch split along B equal to one replica (fp32, within 1e-6 of the
  peak: the replicas run the same kernels on half the rows).
- The engine's ``data_parallel``: ``max_batch`` rounded up to a multiple
  of the mesh size, every coalesced batch padded to one (the batcher's
  padding against the JAX package's ``_InferBatcher`` on the same
  groups), a bundle refused, and a two-replica engine serving the same
  mel as the plain one.
- ``PwgTrainer(mesh=...)`` on two gloo ranks, from the port's seeded
  state with JAX's noise (the global batch's, each rank its rows), across
  the discriminator's start: equal to one process on the global batch,
  and against the JAX ``PwgTrainer`` on a two-device mesh within the
  tolerances of ``tests/test_torch_port_pwg_train.py`` (see the tests'
  docstrings for G's moments).
"""

import json
import threading
import time
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


FEAT = {"fs": 8000, "n_fft": 128, "n_shift": 32, "n_mels": 10,
        "fmin": 0.0, "fmax": None, "win_length": None}
SPK = {"A": 0, "B": 1, "C": 2}


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """(config, checkpoint of a trained step, CMVN stats)."""
    from vae_npvc_tpu_torch.train.trainer import Trainer

    tmp = tmp_path_factory.mktemp("dp_serve")
    cfg = toy_config()
    tr = Trainer(cfg, device="cpu")
    tr.init_state()
    rng = np.random.default_rng(0)
    tr.train_step((rng.normal(size=(4, 32, 10)).astype(np.float32),
                   np.arange(4, dtype=np.int32) % 3))
    ck = tmp / "m.ckpt"
    tr.save_checkpoint(ck)
    stats = np.zeros((2, 11), np.float64)
    stats[0, :-1] = -3.0 * 1000
    stats[0, -1] = 1000
    stats[1, :-1] = (1.0 + 3.0 ** 2) * 1000
    return cfg, ck, stats


def test_converter_on_a_local_mesh_equals_one_replica(parts):
    from vae_npvc_tpu_torch.infer.convert import Converter
    from vae_npvc_tpu_torch.parallel.mesh import data_mesh

    cfg, ck, _ = parts
    one = Converter(cfg, device="cpu")
    two = Converter(cfg, mesh=data_mesh(["cpu", "cpu"]))
    assert one.load_checkpoint(ck) == two.load_checkpoint(ck)
    assert len(two.replicas) == 2
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(4, 48, 10)).astype(np.float32)
    tgts = np.array([0, 1, 2, 1], np.int32)
    lengths = np.array([48, 20, 33, 1], np.int32)
    want = one.infer(feats, tgts, lengths)
    got = two.infer(feats, tgts, lengths)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    with pytest.raises(ValueError, match="does not divide"):
        two.infer(feats[:3], tgts[:3], lengths[:3])


def _groups(batcher_cls, max_batch, pad_multiple, sizes):
    """The batch sizes a batcher submits for groups of ``sizes`` requests
    arriving together."""
    seen = []
    b = batcher_cls(lambda f, t, n: (seen.append(len(f)) or f),
                    max_batch=max_batch, window_ms=200.0,
                    pad_multiple=pad_multiple)
    try:
        for n in sizes:
            futs = [b.submit(np.zeros((8, 2), np.float32), 8, 0)
                    for _ in range(n)]
            for f in futs:
                f.result(timeout=30)
            time.sleep(0.05)
    finally:
        b.close()
    return seen


def test_batcher_pads_to_the_mesh_multiple_as_jax():
    from vae_npvc_tpu.serve.engine import _InferBatcher as JaxBatcher
    from vae_npvc_tpu_torch.serve.engine import _InferBatcher

    for max_batch, m, sizes in ((9, 3, (1, 2, 4, 9)), (8, 2, (1, 3, 5)),
                                (8, 1, (1, 3, 5))):
        got = _groups(_InferBatcher, max_batch, m, sizes)
        assert got == _groups(JaxBatcher, max_batch, m, sizes)
        assert all(b % m == 0 for b in got), got
    for cls in (_InferBatcher, JaxBatcher):
        with pytest.raises(ValueError, match="not divisible"):
            cls(lambda *a: None, max_batch=8, pad_multiple=3)


def test_engine_data_parallel_rounds_serves_and_refuses_bundles(parts):
    from vae_npvc_tpu_torch.parallel.mesh import data_mesh
    from vae_npvc_tpu_torch.serve import ConversionEngine

    cfg, ck, stats = parts

    def engine(**kw):
        return ConversionEngine(cfg, ck, stats, feature=FEAT,
                                spk2spk_id=SPK, bucket_frames=32,
                                vocoder="none", device="cpu", **kw)

    with pytest.raises(ValueError, match="bundle"):
        engine(data_parallel=True, bundle="b")
    plain = engine()
    dp = engine(data_parallel=data_mesh(["cpu", "cpu", "cpu"]), max_batch=8)
    try:
        assert dp.batcher.max_batch == 9 and dp.batcher.pad_multiple == 3
        assert len(dp.converter.replicas) == 3
        rng = np.random.default_rng(4)
        wavs = [rng.normal(size=(700 + 90 * i,)).astype(np.float32) * 0.1
                for i in range(3)]
        outs = {}

        def one(i):
            outs[i] = dp.convert(wavs[i], 8000, "ABC"[i], return_mel=True)[0]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(3):
            want = plain.convert(wavs[i], 8000, "ABC"[i], return_mel=True)[0]
            np.testing.assert_allclose(outs[i], want, rtol=1e-5, atol=1e-5)
    finally:
        plain.close()
        dp.close()


# ------------------------------------------------------------- vocoder
def _vocoder_sets():
    """``{name: (batches, noises)}``: the fixture's six steps of
    ``tests/test_torch_port_pwg_train.py`` (B = 2, one row a rank), and
    four steps at B = 4 (two rows a rank), both across the discriminator's
    start (step 3), with JAX's noise of the global batch."""
    from tests.test_torch_port_pwg_train import (HOP, M, N_MELS,
                                                 PWG_GOLDEN_CONFIG, _batches,
                                                 jax_noise)

    rng = np.random.default_rng(77)
    four = [((rng.normal(size=(4, M * HOP)) * 0.3).astype(np.float32),
             rng.normal(size=(4, M, N_MELS)).astype(np.float32))
            for _ in range(4)]
    seed = PWG_GOLDEN_CONFIG["seed"]
    return {name: (bs, [jax_noise(seed, i, (b[0].shape[0], M * HOP, 1))
                        for i, b in enumerate(bs)])
            for name, bs in (("fixture", _batches()), ("b4", four))}


def _vocoder_ranks(rank, world, out, cfg, names):
    from vae_npvc_tpu_torch.parallel.mesh import make_mesh
    from vae_npvc_tpu_torch.train.pwg import PwgTrainer

    out = Path(out)
    for name in names:
        ins = np.load(out / f"{name}.npz")
        tr = PwgTrainer(cfg, device="cpu", mesh=make_mesh())
        tr.init_state()
        tr.load_checkpoint(out / "seed.ckpt")
        details = []
        for i in range(len(ins.files) // 3):
            d = tr.train_step((ins[f"wav_{i}"], ins[f"mel_{i}"]),
                              ins[f"z_{i}"])
            details.append({k: float(v) for k, v in d.items()})
        tr.save_checkpoint(out / f"{name}_dp.ckpt")
        if rank == 0:
            (out / f"{name}_dp.json").write_text(json.dumps(details))


@pytest.fixture(scope="module")
def vocoder(tmp_path_factory):
    """The DP trainer's (two ranks) and the single process's detail and
    final checkpoints on each batch set."""
    from tests.test_torch_port_pwg_train import (PWG_GOLDEN_CONFIG,
                                                 _port_trainer)

    out = tmp_path_factory.mktemp("dp_vocoder")
    _port_trainer().save_checkpoint(out / "seed.ckpt")
    sets = _vocoder_sets()
    for name, (bs, zs) in sets.items():
        ins = {}
        for i, ((wav, mel), z) in enumerate(zip(bs, zs)):
            ins[f"wav_{i}"], ins[f"mel_{i}"], ins[f"z_{i}"] = wav, mel, z
        np.savez(out / f"{name}.npz", **ins)
        tr = _port_trainer(ckpt=out / "seed.ckpt")
        one = [{k: float(v) for k, v in tr.train_step(b, z).items()}
               for b, z in zip(bs, zs)]
        tr.save_checkpoint(out / f"{name}_one.ckpt")
        (out / f"{name}_one.json").write_text(json.dumps(one))
    spawn(_vocoder_ranks, 2, args=(str(out), PWG_GOLDEN_CONFIG,
                                   tuple(sets)), timeout=240)
    return out, sets


def _jax_vocoder(out, name, batches):
    import jax
    from jax.sharding import Mesh

    from tests.test_torch_port_pwg_train import PWG_GOLDEN_CONFIG
    from vae_npvc_tpu.train.pwg import PwgTrainer as JaxTrainer

    jt = JaxTrainer(PWG_GOLDEN_CONFIG,
                    mesh=Mesh(np.array(jax.devices()[:2]), ("data",)))
    jt.init_state(batches[0])
    assert jt.load_checkpoint(out / "seed.ckpt") == 0
    details = [jt.train_step(b) for b in batches]
    jt.save_checkpoint(out / f"{name}_jax.ckpt")
    return details


def _g_moment_gap(got, want):
    """G's first and second moments: max |got - want| over the largest
    |want|, as ``assert_pwg_state_close`` measures them."""
    from tests.test_torch_port_pwg_train import _payload_leaves

    a, b = _payload_leaves(got), _payload_leaves(want)
    gaps = {}
    for kind in ("mu", "nu"):
        keys = [k for k in b if k.startswith(f"optimizer_G/1/0/{kind}/")]
        x = np.concatenate([a[k].ravel() for k in keys]).astype(np.float64)
        y = np.concatenate([b[k].ravel() for k in keys]).astype(np.float64)
        gaps[kind] = float(np.abs(x - y).max() / np.abs(y).max())
    return gaps


@pytest.mark.parametrize("name", ["fixture", "b4"])
def test_dp_vocoder_equals_one_process_on_the_global_batch(vocoder, name):
    """The data-parallel step is the global batch's: the detail within
    1e-5 relative of one process's, and the final state as
    ``assert_pwg_state_close`` holds two vocoder states (every leaf within
    2e-5 + 1e-3 |x|; G's moments within 2e-2 of their largest and 0.1 of
    each leaf's peak: one row's STFT rounds apart from a batch's, and G's
    gradient amplifies it)."""
    from tests.test_torch_port_pwg_train import assert_pwg_state_close

    out, _ = vocoder
    dp = json.loads((out / f"{name}_dp.json").read_text())
    one = json.loads((out / f"{name}_one.json").read_text())
    for d, o in zip(dp, one):
        for k in o:
            np.testing.assert_allclose(d[k], o[k], rtol=1e-5, atol=1e-8,
                                       err_msg=k)
    assert_pwg_state_close((out / f"{name}_dp.ckpt").read_bytes(),
                           (out / f"{name}_one.ckpt").read_bytes())


@pytest.mark.parametrize("name", ["fixture", "b4"])
def test_dp_vocoder_trainer_matches_jax_on_two_devices(vocoder, name):
    """Against the JAX trainer on a two-device mesh: the per-step detail
    within 1e-4 relative and every state leaf as the fixture holds them.
    G's moments: on the fixture's batches as ``voc_golden`` holds them
    (``assert_pwg_state_close``); at B = 4 no farther from JAX than one
    process of the port on the same batches (the one-process distance is
    the ill-conditioned gradient of the module docstring of
    ``tests/test_torch_port_pwg_train.py``, 3e-2 of the largest |mu|
    here)."""
    from tests.test_torch_port_pwg_train import (DETAIL_KEYS, LOSS_RTOL,
                                                 STATE_TOL, _payload_leaves,
                                                 assert_pwg_state_close)

    out, sets = vocoder
    want = _jax_vocoder(out, name, sets[name][0])
    got = json.loads((out / f"{name}_dp.json").read_text())
    for i, (g, w) in enumerate(zip(got, want)):
        for k in DETAIL_KEYS:
            np.testing.assert_allclose(g[k], float(w[k]), rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    dp = (out / f"{name}_dp.ckpt").read_bytes()
    jx = (out / f"{name}_jax.ckpt").read_bytes()
    if name == "fixture":
        assert_pwg_state_close(dp, jx)
        return
    a, b = _payload_leaves(dp), _payload_leaves(jx)
    for k in b:
        if not (k.startswith("optimizer_G/") and k.split("/")[3] in ("mu",
                                                                   "nu")):
            np.testing.assert_allclose(a[k], b[k], atol=STATE_TOL[0],
                                       rtol=STATE_TOL[1], err_msg=k)
    one = _g_moment_gap((out / f"{name}_one.ckpt").read_bytes(), jx)
    for kind, gap in _g_moment_gap(dp, jx).items():
        assert gap <= one[kind] + 1e-4, (kind, gap, one[kind])
