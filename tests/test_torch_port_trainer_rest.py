"""The rest of the port's training path on the CPU: iid sampling on the
staged corpus (``Trainer.train_steps_device``), ``prefetch_to_device`` and
``bin/train`` with ``iid``, the native loader and ``--profile_dir``.

The port's draws are not ``jax.random``'s, so the JAX ``Trainer`` is held
against the port through the drawn windows: the port's
``train_steps_device`` and JAX's ``train_steps_indices`` on the port's
``(idx, starts)`` give the same per-step losses (the lockstep tests'
tolerance: 1e-5 relative). The sampler's generator is not the VQ draws':
with the same windows, ``train_steps_device`` and ``train_steps_indices``
give the same bits, lazy codebook init included.
"""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_port_train_cli import _config, _kaldi_dir
from tests.toy_config import toy_config
from vae_npvc_tpu_torch.bin import train as train_cli
from vae_npvc_tpu_torch.data.dataset import (UttMelSpkDataset,
                                             prefetch_to_device)
from vae_npvc_tpu_torch.train import build_trainer

torch.set_num_threads(1)

LENS = [30, 9, 45, 60, 22, 38, 51, 40]


def _staged(tmp_path, lens=LENS, crop=16, B=4, **cfg):
    cfg = dict(toy_config(), compute_dtype="float32", crop_length=crop,
               **cfg)
    tmp_path.mkdir(parents=True, exist_ok=True)
    ds = UttMelSpkDataset(_kaldi_dir(tmp_path / "data", lens, 0), cfg)
    tr = build_trainer(cfg, device="cpu")
    tr.init_state()
    assert tr.stage_dataset(ds, B) == ds.padded_nbytes()
    return tr, ds


def test_iid_trains_and_is_deterministic(tmp_path):
    def run(sub):
        tr, _ = _staged(tmp_path / sub)
        d1 = tr.train_steps_device(3)
        d2 = tr.train_steps_device(2)
        assert tr.iteration == 5
        assert d1["Total"].shape == (3,) and d2["Total"].shape == (2,)
        return tr, torch.cat([d1["Total"], d2["Total"]])

    a, ta = run("a")
    b, tb = run("b")
    assert torch.isfinite(ta).all()
    assert torch.equal(ta, tb) and torch.equal(a.flat, b.flat)
    assert bool(a.model.quantizer.initted)
    # distinct steps draw distinct batches
    draws = [a._sample_iid(s) for s in range(5)]
    assert len({(tuple(i.tolist()), tuple(s.tolist()))
                for i, s in draws}) == 5
    assert len(set(np.round(ta.numpy(), 6))) > 1
    with pytest.raises(ValueError, match="stage_dataset"):
        build_trainer(dict(toy_config(), crop_length=16),
                      device="cpu").train_steps_device(1)


def test_iid_short_corpus_is_zero_padded_and_finite(tmp_path):
    tr, ds = _staged(tmp_path, lens=[8, 6, 4], B=2)
    for step in range(3):
        idx, starts = tr._sample_iid(step)
        assert starts.tolist() == [0, 0]
        feats, _ = tr._gather(idx, starts)
        for row, i in zip(feats, idx.tolist()):
            n = [8, 6, 4][i]
            assert torch.all(row[n:] == 0) and torch.any(row[:n] != 0)
    d = tr.train_steps_device(2)
    assert torch.isfinite(d["Total"]).all()
    assert ds.crop_length == 16


def test_iid_starts_in_range_and_crops_equal_get_at(tmp_path):
    tr, ds = _staged(tmp_path, B=6)
    lens = np.asarray(LENS)
    seen = set()
    for step in range(40):
        idx, starts = tr._sample_iid(step)
        assert idx.dtype == starts.dtype == torch.int64
        hi = np.maximum(lens[idx.numpy()] - ds.crop_length, 0)
        assert np.all(starts.numpy() >= 0) and np.all(starts.numpy() <= hi)
        feats, spks = tr._gather(idx, starts)
        for b, (i, s) in enumerate(zip(idx.tolist(), starts.tolist())):
            want, spk = ds.get_at(i, s)
            np.testing.assert_array_equal(feats[b].numpy(), want)
            assert int(spks[b]) == spk
            seen.add((i, s))
    # the draws cover the corpus and more than one start per long utterance
    assert {i for i, _ in seen} == set(range(len(LENS)))
    assert len({s for i, s in seen if i == 3}) > 3
    # the stream depends on the seed and the step only
    again = build_trainer(dict(tr.config), device="cpu")
    again.init_state()
    again.stage_dataset(ds, 6)
    for step in (0, 17):
        for x, y in zip(tr._sample_iid(step), again._sample_iid(step)):
            assert torch.equal(x, y)


def test_iid_steps_track_jax_train_steps_indices(tmp_path):
    """The JAX ``Trainer`` in lockstep with the port's iid steps, fed the
    port's draws."""
    from tests.test_torch_port_train_golden import (DETAIL_KEYS,
                                                    TRAIN_GOLDEN_CONFIG,
                                                    _assert_detail,
                                                    _port_trainer,
                                                    make_jax_trainer)

    cfg = dict(TRAIN_GOLDEN_CONFIG, crop_length=32)
    ds = UttMelSpkDataset(_kaldi_dir(tmp_path / "data", LENS, 4), cfg)
    jtr, _ = make_jax_trainer()
    first = tmp_path / "first.ckpt"
    jtr.save_checkpoint(first)
    jtr.stage_dataset(ds, 4)
    ptr = _port_trainer(first, crop_length=32)
    ptr.stage_dataset(ds, 4)
    K = 5
    draws = [ptr._sample_iid(s) for s in range(K)]
    assert any(s > 0 for _, st in draws for s in st.tolist())
    assert any(LENS[i] < 32 for ii, _ in draws for i in ii.tolist())
    got = ptr.train_steps_device(K)
    want = jtr.train_steps_indices(
        np.stack([d[0].numpy() for d in draws]),
        np.stack([d[1].numpy() for d in draws]))
    for k in range(K):
        _assert_detail({key: got[key][k] for key in DETAIL_KEYS},
                       {key: np.asarray(want[key])[k] for key in DETAIL_KEYS})
    assert ptr.iteration == jtr.iteration == K


def test_iid_resume_draws_what_an_uninterrupted_run_draws(tmp_path):
    full, ds = _staged(tmp_path)
    full.train_steps_device(3)
    full.save_checkpoint(tmp_path / "iter.3")
    rest = full.train_steps_device(2)

    resumed = build_trainer(dict(full.config), device="cpu")
    assert resumed.load_checkpoint(tmp_path / "iter.3") == 3
    resumed.stage_dataset(ds, 4)
    for step in (3, 4):
        for x, y in zip(full._sample_iid(step), resumed._sample_iid(step)):
            assert torch.equal(x, y)
    again = resumed.train_steps_device(2)
    assert resumed.iteration == full.iteration == 5
    assert torch.equal(again["Total"], rest["Total"])
    assert torch.equal(resumed.flat, full.flat)


def test_iid_vq_draws_equal_those_of_train_steps_indices(tmp_path):
    """The sampler has a generator of its own: with the same windows, the
    lazy codebook init and the restarts draw the same candidates."""
    a, ds = _staged(tmp_path)
    b = build_trainer(dict(a.config), device="cpu")
    b.init_state()
    b.stage_dataset(ds, 4)
    draws = [a._sample_iid(s) for s in range(3)]
    da = a.train_steps_device(3)
    db = b.train_steps_indices(np.stack([d[0].numpy() for d in draws]),
                               np.stack([d[1].numpy() for d in draws]))
    assert torch.equal(da["Total"], db["Total"])
    assert torch.equal(a.flat, b.flat)
    for x, y in zip(a.model.quantizer.state(), b.model.quantizer.state()):
        assert torch.equal(x, y)
    # both consumed the same VQ stream: the next step's draw agrees too
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


# ------------------------------------------------------- prefetch_to_device
def _batches(n):
    rng = np.random.default_rng(1)
    return [(rng.normal(size=(2, 5, 3)).astype(np.float32),
             np.arange(2, dtype=np.int32) + i) for i in range(n)]


@pytest.mark.parametrize("size", [1, 3])
def test_prefetch_keeps_order_and_values(size):
    want = _batches(7)
    got = list(prefetch_to_device(iter(want), size=size, device="cpu"))
    assert len(got) == 7
    for (gx, gs), (wx, ws) in zip(got, want):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        assert gs.dtype == torch.int32
        np.testing.assert_array_equal(gx.numpy(), wx)
        np.testing.assert_array_equal(gs.numpy(), ws)
    put = list(prefetch_to_device(iter(want), device="cpu",
                                  put=lambda b: ("put", b[1][0])))
    assert put == [("put", w[1][0]) for w in want]


def test_prefetch_surfaces_a_loader_error_in_the_consumer():
    def loader():
        yield from _batches(2)
        raise IOError("native ark loader failed with code 2")

    it = prefetch_to_device(loader(), size=2, device="cpu")
    assert len([next(it), next(it)]) == 2
    with pytest.raises(IOError, match="code 2"):
        next(it)


def test_prefetch_stops_its_producer_when_closed():
    import threading

    closed = threading.Event()

    def endless():
        try:
            while True:
                yield from _batches(1)
        finally:
            closed.set()

    it = prefetch_to_device(endless(), size=2, device="cpu")
    next(it)
    it.close()
    assert closed.wait(10)
    for t in threading.enumerate():
        if t.name == "prefetch_to_device":
            t.join(5)
            assert not t.is_alive()


# ----------------------------------------------------------------- bin/train
def _cli(tmp_path, cfg, out, train_dir, *extra):
    conf = tmp_path / f"{out.name}.json"
    conf.write_text(json.dumps(cfg))
    train_cli.main(["-c", str(conf), "--output_dir", str(out),
                    "--train_dir", str(train_dir), "--device", "cpu",
                    *extra])


def test_train_cli_iid_with_profile_dir(tmp_path):
    train_dir = _kaldi_dir(tmp_path / "data", LENS, 0)
    cfg = _config(max_iter=6, iters_per_log=2, iters_per_checkpoint=6,
                  steps_per_call=2, device_resident=True,
                  device_resident_sampling="iid")
    out = tmp_path / "out"
    _cli(tmp_path, cfg, out, train_dir, "--profile_dir",
         str(tmp_path / "prof"))
    log = (out / "train.log").read_text()
    assert "(iid sampling)" in log and "Iter 6:" in log
    traces = sorted((tmp_path / "prof").glob("*.json"))
    assert [p.name for p in traces] == ["trace_iter4.json"]
    assert f"Saved profiler trace to {traces[0]}" in log
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::convolution") for n in names)
    # the profiler does not change what is trained
    plain = tmp_path / "plain"
    _cli(tmp_path, cfg, plain, train_dir)
    assert (plain / "iter.6").read_bytes() == (out / "iter.6").read_bytes()


def test_train_cli_native_loader_equals_python_reads(tmp_path):
    """The host loader through prefetch_to_device: the native loader's run
    ends on the bytes of the Python reads' run."""
    train_dir = _kaldi_dir(tmp_path / "data", LENS, 0)
    cfg = _config(max_iter=4, iters_per_log=2, iters_per_checkpoint=4,
                  steps_per_call=2, prefetch_factor=3)
    native = tmp_path / "native"
    _cli(tmp_path, dict(cfg, use_native_loader=True), native, train_dir)
    python = tmp_path / "python"
    _cli(tmp_path, dict(cfg, use_native_loader=False), python, train_dir)
    assert UttMelSpkDataset(train_dir, dict(cfg, use_native_loader=True)) \
        .native is not None
    assert (native / "iter.4").read_bytes() == (python / "iter.4") \
        .read_bytes()
    assert "Device-resident" not in (native / "train.log").read_text()
