"""The port's training CLI and the device-resident corpus path on the CPU.

``Trainer.stage_dataset`` + ``train_steps_indices`` against ``train_step``
on the same windows (bit-equal: the same tensors go through the same
code), and ``bin/train`` for a few iterations on a toy Kaldi directory:
checkpoint cadence, ``metrics.jsonl``, ``best.json``, ``model.loss.best``,
resume with ``--checkpoint auto`` (same files and cadence as an
uninterrupted run; as in the JAX CLI the data iterator restarts with the
process), and a finished run re-invoked as a no-op. No JAX here: what the
files must contain is the JAX CLI's contract.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.toy_config import toy_config
from vae_npvc_tpu_torch.bin import train as train_cli
from vae_npvc_tpu_torch.data import kaldi_io
from vae_npvc_tpu_torch.data.dataset import UttMelSpkDataset, index_iterator
from vae_npvc_tpu_torch.train import build_trainer, get_trainer_cls

torch.set_num_threads(1)


def _kaldi_dir(d, lens, seed):
    d.mkdir()
    rng = np.random.default_rng(seed)
    with kaldi_io.ArkWriter(d / "feats.ark", d / "feats.scp") as w:
        for i, n in enumerate(lens):
            w.write(f"utt{i}", rng.normal(size=(n, 10)).astype(np.float32))
    (d / "utt2num_frames").write_text(
        "".join(f"utt{i} {n}\n" for i, n in enumerate(lens)))
    (d / "utt2spk_id").write_text(
        "".join(f"utt{i} {i % 3}\n" for i in range(len(lens))))
    return d


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return (_kaldi_dir(root / "train", [30, 9, 45, 60, 22, 38, 51, 40], 0),
            _kaldi_dir(root / "dev", [33, 20, 41], 1))


def _config(**kw):
    return dict(toy_config(), compute_dtype="float32", crop_length=16,
                batch_size=4, valid_batch_size=2, num_jobs=0, **kw)


def test_train_steps_indices_equals_train_step_on_the_same_windows(data_dirs):
    cfg = _config()
    dataset = UttMelSpkDataset(data_dirs[0], cfg)
    pairs = [p for p, _ in zip(index_iterator(
        dataset, 4, shuffle=True, drop_last=True, seed=3), range(3))]
    a = build_trainer(cfg, device="cpu")
    a.init_state()
    with pytest.raises(ValueError, match="stage_dataset"):
        a.train_steps_indices(pairs[0][0][None], pairs[0][1][None])
    assert a.stage_dataset(dataset, 4) == dataset.padded_nbytes()
    got = a.train_steps_indices(np.stack([p[0] for p in pairs]),
                                np.stack([p[1] for p in pairs]))
    b = build_trainer(cfg, device="cpu")
    b.init_state()
    for k, (idx, starts) in enumerate(pairs):
        items = [dataset.get_at(i, s) for i, s in zip(idx, starts)]
        detail = b.train_step((np.stack([it[0] for it in items]),
                               np.asarray([it[1] for it in items])))
        assert float(detail["Total"]) == float(got["Total"][k])
    assert a.iteration == b.iteration == 3
    assert torch.equal(a.flat, b.flat)
    # the lazy codebook init ran on the first step
    assert bool(a.model.quantizer.initted)
    assert float(got["skipped_nonfinite"].sum()) == 0.0
    # iid sampling on the staged corpus carries on from there: its steps
    # are train_steps_indices on the windows it drew
    draws = [a._sample_iid(s) for s in (3, 4)]
    dev = a.train_steps_device(2)
    assert a.iteration == 5 and dev["Total"].shape == (2,)
    b.stage_dataset(dataset, 4)
    again = b.train_steps_indices(np.stack([d[0].numpy() for d in draws]),
                                  np.stack([d[1].numpy() for d in draws]))
    assert torch.equal(dev["Total"], again["Total"])
    assert torch.equal(a.flat, b.flat)


def test_trainer_registry_and_default_device():
    from vae_npvc_tpu_torch.train.trainer import Trainer

    from vae_npvc_tpu_torch.train.gan import GanTrainer

    assert get_trainer_cls("vae_npvc.trainer.basic") is Trainer
    assert get_trainer_cls("vae_npvc.trainer.wgan_gp") is GanTrainer
    assert get_trainer_cls("wgan_gp") is GanTrainer
    with pytest.raises(KeyError):
        get_trainer_cls("nope")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_trainer(_config())            # the GPU unless asked for the CPU
    with pytest.raises(ValueError, match="init_state"):
        build_trainer(_config(), device="cpu").train_step(None)


@pytest.mark.parametrize("i,want", [(0, 3), (3, 1), (4, 2), (8, 1)])
def test_chunks_never_cross_a_boundary(i, want):
    # log every 4, checkpoint every 6, stop at 9, up to 3 steps a call
    assert train_cli.chunk_size(i, 3, 4, 6, 9) == want
    assert train_cli.chunk_size(i, 1, 4, 6, 9) == 1


def _run(cfg, tmp_path, out, data_dirs, checkpoint=None, name="conf.json"):
    conf = tmp_path / name
    conf.write_text(json.dumps(cfg))
    argv = ["-c", str(conf), "--output_dir", str(out), "--train_dir",
            str(data_dirs[0]), "--valid_dir", str(data_dirs[1]), "--device",
            "cpu"]
    if checkpoint:
        argv += ["--checkpoint", checkpoint]
    train_cli.main(argv)


@pytest.mark.parametrize("device_resident", [True, False])
def test_train_cli_runs_and_resumes(tmp_path, data_dirs, device_resident):
    from vae_npvc_tpu_torch.infer.convert import read_checkpoint

    cfg = _config(max_iter=6, iters_per_log=2, iters_per_checkpoint=3,
                  steps_per_call=2, device_resident=device_resident)
    full = tmp_path / "full"
    _run(cfg, tmp_path, full, data_dirs)
    assert sorted(p.name for p in full.glob("iter.*")) == ["iter.3", "iter.6"]
    rows = [json.loads(ln) for ln in
            (full / "metrics.jsonl").read_text().splitlines()]
    assert [(r["iter"], r["split"]) for r in rows] == [
        (2, "train"), (3, "valid"), (4, "train"), (6, "train"), (6, "valid")]
    assert all(np.isfinite(r["X like"]) for r in rows)
    assert rows[0]["frames_per_sec"] > 0 and "grad_norm" in rows[0]
    best = json.loads((full / "best.json").read_text())
    assert best["check_loss_kind"] == "X like" and best["iteration"] in (3, 6)
    assert (full / "model.loss.best").read_bytes() \
        == (full / f"iter.{best['iteration']}").read_bytes()
    log = (full / "train.log").read_text()
    assert "Iter 6:" in log and "Valid 6:" in log and "Finished" in log
    assert ("Device-resident corpus" in log) == device_resident
    # the CPU replays no step from a CUDA graph
    assert log.count("0% of steps replayed") == 3

    # a run stopped at 3 is bit-equal to the first half of the full run;
    # resumed with --checkpoint auto it carries on to 6
    part = tmp_path / "part"
    _run(dict(cfg, max_iter=3), tmp_path, part, data_dirs, name="part.json")
    assert (part / "iter.3").read_bytes() == (full / "iter.3").read_bytes()
    _run(cfg, tmp_path, part, data_dirs, checkpoint="auto")
    assert "Resumed from" in (part / "train.log").read_text()
    resumed = [json.loads(ln) for ln in
               (part / "metrics.jsonl").read_text().splitlines()]
    assert [(r["iter"], r["split"]) for r in resumed] == [
        (2, "train"), (3, "valid"), (4, "train"), (6, "train"), (6, "valid")]
    payload, _ = read_checkpoint(part / "iter.6")
    assert payload["iteration"] == 6
    assert int(payload["optimizer"]["1"]["0"]["count"]) == 6
    # a finished run re-invoked trains nothing more
    before = (part / "iter.6").read_bytes()
    _run(cfg, tmp_path, part, data_dirs, checkpoint="auto")
    assert (part / "iter.6").read_bytes() == before
    assert "nothing to train" in (part / "train.log").read_text()
    assert not (part / "iter.7").exists()


def test_train_cli_rejects_unported_sampling(tmp_path, data_dirs):
    """``iid`` sampling trains (a run resumed at 3 ends on the same bytes
    as an uninterrupted one: the draws follow the iteration); a mode that
    is neither ``epoch`` nor ``iid`` is refused."""
    cfg = _config(device_resident=True, device_resident_sampling="iid",
                  max_iter=6, iters_per_log=2, iters_per_checkpoint=3,
                  steps_per_call=2)
    _run(cfg, tmp_path, tmp_path / "out", data_dirs)
    log = (tmp_path / "out" / "train.log").read_text()
    assert "(iid sampling)" in log and "Iter 6:" in log
    _run(dict(cfg, max_iter=3), tmp_path, tmp_path / "part", data_dirs,
         name="part.json")
    _run(cfg, tmp_path, tmp_path / "part", data_dirs, checkpoint="auto")
    assert (tmp_path / "part" / "iter.6").read_bytes() \
        == (tmp_path / "out" / "iter.6").read_bytes()
    with pytest.raises(ValueError, match="device_resident_sampling"):
        _run(dict(cfg, device_resident_sampling="x"), tmp_path,
             tmp_path / "out", data_dirs)


def test_chip_smoke_training_keys_match_recipe_yaml():
    import yaml

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import chip_smoke

    with open(root / "egs/vcc20/vae1/conf/train_vqvae.yaml") as f:
        y = yaml.safe_load(f)
    for k, v in chip_smoke.TRAIN.items():
        assert y[k] == v, k
    for k in ("batch_size", "crop_length", "optim_type", "learning_rate",
              "max_grad_norm", "lr_scheduler", "lr_param", "steps_per_call",
              "device_resident"):
        assert k in chip_smoke.TRAIN
