"""Gradient accumulation (``grad_accum: 2``) under a data axis, in the
port, against the JAX ``Trainer`` on two CPU devices.

The JAX accumulation step reshapes the GLOBAL batch to (k, B / k) and
shards each microbatch over ``data`` (``vae_npvc_tpu/train/trainer.py``
``_train_step_accum``), so its microbatch i is the global rows
[i·B/k, (i+1)·B/k). The port's ranks take the same rows
(``parallel/shard.shard_rows`` with ``micro``): rank r's part of
microbatch i is [i·B/k + r·B/(k·n), i·B/k + (r+1)·B/(k·n)). Two gloo
ranks are spawned once for the whole file (``parallel/launch.spawn``, in
a thread while the JAX references compile here); they run every case and
write their results, and one test per case compares them. The ranks
import only the port; the configurations reach them through a JSON file.
fp32 throughout, 3 steps a case:

- the flat EMA VQ-VAE at global B = 8 (2 rows a rank a microbatch): the
  codebook statistics chain from microbatch to microbatch, so the
  codebook that microbatch 1 quantizes against is the one the global
  microbatch 0 moved (the lazy-init and restart candidates injected on
  both sides as ``tests/test_torch_port_parallel_rest.py`` injects them);
- the transformer synthesizer at B = 8 whose two microbatches, and the
  two ranks' parts of each, hold different numbers of valid frames and
  tokens (every loss is its global microbatch's masked mean);
- the flat model at B = 6: a microbatch of 3 rows the axis does not
  divide, so the whole batch runs on every rank under an axis of one;
- ``bin/train`` with ``device_resident`` at world 2 and ``grad_accum: 2``
  under torchrun's environment: the two ranks' rows of every microbatch,
  in rank order, are the host loader's global microbatch, and the final
  state is one process's on the same windows.

Tolerances, those of ``tests/test_torch_port_parallel_rest.py``:
parameters and codebooks within rtol 2e-5, atol 2e-6, "X like" within
rtol 1e-5, every other detail value within rtol 1e-4 (atol 1e-7); the
synthesizer's parameters whose exact gradient is 0 (an attention key
projection's bias, a weight-normalized one-channel conv's ``v``) within
Adam's reach, 2 learning rates a step. The flat model's case failed on the
tree before the port split the global batch by microbatch first.
"""

import json
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_port_parallel_rest import (_assert_details,
                                                 _assert_state, _batches,
                                                 _ckpt, _cli_env, _inject,
                                                 _jax_candidates, _jax_run,
                                                 _reach, _result)
from vae_npvc_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)
B = 8                     # the global batch: 2 microbatches of 2 rows a rank
K = 2                     # grad_accum
STATE_TOL_ATOL = 2e-6
CAND_SEED = 99
TOK_LENS = [12, 9, 4, 6, 11, 3, 8, 5]


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_compiles():
    """The JAX references compile afresh (see
    ``tests/test_torch_port_parallel.py``: a cached executable rounds
    apart and can move a VQ near tie)."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


# ------------------------------------------------------------ the ranks
def _train_cli(rank, world, out, cases, ins):
    """``bin/train`` device-resident under torchrun's environment, every
    microbatch's local rows recorded."""
    from vae_npvc_tpu_torch.bin import train as train_cli
    from vae_npvc_tpu_torch.train.trainer import Trainer

    _cli_env(rank, world)
    rows = []
    loss_and_grad = Trainer._loss_and_grad

    def recording(self, batch, ema=None):
        rows.append([a.numpy().copy() for a in batch])
        return loss_and_grad(self, batch, ema)

    Trainer._loss_and_grad = recording
    restore = _inject(ins)
    try:
        conf = out / f"train_cli_r{rank}.json"
        conf.write_text(json.dumps(cases["train_cli"]))
        train_cli.main(["-c", str(conf), "--train_dir", str(out / "feats"),
                        "--output_dir", str(out / "train_dp"),
                        "--device", "cpu"])
    finally:
        Trainer._loss_and_grad = loss_and_grad
        restore()
    np.savez(out / f"train_rows_r{rank}.npz",
             **{f"{i}/{j}": a for i, r in enumerate(rows)
                for j, a in enumerate(r)})
    return len(rows)


def _ranks(rank, world, out):
    from vae_npvc_tpu_torch.parallel.mesh import Mesh
    from vae_npvc_tpu_torch.train import build_trainer

    out = Path(out)
    cases = json.loads((out / "cases.json").read_text())
    ins = np.load(out / "inputs.npz")
    meta = {}
    mesh = Mesh({"data": 2})
    restore = _inject(ins)

    def run(name):
        t = build_trainer(cases[name], device="cpu", mesh=mesh)
        t.load_checkpoint(out / f"{name}.init")
        micro_rows = []
        loss_and_grad = t._loss_and_grad

        def recording(batch, ema=None):
            micro_rows.append(int(batch[0].shape[0]))
            return loss_and_grad(batch, ema)

        t._loss_and_grad = recording
        details = [{k: float(v) for k, v in t.train_step(b).items()}
                   for b in _batches(ins, name)]
        t.save_checkpoint(out / f"{name}.port")
        return {"details": details, "micro_rows": micro_rows}

    for name in ("flat", "tts", "flat_b6"):
        try:
            meta[name] = run(name)
        except Exception as e:      # reported by the case's own test
            import traceback

            meta[name] = {"error": "".join(traceback.format_exception(e))}
    restore()
    try:
        meta["train_cli"] = {"calls": _train_cli(rank, world, out, cases,
                                                 ins)}
    except Exception as e:
        import traceback

        meta["train_cli"] = {"error": "".join(traceback.format_exception(e))}
    (out / f"rank{rank}.json").write_text(json.dumps(meta))


# ------------------------------------------------------------- the setup
def _configs():
    from tests.test_torch_port_parallel_rest import _configs as rest_configs
    from tests.toy_config import toy_config

    rest = rest_configs()
    flat = dict(toy_config(), compute_dtype="float32", seed=8, batch_size=B,
                grad_accum=K)
    return {
        "flat": flat,
        "flat_b6": dict(flat, seed=9, batch_size=6),
        "tts": dict(rest["tts"], batch_size=B, grad_accum=K),
        "train_cli": dict(rest["train_cli"], batch_size=B, grad_accum=K),
    }


def _tts_batch(rng, cfg):
    """A token-mel batch of ``TOK_LENS``: the two microbatches, and the
    two ranks' halves of each, hold different numbers of frames and
    tokens."""
    L, T, D = cfg["max_tokens"], cfg["max_frames"], cfg["mel_dim"]
    tok_lens = np.array(TOK_LENS, np.int32)
    tokens = np.zeros((B, L), np.int32)
    durs = np.zeros((B, L), np.int32)
    mels = np.zeros((B, T, D), np.float32)
    mel_lens = np.zeros((B,), np.int32)
    for b, n in enumerate(tok_lens):
        tokens[b, :n] = rng.integers(0, cfg["token_num"], size=n)
        durs[b, :n] = rng.integers(1, 5, size=n)
        while durs[b].sum() > T:
            durs[b, np.argmax(durs[b])] -= 1
        mel_lens[b] = durs[b].sum()
        mels[b, :mel_lens[b]] = rng.normal(size=(mel_lens[b], D))
    spks = rng.integers(0, cfg["y_num"], size=B).astype(np.int32)
    return tokens, durs, mels, spks, tok_lens, mel_lens


def _make_batches(cfgs):
    rng = np.random.default_rng(2027)
    out = {"tts": [_tts_batch(rng, cfgs["tts"]) for _ in range(3)]}
    for name, n_rows in (("flat", B), ("flat_b6", 6)):
        out[name] = [(rng.normal(size=(n_rows, 16, 10)).astype(np.float32),
                      rng.integers(0, cfgs[name]["y_num"], size=n_rows)
                      .astype(np.int32)) for _ in range(3)]
    return out


def _one_process_cli(out, cfgs):
    """``bin/train`` in one process of the port on the same windows (the
    candidates injected as on the ranks): the reference of the two-rank
    run."""
    from vae_npvc_tpu_torch.bin import train as train_cli

    conf = out / "train_cli_one.json"
    conf.write_text(json.dumps(cfgs["train_cli"]))
    restore = _inject(np.load(out / "inputs.npz"))
    try:
        train_cli.main(["-c", str(conf), "--train_dir", str(out / "feats"),
                        "--output_dir", str(out / "train_one"),
                        "--device", "cpu"])
    finally:
        restore()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(output dir, {case: per-step detail of JAX's two-device trainer})
    after the ranks and the references ran."""
    from tests.test_torch_port_train_cli import _kaldi_dir
    from vae_npvc_tpu_torch.train import build_trainer

    out = tmp_path_factory.mktemp("accum_dp")
    cfgs = _configs()
    batches = _make_batches(cfgs)
    cands = {8: np.random.default_rng(CAND_SEED).normal(size=(16, 8))
             .astype(np.float32)}
    no_alphas = np.zeros((1, 1, 1, 1), np.float32)
    ins = {f"{n}/{i}/{j}": a for n, bs in batches.items()
           for i, b in enumerate(bs) for j, a in enumerate(b)}
    ins.update({f"cand/{k}": v for k, v in cands.items()})
    ins["gp_alpha"] = no_alphas
    np.savez(out / "inputs.npz", **ins)
    (out / "cases.json").write_text(json.dumps(cfgs))
    for name in ("flat", "flat_b6", "tts"):
        t = build_trainer(cfgs[name], device="cpu")
        t.init_state()
        t.save_checkpoint(out / f"{name}.init")
    _kaldi_dir(out / "feats", [30, 9, 45, 60, 22, 38, 51, 40, 17, 33], 0)

    failed = []

    def ranks():
        try:
            spawn(_ranks, 2, args=(str(out),), timeout=300)
        except Exception as e:
            failed.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()
    names = ("flat", "flat_b6", "tts")
    try:
        # XLA compiles outside the GIL: the references compile side by side
        with pytest.MonkeyPatch.context() as mp, \
                ThreadPoolExecutor(len(names)) as pool:
            _jax_candidates(mp, cands, no_alphas)
            jax_details = dict(zip(names, pool.map(
                lambda n: _jax_run(cfgs[n], out / f"{n}.init", batches[n],
                                   out / f"{n}.jax"), names)))
        _one_process_cli(out, cfgs)
    finally:
        thread.join()
    if failed:
        raise failed[0]
    return out, jax_details


@pytest.fixture(scope="module")
def ranks(run):
    out, _ = run
    return [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]


def _against_jax(run, ranks, name, micro_rows):
    """The ranks' details equal, each microbatch ``micro_rows`` rows a
    rank, details and final state within the tolerances of JAX's."""
    out, jax_details = run
    got = _result(ranks, name)
    assert got[0]["details"] == got[1]["details"], \
        f"{name}: the ranks' details differ"
    assert all(g["micro_rows"] == [micro_rows] * (3 * K) for g in got), got
    _assert_details(got[0]["details"], jax_details[name], name)
    cfg = json.loads((out / "cases.json").read_text())[name]
    _assert_state(_ckpt(out / f"{name}.port"), _ckpt(out / f"{name}.jax"),
                  name, _reach(cfg, 3))


# ------------------------------------------------------------------ tests
def test_flat_ema_accumulation_under_a_data_axis_matches_jax(run, ranks):
    """Each rank takes 2 rows of each global microbatch of 4; the EMA
    statistics of microbatch 0 (summed over the axis) move the codebook
    that microbatch 1 quantizes against, as JAX's chain does."""
    _against_jax(run, ranks, "flat", B // K // 2)


def test_synthesizer_accumulation_weights_each_global_microbatch(run,
                                                                 ranks):
    """Every loss is its global microbatch's masked mean: the two
    microbatches, and the ranks' parts of each, hold different numbers of
    valid frames and tokens."""
    out, _ = run
    ins = np.load(out / "inputs.npz")
    h = B // K // 2
    for i in range(3):
        for lens in (ins[f"tts/{i}/5"], ins[f"tts/{i}/4"]):
            micro = lens.reshape(K, B // K)
            assert micro[0].sum() != micro[1].sum()
            assert all(m[:h].sum() != m[h:].sum() for m in micro)
    _against_jax(run, ranks, "tts", B // K // 2)


def test_microbatch_the_axis_does_not_divide_runs_whole(run, ranks):
    """B = 6 in 2 microbatches of 3 rows: every rank runs the whole batch
    under an axis of one, as JAX's step computes the global microbatch
    without a sharding constraint."""
    _against_jax(run, ranks, "flat_b6", 6 // K)


def test_train_cli_device_resident_microbatches_are_the_host_loaders(
        run, ranks):
    """``bin/train`` at world 2 with ``grad_accum: 2``: the ranks' rows of
    every microbatch, in rank order, are the host loader's global
    microbatch, row for row; the final state is one process's."""
    from vae_npvc_tpu_torch.data.dataset import (UttMelSpkDataset,
                                                 batch_iterator)

    out, _ = run
    calls = [r["calls"] for r in _result(ranks, "train_cli")]
    cfg = json.loads((out / "cases.json").read_text())["train_cli"]
    assert calls == [cfg["max_iter"] * K] * 2
    log = (out / "train_dp" / "train.log").read_text()
    assert "Device-resident corpus" in log and "Rank 0 of 2" in log
    dataset = UttMelSpkDataset(out / "feats", cfg)
    host = batch_iterator(dataset, B, shuffle=True, drop_last=True,
                          seed=cfg.get("seed", 777), num_workers=0)
    rows = [np.load(out / f"train_rows_r{r}.npz") for r in (0, 1)]
    m = B // K
    for step in range(cfg["max_iter"]):
        want = next(host)
        for i in range(K):
            c = step * K + i
            for j, w in enumerate(want):
                got = np.concatenate([r[f"{c}/{j}"] for r in rows])
                np.testing.assert_array_equal(
                    got, np.asarray(w)[i * m:(i + 1) * m],
                    err_msg=f"step {step} microbatch {i} entry {j}")
    _assert_state(_ckpt(out / "train_dp" / f"iter.{cfg['max_iter']}"),
                  _ckpt(out / "train_one" / f"iter.{cfg['max_iter']}"),
                  "bin/train device_resident", STATE_TOL_ATOL)
