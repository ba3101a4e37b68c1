"""Data-parallel training of every family the JAX package spreads over its
chips, in the port, against the JAX trainers on the CPU.

Two gloo ranks are spawned once for the whole file
(``parallel/launch.spawn``, in a thread while the JAX references run
here); they run every case and write their results, and one test per case
compares them with the JAX ``Trainer``/``GanTrainer`` on two of
``tests/conftest.py``'s virtual CPU devices (GSPMD: the global batch
sharded over a ``data`` mesh), or with one process of the port where the
JAX package has no counterpart. The ranks import only the port; the
configurations reach them through a JSON file. Global batches of 4 rows,
2 a rank, fp32:

- the synthesizer's frame-weighted losses: a transformer synthesizer
  whose two halves hold different numbers of valid frames and tokens
  (the losses divide by the global batch's counts);
- Tacotron2 with dropout 0.5 and zoneout 0.1: JAX's own masks for each
  step (recorded from its forward with the trainer's step key) replayed
  by the port, whose ranks draw the global batch's masks and keep their
  rows;
- the EMA vqvae2 with a GST top and the EMA vqvae2b (every level's
  statistics summed, its candidates pooled), and the recipe's plain
  normalized vqvae2 (renormalized every step; each level's perplexity over
  the global batch's codes);
- the WGAN-GP trainer through phase 1 -> 2 -> 3 (``pre_iter: 1``), the
  penalty's interpolation weights injected for the global batch;
- the latent jitter (``jitter_p: 0.5``) and the Gaussian VAE's
  reparameterization noise: each rank's draws are its rows of the global
  batch's, so the two ranks equal one process of the port on the global
  batch (JAX's draws cannot be replayed in torch; one process of the port
  is held against JAX given the draws in ``tests/test_torch_port_train_ops.py``
  and ``tests/test_torch_port_gan_vae.py``);
- a data axis of one rank (``{"data": 1, "rep": 2}``): the hierarchy's,
  the GAN's and the synthesizer's steps bit-equal to the plain steps;
- the CLIs under torchrun's environment: ``bin/train_tts`` and
  ``bin/train_pwg`` (rank 0 writes, a resume continues, the final state
  against one process of the port on the same global batches) and
  ``bin/train`` with ``device_resident`` (each step's rows of the two
  ranks, in rank order, are the host loader's global batch).

The EMA codebooks' lazy-init and restart candidates are injected on both
sides as ``tests/test_torch_port_parallel.py`` injects them. Every JAX
trainer starts from the port's seeded checkpoint, which replaces its whole
state, so its initial ``init`` (eager flax, ~20-30 s a model here) runs as
shapes only (``_ShapeInit``).

Tolerances (fp32), those of ``tests/test_torch_port_parallel.py``:
parameters and codebooks within rtol 2e-5, atol 2e-6 and "X like" within
rtol 1e-5; every other detail value within rtol 1e-4 (atol 1e-7), the
bound of the one-process lockstep tests; the vocoder's state as
``tests/test_torch_port_pwg_train.py`` holds two vocoder states. The
parameters whose exact gradient is 0 (an attention key projection's bias,
a weight-normalized one-channel conv's ``v``) random-walk under Adam by
rounding noise and are held to that walk's reach, 2 learning rates a step,
as ``tests/test_torch_port_tts_model.py`` holds them.
"""

import json
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from vae_npvc_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)
B = 4                     # the global batch: 2 rows a rank
LOSS_RTOL = 1e-5          # "X like"
DETAIL_RTOL = 1e-4        # every other detail value
STATE_TOL = (2e-5, 2e-6)  # rtol, atol
FREE_SUFFIXES = ("mha/linear_k/bias", "pitch_proj/v", "energy_proj/v")
CAND_SEED = 99


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
def _batches(ins, name):
    n = sum(1 for k in ins.files if k.startswith(f"{name}/") and
            k.endswith("/0"))
    out = []
    for i in range(n):
        m = sum(1 for k in ins.files if k.startswith(f"{name}/{i}/"))
        out.append(tuple(ins[f"{name}/{i}/{j}"] for j in range(m)))
    return out


def _inject(ins):
    """The draws both sides share: every bank's candidates (the first K
    rows of one fixed array; a gathered pool gives its first K rows) and
    the penalty's weights of the global batch. Returns the restore
    function."""
    from vae_npvc_tpu_torch.ops import vq
    from vae_npvc_tpu_torch.train import gan

    rows = {int(k[len("cand/"):]): torch.from_numpy(ins[k])
            for k in ins.files if k.startswith("cand/")}
    alphas = torch.from_numpy(ins["gp_alpha"])
    saved = vq._tiled_candidates, vq._pick, gan.gp_alpha
    vq._tiled_candidates = lambda gen, z, K: rows[z.shape[1]][:K].clone()
    vq._pick = lambda gen, n, K, device: torch.arange(K, device=device)
    gan.gp_alpha = lambda gen, shape, device: alphas.clone()

    def restore():
        vq._tiled_candidates, vq._pick, gan.gp_alpha = saved
    return restore


def _floats(detail):
    return {k: float(v) for k, v in detail.items()}


def _train(cfg, init, batches, mesh, save=None):
    from vae_npvc_tpu_torch.train import build_trainer

    kw = {"mesh": mesh} if mesh is not None else {}
    t = build_trainer(cfg, device="cpu", **kw)
    t.load_checkpoint(init)
    details = [_floats(t.train_step(b)) for b in batches]
    if save is not None:
        t.save_checkpoint(save)
    return t, details


def _world_one(cfg, init, batches, mesh):
    """The DP step on a data axis of one rank against the plain step:
    every detail value and every state tensor equal."""
    plain, want = _train(cfg, init, batches, None)
    dp, got = _train(cfg, init, batches, mesh)

    def state(t):
        out = dict(t.model.state_dict())
        opts = [t.opt_state] + ([t.d_opt_state] if hasattr(t, "d_flat")
                                else [])
        if hasattr(t, "d_flat"):
            out["d_flat"] = t.d_flat
        for i, st in enumerate(opts):
            out.update({f"opt{i}/{j}": x for j, x in enumerate(st)
                        if torch.is_tensor(x)})
        return out

    a, b = state(plain), state(dp)
    same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    return {"detail_equal": got == want, "state_equal": bool(same),
            "steps": len(got)}


def _replay_masks(masks):
    """``token_tts.bernoulli`` replays the recorded global masks in
    order."""
    from vae_npvc_tpu_torch.models import token_tts

    queue = deque(masks)

    def replay(gen, p, shape, device):
        m = queue.popleft()
        if m.shape != tuple(shape):
            raise AssertionError(f"mask {m.shape} for a draw of {shape}")
        return torch.from_numpy(m.copy())

    saved, token_tts.bernoulli = token_tts.bernoulli, replay
    return queue, saved


def _cli_env(rank, world):
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"})


def _cli_cases(rank, world, out, cases, ins, meta):
    from vae_npvc_tpu_torch.bin import train as train_cli
    from vae_npvc_tpu_torch.bin import train_pwg, train_tts
    from vae_npvc_tpu_torch.train.trainer import Trainer

    _cli_env(rank, world)
    root = out / "cli"
    for name, cli, extra in (("tts", train_tts, ["--valid_dir",
                                                  str(root / "tts_dev")]),
                             ("pwg", train_pwg, [])):
        exp = out / f"{name}_dp"
        for half, max_iter in enumerate(cases[f"{name}_cli_iters"]):
            conf = out / f"{name}_cli_{half}_r{rank}.json"
            conf.write_text(json.dumps(dict(cases[f"{name}_cli"],
                                            max_iter=max_iter)))
            ck = (["--checkpoint", str(exp / f"iter.{max_iter // 2}")]
                  if half and name == "tts" else [])
            cli.main(["-c", str(conf), "--train_dir", str(root / name),
                      "--output_dir", str(exp), "--device", "cpu",
                      *extra, *ck])
    # bin/train, device-resident: every step's local rows recorded
    rows = []
    step = Trainer._step

    def recording(self, batch, sharded):
        rows.append([a.numpy().copy() for a in batch])
        return step(self, batch, sharded)

    Trainer._step = recording
    restore = _inject(ins)
    try:
        conf = out / f"train_cli_r{rank}.json"
        conf.write_text(json.dumps(cases["train_cli"]))
        train_cli.main(["-c", str(conf), "--train_dir", str(root / "feats"),
                        "--output_dir", str(out / "train_dp"),
                        "--device", "cpu"])
    finally:
        Trainer._step = step
        restore()
    np.savez(out / f"train_rows_r{rank}.npz",
             **{f"{i}/{j}": a for i, r in enumerate(rows)
                for j, a in enumerate(r)})
    meta["train_cli_steps"] = len(rows)
    # one rank a host: the staged corpus stays single-host, as JAX's
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    conf = out / f"train_cli_hosts_r{rank}.json"
    conf.write_text(json.dumps(dict(cases["train_cli"], max_iter=2)))
    train_cli.main(["-c", str(conf), "--train_dir", str(root / "feats"),
                    "--output_dir", str(out / "train_hosts"),
                    "--device", "cpu"])


def _case(meta, name, fn):
    try:
        meta[name] = fn()
    except Exception as e:      # reported by the case's own test
        import traceback

        meta[name] = {"error": "".join(traceback.format_exception(e))}


def _ranks(rank, world, out):
    from vae_npvc_tpu_torch.parallel.mesh import Mesh

    out = Path(out)
    cases = json.loads((out / "cases.json").read_text())
    ins = np.load(out / "inputs.npz")
    meta = {}
    m2 = Mesh({"data": 2})
    m1 = Mesh({"data": 1, "rep": 2})
    # a data axis of one rank, with the real draws
    for name in ("hier_ema", "gan", "tts"):
        _case(meta, f"one_{name}", lambda name=name: _world_one(
            cases[name], out / f"{name}.init", _batches(ins, name), m1))
    restore = _inject(ins)
    for name in ("tts", "hier_ema", "hier2b_ema", "hier_plain", "gan",
                 "jitter", "vae"):
        _case(meta, name, lambda name=name: _train(
            cases[name], out / f"{name}.init", _batches(ins, name), m2,
            out / f"{name}.port")[1])
    restore()

    def tac2():
        from vae_npvc_tpu_torch.models import token_tts

        left, saved = _replay_masks([ins[f"tac2_mask/{i}"] for i in
                                     range(int(ins["tac2_masks"]))])
        try:
            details = _train(cases["tac2"], out / "tac2.init",
                             _batches(ins, "tac2"), m2, out / "tac2.port")[1]
        finally:
            token_tts.bernoulli = saved
        if left:
            raise AssertionError(f"{len(left)} masks left unused")
        return details

    _case(meta, "tac2", tac2)
    _case(meta, "cli", lambda: _cli_cases(rank, world, out, cases, ins, {}))
    (out / f"rank{rank}.json").write_text(json.dumps(meta))


# ------------------------------------------------------------- the JAX side
class _ShapeInit:
    """A flax module whose ``init`` gives zeros of the variables' shapes
    (traced, not run): the JAX trainers' ``init_state`` only builds the
    tree that ``load_checkpoint`` then fills."""

    def __init__(self, module):
        self._module = module

    def init(self, *args, **kwargs):
        import jax
        import jax.numpy as jnp

        shapes = jax.eval_shape(lambda: self._module.init(*args, **kwargs))
        return jax.tree_util.tree_map(
            lambda a: jnp.zeros(a.shape, a.dtype), shapes)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _two_devices():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:2]), ("data",))


def _configs():
    from tests.test_model_vqvae2 import make_cfg
    from tests.test_model_vqvae2ab import cfg_2b
    from tests.test_pwg import PWG_CFG
    from tests.test_torch_port_gan_vae import GAN_CONFIG, VAE_CONFIG
    from tests.test_torch_port_hier_train import HIER_GOLDEN_CONFIG
    from tests.test_torch_port_tac2 import TAC2_CONFIG
    from tests.toy_config import toy_config

    train = {"trainer_type": "vae_npvc.trainer.basic",
             "compute_dtype": "float32", "optim_type": "Adam",
             "learning_rate": 1e-3, "max_grad_norm": 10, "batch_size": B}
    tts = dict(train, **{
        "model_type": "vae_npvc.model.token_tts", "seed": 11,
        "token_num": 16, "token_dim": 16, "y_num": 4, "y_dim": 8,
        "mel_dim": 10, "block_type": "transformer", "adim": 16,
        "aheads": 2, "elayers": 1, "dlayers": 1, "eunits": 32,
        "dunits": 32, "dur_weight": 0.1, "var_weight": 0.1,
        "postnet_layers": 2, "variance_predictor": True, "max_tokens": 12,
        "max_frames": 48})
    hier_ema = dict(make_cfg(use_gst=True, use_ema=True), **train, seed=5)
    hier2b = dict(cfg_2b(), **train, use_ema=True, seed=6)
    hier_plain = dict(HIER_GOLDEN_CONFIG, batch_size=B)
    return {
        "tts": tts,
        "tac2": dict(TAC2_CONFIG, **{"dropout-rate": 0.5,
                                     "zoneout-rate": 0.1, "batch_size": B}),
        "hier_ema": hier_ema, "hier2b_ema": hier2b,
        "hier_plain": hier_plain,
        "gan": dict(GAN_CONFIG, batch_size=B),
        "jitter": dict(toy_config(), **train, seed=8, jitter_p=0.5),
        "vae": dict(VAE_CONFIG, batch_size=B),
        "tts_cli": dict(tts, max_frames=48, iters_per_log=1,
                        iters_per_checkpoint=2, steps_per_call=1),
        "tts_cli_iters": [2, 4],
        # the published rates (PWG_CFG's are 20x the generator's)
        "pwg_cli": dict(PWG_CFG, discriminator_train_start_steps=1,
                        batch_size=B, iters_per_log=1,
                        iters_per_checkpoint=2, steps_per_call=1,
                        generator_param={"learning_rate": 1e-4},
                        discriminator_param={"learning_rate": 5e-5}),
        "pwg_cli_iters": [2, 4],
        "train_cli": dict(toy_config(), compute_dtype="float32",
                          crop_length=16, batch_size=B, num_jobs=0,
                          max_iter=4, iters_per_log=2,
                          iters_per_checkpoint=4, steps_per_call=2,
                          device_resident=True),
    }


def _tts_batch(rng, cfg):
    """A token-mel batch; row 0 fills the frames, the others are short, so
    the two halves hold different numbers of frames and tokens."""
    L, T, D = cfg["max_tokens"], cfg["max_frames"], cfg["mel_dim"]
    tok_lens = np.array([L, 9, 4, 6], np.int32)
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
    from tests.test_torch_port_tac2 import _batch as tac2_batch

    rng = np.random.default_rng(2026)
    out = {"tts": [_tts_batch(rng, cfgs["tts"]) for _ in range(3)],
           "tac2": [tac2_batch(40 + i, cfgs["tac2"], Bn=B)
                    for i in range(2)]}
    for name, D in (("hier_ema", 10), ("hier2b_ema", 10),
                    ("hier_plain", 10), ("gan", 12), ("jitter", 10),
                    ("vae", 12)):
        T = 16 if name in ("gan", "vae", "jitter") else 32
        n = 4 if name == "gan" else 3
        out[name] = [(rng.normal(size=(B, T, D)).astype(np.float32),
                      rng.integers(0, cfgs[name]["y_num"], size=B)
                      .astype(np.int32)) for _ in range(n)]
    return out


def _record_tac2_masks(cfg, batches):
    """JAX's dropout and zoneout masks of each training step, in draw
    order: the model's forward with the JAX trainer's step key
    (``fold_in(PRNGKey(seed), step)``) on one device, each mask recorded by
    ``jax.debug.callback`` (masks depend on the key and the shapes only, so
    the two-device step draws the same)."""
    import jax
    import jax.numpy as jnp

    from vae_npvc_tpu.models import build_model as jax_build_model

    jm = jax_build_model(cfg)
    params = _ShapeInit(jm).init({"params": jax.random.PRNGKey(0)},
                                 *map(jnp.asarray, batches[0]),
                                 train=False)["params"]
    recorded = []
    orig = jax.random.bernoulli

    def recording(k, p=0.5, shape=None, **kw):
        m = orig(k, p, shape, **kw)
        jax.debug.callback(lambda v: recorded.append(np.asarray(v)), m,
                           ordered=True)
        return m

    base = jax.random.PRNGKey(cfg["seed"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", recording)
        forward = jax.jit(lambda p, key, *a: jm.apply(
            {"params": p}, *a, train=True, rngs={"vq": key})[1])
        for i, b in enumerate(batches):
            forward(params, jax.random.fold_in(base, i),
                    *map(jnp.asarray, b)).block_until_ready()
            jax.effects_barrier()
    return recorded


def _write_cli_data(root, cfgs):
    from tests.test_pwg import sine_corpus
    from tests.test_torch_port_train_cli import _kaldi_dir
    from vae_npvc_tpu_torch.data import token_mel

    rng = np.random.default_rng(7)

    def items(n):
        out = []
        for i in range(n):
            k = int(rng.integers(3, 13))
            durs = rng.integers(1, 4, size=k)
            out.append((f"utt{i}", rng.integers(0, 16, size=k), durs,
                        rng.normal(size=(int(durs.sum()), 10))
                        .astype(np.float32), i % 4))
        return out

    token_mel.write_token_mel_dir(root / "tts", items(9))
    token_mel.write_token_mel_dir(root / "tts_dev", items(5))
    (root / "pwg").mkdir(parents=True)
    sine_corpus(root / "pwg", n=6)
    _kaldi_dir(root / "feats", [30, 9, 45, 60, 22, 38, 51, 40, 17, 33], 0)


def _port_inits(cfgs, out):
    from vae_npvc_tpu_torch.train import build_trainer

    for name in ("tts", "tac2", "hier_ema", "hier2b_ema", "hier_plain",
                 "gan", "jitter", "vae"):
        t = build_trainer(cfgs[name], device="cpu")
        t.init_state()
        t.save_checkpoint(out / f"{name}.init")


def _jax_candidates(mp, cands, alphas):
    import jax
    import jax.numpy as jnp

    from vae_npvc_tpu.ops import vq as jvq

    mp.setattr(jvq, "_tiled_candidates",
               lambda rng, z, K: jnp.asarray(cands[z.shape[-1]][:K],
                                             z.dtype))
    mp.setattr(jax.random, "permutation",
               lambda key, n, *a, **k: jnp.arange(n))
    uniform = jax.random.uniform
    mp.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: (
        jnp.asarray(alphas) if tuple(shape) == alphas.shape
        else uniform(key, shape, *a, **k)))


def _jax_run(cfg, init, batches, save):
    """The JAX trainer on two devices from ``init``: per-step detail and
    the final checkpoint."""
    import jax

    from vae_npvc_tpu.train import build_trainer as jax_build_trainer

    t = jax_build_trainer(cfg, mesh=_two_devices())
    t.model = _ShapeInit(t.model)
    if hasattr(t, "discriminator"):
        t.discriminator = _ShapeInit(t.discriminator)
    t.load_checkpoint(str(init), example_batch=batches[0])
    details = [_floats(jax.device_get(t.train_step(b))) for b in batches]
    t.save_checkpoint(str(save))
    return details


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(output dir, {case: per-step detail of the reference}) after the
    ranks and the references ran: the JAX trainers on two devices, and for
    the jitter and the VAE one process of the port (``{case}.jax`` their
    final states)."""
    out = tmp_path_factory.mktemp("parallel_rest")
    cfgs = _configs()
    batches = _make_batches(cfgs)
    masks = _record_tac2_masks(cfgs["tac2"], batches["tac2"])
    cand_rng = np.random.default_rng(CAND_SEED)
    cands = {8: cand_rng.normal(size=(16, 8)).astype(np.float32),
             16: cand_rng.normal(size=(8, 16)).astype(np.float32)}
    alphas = np.random.default_rng(5).uniform(size=(B, 1, 1)) \
        .astype(np.float32)
    ins = {f"{n}/{i}/{j}": a for n, bs in batches.items()
           for i, b in enumerate(bs) for j, a in enumerate(b)}
    ins.update({f"tac2_mask/{i}": m for i, m in enumerate(masks)})
    ins.update({f"cand/{k}": v for k, v in cands.items()})
    ins["tac2_masks"] = np.array(len(masks))
    ins["gp_alpha"] = alphas
    np.savez(out / "inputs.npz", **ins)
    (out / "cases.json").write_text(json.dumps(cfgs))
    _port_inits(cfgs, out)
    _write_cli_data(out / "cli", cfgs)

    failed = []

    def ranks():
        try:
            spawn(_ranks, 2, args=(str(out),), timeout=420)
        except Exception as e:
            failed.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()
    names = ("hier_ema", "hier_plain", "gan", "hier2b_ema", "tac2", "tts")
    try:
        # XLA compiles outside the GIL: the references compile side by side
        with pytest.MonkeyPatch.context() as mp, \
                ThreadPoolExecutor(len(names)) as pool:
            _jax_candidates(mp, cands, alphas)
            jax_details = dict(zip(names, pool.map(
                lambda n: _jax_run(cfgs[n], out / f"{n}.init", batches[n],
                                   out / f"{n}.jax"), names)))
        _one_process_clis(out, cfgs)
        restore = _inject(np.load(out / "inputs.npz"))
        try:
            for name in ("jitter", "vae"):
                jax_details[name] = _train(cfgs[name], out / f"{name}.init",
                                           batches[name], None,
                                           out / f"{name}.jax")[1]
        finally:
            restore()
    finally:
        thread.join()
    if failed:
        raise failed[0]
    return out, jax_details


def _one_process_clis(out, cfgs):
    """The CLIs' runs in one process of the port on the same data (the
    flat model's candidates injected as on the ranks): the references of
    the two-rank runs."""
    from vae_npvc_tpu_torch.bin import train as train_cli
    from vae_npvc_tpu_torch.bin import train_pwg, train_tts

    root = out / "cli"
    for name, cli, extra in (("tts", train_tts, ["--valid_dir",
                                                  str(root / "tts_dev")]),
                             ("pwg", train_pwg, [])):
        exp = out / f"{name}_one"
        for half, max_iter in enumerate(cfgs[f"{name}_cli_iters"]):
            conf = out / f"{name}_cli_one_{half}.json"
            conf.write_text(json.dumps(dict(cfgs[f"{name}_cli"],
                                            max_iter=max_iter)))
            ck = (["--checkpoint", str(exp / f"iter.{max_iter // 2}")]
                  if half and name == "tts" else [])
            cli.main(["-c", str(conf), "--train_dir", str(root / name),
                      "--output_dir", str(exp), "--device", "cpu",
                      *extra, *ck])
    conf = out / "train_cli_one.json"
    conf.write_text(json.dumps(cfgs["train_cli"]))
    restore = _inject(np.load(out / "inputs.npz"))
    try:
        train_cli.main(["-c", str(conf), "--train_dir", str(root / "feats"),
                        "--output_dir", str(out / "train_one"),
                        "--device", "cpu"])
    finally:
        restore()


@pytest.fixture(scope="module")
def ranks(run):
    out, _ = run
    return [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]


# ---------------------------------------------------------------- helpers
def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _ckpt(path):
    from vae_npvc_tpu_torch.utils import msgpack_io

    return _leaves(msgpack_io.msgpack_restore(Path(path).read_bytes()))


def _result(ranks, name):
    got = [r[name] for r in ranks]
    for g in got:
        assert not (isinstance(g, dict) and "error" in g), g.get("error")
    return got


def _assert_details(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(w) <= set(g), (what, sorted(set(w) - set(g)))
        for k, v in w.items():
            np.testing.assert_allclose(
                g[k], v, rtol=LOSS_RTOL if k == "X like" else DETAIL_RTOL,
                atol=1e-7, err_msg=f"{what} step {i} {k}")


def _assert_state(got, want, what, free_reach,
                  roots=("model/", "ema/", "discriminator/")):
    """Every parameter and codebook leaf within ``STATE_TOL``; one whose
    exact gradient is 0 within ``free_reach``."""
    keys = [k for k in want if k.startswith(roots)]
    assert keys and set(got) == set(want), what
    for k in keys:
        free = k.startswith("model/") and k.endswith(FREE_SUFFIXES)
        np.testing.assert_allclose(got[k], want[k], rtol=STATE_TOL[0],
                                   atol=free_reach if free else STATE_TOL[1],
                                   err_msg=f"{what}: {k}")


def _reach(cfg, steps):
    return 2 * steps * cfg.get("learning_rate", 1e-3)


def _dp_against_reference(run, ranks, name):
    out, jax_details = run
    got = _result(ranks, name)
    assert got[0] == got[1], f"{name}: the ranks' details differ"
    _assert_details(got[0], jax_details[name], name)
    cfg = json.loads((out / "cases.json").read_text())[name]
    _assert_state(_ckpt(out / f"{name}.port"), _ckpt(out / f"{name}.jax"),
                  name, _reach(cfg, len(got[0])))


# ------------------------------------------------------------------ tests
def test_synthesizer_frame_weighted_losses_match_jax(run, ranks):
    """The transformer synthesizer on two ranks whose halves hold
    different numbers of valid frames and tokens: every loss is the global
    batch's masked mean, as JAX's sums over the sharded batch are (a mean
    of the ranks' means is not)."""
    out, _ = run
    ins = np.load(out / "inputs.npz")
    for i in range(3):
        lens, toks = ins[f"tts/{i}/5"], ins[f"tts/{i}/4"]
        assert lens[:2].sum() != lens[2:].sum()
        assert toks[:2].sum() != toks[2:].sum()
    _dp_against_reference(run, ranks, "tts")


def test_tacotron2_dp_step_with_jax_masks_matches_jax(run, ranks):
    """Dropout and zoneout on: JAX's masks of each step replayed whole on
    every rank, each rank keeping its rows; the losses divide by the
    global batch's frames."""
    _dp_against_reference(run, ranks, "tac2")


@pytest.mark.parametrize("name", ["hier_ema", "hier2b_ema"])
def test_ema_hierarchy_dp_step_matches_jax(run, ranks, name):
    """Every EMA level sums its statistics and pools its candidates over
    the data axis (the lazy init at step 1, restarts after); the ranks
    commit the same banks."""
    out, _ = run
    _dp_against_reference(run, ranks, name)
    ema = [k for k in _ckpt(out / f"{name}.jax") if k.startswith("ema/")]
    assert len(ema) >= 8, ema


def test_recipe_plain_hierarchy_dp_step_matches_jax(run, ranks):
    """``train_vqvae2.yaml``'s form (``use_ema: false``, normalized
    codebooks renormalized every step, a GST top): the perplexities and
    root mean squares of the detail are the global batch's."""
    _, jax_details = run
    assert {"entropy.0", "z_rms.1", "gst_in_rms"} <= set(
        jax_details["hier_plain"][0])
    _dp_against_reference(run, ranks, "hier_plain")


def test_gan_dp_matches_jax_through_the_phases(run, ranks):
    """``GanTrainer(mesh=)``: phase 1, then critic and generator steps;
    the penalty's weights are the global batch's, sliced by rank."""
    _, jax_details = run
    keys = set().union(*jax_details["gan"])
    assert {"DISC loss", "gradient_penalty", "ADV loss"} <= keys
    _dp_against_reference(run, ranks, "gan")


@pytest.mark.parametrize("name", ["hier_ema", "gan", "tts"])
def test_world_size_one_equals_the_plain_step(ranks, name):
    for res in _result(ranks, f"one_{name}"):
        assert res["detail_equal"] and res["state_equal"], res
        assert res["steps"] >= 3, res


def _check_cli_log(exp, steps):
    log = (exp / "train.log").read_text()
    assert "Rank 0 of 2" in log and "Rank 1" not in log
    for it in range(1, steps + 1):
        assert log.count(f"Iter {it}:") == 1, (it, log)
    return log


def test_train_tts_under_torchrun_writes_on_rank_zero_and_resumes(run,
                                                                  ranks):
    out, _ = run
    _result(ranks, "cli")
    exp = out / "tts_dp"
    log = _check_cli_log(exp, 4)
    assert "Resumed from" in log and "Valid 4:" in log
    assert sorted(p.name for p in exp.glob("iter.*")) == ["iter.2", "iter.4"]
    best = json.loads((exp / "best.json").read_text())
    assert (exp / "model.loss.best").read_bytes() == \
        (exp / f"iter.{best['iteration']}").read_bytes()
    cfg = json.loads((out / "cases.json").read_text())["tts_cli"]
    _assert_state(_ckpt(exp / "iter.4"), _ckpt(out / "tts_one" / "iter.4"),
                  "train_tts", _reach(cfg, 4))


def test_train_pwg_under_torchrun_writes_on_rank_zero_and_resumes(run,
                                                                  ranks):
    from tests.test_torch_port_pwg_train import assert_pwg_state_close

    out, _ = run
    _result(ranks, "cli")
    exp = out / "pwg_dp"
    log = _check_cli_log(exp, 4)
    assert "Resumed from" in log and "Device-resident corpus" in log
    assert sorted(p.name for p in exp.glob("iter.*")) == ["iter.2", "iter.4"]
    assert_pwg_state_close((exp / "model.final").read_bytes(),
                           (out / "pwg_one" / "model.final").read_bytes())


def test_train_device_resident_rows_are_the_host_loaders_global_batch(
        run, ranks):
    """``bin/train`` at world 2 keeps the device-resident corpus: each
    rank gathers its rows of the host loader's window, and the two ranks'
    rows of every step are the global batch, row for row; the final state
    is one process's. Across hosts (``LOCAL_WORLD_SIZE`` below
    ``WORLD_SIZE``) it trains from the host loader."""
    from vae_npvc_tpu_torch.data.dataset import (UttMelSpkDataset,
                                                 batch_iterator)

    out, _ = run
    _result(ranks, "cli")
    cfg = json.loads((out / "cases.json").read_text())["train_cli"]
    log = (out / "train_dp" / "train.log").read_text()
    assert "Device-resident corpus" in log and "Rank 0 of 2" in log
    # two hosts of one rank each: the host loader
    log = (out / "train_hosts" / "train.log").read_text()
    assert "single-host only" in log and "Device-resident" not in log
    assert (out / "train_hosts" / "iter.2").exists()
    dataset = UttMelSpkDataset(out / "cli" / "feats", cfg)
    host = batch_iterator(dataset, B, shuffle=True, drop_last=True,
                          seed=cfg.get("seed", 777), num_workers=0)
    rows = [np.load(out / f"train_rows_r{r}.npz") for r in (0, 1)]
    for i in range(cfg["max_iter"]):
        want = next(host)
        for j, w in enumerate(want):
            got = np.concatenate([r[f"{i}/{j}"] for r in rows])
            np.testing.assert_array_equal(got, np.asarray(w),
                                          err_msg=f"step {i} entry {j}")
        assert all(r[f"{i}/0"].shape[0] == B // 2 for r in rows)
    _assert_state(_ckpt(out / "train_dp" / f"iter.{cfg['max_iter']}"),
                  _ckpt(out / "train_one" / f"iter.{cfg['max_iter']}"),
                  "bin/train device_resident", STATE_TOL[1])


@pytest.mark.parametrize("name", ["jitter", "vae"])
def test_per_row_draws_are_the_global_batchs(run, ranks, name):
    """The jitter's replace/direction draws and the VAE's noise: two ranks
    keep their rows of one draw over the global batch, so they equal one
    process of the port on it."""
    _dp_against_reference(run, ranks, name)
