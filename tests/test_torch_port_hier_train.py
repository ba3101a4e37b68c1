"""Training and serving the hierarchical VQ-VAE in the port, against the
JAX ``Trainer``, and the committed JAX fixture of the family.

``tests/torch_port_fixtures/hier_golden*`` holds a small fp32 vqvae2 in the
recipe's form (``egs/vcc20/vae2/conf/train_vqvae2.yaml``: three levels, a
GST top, plain normalized codebooks renormalized every step, the clip and
StepLR) at test width, made by the JAX package on the CPU: the initial
checkpoint (the port's seeded weights as JAX saved them, no optimizer
state), a padded evaluation batch with its valid-mode forward losses,
``encode`` ids and style and ``infer`` mel, six training batches with JAX's
per-step detail, and the final checkpoint (parameters and Adam moments).
A host with the port but without JAX (``chip_smoke.py`` on a GPU machine)
holds the port against it. Regenerate with

    python -m tests.test_torch_port_hier_train

(from the repo root, with JAX on the CPU at full matmul precision, as
``tests/conftest.py`` sets it).

Tolerances (fp32, CPU against CPU): per-step losses and ``grad_norm`` 1e-4
relative, parameters and Adam moments 2e-5 + 1e-3 |x| after six steps
(summation order through three levels; the clip bites and StepLR halves
the rate at step 4), ids equal, style 1e-5 and mel 1e-4 of the peak.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_model_vqvae2 import enc_cfg, make_cfg

torch.set_num_threads(1)
FIXTURES = Path(__file__).resolve().parent / "torch_port_fixtures"
STEPS = 6
DETAIL_KEYS = ("Total", "VQ loss", "X like", "grad_norm", "gst_in_rms",
               "entropy.0", "quanti_err.1", "skipped_nonfinite")
FWD_KEYS = ("Total", "VQ loss", "X like", "gst_in_rms", "z_rms.0",
            "z_rms.1")
LOSS_RTOL = 1e-4
STATE_TOL = (2e-5, 1e-3)
EVAL_LENGTHS = np.array([32, 21, 9], np.int32)

# the recipe's form at test width: level 1 downsamples x2 and level 2 x4
# (so a 32-frame crop gives 32, 16 and 4 frames)
HIER_GOLDEN_CONFIG = dict(
    make_cfg(use_gst=True, use_ema=False),
    **{"encoder.2": enc_cfg(16, 4),
       "trainer_type": "vae_npvc.trainer.basic", "compute_dtype": "float32",
       "seed": 7, "gst_scale_penalty": 0.0, "optim_type": "Adam",
       "learning_rate": 1e-3, "max_grad_norm": 1.0, "lr_scheduler": "StepLR",
       "lr_param": {"step_size": 4, "gamma": 0.5}, "crop_length": 32,
       "batch_size": 4, "use_native_loader": False})


def _batches(seed=20261017):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(4, 32, 10)).astype(np.float32),
             rng.integers(0, 4, size=(4,)).astype(np.int32))
            for _ in range(STEPS)]


def _eval_batch():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 32, 10)).astype(np.float32)
    x[np.arange(32)[None] >= EVAL_LENGTHS[:, None]] = 0.0
    return x, np.array([3, 0, 2], np.int32)


def _mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _port_trainer(cfg, ckpt=None):
    from vae_npvc_tpu_torch.train import build_trainer

    tr = build_trainer(cfg, device="cpu")
    tr.init_state()
    if ckpt is not None:
        tr.load_checkpoint(ckpt)
    return tr


def _bare(ckpt_bytes):
    """A checkpoint's bytes without its optimizer state."""
    from vae_npvc_tpu_torch.utils import msgpack_io

    payload = msgpack_io.msgpack_restore(ckpt_bytes)
    payload["optimizer"] = {}
    return msgpack_io.msgpack_serialize(payload)


def make_hier_golden(tmp):
    """Run the fixture with JAX from the port's seeded initial state:
    (JAX trainer after six steps, initial ckpt bytes, final ckpt bytes,
    arrays)."""
    import jax
    import jax.numpy as jnp

    from vae_npvc_tpu.train.trainer import Trainer

    cfg = HIER_GOLDEN_CONFIG
    tmp = Path(tmp)
    seed_ckpt = tmp / "seed.ckpt"
    _port_trainer(cfg).save_checkpoint(seed_ckpt)
    seed_ckpt.write_bytes(_bare(seed_ckpt.read_bytes()))
    batches = _batches()
    tr = Trainer(cfg, mesh=_mesh())
    tr.init_state(batches[0])
    assert tr.load_checkpoint(seed_ckpt) == 0
    tr.save_checkpoint(tmp / "first.ckpt")
    first = _bare((tmp / "first.ckpt").read_bytes())

    x, y = _eval_batch()
    jm, params = tr.model, tr.state.params

    def evaluate(p, x, y, n):
        _, _, detail = jm.apply({"params": p}, x, y, train=False)
        ids, style = jm.apply({"params": p}, x, n, method=jm.encode)
        mel = jm.apply({"params": p}, x, y, n, method=jm.infer)
        return detail, ids, style, mel

    detail, ids, style, mel = jax.tree_util.tree_map(
        np.asarray, jax.jit(evaluate)(params, jnp.asarray(x),
                                      jnp.asarray(y),
                                      jnp.asarray(EVAL_LENGTHS)))
    arrays = {"eval/feats": x, "eval/spks": y, "eval/lengths": EVAL_LENGTHS,
              "eval/style": style, "eval/mel": mel}
    arrays.update({f"eval/ids_{i}": a for i, a in enumerate(ids)})
    arrays.update({f"fwd/{k}": np.float64(detail[k]) for k in FWD_KEYS})
    details = [tr.train_step(b) for b in batches]
    arrays.update({f"feats_{i}": b[0] for i, b in enumerate(batches)})
    arrays.update({f"spks_{i}": b[1] for i, b in enumerate(batches)})
    for k in DETAIL_KEYS:
        arrays["detail/" + k] = np.asarray([float(d[k]) for d in details],
                                           np.float64)
    tr.save_checkpoint(tmp / "final.ckpt")
    return tr, first, (tmp / "final.ckpt").read_bytes(), arrays


def write_hier_golden(out_dir=FIXTURES):
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        _, first, final, arrays = make_hier_golden(tmp)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "hier_golden.msgpack").write_bytes(first)
    (out_dir / "hier_golden_final.msgpack").write_bytes(final)
    np.savez_compressed(out_dir / "hier_golden.npz", **arrays)
    (out_dir / "hier_golden_config.json").write_text(
        json.dumps(HIER_GOLDEN_CONFIG, indent=1) + "\n")


# ------------------------------------------------------------------ helpers
def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_state_close(got, want, atol, rtol):
    """Two checkpoint payloads' bytes: same trees, every leaf close."""
    from vae_npvc_tpu_torch.utils import msgpack_io

    a = _leaves(msgpack_io.msgpack_restore(got))
    b = _leaves(msgpack_io.msgpack_restore(want))
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def _assert_detail(pd, jd, keys):
    for k in keys:
        np.testing.assert_allclose(float(pd[k]), float(jd[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    peak = max(float(np.abs(b).max()), 1e-12)
    assert float(np.abs(a - b).max()) <= tol * peak, what


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """(JAX trainer after the fixture's six steps, initial ckpt path,
    (first, final, arrays)) regenerated with JAX."""
    tmp = tmp_path_factory.mktemp("hier_golden")
    tr, first, final, arrays = make_hier_golden(tmp)
    (tmp / "first.bare").write_bytes(first)
    return tr, tmp / "first.bare", (first, final, arrays)


# -------------------------------------------------------------------- tests
def test_committed_hier_fixture_matches_jax(jax_side):
    """Regenerating with JAX reproduces the committed fixture."""
    _, _, (first, final, arrays) = jax_side
    assert json.loads((FIXTURES / "hier_golden_config.json").read_text()) \
        == HIER_GOLDEN_CONFIG
    committed = np.load(FIXTURES / "hier_golden.npz")
    assert set(committed.files) == set(arrays)
    for k, v in arrays.items():
        if k.startswith(("detail/", "fwd/", "eval/style", "eval/mel")):
            np.testing.assert_allclose(v, committed[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(v, committed[k], err_msg=k)
    assert_state_close(first, (FIXTURES / "hier_golden.msgpack")
                       .read_bytes(), 1e-7, 1e-6)
    assert_state_close(final, (FIXTURES / "hier_golden_final.msgpack")
                       .read_bytes(), *STATE_TOL)
    assert np.all(committed["detail/skipped_nonfinite"] == 0)
    size = sum((FIXTURES / n).stat().st_size for n in (
        "hier_golden.msgpack", "hier_golden_final.msgpack",
        "hier_golden.npz", "hier_golden_config.json"))
    assert size < 400_000


def test_port_trainer_tracks_jax_for_six_steps(jax_side, tmp_path):
    """From the same state: the evaluation batch's forward, ids, style and
    mel, then six steps (per-step detail) and the final parameters and
    Adam moments."""
    _, first, (_, final, arrays) = jax_side
    tr = _port_trainer(HIER_GOLDEN_CONFIG, first)
    m = tr.model
    x, y, n = (torch.from_numpy(arrays[k]) for k in (
        "eval/feats", "eval/spks", "eval/lengths"))
    with torch.no_grad():
        _, _, detail = m(x, y, False)
        ids, style = m.encode(x, n)
        mel = m.infer(x, y, n)
    _assert_detail(detail, {k: arrays["fwd/" + k] for k in FWD_KEYS},
                   FWD_KEYS)
    for i, a in enumerate(ids):
        np.testing.assert_array_equal(a.numpy(), arrays[f"eval/ids_{i}"])
    _close(style.numpy(), arrays["eval/style"], 1e-5, "style")
    valid = np.arange(32)[None] < EVAL_LENGTHS[:, None]
    _close(mel.numpy()[valid], arrays["eval/mel"][valid], 1e-4, "mel")
    for i in range(STEPS):
        d = tr.train_step((arrays[f"feats_{i}"], arrays[f"spks_{i}"]))
        _assert_detail(d, {k: arrays["detail/" + k][i]
                           for k in DETAIL_KEYS}, DETAIL_KEYS)
    tr.save_checkpoint(tmp_path / "final")
    assert_state_close((tmp_path / "final").read_bytes(), final, *STATE_TOL)


def test_ema_hierarchy_tracks_jax_with_injected_candidates(tmp_path):
    """``use_ema: true``: three steps from a fresh state (lazy init on step
    1, restarts after), every level's bank drawing the same injected
    candidate rows on both sides; then the EMA banks."""
    import jax.numpy as jnp

    from vae_npvc_tpu.ops import vq as jvq
    from vae_npvc_tpu.train.trainer import Trainer
    from vae_npvc_tpu_torch.ops import vq as pvq
    from vae_npvc_tpu_torch.utils import msgpack_io

    cfg = dict(HIER_GOLDEN_CONFIG, use_ema=True, use_gst=False)
    cfg["quantizer.2"] = dict(cfg["quantizer.1"])
    rows = np.random.default_rng(99).normal(size=(16, 8)).astype(np.float32)
    batches = _batches(3)[:3]
    seed = tmp_path / "seed"
    ptr = _port_trainer(cfg)
    ptr.save_checkpoint(seed)
    jtr = Trainer(cfg, mesh=_mesh())
    jtr.init_state(batches[0])
    jtr.load_checkpoint(seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvq, "_tiled_candidates",
                   lambda rng, z, K: jnp.asarray(rows[:K]))
        mp.setattr(pvq, "_tiled_candidates",
                   lambda gen, z, K: torch.from_numpy(rows[:K]))
        for batch in batches:
            pd, jd = ptr.train_step(batch), jtr.train_step(batch)
            _assert_detail(pd, jd, ("Total", "VQ loss", "X like",
                                    "grad_norm", "usage.0", "usage.2",
                                    "skipped_nonfinite"))
    assert set(ptr.ema) == {"quantizer_0", "quantizer_1", "quantizer_2"}
    jtr.save_checkpoint(tmp_path / "jax")
    ptr.save_checkpoint(tmp_path / "port")
    a = _leaves(msgpack_io.msgpack_restore((tmp_path / "port").read_bytes()))
    b = _leaves(msgpack_io.msgpack_restore((tmp_path / "jax").read_bytes()))
    ema = [k for k in b if k.startswith("ema/")]
    assert len(ema) == 12 and set(a) == set(b)
    for k in ema:
        np.testing.assert_allclose(a[k], b[k], atol=2e-5, rtol=1e-3,
                                   err_msg=k)


def test_ema_levels_draw_from_their_own_seeded_generators():
    """An EMA hierarchy's trainer keeps one generator per level, reseeded
    from (seed, step, level) every step: two trainers from the same seed
    take the same lazy inits and restarts, and each level's first draw
    differs from the others'."""
    cfg = dict(HIER_GOLDEN_CONFIG, use_ema=True, use_gst=False)
    cfg["quantizer.2"] = dict(cfg["quantizer.1"])
    batches = _batches(5)[:2]
    a, b = _port_trainer(cfg), _port_trainer(cfg)
    assert sorted(a.level_gens) == [0, 1, 2]
    for batch in batches:
        a.train_step(batch)
        b.train_step(batch)
    for name, q in a.ema.items():
        assert bool(q.initted)
        assert torch.equal(q.emb, b.ema[name].emb), name
    a._begin_step()
    first = [torch.rand(4, generator=g) for g in a.level_gens.values()]
    assert not torch.equal(first[0], first[1])
    assert not torch.equal(first[1], first[2])


def test_checkpoints_load_both_ways(jax_side, tmp_path):
    """port -> JAX and JAX -> port: each loads the other's checkpoint after
    three steps and both take the same next step."""
    jtr, first, _ = jax_side
    batches = _batches(11)
    ptr = _port_trainer(HIER_GOLDEN_CONFIG, first)
    for batch in batches[:3]:
        ptr.train_step(batch)
    ptr.save_checkpoint(tmp_path / "port.3")
    assert jtr.load_checkpoint(tmp_path / "port.3") == 3
    _assert_detail(ptr.train_step(batches[3]), jtr.train_step(batches[3]),
                   DETAIL_KEYS)
    jtr.save_checkpoint(tmp_path / "jax.4")
    other = _port_trainer(HIER_GOLDEN_CONFIG, tmp_path / "jax.4")
    assert other.iteration == 4
    _assert_detail(other.train_step(batches[4]), jtr.train_step(batches[4]),
                   DETAIL_KEYS)


def test_codebook_renorm_matches_jax_for_every_family():
    import jax.numpy as jnp

    from tests.test_model_vqvae2ab import cfg_2a
    from vae_npvc_tpu.models import codebook_renorm_fn as jax_renorm_fn
    from vae_npvc_tpu_torch.models import build_model, codebook_renorm_fn

    for cfg in (HIER_GOLDEN_CONFIG,
                cfg_2a(use_gst=False, use_ema=False, use_quantizers=False),
                dict(HIER_GOLDEN_CONFIG, use_ema=True)):
        pm = build_model(cfg, device="cpu").init_random(0)
        fn, jfn = codebook_renorm_fn(cfg), jax_renorm_fn(cfg)
        assert (fn is None) == (jfn is None)
        if fn is None:
            continue
        names = [n for n, _ in pm.named_parameters()
                 if n.startswith("quantizer_embedding")]
        assert names
        want = jfn({n: jnp.asarray(getattr(pm, n).detach().numpy())
                    for n in names})
        fn(pm)
        for n in names:
            np.testing.assert_allclose(getattr(pm, n).detach().numpy(),
                                       np.asarray(want[n]), rtol=1e-6)


def _kaldi_dir(d, lens, seed):
    from vae_npvc_tpu_torch.data import kaldi_io

    d.mkdir()
    rng = np.random.default_rng(seed)
    with kaldi_io.ArkWriter(d / "feats.ark", d / "feats.scp") as w:
        for i, n in enumerate(lens):
            w.write(f"utt{i}", rng.normal(size=(n, 10)).astype(np.float32))
    (d / "utt2num_frames").write_text(
        "".join(f"utt{i} {n}\n" for i, n in enumerate(lens)))
    (d / "utt2spk_id").write_text(
        "".join(f"utt{i} {i % 4}\n" for i in range(len(lens))))
    return d


def test_train_cli_trains_a_vqvae2_json_config_and_resumes(tmp_path):
    from vae_npvc_tpu_torch.bin import train as train_cli
    from vae_npvc_tpu_torch.infer.convert import read_checkpoint

    train = _kaldi_dir(tmp_path / "train", [40, 33, 64, 50, 37, 45], 0)
    valid = _kaldi_dir(tmp_path / "dev", [36, 48], 1)
    cfg = dict(HIER_GOLDEN_CONFIG, max_iter=4, iters_per_log=2,
               iters_per_checkpoint=2, steps_per_call=8, device_resident=True,
               use_native_loader=True, batch_size=2, valid_batch_size=2,
               num_jobs=0)
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps(cfg))

    def run(out, *extra):
        train_cli.main(["-c", str(conf), "--output_dir", str(out),
                        "--train_dir", str(train), "--valid_dir", str(valid),
                        "--device", "cpu", *extra])

    run(tmp_path / "full")
    log = (tmp_path / "full" / "train.log").read_text()
    assert "vqvae2.Model" in log and "Device-resident corpus" in log
    rows = [json.loads(ln) for ln in
            (tmp_path / "full" / "metrics.jsonl").read_text().splitlines()]
    assert [(r["iter"], r["split"]) for r in rows] == [
        (2, "train"), (2, "valid"), (4, "train"), (4, "valid")]
    assert all(np.isfinite(r["X like"]) and np.isfinite(r["gst_in_rms"])
               for r in rows)
    payload, variables = read_checkpoint(tmp_path / "full" / "iter.4")
    assert set(variables["params"]) >= {"encoder_0", "decoder_2", "gst",
                                        "embeds", "quantizer_embedding_1"}
    # a run stopped at 2 is bit-equal to the first half of the full run;
    # resumed with --checkpoint auto it carries on to 4 (the data iterator
    # restarts with the process, as in the JAX CLI)
    cfg["max_iter"] = 2
    conf.write_text(json.dumps(cfg))
    run(tmp_path / "half")
    assert (tmp_path / "half" / "iter.2").read_bytes() \
        == (tmp_path / "full" / "iter.2").read_bytes()
    cfg["max_iter"] = 4
    conf.write_text(json.dumps(cfg))
    run(tmp_path / "half", "--checkpoint", "auto")
    assert "Resumed from" in (tmp_path / "half" / "train.log").read_text()
    payload, _ = read_checkpoint(tmp_path / "half" / "iter.4")
    assert payload["iteration"] == 4
    assert int(payload["optimizer"]["1"]["0"]["count"]) == 4


def test_engine_serves_a_vqvae2_checkpoint(jax_side, tmp_path):
    """A ``ConversionEngine`` on a vqvae2 checkpoint answers concurrent
    requests (coalesced into padded batches) with ``Converter.infer``'s
    mel of each utterance alone; short requests pad up to the encoder
    chain's minimum."""
    from concurrent.futures import ThreadPoolExecutor

    from vae_npvc_tpu_torch.data import cmvn as cmvn_mod
    from vae_npvc_tpu_torch.infer.convert import Converter
    from vae_npvc_tpu_torch.serve import ConversionEngine

    _, first, _ = jax_side
    feat = {"fs": 8000, "n_fft": 128, "n_shift": 32, "n_mels": 10,
            "fmin": 0.0, "fmax": None, "win_length": None}
    stats = np.zeros((2, 11), np.float64)
    stats[0, :-1] = -3.0 * 1000
    stats[0, -1] = 1000
    stats[1, :-1] = (1.0 + 3.0 ** 2) * 1000
    eng = ConversionEngine(HIER_GOLDEN_CONFIG, first, stats, feature=feat,
                           vocoder="none", bucket_frames=32,
                           batch_window_ms=30.0, device="cpu")
    cv = Converter(HIER_GOLDEN_CONFIG, device="cpu")
    cv.load_checkpoint(first)
    assert eng.converter.min_frames == cv.min_frames == 8
    rng = np.random.default_rng(4)
    wavs = [0.1 * rng.normal(size=(n,)).astype(np.float32)
            for n in (100, 700, 1000, 1500, 2000, 900)]
    try:
        with ThreadPoolExecutor(6) as ex:
            outs = list(ex.map(lambda i: eng.convert(wavs[i], 8000, i % 4,
                                                     return_mel=True)[0],
                               range(len(wavs))))
        assert eng.batcher.calls < len(wavs)
        for i, (wav, got) in enumerate(zip(wavs, outs)):
            T_true = 1 + wav.size // 32
            T_pad = max(-(-max(T_true, 8) // 32) * 32, 8)
            xp = np.zeros((1, T_pad * 32 - 1), np.float32)
            xp[0, :wav.size] = wav
            mel = eng._mel_batch(xp)[0]
            feats = np.zeros_like(mel)
            feats[:T_true] = cmvn_mod.apply(mel[:T_true], stats)
            want = cv.infer(feats[None], np.array([i % 4]),
                            np.array([T_true]))[0, :T_true]
            want = cmvn_mod.apply(want, stats, reverse=True)
            assert got.shape == (T_true, 10)
            _close(got, want, 1e-5, f"request {i}")
    finally:
        eng.close()


def test_chip_smoke_hier_config_is_the_recipe_yaml():
    import sys

    import yaml

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import chip_smoke

    with open(root / "egs/vcc20/vae2/conf/train_vqvae2.yaml") as f:
        assert yaml.safe_load(f) == chip_smoke.HIER


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    write_hier_golden()
