"""Training the vocoder in the port, against the JAX ``PwgTrainer``, and the
committed JAX fixture of it.

``tests/torch_port_fixtures/pwg_golden*`` holds a small fp32 vocoder in the
recipe's form (``egs/vcc20/vae1/conf/train_jpwg.yaml``: RAdam at the
published rates with StepLR, G clipped at 10 and D at 1, ``lambda_adv`` 4)
at test width, made by the JAX package on the CPU: the initial checkpoint
(the port's seeded weights as JAX saved them), six training batches with
the noise JAX drew for each step, JAX's per-step detail across
``discriminator_train_start_steps`` (3), the final checkpoint, and the
generator's output at the final parameters on an evaluation mel and noise.
A host with the port but without JAX (``chip_smoke.py`` on a GPU machine)
holds the port against it. Regenerate with

    python -m tests.test_torch_port_pwg_train

(from the repo root, with JAX on the CPU at full matmul precision, as
``tests/conftest.py`` sets it).

Tolerances (fp32, CPU against CPU): per-step losses 1e-4 relative; after
six steps the parameters of both networks and the discriminator's RAdam
moments within 2e-5 + 1e-3 |x|; the generator's first and second moments
within 0.1 of each leaf's own peak and 2e-2 of the network's largest
(|mu|, resp. |nu|); the generator's output at the final state within 1e-5
of its peak.

The generator's moments are the one state not held per element. At the
seeded initialization the generator's output is its last bias (a DC level)
plus ~1 % of it in variation, so the log-STFT-magnitude gradient, 1/|X| at
the smallest bins, carries each FFT's rounding. :func:`lockstep_gradients`
shows it at the six lockstep points: the port's fp32 gradient is as far
from the same function computed in float64 as it is from JAX's (G's
gradient leaves 0.022 and 0.016 of a leaf's peak, the moments built from
them 0.027 and 0.027), and JAX's own fp32 gradient is 0.008-0.015 from the
float64 one; which package rounds closer changes from step to step with
the FFT's rounding (``python -m tests.test_torch_port_pwg_train
--gradients`` prints the numbers). The six free-running steps leave G's
moments 0.044 of a leaf's peak from JAX's.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_pwg import PWG_CFG, sine_corpus

torch.set_num_threads(1)
FIXTURES = Path(__file__).resolve().parent / "torch_port_fixtures"
STEPS = 6
B, M, HOP, N_MELS = 2, 16, 16, 10
DETAIL_KEYS = ("Total", "spectral_convergence", "log_stft_magnitude",
               "adversarial", "disc_real", "disc_fake")
LOSS_RTOL = 1e-4
STATE_TOL = (2e-5, 1e-3)
G_MOMENT_TOL = 2e-2     # of the generator's largest |mu| (resp. |nu|)
G_MOMENT_LEAF_TOL = 0.1  # of each leaf's own peak
# along the lockstep (lockstep_gradients), of each peak: the STFT loss's
# gradient over the waveform and G's gradient leaves against jax.grad
WAVE_GRAD_TOL, LEAF_GRAD_TOL = 2.5e-2, 4e-2

PWG_GOLDEN_CONFIG = {
    "layers": 6, "stacks": 2, "residual_channels": 8, "gate_channels": 16,
    "skip_channels": 8, "kernel_size": 3, "upsample_scales": [4, 4],
    "n_mels": N_MELS, "disc_layers": 4, "disc_channels": 8,
    "compute_dtype": "float32", "seed": 5, "lambda_adv": 4.0,
    "discriminator_train_start_steps": 3,
    "stft_loss_params": [[64, 16, 32], [128, 32, 64], [32, 8, 16]],
    "generator_param": {"optim_type": "RAdam", "learning_rate": 1e-4,
                        "lr_scheduler": {"step_size": 4, "gamma": 0.5}},
    "discriminator_param": {"optim_type": "RAdam", "learning_rate": 5e-5,
                            "lr_scheduler": {"step_size": 2, "gamma": 0.5}},
}


def _batches(seed=20261017):
    rng = np.random.default_rng(seed)
    return [((rng.normal(size=(B, M * HOP)) * 0.3).astype(np.float32),
             rng.normal(size=(B, M, N_MELS)).astype(np.float32))
            for _ in range(STEPS)]


def jax_noise(seed, step, shape):
    """The noise the JAX trainer draws inside its step ``step``."""
    import jax

    return np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(seed), step), shape))


def _jax_trainer(cfg, example):
    import jax
    from jax.sharding import Mesh

    from vae_npvc_tpu.train.pwg import PwgTrainer as JaxTrainer

    tr = JaxTrainer(cfg, mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))
    tr.init_state(example)
    return tr


def _port_trainer(cfg=PWG_GOLDEN_CONFIG, ckpt=None):
    from vae_npvc_tpu_torch.train.pwg import PwgTrainer

    tr = PwgTrainer(cfg, device="cpu")
    tr.init_state()
    if ckpt is not None:
        tr.load_checkpoint(ckpt)
    return tr


def make_pwg_golden(tmp):
    """Run the fixture with JAX from the port's seeded initial state:
    (JAX trainer after six steps, initial ckpt bytes, final ckpt bytes,
    arrays)."""
    import jax.numpy as jnp

    cfg = PWG_GOLDEN_CONFIG
    tmp = Path(tmp)
    _port_trainer().save_checkpoint(tmp / "seed.ckpt")
    batches = _batches()
    tr = _jax_trainer(cfg, batches[0])
    assert tr.load_checkpoint(tmp / "seed.ckpt") == 0
    tr.save_checkpoint(tmp / "first.ckpt")
    arrays = {}
    details = []
    for i, (wav, mel) in enumerate(batches):
        arrays[f"wav_{i}"], arrays[f"mel_{i}"] = wav, mel
        arrays[f"z_{i}"] = jax_noise(cfg["seed"], i, (B, M * HOP, 1))
        details.append(tr.train_step((wav, mel)))
    for k in DETAIL_KEYS:
        arrays["detail/" + k] = np.asarray([float(d[k]) for d in details],
                                           np.float64)
    rng = np.random.default_rng(3)
    mel = rng.normal(size=(2, 24, N_MELS)).astype(np.float32)
    z = rng.normal(size=(2, 24 * HOP, 1)).astype(np.float32)
    arrays["eval/mel"], arrays["eval/z"] = mel, z
    arrays["eval/wav"] = np.asarray(tr.generator.apply(
        {"params": tr.state.g_params}, jnp.asarray(z), jnp.asarray(mel)))
    tr.save_checkpoint(tmp / "final.ckpt")
    return (tr, (tmp / "first.ckpt").read_bytes(),
            (tmp / "final.ckpt").read_bytes(), arrays)


def write_pwg_golden(out_dir=FIXTURES):
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        _, first, final, arrays = make_pwg_golden(tmp)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "pwg_golden.msgpack").write_bytes(first)
    (out_dir / "pwg_golden_final.msgpack").write_bytes(final)
    np.savez_compressed(out_dir / "pwg_golden.npz", **arrays)
    (out_dir / "pwg_golden_config.json").write_text(
        json.dumps(PWG_GOLDEN_CONFIG, indent=1) + "\n")


# ------------------------------------------------------------------ helpers
def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _payload_leaves(data):
    from vae_npvc_tpu_torch.utils import msgpack_io

    return _leaves(msgpack_io.msgpack_restore(data))


def assert_pwg_state_close(got, want):
    """Two vocoder checkpoints' bytes: the same trees, the tolerances of the
    module docstring."""
    a, b = _payload_leaves(got), _payload_leaves(want)
    assert set(a) == set(b)
    for k in b:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        if not (k.startswith("optimizer_G/") and k.split("/")[3] in ("mu",
                                                                   "nu")):
            np.testing.assert_allclose(a[k], b[k], atol=STATE_TOL[0],
                                       rtol=STATE_TOL[1], err_msg=k)
    for kind in ("mu", "nu"):
        keys = [k for k in b if k.startswith(f"optimizer_G/1/0/{kind}/")]
        x = np.concatenate([a[k].ravel() for k in keys]).astype(np.float64)
        y = np.concatenate([b[k].ravel() for k in keys]).astype(np.float64)
        assert np.abs(x - y).max() <= G_MOMENT_TOL * np.abs(y).max(), kind
        for k in keys:
            if not _zero_gradient_leaf(k):
                assert np.abs(a[k] - b[k]).max() \
                    <= G_MOMENT_LEAF_TOL * np.abs(b[k]).max(), k


def _zero_gradient_leaf(name):
    """``in/v``: the ``in`` conv has one input channel and kernel 1, so its
    weight norm keeps only the sign of ``v`` and ``v``'s exact gradient is
    0; both packages hold rounding noise there."""
    return name.endswith("in/v")


def _g_loss_port(cfg, gp, dp, batch, z, active, dtype):
    """The port's generator loss at parameters ``gp`` (and the
    discriminator's ``dp``), with the trunk and the STFT loss computed in
    ``dtype`` (parameters and the waveform between them stay fp32):
    (loss, the loss's gradient over the waveform, G's gradient leaves)."""
    from vae_npvc_tpu_torch.models.pwg import PWGDiscriminator, PWGGenerator
    from vae_npvc_tpu_torch.ops.stft_loss import single_stft_loss
    from vae_npvc_tpu_torch.utils.bridge import (from_jax_variables,
                                                 to_jax_variables)

    gen = PWGGenerator(cfg, dtype=dtype)
    disc = PWGDiscriminator(cfg, dtype=dtype)
    gen.load_state_dict(from_jax_variables({"params": gp}))
    disc.load_state_dict(from_jax_variables({"params": dp}))
    wav, mel = (torch.from_numpy(np.asarray(a)) for a in batch)
    x = gen(torch.from_numpy(np.asarray(z)), mel)[..., 0]
    adv = torch.mean((disc(x[..., None]) - 1.0) ** 2)
    # the STFT loss of ops/stft_loss.multi_stft_loss, in ``dtype``
    xl = x.to(dtype)
    sc = mag = 0.0
    res = [tuple(r) for r in cfg["stft_loss_params"]]
    for r in res:
        a, b = single_stft_loss(xl, wav.to(dtype), *r)
        sc, mag = sc + a, mag + b
    stft = (sc + mag) / len(res)
    loss = stft + cfg["lambda_adv"] * active * adv
    names = [n for n, _ in gen.named_parameters()]
    grads = torch.autograd.grad(loss, list(gen.parameters()),
                                retain_graph=True)
    (in_grad,) = torch.autograd.grad(stft, xl)
    tree = to_jax_variables({n: g.double() for n, g in zip(names, grads)})
    return (float(stft.detach()), in_grad.double().numpy(),
            _leaves(tree["params"]))


def _g_loss_jax(cfg):
    """jax.grad of the JAX trainer's generator loss (``g_loss_fn``), jitted:
    f(gp, dp, wav, mel, z, active) -> (the STFT loss, its gradient over
    the waveform, G's gradient tree)."""
    import jax
    import jax.numpy as jnp

    from vae_npvc_tpu.models.pwg import PWGDiscriminator, PWGGenerator
    from vae_npvc_tpu.ops.stft_loss import multi_stft_loss

    gen, disc = PWGGenerator(arch=cfg), PWGDiscriminator(arch=cfg)
    res = tuple(tuple(r) for r in cfg["stft_loss_params"])

    def stft(x, wav):
        sc, mag = multi_stft_loss(x, wav, res)
        return sc + mag

    def loss(gp, dp, wav, mel, z, active):
        x = gen.apply({"params": gp}, z, mel)[..., 0]
        adv = jnp.mean((disc.apply({"params": dp}, x[..., None]) - 1.0) ** 2)
        return stft(x, wav) + cfg["lambda_adv"] * active * adv, x

    @jax.jit
    def f(gp, dp, wav, mel, z, active):
        (_, x), g = jax.value_and_grad(loss, has_aux=True)(
            gp, dp, wav, mel, z, active)
        value, in_grad = jax.value_and_grad(stft)(x, wav)
        return value, in_grad, g

    return f


def lockstep_gradients():
    """Along the port's six lockstep steps from the fixture (JAX's noise),
    at each step's parameters: the generator's loss, its gradient over the
    waveform and G's gradient three ways: the port in fp32 (``P``), JAX in
    fp32 (``J``) and the port's trunk and STFT loss in float64 (``R``,
    the reference). Returns, over the steps and over G's leaves but the
    zero-gradient ``in/v``, each as a share of the reference's peak (of
    the waveform gradient, of each leaf):

    - ``wave_grad``: the largest |P - J|, |P - R|, |J - R| of the
      waveform gradient (``wave_grad_by_step``: each step's);
    - ``leaf_grad``: the same for G's gradient leaves;
    - ``mu``, ``nu``: the same for the moments that RAdam's betas (0.9,
      0.999) build from each series of six gradients;
    - ``loss_rel``: the largest relative |P - J| of the STFT loss;
    - ``unread``: for each leaf whose reference gradient is exactly 0 (a
      layer whose output nothing reads), the largest |P| or |J| there;
    - ``free_running``: after the six steps, the port's G moments against
      the committed JAX fixture's: the largest share of a leaf's peak (but
      ``in/v``) and of the network's largest."""
    import jax

    cfg = PWG_GOLDEN_CONFIG
    arrays = np.load(FIXTURES / "pwg_golden.npz")
    tr = _port_trainer(ckpt=FIXTURES / "pwg_golden.msgpack")
    jax_fn = _g_loss_jax(cfg)
    pairs = (("P", "J"), ("P", "R"), ("J", "R"))
    out = {k: {a + b: 0.0 for a, b in pairs}
           for k in ("wave_grad", "leaf_grad", "mu", "nu")}
    out["loss_rel"], out["unread"], out["wave_grad_by_step"] = 0.0, {}, []
    moments = {}
    for i in range(STEPS):
        batch = (arrays[f"wav_{i}"], arrays[f"mel_{i}"])
        z = arrays[f"z_{i}"]
        active = float(i >= cfg["discriminator_train_start_steps"])
        gp = jax.tree_util.tree_map(np.asarray, tr.G.params_tree())
        dp = jax.tree_util.tree_map(np.asarray, tr.D.params_tree())
        runs = {"P": _g_loss_port(cfg, gp, dp, batch, z, active,
                                  torch.float32),
                "R": _g_loss_port(cfg, gp, dp, batch, z, active,
                                  torch.float64)}
        value, in_grad, g = jax_fn(gp, dp, batch[0], batch[1], z, active)
        runs["J"] = (float(value), np.asarray(in_grad, np.float64),
                     {k: np.asarray(v, np.float64) for k, v in
                      _leaves(jax.tree_util.tree_map(np.asarray,
                                                     g)).items()})
        out["loss_rel"] = max(out["loss_rel"], abs(runs["P"][0] - runs[
            "J"][0]) / abs(runs["J"][0]))
        peak = np.abs(runs["R"][1]).max()
        step = {a + b: float(np.abs(runs[a][1] - runs[b][1]).max() / peak)
                for a, b in pairs}
        out["wave_grad_by_step"].append(step)
        for k, v in step.items():
            out["wave_grad"][k] = max(out["wave_grad"][k], v)
        for name, (_, _, leaves) in runs.items():
            for k, v in leaves.items():
                mu, nu = moments.get((name, k), (0.0, 0.0))
                moments[name, k] = (0.9 * mu + 0.1 * v,
                                    0.999 * nu + 0.001 * v * v)
        for k, ref in runs["R"][2].items():
            if _zero_gradient_leaf(k):
                continue
            if not np.abs(ref).any():
                # a layer whose output nothing reads (the last res_i)
                out["unread"][k] = max(out["unread"].get(k, 0.0), float(max(
                    np.abs(runs[n][2][k]).max() for n in "PJ")))
                continue
            for a, b in pairs:
                d = np.abs(runs[a][2][k] - runs[b][2][k]).max()
                out["leaf_grad"][a + b] = max(out["leaf_grad"][a + b],
                                              float(d / np.abs(ref).max()))
        tr.train_step(batch, z)
    from vae_npvc_tpu_torch.utils import msgpack_io

    tree = _payload_leaves(msgpack_io.msgpack_serialize(
        {"optimizer_G": tr.G.opt_tree()}))
    want = _payload_leaves(
        (FIXTURES / "pwg_golden_final.msgpack").read_bytes())
    out["free_running"] = {}
    for kind in ("mu", "nu"):
        keys = [k for k in want if k.startswith(f"optimizer_G/1/0/{kind}/")]
        largest = max(np.abs(want[k]).max() for k in keys)
        errs = {k: np.abs(tree[k] - want[k]).max() for k in keys}
        out["free_running"][kind] = {
            "of_leaf_peak": float(max(
                errs[k] / np.abs(want[k]).max() for k in keys
                if errs[k] and not _zero_gradient_leaf(k))),
            "of_largest": float(max(errs.values()) / largest)}
    for j, kind in enumerate(("mu", "nu")):
        for k in runs["R"][2]:
            if _zero_gradient_leaf(k) or k in out["unread"]:
                continue
            ref = np.abs(moments["R", k][j]).max()
            for a, b in pairs:
                d = np.abs(moments[a, k][j] - moments[b, k][j]).max()
                out[kind][a + b] = max(out[kind][a + b], float(d / ref))
    return out


def _assert_detail(pd, jd):
    for k in DETAIL_KEYS:
        np.testing.assert_allclose(float(pd[k]), float(jd[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """(JAX trainer after the fixture's six steps, initial ckpt path,
    (first, final, arrays)) regenerated with JAX."""
    tmp = tmp_path_factory.mktemp("pwg_golden")
    tr, first, final, arrays = make_pwg_golden(tmp)
    (tmp / "first.bytes").write_bytes(first)
    return tr, tmp / "first.bytes", (first, final, arrays)


# -------------------------------------------------------------------- tests
def test_committed_pwg_fixture_matches_jax(jax_side):
    """Regenerating with JAX reproduces the committed fixture."""
    _, _, (first, final, arrays) = jax_side
    assert json.loads((FIXTURES / "pwg_golden_config.json").read_text()) \
        == PWG_GOLDEN_CONFIG
    committed = np.load(FIXTURES / "pwg_golden.npz")
    assert set(committed.files) == set(arrays)
    for k, v in arrays.items():
        if k.startswith(("detail/", "eval/wav")):
            np.testing.assert_allclose(v, committed[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(v, committed[k], err_msg=k)
    assert (FIXTURES / "pwg_golden.msgpack").read_bytes() == first
    assert_pwg_state_close(final, (FIXTURES / "pwg_golden_final.msgpack")
                           .read_bytes())
    size = sum((FIXTURES / n).stat().st_size for n in (
        "pwg_golden.msgpack", "pwg_golden_final.msgpack", "pwg_golden.npz",
        "pwg_golden_config.json"))
    assert size < 300_000


def test_port_trainer_tracks_jax_across_the_start_step(jax_side, tmp_path):
    """From the same state with JAX's noise: six steps across
    ``discriminator_train_start_steps`` (per-step detail), D frozen before
    it, then both networks and both optimizers' states."""
    _, first, (_, final, arrays) = jax_side
    tr = _port_trainer(ckpt=first)
    d0 = tr.D.flat.clone()
    for i in range(STEPS):
        d = tr.train_step((arrays[f"wav_{i}"], arrays[f"mel_{i}"]),
                          arrays[f"z_{i}"])
        _assert_detail(d, {k: arrays["detail/" + k][i]
                           for k in DETAIL_KEYS})
        frozen = i + 1 <= PWG_GOLDEN_CONFIG[
            "discriminator_train_start_steps"]
        assert torch.equal(tr.D.flat, d0) == frozen, i
        assert int(tr.D.opt_state.count) == max(i - 2, 0)
        assert int(tr.D.opt_state.sched_count) == max(i - 2, 0)
    # the adversarial weight is 0 before the start step: Total = sc + mag
    det = arrays["detail/Total"]
    sc_mag = (arrays["detail/spectral_convergence"]
              + arrays["detail/log_stft_magnitude"])
    np.testing.assert_allclose(det[:3], sc_mag[:3], rtol=1e-6)
    np.testing.assert_allclose(det[3:], sc_mag[3:] + 4.0 * arrays[
        "detail/adversarial"][3:], rtol=1e-6)
    tr.save_checkpoint(tmp_path / "final")
    assert_pwg_state_close((tmp_path / "final").read_bytes(), final)


def test_generator_gradient_along_the_lockstep_against_jax_and_float64():
    """At each of the six lockstep points: the STFT loss against JAX's
    (1e-5 relative); its gradient over the waveform and G's gradient
    leaves against ``jax.grad`` of JAX's generator loss; and the witness
    that the gap is rounding, not a difference of function: the port is
    no more than twice as far from JAX as from its own float64
    computation of the same loss, in the waveform gradient, G's leaves and
    the moments built from them. A layer whose output nothing reads has a
    gradient of exactly 0 in both packages."""
    g = lockstep_gradients()
    assert g["loss_rel"] <= 1e-5
    assert g["wave_grad"]["PJ"] <= WAVE_GRAD_TOL
    assert g["leaf_grad"]["PJ"] <= LEAF_GRAD_TOL
    for kind in ("mu", "nu"):
        assert g[kind]["PJ"] <= G_MOMENT_LEAF_TOL, kind
    for k in ("wave_grad", "leaf_grad", "mu", "nu"):
        assert g[k]["PJ"] <= 2.0 * g[k]["PR"], (k, g[k])
    assert g["unread"] and not any(g["unread"].values())


def test_generator_output_at_the_final_state(jax_side, tmp_path):
    _, _, (_, final, arrays) = jax_side
    (tmp_path / "final").write_bytes(final)
    tr = _port_trainer(ckpt=tmp_path / "final")
    wav = tr.synthesize(arrays["eval/mel"], arrays["eval/z"])
    want = arrays["eval/wav"][..., 0]
    assert wav.shape == want.shape
    assert np.abs(wav - want).max() <= 1e-5 * np.abs(want).max()


def test_checkpoints_cross_both_ways_byte_identical(jax_side, tmp_path):
    """JAX -> port -> JAX and port -> JAX -> port give the same bytes, and a
    restored trainer takes the same next step as the one it came from."""
    jtr, first, (_, final, arrays) = jax_side
    (tmp_path / "jax").write_bytes(final)
    ptr = _port_trainer(ckpt=tmp_path / "jax")
    assert ptr.iteration == STEPS
    ptr.save_checkpoint(tmp_path / "port")
    assert (tmp_path / "port").read_bytes() == final
    batch = (arrays["wav_0"], arrays["mel_0"])
    ptr.train_step(batch, arrays["z_1"])
    ptr.save_checkpoint(tmp_path / "port7")
    jtr2 = _jax_trainer(PWG_GOLDEN_CONFIG, batch)
    assert jtr2.load_checkpoint(tmp_path / "port7") == STEPS + 1
    jtr2.save_checkpoint(tmp_path / "jax7")
    assert (tmp_path / "jax7").read_bytes() \
        == (tmp_path / "port7").read_bytes()
    again = _port_trainer(ckpt=tmp_path / "jax7")
    d1 = ptr.train_step(batch, arrays["z_2"])
    d2 = again.train_step(batch, arrays["z_2"])
    for k in DETAIL_KEYS:
        assert float(d1[k]) == float(d2[k]), k


def test_wav_mel_dataset_matches_jax(tmp_path):
    """The same crops as JAX's for the same seed (wav equal, log-mel within
    1e-5 of 1), from a corpus with a short utterance (zero-padded) and one
    at another rate (resampled); ``padded_arrays`` likewise."""
    from scipy.io import wavfile

    from vae_npvc_tpu.data.wav_mel import WavMelDataset as JaxDataset
    from vae_npvc_tpu_torch.data.wav_mel import WavMelDataset

    root = sine_corpus(tmp_path, n=5)
    rng = np.random.default_rng(2)
    wavfile.write(tmp_path / "short.wav", 8000,
                  (rng.normal(size=60) * 3000).astype(np.int16))
    wavfile.write(tmp_path / "rate.wav", 16000,
                  (rng.normal(size=5000) * 3000).astype(np.int16))
    with open(root / "wav.scp", "a") as f:
        f.write(f"short {tmp_path / 'short.wav'}\n"
                f"rate {tmp_path / 'rate.wav'}\n")
    pt, jx = WavMelDataset(root, PWG_CFG), JaxDataset(root, PWG_CFG)
    assert len(pt) == len(jx) == 7
    for (pw, pm), (jw, jm) in zip(pt.batches(3, seed=4, epochs=2),
                                  jx.batches(3, seed=4, epochs=2)):
        np.testing.assert_array_equal(pw, jw)
        np.testing.assert_allclose(pm, jm, atol=1e-5)
    for a, b in zip(pt.padded_arrays(), jx.padded_arrays()):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert pt.padded_nbytes() == jx.padded_nbytes()
    lazy = WavMelDataset(root, dict(PWG_CFG, preload_limit=2))
    assert not lazy.preload
    w1, _ = next(lazy.batches(4, seed=7))
    w2, _ = next(pt.batches(4, seed=7))
    np.testing.assert_array_equal(w1, w2)
    with pytest.raises(ValueError, match="preloaded"):
        lazy.padded_arrays()


def _small_cfg(**kw):
    return dict(PWG_CFG, discriminator_train_start_steps=1, **kw)


def test_device_resident_crops_are_aligned_and_resumable(tmp_path):
    """Crops drawn on the device are aligned windows of the staged corpus,
    and a run resumed from a checkpoint draws what an uninterrupted one
    does."""
    from vae_npvc_tpu_torch.data.wav_mel import WavMelDataset
    from vae_npvc_tpu_torch.train.pwg import PwgTrainer

    ds = WavMelDataset(sine_corpus(tmp_path, n=4), PWG_CFG)
    wavs, mels, m_hi = ds.padded_arrays()

    def trainer():
        tr = PwgTrainer(_small_cfg(), device="cpu")
        tr.init_state()
        tr.stage_dataset(ds, 3)
        return tr

    a = trainer()
    a._reseed()
    wav, mel, z = a._sample()
    assert wav.shape == (3, ds.max_frames * ds.hop) and z.shape[-1] == 1
    # each crop is a window of one staged utterance, mel and wav aligned
    for b in range(3):
        hits = [(i, m0) for i in range(len(ds)) for m0 in range(m_hi[i] + 1)
                if np.array_equal(mels[i, m0:m0 + ds.max_frames],
                                  mel[b].numpy())]
        assert len(hits) >= 1
        i, m0 = hits[0]
        np.testing.assert_array_equal(
            wavs[i, m0 * ds.hop:(m0 + ds.max_frames) * ds.hop],
            wav[b].numpy())
    full = a.train_steps_device(4)
    b = trainer()
    b.train_steps_device(2)
    b.save_checkpoint(tmp_path / "half")
    c = trainer()
    c.load_checkpoint(tmp_path / "half")
    rest = c.train_steps_device(2)
    for k in DETAIL_KEYS:
        np.testing.assert_array_equal(full[k][2:].numpy(), rest[k].numpy())


def test_staged_batches_equal_host_batches():
    """``stage_batches`` + ``train_steps`` take the same steps as host
    batches; each step's noise comes from the generator reseeded from
    (seed, step)."""
    from vae_npvc_tpu_torch.train.pwg import PwgTrainer

    batches = _batches(9)[:2]
    out = []
    for staged in (False, True):
        tr = PwgTrainer(PWG_GOLDEN_CONFIG, device="cpu")
        tr.init_state()
        arg = tr.stage_batches(batches) if staged else batches
        out.append(tr.train_steps(arg))
    for k in DETAIL_KEYS:
        assert out[0][k].shape == (2,)
        np.testing.assert_array_equal(out[0][k].numpy(), out[1][k].numpy())


def test_train_pwg_cli_resumes_and_keeps_a_finished_run(tmp_path):
    """``bin/train_pwg``: four steps (device-resident crops, two per call,
    a checkpoint every two), auto-resume to six, a finished run invoked
    again leaves ``model.final`` as it is; the host-batch path too."""
    from vae_npvc_tpu_torch.bin import train_pwg

    root = sine_corpus(tmp_path)
    out = tmp_path / "exp"
    conf = tmp_path / "pwg.json"

    def run(**kw):
        cfg = _small_cfg(iters_per_checkpoint=2, iters_per_log=2,
                         steps_per_call=2, **kw)
        conf.write_text(json.dumps(cfg))
        train_pwg.main(["-c", str(conf), "--train_dir", str(root),
                        "--output_dir", str(out), "--device", "cpu"])

    run(max_iter=4)
    assert sorted(p.name for p in out.glob("iter.*")) == ["iter.2",
                                                          "iter.4"]
    log = (out / "train.log").read_text()
    assert "Device-resident corpus" in log and "Iter 4:" in log
    assert "adversarial" in log
    run(max_iter=6)
    log = (out / "train.log").read_text()
    assert "Resumed from" in log and "(iteration 4)" in log
    final = (out / "model.final").read_bytes()
    run(max_iter=6)
    assert (out / "model.final").read_bytes() == final
    assert "nothing to do" in (out / "train.log").read_text()
    shutil.rmtree(out)
    run(max_iter=2, device_resident=False)
    log = (out / "train.log").read_text()
    assert "Device-resident" not in log and "Iter 2:" in log
    assert (out / "model.final").exists()


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["--gradients"]:
        print(json.dumps(lockstep_gradients(), indent=1))
    else:
        write_pwg_golden()
        print(f"wrote {FIXTURES}/pwg_golden*")
