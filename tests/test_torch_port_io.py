"""PyTorch port I/O and front-end vs the JAX package on the CPU.

The msgpack checkpoint codec against flax, CMVN against the JAX package's
stats arks, the log-mel front-end (1e-4 absolute) and Griffin-Lim with
JAX's own initial phase (1e-3 of the waveform's peak), plus the port's
import isolation: no module of the port, and not ``chip_smoke.py``, may
import JAX, flax, msgpack or the JAX package, nor PyYAML when it is
imported (the GPU host has none).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_npvc_tpu.data import cmvn as jax_cmvn
from vae_npvc_tpu.data import features as jax_features
from vae_npvc_tpu_torch.data import cmvn, features, kaldi_io
from vae_npvc_tpu_torch.utils import msgpack_io

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _leaves(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return [np.asarray(x) for x in leaves], treedef


@pytest.fixture(scope="module")
def flax_checkpoint(tmp_path_factory):
    """A checkpoint the JAX Trainer wrote after one step (with optimizer
    state)."""
    from tests.toy_config import toy_config
    from vae_npvc_tpu.train.trainer import Trainer

    tr = Trainer(toy_config())
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(2, 32, 10)).astype(np.float32),
             np.zeros((2,), np.int32))
    tr.init_state(batch)
    tr.train_step(batch)
    path = tmp_path_factory.mktemp("ckpt") / "m.ckpt"
    tr.save_checkpoint(path)
    return path


def test_msgpack_reads_flax_checkpoint(flax_checkpoint):
    from flax import serialization

    raw = flax_checkpoint.read_bytes()
    ref = serialization.msgpack_restore(raw)
    got = msgpack_io.msgpack_restore(raw)
    la, ta = _leaves(ref)
    lb, tb = _leaves(got)
    assert ta == tb
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got["wn_axis_format"] == 2 and got["optimizer"]
    # the writer reproduces flax's bytes exactly
    assert msgpack_io.msgpack_serialize(got) == raw


def test_msgpack_written_tree_restores_in_flax():
    from flax import serialization

    tree = {"model": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                      "flag": np.array(True), "i": np.int32(-5)},
            "ema": {}, "iteration": 70000, "neg": -40000, "f": 0.25,
            "s": "x" * 40, "none": None, "b": b"\x00\x01",
            "list": [1, 2.5, "a"], "big": np.zeros((300,), np.float64)}
    back = serialization.msgpack_restore(
        msgpack_io.msgpack_serialize(tree))
    np.testing.assert_array_equal(back["model"]["w"], tree["model"]["w"])
    assert back["model"]["flag"] == np.array(True)
    assert back["model"]["i"] == -5 and back["model"]["i"].dtype == np.int32
    assert (back["iteration"], back["neg"], back["f"], back["s"],
            back["none"], back["b"], back["list"]) == (
        70000, -40000, 0.25, "x" * 40, None, b"\x00\x01", [1, 2.5, "a"])
    np.testing.assert_array_equal(back["big"], tree["big"])
    assert serialization.msgpack_serialize(tree) \
        == msgpack_io.msgpack_serialize(tree)


def test_cmvn_reads_jax_stats_and_applies(tmp_path):
    rng = np.random.default_rng(3)
    stats = np.zeros((2, 6), np.float64)
    stats[0, :-1] = rng.normal(size=5) * 100
    stats[0, -1] = 100
    stats[1, :-1] = stats[0, :-1] ** 2 / 100 + rng.uniform(1, 5, 5) * 100
    path = tmp_path / "cmvn.ark"
    jax_cmvn.write_stats(path, stats)
    got = cmvn.read_stats(path)
    np.testing.assert_array_equal(got, stats)
    np.testing.assert_array_equal(got, jax_cmvn.read_stats(path))
    feat = rng.normal(size=(7, 5)).astype(np.float32)
    for reverse in (False, True):
        np.testing.assert_array_equal(
            cmvn.apply(feat, got, reverse=reverse),
            jax_cmvn.apply(feat, stats, reverse=reverse))
    spk = tmp_path / "spk2spk_id"
    spk.write_text("A 0\nB 1\n\n")
    assert kaldi_io.load_dict_data(spk) == {"A": "0", "B": "1"}


FEAT = {"fs": 8000, "n_fft": 128, "n_shift": 32, "n_mels": 10,
        "fmin": 0.0, "fmax": None}


def test_logmelspectrogram_matches_jax():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 3001)) * 0.1).astype(np.float32)
    ref = np.asarray(jax_features.logmelspectrogram(jnp.asarray(x), **FEAT))
    got = features.logmelspectrogram(torch.from_numpy(x), **FEAT).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_array_equal(
        features.mel_filterbank(8000, 128, 10, 0.0, None),
        jax_features.mel_filterbank(8000, 128, 10, 0.0, None))


def test_griffin_lim_matches_jax_with_its_phase():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 2000)) * 0.1).astype(np.float32)
    log_mel = np.array(jax_features.logmelspectrogram(jnp.asarray(x),
                                                      **FEAT))
    ref = np.asarray(jax_features.griffin_lim(jnp.asarray(log_mel), **FEAT,
                                              n_iter=4, seed=3))
    # JAX's initial phase (features.py griffin_lim: PRNGKey(seed) uniform)
    phase = np.array(jax.random.uniform(
        jax.random.PRNGKey(3), log_mel.shape[:2] + (65,),
        minval=-np.pi, maxval=np.pi))
    got = features.griffin_lim(torch.from_numpy(log_mel), **FEAT, n_iter=4,
                               phase=torch.from_numpy(phase)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-3 * np.abs(ref).max())


def test_chip_smoke_flagship_config_matches_recipe_yaml():
    import yaml

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    with open(ROOT / "egs/vcc20/vae1/conf/train_vqvae.yaml") as f:
        y = yaml.safe_load(f)
    for k, v in chip_smoke.FLAGSHIP.items():
        assert y[k] == v, k
    for k in ("y_dim", "y_num", "z_dim", "z_num", "use_ema", "beta", "mu",
              "jitter_p", "encoder", "decoder"):
        assert k in chip_smoke.FLAGSHIP


def test_chip_smoke_aishell3_configs_match_recipe_yamls():
    """The ``bnf`` phase's VQ-VAE (model keys, and training keys but the
    batch it cuts) and conv synthesizer (every key) are the AISHELL-3
    recipe's."""
    import yaml

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    conf = ROOT / "egs/aishell3/vc2/conf"
    with open(conf / "train_vqvae.yaml") as f:
        y = yaml.safe_load(f)
    for k, v in chip_smoke.AISHELL.items():
        assert y[k] == v, k
    for k in ("y_dim", "y_num", "z_dim", "z_num", "use_ema", "beta", "mu",
              "jitter_p", "encoder", "decoder"):
        assert k in chip_smoke.AISHELL
    assert {k for k, v in chip_smoke.AISHELL_TRAIN.items()
            if y[k] != v} == {"batch_size"}
    with open(conf / "train_token_tts.yaml") as f:
        assert chip_smoke.TOKEN_TTS == yaml.safe_load(f)


def test_chip_smoke_vocoder_config_is_the_recipe_yaml():
    import yaml

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    with open(ROOT / "egs/vcc20/vae1/conf/train_jpwg.yaml") as f:
        y = yaml.safe_load(f)
    assert chip_smoke.PWG == y
    # voc_train moves only the adversary's start step
    assert {k: v for k, v in chip_smoke.VOC_TRAIN.items()
            if y[k] != v} == {"discriminator_train_start_steps": 8}


_BLOCKED_IMPORTS = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "vae_npvc_tpu",
           "yaml")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
import vae_npvc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    vae_npvc_tpu_torch.__path__, "vae_npvc_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
vocoder = {"vae_npvc_tpu_torch." + n for n in (
    "models.pwg", "ops.stft_loss", "train.pwg", "data.wav_mel",
    "bin.train_pwg", "infer.vocoder")}
assert vocoder <= set(names), vocoder - set(names)
print(len(names))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20   # every module was imported


def test_attn_blocks_tool_patches_the_forward_launch():
    """``tools/torch_attn_blocks.py`` times the attention forward with its
    64-query launch replaced; the line it replaces must stay in the
    source."""
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_attn_blocks

    src = (ROOT / "vae_npvc_tpu_torch/csrc/attention.cu").read_text()
    assert src.count(torch_attn_blocks.LAUNCH) == 1
    for warps in (2, 1):
        patched = src.replace(torch_attn_blocks.LAUNCH,
                              torch_attn_blocks.FIXED.format(warps=warps))
        assert f"forward_rows<DP, {warps}, 1, BF16>" in patched
