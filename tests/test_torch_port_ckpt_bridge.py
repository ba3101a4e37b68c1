"""The port's reference-PyTorch checkpoint bridge against the JAX package's.

``utils/torch_export.py`` and ``utils/torch_convert.py`` of the port and of
the JAX package on the same checkpoints: JAX-initialized parameters (EMA
banks set to seeded values, one left uninitialized) of the toy flat model
(EMA and plain codebooks, and a strided variant with two layers per encoder
stack), vqvae2 (GST top), vqvae2a (one shared EMA quantizer without
per-level speakers) and vqvae2b (GST top, EMA). The reference checkout is
not in the repository, so JAX's exporter and converter define the reference
format here. Held: the port's export equal to JAX's key for key and bit for
bit, the port's converted file byte-identical to JAX's and to the original
checkpoint (the round trip is the identity), a state dict without weight
norm, a format-1 checkpoint, the converted checkpoint in the port's
``Converter`` against JAX's ``Converter`` on JAX's converted file (1e-5,
fp32) and both CLIs with a ``.json`` config.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tests.test_model_vqvae2 import make_cfg
from tests.test_model_vqvae2ab import cfg_2a
from tests.test_torch_port_hier_model import _2b_gst_ema
from tests.test_wn_migration import _downgrade
from tests.toy_config import toy_config
from vae_npvc_tpu.models import build_model as jax_build_model
from vae_npvc_tpu.utils import torch_convert as jconv
from vae_npvc_tpu.utils import torch_export as jexp
from vae_npvc_tpu_torch.utils import msgpack_io
from vae_npvc_tpu_torch.utils import torch_convert as pconv
from vae_npvc_tpu_torch.utils import torch_export as pexp

torch.set_num_threads(1)
ITERATION = 1234


def _flat_strided():
    cfg = toy_config()
    cfg["encoder"] = dict(cfg["encoder"], downsample_scales=[2],
                          stack_layers=2, stacks=[2], dilation=True)
    cfg["decoder"] = dict(cfg["decoder"], upsample_scales=[2])
    return cfg


CASES = {
    "flat_ema": toy_config,
    "flat_plain": lambda: dict(toy_config(), use_ema=False),
    "flat_strided": _flat_strided,
    "vqvae2_gst": lambda: make_cfg(use_gst=True, use_ema=False),
    "vqvae2a_shared_ema": lambda: cfg_2a(use_gst=False, use_ema=True,
                                         use_quantizers=False,
                                         use_embeds=False),
    "vqvae2b_gst_ema": _2b_gst_ema,
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(
        tree))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """name -> (config, original msgpack path, payload): JAX-initialized
    parameters; each EMA bank seeded, the first one left uninitialized."""
    root = tmp_path_factory.mktemp("bridge")
    out = {}
    for i, (name, make) in enumerate(CASES.items()):
        cfg = make()
        x = jnp.zeros((2, 16, 10))
        y = jnp.zeros((2,), jnp.int32)
        variables = jax.jit(lambda k, x, y, m=jax_build_model(cfg): m.init(
            {"params": k, "vq": k}, x, y, train=True))(
                jax.random.PRNGKey(i), x, y)
        params = _np_tree(variables["params"])
        ema = {}
        if "ema" in variables:
            rng = np.random.default_rng(i)
            banks = _np_tree(variables["ema"])
            for j, bank in enumerate(sorted(banks)):
                s = banks[bank]
                banks[bank] = {
                    "initted": np.asarray(j > 0),
                    "emb": rng.normal(size=s["emb"].shape).astype(np.float32),
                    "emb_sum": rng.normal(size=s["emb_sum"].shape).astype(
                        np.float32),
                    "emb_elem": rng.uniform(
                        0.5, 2.0, size=s["emb_elem"].shape).astype(
                            np.float32)}
            ema = {"ema": banks}
        payload = {"model": params, "ema": ema, "optimizer": {},
                   "iteration": ITERATION, "wn_axis_format": 2}
        path = root / f"{name}.msgpack"
        path.write_bytes(serialization.msgpack_serialize(payload))
        out[name] = (cfg, path, payload)
    return out


def _load_pt(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_same_state(got, want):
    """Two ``{'model': state_dict, 'iteration'}`` files: the same keys,
    dtypes, shapes and bits."""
    assert got["iteration"] == want["iteration"]
    assert list(got["model"]) == list(want["model"])
    for k, w in want["model"].items():
        g = got["model"][k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


@pytest.mark.parametrize("name", list(CASES))
def test_export_and_convert_match_jax(checkpoints, tmp_path, name):
    """Export: the port's state dict is JAX's bit for bit (``emb_init``
    bool). Convert: the port's msgpack bytes are JAX's, and equal the
    original checkpoint's (the round trip is the identity)."""
    cfg, ck, _ = checkpoints[name]
    assert pexp.export_checkpoint_file(ck, cfg, tmp_path / "p.pt") \
        == ITERATION
    jexp.export_checkpoint_file(ck, cfg, tmp_path / "j.pt")
    got, want = _load_pt(tmp_path / "p.pt"), _load_pt(tmp_path / "j.pt")
    _assert_same_state(got, want)
    for k, v in got["model"].items():
        assert (v.dtype == torch.bool) == k.endswith(".emb_init"), k

    assert pconv.convert_checkpoint_file(tmp_path / "j.pt", cfg,
                                         tmp_path / "p.msgpack") == ITERATION
    jconv.convert_checkpoint_file(tmp_path / "j.pt", cfg,
                                  tmp_path / "j.msgpack")
    port_bytes = (tmp_path / "p.msgpack").read_bytes()
    assert port_bytes == (tmp_path / "j.msgpack").read_bytes()
    assert port_bytes == ck.read_bytes()


def _strip_weight_norm(state):
    """The state dict with every ``(weight_g, weight_v)`` pair replaced by
    its effective ``weight`` (torch's ``weight_norm`` over dim 0)."""
    out = {}
    for k, v in state.items():
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            g = state[k[:-1] + "g"]
            out[k[:-2]] = torch._weight_norm(v, g, 0)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("name", ["flat_strided", "vqvae2a_shared_ema"])
def test_weight_norm_free_state_dict(checkpoints, tmp_path, name):
    """A state dict without weight norm: ``weight`` collapsed, ``g``
    re-derived; bytes equal JAX's, and the effective weights equal the
    original's within fp32 rounding."""
    cfg, ck, payload = checkpoints[name]
    jexp.export_checkpoint_file(ck, cfg, tmp_path / "wn.pt")
    data = _load_pt(tmp_path / "wn.pt")
    data["model"] = _strip_weight_norm(data["model"])
    assert not any(k.endswith("weight_v") for k in data["model"])
    torch.save(data, tmp_path / "plain.pt")
    pconv.convert_checkpoint_file(tmp_path / "plain.pt", cfg,
                                  tmp_path / "p.msgpack")
    jconv.convert_checkpoint_file(tmp_path / "plain.pt", cfg,
                                  tmp_path / "j.msgpack")
    port_bytes = (tmp_path / "p.msgpack").read_bytes()
    assert port_bytes == (tmp_path / "j.msgpack").read_bytes()

    def effective(tree, path=""):
        """path -> the layer's effective kernel g * v / ||v||."""
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and "g" in v and "v" in v:
                vv = np.asarray(v["v"], np.float64)
                g = np.asarray(v["g"], np.float64)
                axes = (0, 2) if g.shape == (vv.shape[1],) else (0, 1)
                shape = [1, 1, 1]
                shape[1 if axes == (0, 2) else 2] = -1
                norm = np.sqrt(np.sum(vv * vv, axis=axes))
                out[path + k] = vv * (g / norm).reshape(shape)
            elif isinstance(v, dict):
                out.update(effective(v, f"{path}{k}/"))
        return out

    got = effective(msgpack_io.msgpack_restore(port_bytes)["model"])
    want = effective(payload["model"])
    assert got.keys() == want.keys() and got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_format1_checkpoint_export(checkpoints, tmp_path):
    """A format-1 checkpoint (g per output channel on the in-axis layers)
    is migrated against the model's own tree before export: the port's
    file equals JAX's export of the tree JAX's loader migrates, and every
    stride-1 ConvTranspose ``weight_g`` is per input channel. (JAX's
    exporter takes the stored tree as its own template and leaves such
    layers unmigrated.)"""
    from vae_npvc_tpu.utils.migrate import maybe_migrate_model

    cfg, _, payload = checkpoints["flat_ema"]
    old = dict(payload, model=_downgrade(payload["model"]))
    del old["wn_axis_format"]
    ck = tmp_path / "format1.msgpack"
    ck.write_bytes(serialization.msgpack_serialize(old))
    pexp.export_checkpoint_file(ck, cfg, tmp_path / "p.pt")
    migrated, changed = maybe_migrate_model(old, payload["model"])
    assert changed
    want = jexp.export_flat_vqvae(migrated, old["ema"]["ema"], cfg)
    got = _load_pt(tmp_path / "p.pt")["model"]
    assert list(got) == list(want)
    for k, w in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(w)), k
    conv_in = [k for k in got if k.endswith("conv_in.weight_g")]
    assert conv_in
    for k in conv_in:
        v = got[k[:-1] + "v"]
        assert got[k].shape == (v.shape[0], 1, 1), k


@pytest.mark.parametrize("name", ["flat_ema", "vqvae2b_gst_ema"])
def test_converted_checkpoint_in_converter(checkpoints, tmp_path, name):
    """The port's ``Converter`` on the port's converted file against JAX's
    ``Converter`` on JAX's: the same mel within 1e-5 (fp32)."""
    from vae_npvc_tpu.infer.convert import Converter as JaxConverter
    from vae_npvc_tpu_torch.infer.convert import Converter

    cfg, ck, _ = checkpoints[name]
    jexp.export_checkpoint_file(ck, cfg, tmp_path / "ref.pt")
    pconv.convert_checkpoint_file(tmp_path / "ref.pt", cfg,
                                  tmp_path / "p.msgpack")
    jconv.convert_checkpoint_file(tmp_path / "ref.pt", cfg,
                                  tmp_path / "j.msgpack")
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(2, 32, 10)).astype(np.float32)
    tgts = np.array([1, 2], np.int32)
    lengths = np.array([32, 20], np.int32)
    port = Converter(cfg, device="cpu")
    assert port.load_checkpoint(tmp_path / "p.msgpack") == ITERATION
    jconv_ = JaxConverter(cfg)
    jconv_.load_checkpoint(tmp_path / "j.msgpack")
    got = port.infer(feats, tgts, lengths)
    want = np.asarray(jconv_._infer_with_fallback(feats, tgts, lengths))
    assert got.shape == want.shape
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-5,
                                   rtol=1e-5)


def test_clis(checkpoints, tmp_path, capsys):
    """``bin/export_checkpoint`` and ``bin/convert_checkpoint`` with a
    ``.json`` config: JAX's state dict, then the original bytes back."""
    from vae_npvc_tpu_torch.bin import convert_checkpoint, export_checkpoint

    cfg, ck, _ = checkpoints["vqvae2_gst"]
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps(cfg))
    export_checkpoint.main([str(ck), "-c", str(conf), "-o",
                            str(tmp_path / "out.pt")])
    assert f"(iteration {ITERATION})" in capsys.readouterr().out
    jexp.export_checkpoint_file(ck, cfg, tmp_path / "j.pt")
    _assert_same_state(_load_pt(tmp_path / "out.pt"),
                       _load_pt(tmp_path / "j.pt"))
    convert_checkpoint.main([str(tmp_path / "out.pt"),
                             str(tmp_path / "back.msgpack"), "-c", str(conf)])
    assert f"(iteration {ITERATION})" in capsys.readouterr().out
    assert (tmp_path / "back.msgpack").read_bytes() == ck.read_bytes()
