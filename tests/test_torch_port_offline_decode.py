"""Offline conversion of the PyTorch port against the JAX package on the
CPU, and the committed JAX decode fixture.

The flat EMA VQ-VAE of ``tests/torch_port_fixtures/golden.msgpack`` (the
vqvae2 of ``hier_golden.msgpack`` in
``tests/test_torch_port_offline_hier.py``) converts the seeded decode dir
of ``vae_npvc_tpu_torch/utils/offline_fixture.py`` through the JAX
``Converter`` and the port's: ``decode`` over trials (named and integer
targets, fixed and automatic buckets) and the ``sweep`` to two targets,
uncompressed, within 1e-5 in fp32; compressed outputs within one
quantization step; JAX's ``ValueError`` for an unknown target; a
checkpoint of weight-norm axis format 1 loaded as JAX migrates it;
``bin/decode`` with a ``.json`` config; no run on the CPU when the GPU is
asked for; a sweep of a family that is not ported raises.

``tests/torch_port_fixtures/offline_golden.npz`` holds JAX's uncompressed
decode and sweep of both models; ``chip_smoke.py`` holds the card against
it. Regenerate with

    python -m tests.test_torch_port_offline_decode

(from the repo root, with JAX on the CPU at full matmul precision, as
``tests/conftest.py`` sets it).
"""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from vae_npvc_tpu_torch.utils import offline_fixture as fx

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_port_fixtures"
OFFLINE_GOLDEN = FIXTURES / "offline_golden.npz"

TOL = 1e-5


def feat_dim(cfg):
    return (cfg.get("encoder") or cfg["encoder.0"])["in_channels"][0]


def jax_converter(name, cfg=None):
    from vae_npvc_tpu.infer.convert import Converter

    cv = Converter(cfg or fx.offline_config(FIXTURES, name))
    cv.load_checkpoint(FIXTURES / f"{name}.msgpack")
    return cv


def port_converter(name, cfg=None):
    from vae_npvc_tpu_torch.infer.convert import Converter

    cv = Converter(cfg or fx.offline_config(FIXTURES, name), device="cpu")
    cv.load_checkpoint(FIXTURES / f"{name}.msgpack")
    return cv


def run(cv, mode, decode_dir, out_dir, compress=False):
    """``read_outputs`` of a converter's decode or sweep."""
    if mode == "decode":
        cv.decode(decode_dir, out_dir, compress=compress)
    else:
        cv.sweep(decode_dir, out_dir, fx.OFFLINE_TARGETS,
                 compress=compress)
    return fx.read_outputs(out_dir)


def jax_reference(model, root):
    """The JAX converter of ``model``, its decode dir and its uncompressed
    decode and sweep outputs."""
    name = fx.OFFLINE_MODELS[model]
    cv = jax_converter(name)
    d = fx.offline_decode_dir(root / "dd", feat_dim(cv.config))
    outs = {mode: run(cv, mode, d, root / f"jax_{mode}")
            for mode in ("decode", "sweep")}
    return {"cv": cv, "dir": d, "root": root, "outs": outs}


def make_offline_golden(root):
    arrays = {}
    for model in fx.OFFLINE_MODELS:
        ref = jax_reference(model, root / model)
        for mode, items in ref["outs"].items():
            arrays.update(fx.pack_outputs(f"{model}/{mode}", items))
    return arrays


def assert_same(got, want, tol=TOL):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=k)


def check_committed(model, ref):
    """JAX's outputs now equal the committed fixture's."""
    g = np.load(OFFLINE_GOLDEN)
    for mode, items in ref["outs"].items():
        assert_same(items, fx.unpack_outputs(g, f"{model}/{mode}"))
    assert OFFLINE_GOLDEN.stat().st_size < 200_000


def check_port_matches(model, ref, tmp_path, jax_auto=None):
    """The port's decode (named and integer targets, fixed and automatic
    buckets) and sweep against JAX's, uncompressed."""
    name = fx.OFFLINE_MODELS[model]
    cv = port_converter(name)
    for mode in ("decode", "sweep"):
        assert_same(run(cv, mode, ref["dir"], tmp_path / mode),
                    ref["outs"][mode])
    ints = fx.offline_decode_dir(tmp_path / "ints", feat_dim(cv.config),
                                 named=False)
    assert not (ints / "spk2spk_id").exists()
    assert_same(run(cv, "decode", ints, tmp_path / "ints_out"),
                ref["outs"]["decode"])
    auto = port_converter(name, dict(cv.config, decode_bucket_auto=True))
    got = run(auto, "decode", ref["dir"], tmp_path / "auto")
    # the automatic edges order the buckets differently: compare by key
    want = dict(jax_auto or ref["outs"]["decode"])
    assert sorted(k for k, _ in got) == sorted(want)
    for k, a in got:
        np.testing.assert_allclose(a, want[k], rtol=0, atol=TOL, err_msg=k)
    if jax_auto is not None:
        assert [k for k, _ in got] == [k for k, _ in jax_auto]


def check_compressed(model, ref, tmp_path):
    """Compressed outputs decompress within one quantization step of JAX's
    uncompressed ones."""
    cv = port_converter(fx.OFFLINE_MODELS[model])
    for mode in ("decode", "sweep"):
        got = run(cv, mode, ref["dir"], tmp_path / mode, compress=True)
        assert [k for k, _ in got] == [k for k, _ in ref["outs"][mode]]
        for (k, a), (_, b) in zip(got, ref["outs"][mode]):
            step = fx.compression_step(b)
            assert np.all(np.abs(a - b) <= step[None, :] + TOL), k


def check_unknown_target(model, ref, tmp_path):
    """An unknown target raises JAX's ValueError, with its text."""
    d = ref["dir"]
    trials = (d / "trials").read_text()
    (d / "trials").write_text(trials + "utt0 nobody\n")
    try:
        with pytest.raises(ValueError) as want:
            ref["cv"].decode(d, tmp_path / "jax", compress=False)
        cv = port_converter(fx.OFFLINE_MODELS[model])
        with pytest.raises(ValueError) as got:
            cv.decode(d, tmp_path / "port", compress=False)
    finally:
        (d / "trials").write_text(trials)
    assert str(got.value) == str(want.value)
    assert "'nobody'" in str(got.value) and "spk2spk_id" in str(got.value)


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    ref = jax_reference("flat", tmp_path_factory.mktemp("flat"))
    cv = jax_converter("golden", dict(ref["cv"].config,
                                      decode_bucket_auto=True))
    ref["auto"] = run(cv, "decode", ref["dir"], ref["root"] / "jax_auto")
    return ref


def test_flat_offline_fixture_matches_jax(flat):
    check_committed("flat", flat)


def test_flat_decode_and_sweep_match_jax(flat, tmp_path):
    check_port_matches("flat", flat, tmp_path, jax_auto=flat["auto"])


def test_flat_compressed_outputs_within_a_step(flat, tmp_path):
    check_compressed("flat", flat, tmp_path)


def test_flat_unknown_target_raises_jax_error(flat, tmp_path):
    check_unknown_target("flat", flat, tmp_path)


def test_auto_bucket_edges_match_jax():
    from vae_npvc_tpu.infer.convert import auto_bucket_edges as jax_edges
    from vae_npvc_tpu_torch.infer.convert import auto_bucket_edges

    rng = np.random.default_rng(11)
    sets = [rng.integers(1, 1000, size=n).tolist() for n in (1, 7, 60, 300)]
    sets.append((rng.lognormal(5.5, 0.6, size=200)).astype(int).tolist())
    sets.append([])
    for lengths in sets:
        for kw in ({}, {"max_buckets": 3, "align": 16, "min_len": 8}):
            assert auto_bucket_edges(lengths, **kw) \
                == jax_edges(lengths, **kw)


def test_dummy_rows_do_not_change_a_batch(flat):
    """The port drops JAX's padding of a bucket's last chunk with zero rows
    of length 1: a chunk alone equals the same chunk padded so, up to the
    rounding of batch-size-dependent convolution sums (3e-8 here)."""
    cv = port_converter("golden")
    rng = np.random.default_rng(5)
    feats = np.zeros((4, 16, 20), np.float32)
    feats[0, :11] = rng.normal(size=(11, 20))
    lengths = np.array([11, 1, 1, 1], np.int32)
    tgts = np.array([3, 0, 0, 0], np.int32)
    np.testing.assert_allclose(cv.infer(feats[:1], tgts[:1], lengths[:1]),
                               cv.infer(feats, tgts, lengths)[:1], rtol=0,
                               atol=1e-6)


def test_sweep_of_an_unported_family_raises(tmp_path):
    """Every family sweeps (the Gaussian VAE through its ``infer``, in
    ``tests/test_torch_port_gan_vae.py``); a model without ``infer`` is
    refused before anything is written."""
    cv = port_converter("golden")
    cv.model = torch.nn.Identity()
    d = fx.offline_decode_dir(tmp_path / "dd", feat_dim(cv.config))
    with pytest.raises(TypeError, match="has no infer"):
        cv.sweep(d, tmp_path / "out", fx.OFFLINE_TARGETS)
    assert not (tmp_path / "out" / "feats.ark").exists()


def _format1(src, dst, downgrade):
    """A copy of checkpoint ``src`` in weight-norm axis format 1."""
    from flax import serialization

    payload = serialization.msgpack_restore(Path(src).read_bytes())
    old = dict(payload, model=downgrade(payload["model"]))
    del old["wn_axis_format"]
    Path(dst).write_bytes(serialization.msgpack_serialize(old))
    return old


def test_format1_checkpoint_decodes_as_jax_migrates_it(flat, tmp_path):
    import jax
    from flax import serialization

    from tests.test_wn_migration import _downgrade, _n_in_axis
    from vae_npvc_tpu.utils.migrate import maybe_migrate_model
    from vae_npvc_tpu_torch.infer.convert import Converter
    from vae_npvc_tpu_torch.utils.bridge import to_jax_variables

    old = _format1(FIXTURES / "golden.msgpack", tmp_path / "old.msgpack",
                   _downgrade)
    assert _n_in_axis(old["model"]) == 0
    jcv = jax_converter("golden")
    jcv.load_checkpoint(tmp_path / "old.msgpack")
    want_tree, changed = maybe_migrate_model(
        old, serialization.to_state_dict(
            jax.device_get(jcv.variables["params"])))
    assert changed
    want = run(jcv, "decode", flat["dir"], tmp_path / "jax")
    cv = Converter(flat["cv"].config, device="cpu")
    cv.load_checkpoint(tmp_path / "old.msgpack")
    got_tree = to_jax_variables(cv.model.state_dict())["params"]
    flat_want = jax.tree_util.tree_leaves_with_path(want_tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    assert len(flat_want) == len(flat_got)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf))
    assert_same(run(cv, "decode", flat["dir"], tmp_path / "port"), want)
    # the migrated model converts as the format-2 checkpoint does
    assert_same(want, flat["outs"]["decode"], tol=1e-5)


def test_plain_codebook_of_another_size_is_adopted(tmp_path, caplog):
    """A plain-VQ checkpoint whose codebook size differs from the config's
    loads with the stored codebook (JAX ``_migrate_codebook``) and converts
    as a converter built at the stored size does."""
    from vae_npvc_tpu_torch.infer.convert import Converter
    from vae_npvc_tpu_torch.models import build_model
    from vae_npvc_tpu_torch.utils import msgpack_io
    from vae_npvc_tpu_torch.utils.bridge import to_jax_variables

    cfg = dict(fx.offline_config(FIXTURES, "golden"), use_ema=False,
               z_num=24)
    model = build_model(cfg, device="cpu").init_random(4)
    v = to_jax_variables(model.state_dict())
    (tmp_path / "ck").write_bytes(msgpack_io.msgpack_serialize(
        {"model": v["params"], "ema": {}, "iteration": 5,
         "wn_axis_format": 2}))
    rng = np.random.default_rng(8)
    feats = rng.normal(size=(2, 16, 20)).astype(np.float32)
    args = (feats, np.array([1, 2], np.int32), np.array([16, 9], np.int32))
    want = Converter(cfg, device="cpu")
    want.load_checkpoint(tmp_path / "ck")
    other = Converter(dict(cfg, z_num=32), device="cpu")
    with caplog.at_level(logging.WARNING, "vae_npvc_tpu_torch.convert"):
        assert other.load_checkpoint(tmp_path / "ck") == 5
    assert "codebook size mismatch" in caplog.text
    assert other.model.quantizer_embedding.shape == (24, 16)
    np.testing.assert_array_equal(other.infer(*args), want.infer(*args))


def test_trainer_reinitializes_moments_after_migration(tmp_path, caplog):
    from flax import serialization

    from tests.test_wn_migration import _downgrade
    from tests.toy_config import toy_config
    from vae_npvc_tpu_torch.train import build_trainer

    cfg = toy_config()
    rng = np.random.default_rng(3)
    batch = (rng.normal(size=(2, 16, 10)).astype(np.float32),
             np.array([0, 2], np.int32))
    tr = build_trainer(cfg, device="cpu")
    tr.init_state()
    tr.train_step(batch)
    tr.save_checkpoint(tmp_path / "new")
    _format1(tmp_path / "new", tmp_path / "old", _downgrade)
    assert serialization.msgpack_restore(
        (tmp_path / "old").read_bytes())["optimizer"]
    # a format-2 checkpoint restores its moments
    same = build_trainer(cfg, device="cpu")
    same.load_checkpoint(tmp_path / "new")
    assert float(same.opt_state.mu.abs().sum()) > 0
    other = build_trainer(cfg, device="cpu")
    with caplog.at_level(logging.WARNING, "vae_npvc_tpu_torch.train"):
        assert other.load_checkpoint(tmp_path / "old") == 1
    assert "optimizer moments re-initialized" in caplog.text
    assert int(other.opt_state.count) == 0
    assert float(other.opt_state.mu.abs().sum()) == 0.0
    assert float(other.opt_state.nu.abs().sum()) == 0.0
    # the same function: equal outputs from the migrated parameters
    x = torch.from_numpy(batch[0])
    y = torch.from_numpy(batch[1])
    with torch.no_grad():
        a = tr.model.infer(x, y)
        b = other.model.infer(x, y)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5)


def test_bin_decode_with_json_config(flat, tmp_path):
    from vae_npvc_tpu_torch.bin import decode

    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps(flat["cv"].config))
    args = ["-c", str(conf), "--checkpoint", str(FIXTURES / "golden.msgpack"),
            "--decode-dir", str(flat["dir"]), "--device", "cpu"]
    assert decode.main(args + ["--output-dir", str(tmp_path / "dec")]) == 8
    assert "Finished (8 utterances)" in (tmp_path / "dec/decode.log") \
        .read_text()
    got = fx.read_outputs(tmp_path / "dec")
    for (k, a), (_, b) in zip(got, flat["outs"]["decode"]):
        assert np.all(np.abs(a - b)
                      <= fx.compression_step(b)[None] + TOL), k
    assert decode.main(args + ["--output-dir", str(tmp_path / "sweep"),
                               "--all-targets", "spkB,spkC"]) == 16
    assert [k for k, _ in fx.read_outputs(tmp_path / "sweep")] \
        == [k for k, _ in flat["outs"]["sweep"]]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(dict(flat["cv"].config, decoder_type="x")))
    with pytest.raises(KeyError, match="decoder_type"):
        decode.main(["-c", str(bad)] + args[2:]
                    + ["--output-dir", str(tmp_path / "bad")])


def test_converter_asked_for_the_gpu_does_not_run_on_the_cpu(tmp_path):
    from vae_npvc_tpu_torch.bin import decode
    from vae_npvc_tpu_torch.infer.convert import Converter

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Converter(fx.offline_config(FIXTURES, "golden"), device="cuda")
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps(fx.offline_config(FIXTURES, "golden")))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        decode.main(["-c", str(conf), "--checkpoint",
                     str(FIXTURES / "golden.msgpack"), "--decode-dir",
                     str(tmp_path), "--output-dir", str(tmp_path / "o")])
    assert not (tmp_path / "o" / "feats.ark").exists()


if __name__ == "__main__":
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    with tempfile.TemporaryDirectory() as tmp:
        np.savez_compressed(OFFLINE_GOLDEN, **make_offline_golden(Path(tmp)))
