"""Serving bundles of the PyTorch port against the JAX package's, on the
CPU.

The golden checkpoints of ``tests/torch_port_fixtures`` (the flat EMA
VQ-VAE ``golden.msgpack`` and the vqvae2 ``hier_golden.msgpack``) are
exported by both packages at two 16-frame buckets and B = 2 (JAX with
``platforms=("cpu",)``, the port with ``device="cpu"``):

- ``params.msgpack`` has JAX's bytes, fp32 and int8, and ``bundle.json``
  JAX's keys and values but ``platforms`` -> ``device``, ``jax_version`` ->
  ``torch_version`` and the added ``exporter``;
- the port's bundle equals the port's ``Converter.infer`` bit for bit and
  JAX's ``ServingBundle.convert`` within ``TOL`` of the peak (fp32 on two
  frameworks), flat and vqvae2 with two targets per row;
- bucketing, trimming, guards, speaker names and error texts are JAX's;
- a program holds no weight, holds the two registered kernel operators and
  no ``aten.argmin``, and loads with the model code blocked from import;
- a JAX bundle is refused; ``bin/bundle_check`` passes on the port's
  decode arks and fails on arks moved by 10 compression steps; the engine
  serves ``/convert`` from a bundle.
"""

import io
import json
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from vae_npvc_tpu_torch.utils import offline_fixture as fx

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_port_fixtures"
TOL = 1e-5           # of the peak: the same weights in fp32, two frameworks
BUCKETS = [16, 32]
B = 2
SPK = {"A": 0, "B": 1, "C": 2}


def _config(name):
    return fx.offline_config(FIXTURES, name)


def _export_both(root, name, quantize=None, n_targets=1, buckets=BUCKETS):
    """``(jax dir, jax meta, port dir, port meta)`` of one checkpoint."""
    from vae_npvc_tpu.infer import export_serving as jax_export
    from vae_npvc_tpu_torch.infer import export_serving as port_export

    cfg, ck = _config(name), FIXTURES / f"{name}.msgpack"
    kw = dict(buckets=buckets, batch_size=B, n_targets=n_targets,
              spk2spk_id=SPK, quantize=quantize, quantize_min_size=64)
    tag = f"{name}_{quantize or 'fp32'}"
    jmeta = jax_export.export_bundle(cfg, ck, root / f"jax_{tag}",
                                     platforms=("cpu",), **kw)
    pmeta = port_export.export_bundle(cfg, ck, root / f"port_{tag}",
                                      device="cpu", **kw)
    return root / f"jax_{tag}", jmeta, root / f"port_{tag}", pmeta


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    return _export_both(tmp_path_factory.mktemp("export_flat"), "golden")


def _port_bundle(path):
    from vae_npvc_tpu_torch.infer.export_serving import ServingBundle

    return ServingBundle(path, device="cpu")


def _port_converter(name):
    from vae_npvc_tpu_torch.infer.convert import Converter

    cv = Converter(_config(name), device="cpu")
    cv.load_checkpoint(FIXTURES / f"{name}.msgpack")
    return cv


def _items(dim, lengths, targets, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(T, dim)).astype(np.float32), t)
            for T, t in zip(lengths, targets)]


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_params_and_metadata_equal_jax(flat, tmp_path, quantize):
    if quantize is None:
        jdir, jmeta, pdir, pmeta = flat
    else:
        jdir, jmeta, pdir, pmeta = _export_both(tmp_path, "golden",
                                                quantize, buckets=[16])
    assert (pdir / "params.msgpack").read_bytes() \
        == (jdir / "params.msgpack").read_bytes()
    import torch as _torch

    want = dict(jmeta, device="cpu", torch_version=_torch.__version__,
                exporter="torch.export")
    del want["platforms"], want["jax_version"]
    assert pmeta == want
    assert json.loads((pdir / "bundle.json").read_text()) == pmeta
    assert sorted(p.name for p in pdir.glob("bucket_*")) == [
        f"bucket_{t:05d}.pt2" for t in pmeta["buckets"]]


def test_bundle_matches_live_converter(flat):
    """The deserialized program == the port's ``Converter.infer`` (the call
    ``Converter.decode`` batches through), bit for bit."""
    bundle = _port_bundle(flat[2])
    cv = _port_converter("golden")
    rng = np.random.default_rng(1)
    feats = np.zeros((2, 16, 20), np.float32)
    feats[0, :10] = rng.normal(size=(10, 20))
    feats[1, :16] = rng.normal(size=(16, 20))
    tgts = np.array([[1], [2]], np.int32)
    lengths = np.array([10, 16], np.int32)
    np.testing.assert_array_equal(bundle.infer(feats, tgts, lengths),
                                  cv.infer(feats, tgts, lengths))


def test_convert_matches_jax_and_trims(flat):
    from vae_npvc_tpu.infer.export_serving import ServingBundle

    items = _items(20, [10, 30, 16, 5, 27], [1, "C", [2], "A", 3], 2)
    got = _port_bundle(flat[2]).convert(items)
    want = ServingBundle(flat[0]).convert(items)
    assert [o.shape[0] for o in got] == [10, 30, 16, 5, 27]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=TOL * np.abs(w).max(), rtol=0)


def test_hierarchy_two_targets_matches_jax(tmp_path):
    from vae_npvc_tpu.infer.export_serving import ServingBundle

    jdir, _, pdir, meta = _export_both(tmp_path, "hier_golden", n_targets=2,
                                       buckets=[16])
    assert meta["n_targets"] == 2 and meta["n_encoder_levels"] == 3
    items = _items(10, [16, 5, 12], [[1, 3], 2, ["B", "C"]], 3)
    got = _port_bundle(pdir).convert(items)
    want = ServingBundle(jdir).convert(items)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=TOL * np.abs(w).max(), rtol=0)


def test_guards_and_name_resolution(flat):
    """JAX's ``test_guards_and_name_resolution`` cases, texts and all."""
    from vae_npvc_tpu.infer.export_serving import ServingBundle

    for bundle in (_port_bundle(flat[2]), ServingBundle(flat[0])):
        assert bundle.resolve_target("B") == 1
        assert bundle.resolve_target(2) == 2
        assert bundle.resolve_target("2") == 2
        with pytest.raises(KeyError):
            bundle.resolve_target("nope")
        with pytest.raises(ValueError, match="largest exported bucket 32"):
            bundle.pick_bucket(33)
        assert [bundle.pick_bucket(t) for t in (1, 16, 17, 32)] \
            == [16, 16, 32, 32]
        with pytest.raises(ValueError, match="targets per row"):
            bundle.infer(np.zeros((1, 8, 20), np.float32),
                         np.zeros((1, 2), np.int32), np.array([8]))
        with pytest.raises(ValueError, match="feat dim 9 != exported 20"):
            bundle.infer(np.zeros((1, 8, 9), np.float32),
                         np.zeros((1,), np.int32), np.array([8]))
        with pytest.raises(ValueError, match="batch 3 > exported batch 2"):
            bundle.infer(np.zeros((3, 8, 20), np.float32),
                         np.zeros((3,), np.int32), np.array([8] * 3))
    from vae_npvc_tpu_torch.infer.export_serving import export_bundle

    with pytest.raises(ValueError, match="quantize mode"):
        export_bundle(_config("golden"), FIXTURES / "golden.msgpack",
                      flat[2].parent / "bad", quantize="int4", device="cpu")


def test_programs_hold_no_weight_and_the_kernel_operators(flat):
    variables = _port_bundle(flat[2]).variables
    largest = sorted(variables.values(), key=lambda v: -v.numel())[:3]
    for path in sorted(flat[2].glob("bucket_*.pt2")):
        data = path.read_bytes()
        assert not any(v.numpy().tobytes() in data for v in largest)
        program = torch.export.load(str(path))
        assert not program.state_dict and program.example_inputs is None
        assert all(c.numel() <= 1 for c in program.constants.values())
        ops = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
        assert {"vae_npvc_torch.nearest_code.default",
                "vae_npvc_torch.group_norm.default"} <= ops
        assert not any("argmin" in op for op in ops)


_BLOCKED_LOAD = r"""
import importlib.abc, sys
import numpy as np
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "flax", "yaml", "vae_npvc_tpu") or name in (
                "vae_npvc_tpu_torch.models",
                "vae_npvc_tpu_torch.infer.convert",
                "vae_npvc_tpu_torch.train"):
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
from vae_npvc_tpu_torch.infer.export_serving import ServingBundle
b = ServingBundle(sys.argv[1], device="cpu")
(out,) = b.convert([(np.ones((12, 20), np.float32), "B")])
assert out.shape == (12, 20) and np.isfinite(out).all()
print(sorted(m for m in sys.modules if m.startswith("vae_npvc_tpu_torch.")))
"""


def test_loading_needs_no_model_code(flat):
    out = subprocess.run([sys.executable, "-c", _BLOCKED_LOAD, str(flat[2])],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "vae_npvc_tpu_torch.models" not in out.stdout


def test_jax_bundle_is_refused_but_its_params_read(flat):
    from vae_npvc_tpu_torch.infer.export_serving import read_params

    with pytest.raises(ValueError, match="bin.export_serving"):
        _port_bundle(flat[0])
    jax_params = read_params(flat[0] / "params.msgpack")
    port = _port_bundle(flat[2]).variables
    assert list(jax_params) == list(port)
    for k, v in port.items():
        assert torch.equal(jax_params[k], v), k


def test_bundle_on_another_device_type_is_moved_or_refused(flat, tmp_path,
                                                           monkeypatch):
    import shutil

    from vae_npvc_tpu_torch.infer import export_serving

    moved = tmp_path / "meta_bundle"
    shutil.copytree(flat[2], moved)
    meta = json.loads((moved / "bundle.json").read_text())
    (moved / "bundle.json").write_text(json.dumps(dict(meta, device="cuda")))
    calls = []

    def fake_move(program, device):
        calls.append(device)
        return program
    monkeypatch.setattr(export_serving, "_move_pass", lambda: fake_move)
    bundle = _port_bundle(moved)
    bundle.convert(_items(20, [12], [1], 5))
    assert calls == [torch.device("cpu")]
    monkeypatch.setattr(export_serving, "_move_pass", lambda: None)
    with pytest.raises(ValueError, match="exported on 'cuda' cannot be "
                                         "served on 'cpu'"):
        _port_bundle(moved)


def _decode(tmp_path, trials):
    """A decode dir (seeded utterances u0..) and the port's compressed
    decode of ``trials`` with the flat golden model."""
    from vae_npvc_tpu_torch.data import kaldi_io

    dec = tmp_path / "dec"
    dec.mkdir()
    rng = np.random.default_rng(11)
    with kaldi_io.ArkWriter(dec / "f.ark", dec / "feats.scp") as w:
        for i, T in enumerate((20, 9, 31)):
            w.write(f"u{i}", rng.normal(size=(T, 20)).astype(np.float32))
    (dec / "trials").write_text(trials)
    out = tmp_path / "off"
    _port_converter("golden").decode(dec, out)
    return dec, out


def test_bundle_check_passes_and_catches_a_shift(flat, tmp_path, capsys):
    from vae_npvc_tpu_torch.bin.bundle_check import main as check_main
    from vae_npvc_tpu_torch.data import kaldi_io

    # a repeated source utterance: the scp's last line wins
    dec, out = _decode(tmp_path, "u0 1\nu0 2\nu1 0\nu2 2\n")
    args = ["--bundle", str(flat[2]), "--decode_dir", str(dec),
            "--device", "cpu"]
    check_main(args + ["--offline_scp", str(out / "feats.scp")])
    assert "bundle_check PASS: 3 utts" in capsys.readouterr().out
    # every element moved by 10 of its column's compression steps
    shifted = tmp_path / "shifted"
    shifted.mkdir()
    offline = kaldi_io.load_dict_data(out / "feats.scp")
    with kaldi_io.write_helper(
            f"ark,scp:{shifted}/f.ark,{shifted}/feats.scp",
            compression_method=1) as wf:
        for utt, rx in offline.items():
            ref = kaldi_io.load_mat(rx)
            p0, p25, p75, p100 = np.percentile(ref, [0, 25, 75, 100], axis=0)
            step = np.maximum.reduce([(p25 - p0) / 64.0, (p75 - p25) / 128.0,
                                      (p100 - p75) / 63.0])
            wf[utt] = ref + 10 * 1.5 * step
    with pytest.raises(SystemExit) as e:
        check_main(args + ["--offline_scp", str(shifted / "feats.scp")])
    assert e.value.code == 1
    assert "bundle_check FAIL" in capsys.readouterr().out


def test_engine_serves_convert_from_a_bundle(flat):
    from scipy.io import wavfile

    from vae_npvc_tpu_torch.bin.serve import serve
    from vae_npvc_tpu_torch.serve import ConversionEngine

    stats = np.zeros((2, 21), np.float64)
    stats[0, -1] = stats[1, -1] = 1000
    stats[1, :-1] = 1000
    feature = {"fs": 8000, "n_fft": 128, "n_shift": 32, "n_mels": 20,
               "fmin": 0.0, "fmax": None, "win_length": None}
    eng = ConversionEngine(None, None, stats, bundle=flat[2],
                           feature=feature, vocoder="none", device="cpu")
    assert eng.speakers() == SPK and eng.bucket_frames == 16
    assert eng.batcher.max_batch == B
    with pytest.raises(KeyError, match="out of range"):
        eng.resolve_target(4)
    eng.warmup(1)
    httpd = serve(eng, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        wav = (np.random.default_rng(3).normal(size=(600,)) * 0.1)
        buf = io.BytesIO()
        wavfile.write(buf, 8000, (wav * 32767).astype(np.int16))
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/convert"
            "?target=C&mel=1", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            mel = np.load(io.BytesIO(r.read()))
        assert mel.shape == (1 + 600 // 32, 20) and np.isfinite(mel).all()
        assert eng.stats_snapshot()["requests"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.close()
