"""The port's native C++ ark loader (``vae_npvc_tpu_torch/native/
ark_loader.cc`` through ``data/native_loader.py``).

One counterpart of each case of ``tests/test_native_loader.py``: batches
against the port's ``kaldi_io`` reads, bit for bit, on FM, CM, CM2 and CM3
arks, the dataset's fast path against its Python path, and a double ark
left to Python. Besides: the same batches from the JAX package's
``NativeArkLoader`` on the same files, a failing compiler raising with its
output, and the library built under ``_build/``, named by the source's
hash, never beside the source.
"""

import struct

import numpy as np
import pytest

from vae_npvc_tpu_torch.data import kaldi_io, native_loader
from vae_npvc_tpu_torch.data.dataset import UttMelSpkDataset, batch_iterator
from vae_npvc_tpu_torch.data.native_loader import NativeArkLoader


@pytest.fixture(scope="module")
def toy_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    mats = {}
    with kaldi_io.ArkWriter(d / "f.ark", d / "feats.scp") as w, \
            open(d / "utt2num_frames", "w") as unf, \
            open(d / "utt2spk_id", "w") as u2s:
        for i in range(10):
            T = int(rng.integers(5, 40))
            m = rng.normal(size=(T, 6)).astype(np.float32)
            mats[f"u{i}"] = m
            w.write(f"u{i}", m)
            unf.write(f"u{i} {T}\n")
            u2s.write(f"u{i} {i % 3}\n")
    return d, mats


def _cm3_ark(d, T=20, D=4, seed=9):
    """A CM3 (global uint8) ark: not written by the writer, but readable
    from Kaldi-produced arks; bytes forged to the Kaldi layout."""
    raw = np.random.default_rng(seed).integers(0, 256, size=(T, D)) \
        .astype(np.uint8)
    with open(d / "c.ark", "wb") as f, open(d / "feats.scp", "w") as scp:
        f.write(b"u0 ")
        scp.write(f"u0 {d / 'c.ark'}:{f.tell()}\n")
        f.write(b"\x00BCM3 ")
        f.write(struct.pack("<ffii", -2.5, 7.25, T, D))
        f.write(raw.tobytes())


def _compressed_dir(d, method, n=6, seed=None):
    rng = np.random.default_rng(1 + method if seed is None else seed)
    with kaldi_io.ArkWriter(d / "c.ark", d / "feats.scp",
                            compression_method=method) as w:
        for i in range(n):
            T = int(rng.integers(9, 50))
            w.write(f"u{i}", (rng.normal(size=(T, 5)) * 10 - 3)
                    .astype(np.float32))


def _oracle(d):
    return {u: kaldi_io.load_mat(rx)
            for u, rx in kaldi_io.read_scp(d / "feats.scp").items()}


def _assert_windows(out, oracle, indices, starts, crop):
    for b, (i, s) in enumerate(zip(indices, starts)):
        m = oracle[f"u{i}"]
        take = max(min(crop, m.shape[0] - s), 0)
        np.testing.assert_array_equal(out[b, :take], m[s:s + take])
        assert np.all(out[b, take:] == 0.0)


def test_open_and_metadata(toy_dir):
    d, mats = toy_dir
    ld = NativeArkLoader.open(d / "feats.scp")
    assert ld is not None
    assert ld.num_utts == 10
    assert ld.feat_dim == 6
    assert ld.num_frames(3) == mats["u3"].shape[0]
    assert ld.num_frames(10) == -1
    ld.close()
    ld.close()


def test_batch_matches_python_reads(toy_dir):
    d, mats = toy_dir
    ld = NativeArkLoader.open(d / "feats.scp")
    indices, starts = np.array([0, 3, 7, 9]), np.array([0, 2, 0, 5])
    out = ld.load_batch(indices, starts, 16, nthreads=4)
    _assert_windows(out, mats, indices, starts, 16)
    # into a caller's buffer, and refusing one of the wrong shape
    buf = np.full((4, 16, 6), np.nan, np.float32)
    assert ld.load_batch(indices, starts, 16, out=buf) is buf
    np.testing.assert_array_equal(buf, out)
    with pytest.raises(ValueError, match="out must be"):
        ld.load_batch(indices, starts, 8, out=buf)


def test_pipeline_uses_native_and_matches_fallback(toy_dir):
    d, _ = toy_dir
    cfg = {"crop_length": 12}
    ds_native = UttMelSpkDataset(d, cfg, valid=True)
    assert ds_native.native is not None
    ds_py = UttMelSpkDataset(d, dict(cfg, use_native_loader=False),
                             valid=True)
    assert ds_py.native is None
    b_n = next(batch_iterator(ds_native, 10, shuffle=False, drop_last=False,
                              epochs=1, num_workers=2))
    b_p = next(batch_iterator(ds_py, 10, shuffle=False, drop_last=False,
                              epochs=1, num_workers=2))
    np.testing.assert_array_equal(b_n[0], b_p[0])
    np.testing.assert_array_equal(b_n[1], b_p[1])


@pytest.mark.parametrize("method", [1, 2])
def test_compressed_bitexact_vs_python(tmp_path, method):
    """CM (per-column piecewise uint8) and CM2 (global uint16) windows
    decode bit for bit as the port's kaldi_io decodes them."""
    _compressed_dir(tmp_path, method)
    ld = NativeArkLoader.open(tmp_path / "feats.scp")
    assert ld is not None
    indices, starts = np.array([0, 2, 5, 3]), np.array([0, 3, 1, 40])
    out = ld.load_batch(indices, starts, 16, nthreads=4)
    _assert_windows(out, _oracle(tmp_path), indices, starts, 16)


def test_cm3_bitexact(tmp_path):
    _cm3_ark(tmp_path)
    ld = NativeArkLoader.open(tmp_path / "feats.scp")
    assert ld is not None
    out = ld.load_batch(np.array([0]), np.array([2]), 8)
    np.testing.assert_array_equal(out[0], _oracle(tmp_path)["u0"][2:10])


def test_compressed_pipeline_matches_fallback(tmp_path):
    """The fast path engages on a compression_method=1 dir (Kaldi's
    make_fbank default) and matches the Python loader exactly, shuffled
    with random crops."""
    rng = np.random.default_rng(3)
    with kaldi_io.ArkWriter(tmp_path / "c.ark", tmp_path / "feats.scp",
                            compression_method=1) as w, \
            open(tmp_path / "utt2num_frames", "w") as unf, \
            open(tmp_path / "utt2spk_id", "w") as u2s:
        for i in range(8):
            T = int(rng.integers(12, 40))
            w.write(f"u{i}", rng.normal(size=(T, 6)).astype(np.float32))
            unf.write(f"u{i} {T}\n")
            u2s.write(f"u{i} {i % 3}\n")
    cfg = {"crop_length": 12}
    ds_native = UttMelSpkDataset(tmp_path, cfg)
    assert ds_native.native is not None
    ds_py = UttMelSpkDataset(tmp_path, dict(cfg, use_native_loader=False))
    it_n = batch_iterator(ds_native, 4, shuffle=True, drop_last=True, seed=5,
                          num_workers=2)
    it_p = batch_iterator(ds_py, 4, shuffle=True, drop_last=True, seed=5,
                          num_workers=2)
    for _ in range(5):
        b_n, b_p = next(it_n), next(it_p)
        np.testing.assert_array_equal(b_n[0], b_p[0])
        np.testing.assert_array_equal(b_n[1], b_p[1])


def test_double_ark_falls_back(tmp_path):
    with kaldi_io.ArkWriter(tmp_path / "d.ark", tmp_path / "feats.scp") as w:
        w.write("u0", np.random.default_rng(0).normal(size=(10, 4)))
    assert NativeArkLoader.open(tmp_path / "feats.scp") is None
    (tmp_path / "utt2num_frames").write_text("u0 10\n")
    (tmp_path / "utt2spk_id").write_text("u0 0\n")
    ds = UttMelSpkDataset(tmp_path, {"crop_length": 8}, valid=True)
    assert ds.native is None
    feats, _ = next(batch_iterator(ds, 1, shuffle=False, drop_last=False,
                                   epochs=1, num_workers=0))
    np.testing.assert_array_equal(feats[0], _oracle(tmp_path)["u0"][:8]
                                  .astype(np.float32))


@pytest.mark.parametrize("fmt", ["FM", "CM", "CM2", "CM3"])
def test_batches_equal_the_jax_native_loader(tmp_path, fmt):
    from vae_npvc_tpu.data.native_loader import \
        NativeArkLoader as JaxNativeArkLoader

    if fmt == "CM3":
        _cm3_ark(tmp_path, T=40, D=5, seed=11)
        indices, starts = np.array([0, 0, 0]), np.array([0, 17, 38])
    else:
        _compressed_dir(tmp_path, {"FM": None, "CM": 1, "CM2": 2}[fmt],
                        seed=21)
        indices, starts = np.array([5, 0, 2, 3, 1]), np.array([2, 0, 7, 45,
                                                               1])
    ours = NativeArkLoader.open(tmp_path / "feats.scp")
    theirs = JaxNativeArkLoader.open(tmp_path / "feats.scp")
    assert ours is not None and theirs is not None
    assert (ours.num_utts, ours.feat_dim) == (theirs.num_utts,
                                              theirs.feat_dim)
    a = ours.load_batch(indices, starts, 16, nthreads=3)
    b = theirs.load_batch(indices, starts, 16, nthreads=3)
    np.testing.assert_array_equal(a, b)
    _assert_windows(a, _oracle(tmp_path), indices, starts, 16)


def test_failing_compiler_raises_with_its_output(tmp_path):
    cxx = tmp_path / "broken-g++"
    cxx.write_text("#!/bin/sh\necho 'broken-g++: no toolchain here' >&2\n"
                   "exit 3\n")
    cxx.chmod(0o755)
    with pytest.raises(RuntimeError, match="no toolchain here"):
        native_loader.build(tmp_path / "build", cxx=str(cxx))
    with pytest.raises(RuntimeError, match="cannot run"):
        native_loader.build(tmp_path / "build",
                            cxx=str(tmp_path / "missing-g++"))
    assert not list((tmp_path / "build").glob("*"))


def test_library_lands_in_the_build_dir(tmp_path):
    path = native_loader.build(tmp_path / "build")
    assert path.parent == tmp_path / "build"
    assert path == native_loader.library_path(tmp_path / "build")
    assert path.name.startswith("ark_loader-") and path.suffix == ".so"
    assert native_loader.build(tmp_path / "build") == path   # reused
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) \
        == [path.name]
    assert not list(native_loader.SOURCE.parent.glob("*.so"))
