"""The PyTorch port's offline I/O and front-end CLIs against the JAX
package on the CPU.

The Kaldi writer (``_write_matrix`` in every mode, ``ArkWriter``,
``write_helper``) gives JAX's bytes; ranged and compressed reads,
``read_wav_scp_entry`` and the CMVN stats match JAX's; the CLIs
``make_spk_id``, ``apply_cmvn`` (compute, apply, reverse), ``make_fbank``
(log-mel within 1e-4, a 16 kHz wav resampled, the ``--pitch``
columns equal) and ``convert_fbank``
(Griffin-Lim with JAX's initial phase, within 1e-3 of the peak) give JAX's
files; asked for the GPU on a host without one, ``make_fbank`` and
``convert_fbank`` raise and write nothing.
"""

import io
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from vae_npvc_tpu.data import cmvn as jax_cmvn
from vae_npvc_tpu.data import kaldi_io as jax_kio
from vae_npvc_tpu_torch.data import cmvn, kaldi_io

torch.set_num_threads(1)

FEAT = {"fs": 8000, "n_fft": 128, "n_shift": 32, "n_mels": 10,
        "fmin": 0.0, "fmax": None}


def _matrix(rows, cols=6, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(rows, cols)) * rng.uniform(0.1, 10, size=cols)
    return m.astype(dtype)


def _bytes(write, mat, method):
    f = io.BytesIO()
    write(f, mat, method)
    return f.getvalue()


@pytest.mark.parametrize("rows,method,dtype", [
    (20, None, np.float32), (20, 0, np.float32), (20, None, np.float64),
    (20, 1, np.float32), (8, 1, np.float32), (20, 2, np.float32),
    (1, 1, np.float32), (33, 1, np.float64)])
def test_write_matrix_bytes_equal_jax(rows, method, dtype):
    mat = _matrix(rows, dtype=dtype)
    mat[3 % rows, 2] = mat[0, 2]          # repeated values in a column
    got = _bytes(kaldi_io._write_matrix, mat, method)
    assert got == _bytes(jax_kio._write_matrix, mat, method)
    token = got[2:5]
    assert token == {None: b"FM " if dtype == np.float32 else b"DM ",
                     0: b"FM ", 2: b"CM2"}.get(
        method, b"CM " if rows > 8 else b"CM2")


def test_ark_writer_and_ranged_reads_match_jax(tmp_path):
    mats = {"a": _matrix(30, seed=1), "b": _matrix(5, seed=2),
            "c": _matrix(12, seed=3)}
    for method in (None, 1, 2):
        arks = []
        for pkg, kio in (("port", kaldi_io), ("jax", jax_kio)):
            d = tmp_path / f"{pkg}{method}"
            d.mkdir()
            with kio.write_helper(f"ark,scp:{d}/x.ark,{d}/x.scp",
                                  compression_method=method) as w:
                for k, m in mats.items():
                    w[k] = m
            arks.append((d / "x.ark").read_bytes())
            assert list(kio.read_scp(d / "x.scp")) == list(mats)
        assert arks[0] == arks[1]
        scp = kaldi_io.read_scp(tmp_path / f"port{method}" / "x.scp")
        for k, rx in scp.items():
            for rng in ("", "[2:4]", "[1:3,2:4]", "[:,1:2]"):
                if k == "b" and rng == "[2:4]":
                    rng = "[0:4]"
                got, want = kaldi_io.load_mat(rx + rng), \
                    jax_kio.load_mat(rx + rng)
                np.testing.assert_array_equal(got, want)
                assert kaldi_io.matrix_header(rx + rng) \
                    == jax_kio.matrix_header(rx + rng) == got.shape
        for (k, a), (_, b) in zip(kaldi_io.read_ark(
                tmp_path / f"port{method}" / "x.ark"), jax_kio.read_ark(
                f"ark:{tmp_path}/jax{method}/x.ark")):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no ark"):
        kaldi_io.write_helper(f"scp:{tmp_path}/x.scp")


@pytest.mark.parametrize("kind", ["int16", "int32", "uint8", "float32",
                                  "pipe"])
def test_read_wav_scp_entry_matches_jax(kind, tmp_path):
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.9, 0.9, size=400)
    data = {"int16": (x * 32767).astype(np.int16),
            "int32": (x * 2 ** 31).astype(np.int32),
            "uint8": (x * 127 + 128).astype(np.uint8),
            "float32": x.astype(np.float32),
            "pipe": (x * 32767).astype(np.int16)}[kind]
    path = tmp_path / "a.wav"
    wavfile.write(path, 16000, data)
    entry = f"cat {path} |" if kind == "pipe" else str(path)
    sr, got = kaldi_io.read_wav_scp_entry(entry)
    want_sr, want = jax_kio.read_wav_scp_entry(entry)
    assert sr == want_sr == 16000
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _feats_dir(root, n=5, dim=6, seed=7):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    with kaldi_io.ArkWriter(root / "feats.ark", root / "feats.scp") as w:
        for i in range(n):
            w.write(f"u{i}", (rng.normal(size=(10 + 3 * i, dim)) * 2 + 1)
                    .astype(np.float32))
    (root / "utt2num_frames").write_text(
        "".join(f"u{i} {10 + 3 * i}\n" for i in range(n)))
    (root / "utt2spk").write_text(
        "".join(f"u{i} s{i % 2}\n" for i in range(n)))
    return root


def test_cmvn_stats_bytes_equal_jax(tmp_path):
    d = _feats_dir(tmp_path / "d")
    stats = cmvn.compute_stats(d / "feats.scp")
    want = jax_cmvn.compute_stats(d / "feats.scp")
    np.testing.assert_array_equal(stats, want)
    cmvn.write_stats(tmp_path / "p.ark", stats)
    jax_cmvn.write_stats(tmp_path / "j.ark", want)
    assert (tmp_path / "p.ark").read_bytes() \
        == (tmp_path / "j.ark").read_bytes()
    np.testing.assert_array_equal(cmvn.read_stats(tmp_path / "p.ark"), want)
    (tmp_path / "empty.scp").write_text("")
    with pytest.raises(ValueError, match="empty scp"):
        cmvn.compute_stats(tmp_path / "empty.scp")


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _strip_paths(files, root):
    """scp text with the directory of its arks removed."""
    return {k: v.replace(str(root).encode(), b"") for k, v in files.items()}


def test_make_spk_id_matches_jax(tmp_path):
    from vae_npvc_tpu.bin.make_spk_id import make_spk_id as jax_make
    from vae_npvc_tpu_torch.bin.make_spk_id import main, make_spk_id

    for pkg, fn in (("port", make_spk_id), ("jax", jax_make)):
        d = tmp_path / pkg / "train"
        d.mkdir(parents=True)
        (d / "spk2utt").write_text("TEF1 a b\nSEM2 c\nTMF1 d\n")
        (d / "utt2spk").write_text("a TEF1\nb TEF1\nc SEM2\nd TMF1\ne X\n")
        fn(d)
        fn(d)                                  # reuses its own map
        e = tmp_path / pkg / "eval"
        e.mkdir()
        (e / "utt2spk").write_text("f SEM2\ng TMF1\n")
        (e / "spk2spk_id").write_text("OLD 000009\n")
        fn(e, str(d / "spk2spk_id"))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert (tmp_path / "port/eval/.backup/spk2spk_id").read_text() \
        == "OLD 000009\n"
    main([str(tmp_path / "port/train"), "--write_utt2spk_id", "false"])
    with pytest.raises(FileNotFoundError):
        make_spk_id(tmp_path / "nowhere")


def test_apply_cmvn_cli_matches_jax(tmp_path, monkeypatch):
    from vae_npvc_tpu.bin import apply_cmvn as jax_cli
    from vae_npvc_tpu_torch.bin import apply_cmvn

    trees = {}
    for pkg, cli in (("port", apply_cmvn), ("jax", jax_cli)):
        root = tmp_path / pkg
        d = _feats_dir(root / "data")
        steps = [["compute", f"scp:{d}/feats.scp", f"{root}/cmvn.ark"],
                 ["apply", f"{root}/cmvn.ark", f"scp:{d}/feats.scp",
                  f"{root}/dump"],
                 ["apply", "--reverse", f"{root}/cmvn.ark",
                  f"scp:{root}/dump/feats.scp", f"{root}/back"],
                 ["apply", "--norm-vars", "false", f"{root}/cmvn.ark",
                  f"{d}/feats.scp", f"{root}/mean", "--copy", "utt2spk"]]
        for argv in steps:
            if cli is apply_cmvn:
                cli.main(argv)
            else:
                monkeypatch.setattr(sys, "argv", ["apply_cmvn"] + argv)
                cli.main()
        trees[pkg] = _strip_paths(_tree(root), root)
    assert trees["port"] == trees["jax"]
    assert "mean/utt2num_frames" not in trees["port"]
    back = dict(kaldi_io.read_ark(tmp_path / "port/back/feats_cmvn.ark"))
    for k, m in kaldi_io.read_ark(tmp_path / "port/data/feats.ark"):
        np.testing.assert_allclose(back[k], m, rtol=0, atol=1e-5)


def _wav_dir(root):
    """A data dir of three 8 kHz wavs and one at 16 kHz (resampled)."""
    root.mkdir(parents=True)
    rng = np.random.default_rng(9)
    lines = []
    for i, (n, fs) in enumerate(((3000, 8000), (9000, 8000), (17000, 8000),
                                 (7000, 16000))):
        x = (0.3 * np.sin(np.arange(n) * 0.05 * (i + 1))
             + 0.05 * rng.normal(size=n))
        wavfile.write(root / f"w{i}.wav", fs, (x * 32767).astype(np.int16))
        lines.append(f"w{i} {root}/w{i}.wav\n")
    (root / "wav.scp").write_text("".join(lines))
    (root / "utt2spk").write_text("".join(f"w{i} s\n" for i in range(4)))
    (root / "spk2utt").write_text("s w0 w1 w2 w3\n")
    return root


def test_make_fbank_matches_jax(tmp_path):
    from vae_npvc_tpu.bin.make_fbank import make_fbank as jax_make
    from vae_npvc_tpu_torch.bin.make_fbank import main, make_fbank

    d = _wav_dir(tmp_path / "data")
    assert jax_make(d, tmp_path / "jax", batch_frames=600, **FEAT) == 4
    assert make_fbank(d, tmp_path / "port", batch_frames=600,
                      device="cpu", **FEAT) == 4
    want = dict(jax_kio.read_ark(f"ark:{tmp_path}/jax/feats_raw.ark"))
    got = dict(kaldi_io.read_ark(tmp_path / "port/feats_raw.ark"))
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)
    for f in ("utt2num_frames", "utt2spk", "spk2utt"):
        assert (tmp_path / "port" / f).read_text() \
            == (tmp_path / "jax" / f).read_text()
    assert got["w3"].shape[0] == 1 + 3500 // FEAT["n_shift"]
    args = [str(d), str(tmp_path / "cli"), "--fs", "8000", "--n_fft", "128",
            "--n_shift", "32", "--n_mels", "10", "--compress",
            "--device", "cpu"]
    assert main(args) == 4
    for k, m in kaldi_io.read_ark(tmp_path / "cli/feats_raw.ark"):
        step = np.abs(want[k]).max() / 30
        assert np.abs(m - want[k]).max() <= step
    # --pitch: the 3 pitch columns come from the same host code on the same
    # resampled samples, so they equal JAX's exactly
    assert jax_make(d, tmp_path / "jax_p", batch_frames=600, pitch=True,
                    **FEAT) == 4
    assert main([str(d), str(tmp_path / "cli_p"), "--pitch"]
                + args[2:10] + ["--device", "cpu"]) == 4
    want = dict(jax_kio.read_ark(f"ark:{tmp_path}/jax_p/feats_raw.ark"))
    got = dict(kaldi_io.read_ark(tmp_path / "cli_p/feats_raw.ark"))
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape == (want[k].shape[0],
                                                 FEAT["n_mels"] + 3)
        np.testing.assert_array_equal(got[k][:, -3:], want[k][:, -3:])
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)


def test_convert_fbank_matches_jax_with_its_phase(tmp_path, monkeypatch):
    from vae_npvc_tpu.bin.convert_fbank import convert_fbank as jax_convert
    from vae_npvc_tpu_torch.bin.convert_fbank import convert_fbank, main
    from vae_npvc_tpu_torch.data import features

    rng = np.random.default_rng(6)
    d = tmp_path / "mel"
    d.mkdir()
    with kaldi_io.ArkWriter(d / "feats.ark", d / "feats.scp") as w:
        for i, T in enumerate((40, 150, 90, 130, 20, 60)):
            w.write(f"m{i}", (rng.normal(size=(T, 10)) - 2).astype(np.float32))
    jax_convert(d / "feats.scp", tmp_path / "jax", n_iter=3, **FEAT)

    gl = features.griffin_lim

    def with_jax_phase(log_mel, **kw):
        # JAX's initial phase for this batch (features.py griffin_lim:
        # PRNGKey(0) uniform over the magnitude's shape)
        shape = tuple(log_mel.shape[:2]) + (FEAT["n_fft"] // 2 + 1,)
        phase = np.array(jax.random.uniform(
            jax.random.PRNGKey(0), shape, minval=-np.pi, maxval=np.pi))
        return gl(log_mel, phase=torch.from_numpy(phase), **kw)

    monkeypatch.setattr(features, "griffin_lim", with_jax_phase)
    assert convert_fbank(d / "feats.scp", tmp_path / "port", n_iter=3,
                         device="cpu", **FEAT) == 6
    for i, T in enumerate((40, 150, 90, 130, 20, 60)):
        sr, got = wavfile.read(tmp_path / "port" / f"m{i}.wav")
        _, want = wavfile.read(tmp_path / "jax" / f"m{i}.wav")
        assert sr == 8000 and got.dtype == np.int16
        assert got.shape == want.shape == (T * FEAT["n_shift"],)
        assert np.abs(got.astype(np.int32)).max() == int(0.95 * 32767)
        assert np.abs(got.astype(np.int32) - want).max() \
            <= 1e-3 * np.abs(want).max()
    with pytest.raises(ValueError, match="--n_mels 80"):
        main([str(d / "feats.scp"), str(tmp_path / "x"), "--fs", "8000",
              "--device", "cpu"])


def test_front_end_clis_asked_for_the_gpu_do_not_run_on_the_cpu(tmp_path):
    from vae_npvc_tpu_torch.bin.convert_fbank import convert_fbank
    from vae_npvc_tpu_torch.bin.make_fbank import main as make_main

    assert not torch.cuda.is_available()
    d = _wav_dir(tmp_path / "data")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_main([str(d), str(tmp_path / "f"), "--fs", "8000",
                   "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        convert_fbank(d / "wav.scp", tmp_path / "w", **FEAT)
    assert not (tmp_path / "f").exists() and not (tmp_path / "w").exists()
