"""The port's token->mel data contract and CLIs on the CPU.

``TokenMelDataset`` against the JAX package's on the same token-mel
directory (batches exact, either writer); ``bin/train_tts`` for a few
iterations with ``--device cpu``: checkpoint cadence, ``best.json``,
``model.loss.best``, resume, a finished run re-invoked as a no-op; and
``bin/decode_tts``, whose ``mel.ark``/``feats.scp`` hold the frames
``Model.infer`` gives, for int speaker ids, a per-utterance speaker file,
trials and float speaker embeddings.
"""

import json

import numpy as np
import pytest
import torch

from vae_npvc_tpu.data import token_mel as jtm
from vae_npvc_tpu_torch.bin import decode_tts, train_tts
from vae_npvc_tpu_torch.data import kaldi_io, token_mel

torch.set_num_threads(1)
L, T, MEL = 12, 48, 10


def _config(**kw):
    cfg = {
        "model_type": "vae_npvc.model.token_tts",
        "trainer_type": "vae_npvc.trainer.basic", "seed": 3,
        "token_num": 16, "token_dim": 16, "y_num": 4, "y_dim": 8,
        "mel_dim": MEL, "block_type": "transformer", "adim": 16,
        "aheads": 2, "elayers": 1, "dlayers": 1, "eunits": 32, "dunits": 32,
        "max_tokens": L, "max_frames": T, "batch_size": 4,
        "optim_type": "Adam", "learning_rate": 1e-3, "max_grad_norm": 10,
        "max_iter": 6, "iters_per_log": 2, "iters_per_checkpoint": 3,
        "steps_per_call": 2,
    }
    cfg.update(kw)
    return cfg


def _items(n, seed):
    rng = np.random.default_rng(seed)
    items, embs = [], {}
    for i in range(n):
        k = int(rng.integers(3, L + 1))
        toks = rng.integers(0, 16, size=k)
        durs = rng.integers(1, 4, size=k)
        mel = rng.normal(size=(int(durs.sum()), MEL)).astype(np.float32)
        items.append((f"utt{i}", toks, durs, mel, i % 4))
        embs[f"utt{i}"] = rng.normal(size=6).astype(np.float32)
    # one utterance too long for max_tokens: both datasets drop it
    items.append(("long", np.zeros(L + 1, int), np.ones(L + 1, int),
                  np.zeros((L + 1, MEL), np.float32), 0))
    embs["long"] = np.zeros(6, np.float32)
    return items, embs


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("token_mel")
    items, embs = _items(9, 0)
    token_mel.write_token_mel_dir(root / "train", items, embs)
    items, embs = _items(5, 1)
    token_mel.write_token_mel_dir(root / "dev", items, embs)
    return root / "train", root / "dev"


@pytest.mark.parametrize("use_emb", [False, True])
def test_token_mel_dataset_equals_the_jax_package(data_dirs, tmp_path,
                                                  use_emb):
    cfg = _config(use_spk_embed=use_emb)
    a, b = token_mel.TokenMelDataset(data_dirs[0], cfg), \
        jtm.TokenMelDataset(data_dirs[0], cfg)
    assert len(a) == len(b) == 9 and a.mel_dim == b.mel_dim == MEL
    for kw in ({"shuffle": True, "seed": 5}, {"shuffle": False, "epochs": 1}):
        for (x, y), _ in zip(zip(a.batches(4, **kw), b.batches(4, **kw)),
                             range(4)):
            assert len(x) == len(y) == 6
            for u, v in zip(x, y):
                assert u.dtype == v.dtype and np.array_equal(u, v)
            assert x[3].dtype == (np.float32 if use_emb else np.int32)
    # the JAX writer's directory reads the same through the port's reader
    items, embs = _items(4, 2)
    jtm.write_token_mel_dir(tmp_path / "j", items, embs)
    token_mel.write_token_mel_dir(tmp_path / "p", items, embs)
    for name in ("tokens.txt", "durations.txt", "utt2spk_id", "mel.ark",
                 "spk_emb.ark"):
        assert (tmp_path / "j" / name).read_bytes() \
            == (tmp_path / "p" / name).read_bytes(), name
    np.testing.assert_array_equal(
        token_mel.parse_token_line("utt <3><15><0>"), [3, 15, 0])
    with pytest.raises(ValueError, match="no usable items"):
        token_mel.TokenMelDataset(tmp_path / "p", dict(cfg, max_frames=1))
    with pytest.raises(ValueError, match="batch_size"):
        next(a.batches(64, shuffle=True))


def test_chip_smoke_tts_config_matches_recipe_yaml():
    import sys
    from pathlib import Path

    import yaml

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import chip_smoke

    with open(root / "egs/aishell3/vc2/conf/"
              "train_token_tts_transformer.yaml") as f:
        assert chip_smoke.TTS == yaml.safe_load(f)


def _run(cfg, out, data_dirs, *extra):
    conf = out.parent / f"{out.name}.json"
    conf.write_text(json.dumps(cfg))
    train_tts.main(["-c", str(conf), "--train_dir", str(data_dirs[0]),
                    "--valid_dir", str(data_dirs[1]), "--output_dir",
                    str(out), "--device", "cpu", *extra])
    return conf


def test_train_tts_cli_checkpoints_best_and_resume(data_dirs, tmp_path):
    from vae_npvc_tpu_torch.utils import msgpack_io

    cfg = _config()
    out = tmp_path / "exp"
    _run(cfg, out, data_dirs)
    assert sorted(p.name for p in out.glob("iter.*")) == ["iter.3", "iter.6"]
    best = json.loads((out / "best.json").read_text())
    assert best["check_loss_kind"] == "X like" and best["iteration"] in (3, 6)
    assert (out / "model.loss.best").read_bytes() \
        == (out / f"iter.{best['iteration']}").read_bytes()
    log = (out / "train.log").read_text()
    for it in (2, 4, 6):
        assert f"Iter {it}:" in log
    assert "Valid 3:" in log and "Valid 6:" in log and "Finished" in log
    assert "token_tts.Model" in log and "Training utterances: 9" in log
    payload = msgpack_io.msgpack_restore((out / "iter.6").read_bytes())
    assert payload["iteration"] == 6 and payload["ema"] == {}
    assert int(payload["optimizer"]["1"]["0"]["count"]) == 6

    # resume from iter.3 in a second directory: the same cadence, and the
    # best-so-far of the first half is kept when it exists there
    out2 = tmp_path / "exp2"
    out2.mkdir()
    (out2 / "iter.3").write_bytes((out / "iter.3").read_bytes())
    (out2 / "best.json").write_text(json.dumps(
        {"iteration": 3, "check_loss_kind": "X like",
         "loss": {"X like": -1e9}}))
    _run(cfg, out2, data_dirs, "--checkpoint", str(out2 / "iter.3"))
    log2 = (out2 / "train.log").read_text()
    assert "Resumed from" in log2 and "Best-so-far restored: iteration 3" \
        in log2
    assert "Iter 4:" in log2 and "Iter 6:" in log2 and "Iter 2:" not in log2
    assert (out2 / "iter.6").exists()
    assert (out2 / "model.loss.best").read_bytes() \
        == (out2 / "iter.3").read_bytes()
    # a finished run re-invoked trains nothing
    before = (out / "iter.6").read_bytes()
    _run(cfg, out, data_dirs, "--checkpoint", str(out / "iter.6"))
    assert (out / "iter.6").read_bytes() == before
    assert not (out / "iter.7").exists()
    # without a validation set the final state is the best
    out3 = tmp_path / "exp3"
    conf = tmp_path / "c3.json"
    conf.write_text(json.dumps(_config(max_iter=2, block_type="conv",
                                       hidden=16, enc_stacks=1,
                                       dec_stacks=1)))
    train_tts.main(["-c", str(conf), "--train_dir", str(data_dirs[0]),
                    "--output_dir", str(out3), "--device", "cpu"])
    assert (out3 / "model.loss.best").read_bytes() \
        == (out3 / "iter.2").read_bytes()


def _trained(cfg, tmp_path, name):
    """A checkpoint of seeded random weights, written by the trainer."""
    from vae_npvc_tpu_torch.train import build_trainer

    tr = build_trainer(cfg, device="cpu")
    tr.init_state()
    with torch.no_grad():      # a spread of predicted durations
        tr.model.dur_1.b.fill_(0.9)
    path = tmp_path / name
    tr.save_checkpoint(path)
    return tr.model.eval(), path


def _expected(model, line, y):
    toks = token_mel.parse_token_line(line)[:L]
    pad = np.zeros((1, L), np.int32)
    pad[0, :len(toks)] = toks
    with torch.no_grad():
        mel, lens = model.infer(torch.from_numpy(pad), y,
                                torch.tensor([len(toks)], dtype=torch.int32))
    return mel[0, :int(lens[0])].numpy()


def test_decode_tts_cli_writes_what_infer_gives(data_dirs, tmp_path):
    cfg = _config()
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps(cfg))
    model, ckpt = _trained(cfg, tmp_path, "ids.ckpt")
    tokens = kaldi_io.load_dict_data(data_dirs[1] / "tokens.txt")
    common = ["-c", str(conf), "--checkpoint", str(ckpt), "--tokens",
              str(data_dirs[1] / "tokens.txt"), "--device", "cpu"]

    decode_tts.main(common + ["--spk", "2", "--output-dir",
                              str(tmp_path / "d1")])
    scp = kaldi_io.load_dict_data(tmp_path / "d1" / "feats.scp")
    assert list(scp) == list(tokens) and (tmp_path / "d1" / "mel.ark").exists()
    lengths = set()
    for utt, line in tokens.items():
        got = kaldi_io.load_mat(scp[utt])
        want = _expected(model, line, torch.tensor([2], dtype=torch.int32))
        assert got.shape == want.shape and got.shape[1] == MEL
        np.testing.assert_array_equal(got, want)
        lengths.add(got.shape[0])
    assert len(lengths) > 1
    # per-utterance speakers from a file, and trials keyed by target speaker
    decode_tts.main(common + ["--spk", str(data_dirs[1] / "utt2spk_id"),
                              "--output_dir", str(tmp_path / "d2")])
    scp = kaldi_io.load_dict_data(tmp_path / "d2" / "feats.scp")
    np.testing.assert_array_equal(
        kaldi_io.load_mat(scp["utt3"]),
        _expected(model, tokens["utt3"],
                  torch.tensor([3], dtype=torch.int32)))
    (tmp_path / "trials").write_text("utt1 3\nutt4 0\n")
    decode_tts.main(common + ["--spk", "0", "--trials",
                              str(tmp_path / "trials"), "--output-dir",
                              str(tmp_path / "d3")])
    scp = kaldi_io.load_dict_data(tmp_path / "d3" / "feats.scp")
    assert list(scp) == ["utt1", "utt4"]
    np.testing.assert_array_equal(
        kaldi_io.load_mat(scp["utt1"]),
        _expected(model, tokens["utt1"],
                  torch.tensor([3], dtype=torch.int32)))
    with pytest.raises(SystemExit):
        decode_tts.main(common + ["--output-dir", str(tmp_path / "d4")])

    # float speaker embeddings, per utterance
    cfg_e = _config(use_spk_embed=True, spk_embed_dim=6)
    conf.write_text(json.dumps(cfg_e))
    model_e, ckpt_e = _trained(cfg_e, tmp_path, "emb.ckpt")
    decode_tts.main(["-c", str(conf), "--checkpoint", str(ckpt_e), "--tokens",
                     str(data_dirs[1] / "tokens.txt"), "--device", "cpu",
                     "--spk_emb", str(data_dirs[1] / "spk_emb.scp"),
                     "--output-dir", str(tmp_path / "d5")])
    scp = kaldi_io.load_dict_data(tmp_path / "d5" / "feats.scp")
    embs = kaldi_io.load_dict_data(data_dirs[1] / "spk_emb.scp")
    y = torch.from_numpy(kaldi_io.load_mat(embs["utt2"])[:1].astype(
        np.float32))
    np.testing.assert_array_equal(kaldi_io.load_mat(scp["utt2"]),
                                  _expected(model_e, tokens["utt2"], y))


def test_tts_clis_default_to_cuda_and_refuse_a_missing_gpu(data_dirs,
                                                           tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps(_config()))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        train_tts.main(["-c", str(conf), "--train_dir", str(data_dirs[0]),
                        "--output_dir", str(tmp_path / "o")])
    _, ckpt = _trained(_config(), tmp_path, "c.ckpt")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        decode_tts.main(["-c", str(conf), "--checkpoint", str(ckpt),
                         "--tokens", str(data_dirs[1] / "tokens.txt"),
                         "--spk", "0", "--output-dir", str(tmp_path / "d")])
