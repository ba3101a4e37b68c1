"""VQ-token (BNF) extraction and the train/valid split of the PyTorch port
against the JAX package, on the CPU.

The golden checkpoints of ``tests/torch_port_fixtures`` (the flat EMA
VQ-VAE and the vqvae2) extract ``id``, ``csid`` and ``token`` outputs, as
text and as arks, and the duration file from a seeded corpus; every output
equals JAX's exactly (text files and ark bytes). The flat corpus's
16-frame bucket holds five utterances at B = 4, so its last batch is short:
the port encodes it at B = 1 where JAX fills it with length-1 rows, and the
ids agree. ``collapse_*`` equal JAX's on edge cases;
``bin/subset_data_into_tr_cv`` writes JAX's files for ``--seed 777``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from vae_npvc_tpu_torch.utils import offline_fixture as fx

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_port_fixtures"
# the flat corpus: buckets of 16 (five utterances, B = 4: a short last
# batch), 32 and 48; the hierarchy's includes one shorter than its 8-frame
# minimum
LENGTHS = {"golden": (5, 12, 16, 14, 11, 30, 47, 21),
           "hier_golden": (5, 12, 30, 16)}


@pytest.mark.parametrize("ids", [[], [3], [7, 7, 7, 7], [1, 1, 2, 3, 3, 1],
                                 np.arange(6).reshape(2, 3)])
def test_collapse_matches_jax(ids):
    from vae_npvc_tpu.infer import bnf as jax_bnf
    from vae_npvc_tpu_torch.infer import bnf

    got = bnf.collapse_consecutive(ids)
    want = jax_bnf.collapse_consecutive(ids)
    assert got.tolist() == want.tolist() and got.dtype == want.dtype
    for g, w in zip(bnf.collapse_with_durations(ids),
                    jax_bnf.collapse_with_durations(ids)):
        assert g.tolist() == w.tolist() and g.dtype == w.dtype


def _corpus(root, name):
    from vae_npvc_tpu_torch.data import kaldi_io

    cfg = fx.offline_config(FIXTURES, name)
    dim = (cfg.get("encoder") or cfg["encoder.0"])["in_channels"][0]
    rng = np.random.default_rng(5)
    root.mkdir(parents=True, exist_ok=True)
    with kaldi_io.ArkWriter(root / "feats.ark", root / "feats.scp") as w:
        for i, T in enumerate(LENGTHS[name]):
            w.write(f"utt{i}", rng.normal(size=(T, dim)).astype(np.float32))
    return cfg, f"scp:{root}/feats.scp"


# (kind, text output): every output the extractor writes; the hierarchy
# (whose JAX extractor encodes eagerly, one utterance at a time) takes the
# two the AISHELL-3 recipe reads
OUTPUTS = {"golden": [("id", True), ("csid", True), ("csid", False),
                      ("token", False)],
           "hier_golden": [("csid", True), ("token", False)]}


def _extract_all(ex, rspec, out, name):
    out.mkdir()
    n = len(LENGTHS[name])
    for kind, txt in OUTPUTS[name]:
        dst = (out / f"{kind}.txt" if txt
               else f"ark,scp:{out}/{kind}.ark,{out}/{kind}.scp")
        dur = out / f"{kind}_{txt}.dur" if kind == "csid" else None
        assert ex.extract(rspec, str(dst), kind, txt,
                          durations_path=dur) == n


@pytest.mark.parametrize("name", ["golden", "hier_golden"])
def test_extract_matches_jax(tmp_path, name):
    from vae_npvc_tpu.infer.bnf import BnfExtractor as JaxExtractor
    from vae_npvc_tpu_torch.infer.bnf import BnfExtractor

    cfg, rspec = _corpus(tmp_path / "data", name)
    ck = FIXTURES / f"{name}.msgpack"
    jex = JaxExtractor(cfg)
    pex = BnfExtractor(cfg, device="cpu")
    assert pex.load_checkpoint(ck) == jex.load_checkpoint(ck)
    _extract_all(jex, rspec, tmp_path / "jax", name)
    _extract_all(pex, rspec, tmp_path / "port", name)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    for f in files:
        got = (tmp_path / "port" / f).read_bytes()
        want = (tmp_path / "jax" / f).read_bytes()
        if f.endswith(".scp"):    # the ark paths differ
            got = got.replace(str(tmp_path / "port").encode(), b"")
            want = want.replace(str(tmp_path / "jax").encode(), b"")
        assert got == want, f
    lines = (tmp_path / "port" / "csid.txt").read_text().splitlines()
    assert len(lines) == len(LENGTHS[name])
    assert all(line.split(" ", 1)[1].startswith("<") for line in lines)


def test_flat_short_last_batch_encodes_only_its_utterances(tmp_path,
                                                           monkeypatch):
    from vae_npvc_tpu_torch.infer.bnf import BnfExtractor

    cfg, rspec = _corpus(tmp_path / "data", "golden")
    ex = BnfExtractor(cfg, device="cpu")
    ex.load_checkpoint(FIXTURES / "golden.msgpack")
    shapes = []
    encode = ex.model.encode
    monkeypatch.setattr(ex.model, "encode", lambda x, n: (
        shapes.append(tuple(x.shape)), encode(x, n))[1])
    ex.extract(rspec, str(tmp_path / "ids.txt"), "id")
    assert shapes == [(4, 16, 20), (1, 16, 20), (2, 32, 20), (1, 48, 20)]


def test_extract_cli_matches_jax(tmp_path):
    import json

    from vae_npvc_tpu.infer.bnf import BnfExtractor as JaxExtractor
    from vae_npvc_tpu_torch.bin.extract_bnf import main

    cfg, rspec = _corpus(tmp_path / "data", "golden")
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps(cfg))
    ck = FIXTURES / "golden.msgpack"
    got, dur = tmp_path / "port.txt", tmp_path / "port.dur"
    assert main([rspec, str(got), "-c", str(conf), "-m", str(ck), "-k",
                 "csid", "--durations", str(dur), "-g", "0",
                 "--device", "cpu"]) == len(LENGTHS["golden"])
    jex = JaxExtractor(cfg)
    jex.load_checkpoint(ck)
    jex.extract(rspec, str(tmp_path / "jax.txt"), "csid",
                durations_path=tmp_path / "jax.dur")
    assert got.read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert dur.read_bytes() == (tmp_path / "jax.dur").read_bytes()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main([rspec, str(got), "-c", str(conf), "-m", str(ck)])


def test_subset_data_into_tr_cv_matches_jax(tmp_path):
    from vae_npvc_tpu.bin.subset_data_into_tr_cv import subset as jax_subset
    from vae_npvc_tpu_torch.bin.subset_data_into_tr_cv import main

    data = tmp_path / "data"
    data.mkdir()
    utts = [f"spk{i % 3}_utt{i:03d}" for i in range(40)]
    (data / "utt2spk").write_text("".join(f"{u} {u[:4]}\n" for u in utts))
    (data / "feats.scp").write_text("".join(f"{u} f.ark:{i}\n"
                                            for i, u in enumerate(utts)))
    (data / "utt2num_frames").write_text("".join(
        f"{u} {100 + i}\n" for i, u in enumerate(utts) if i % 7))
    args = ["-nt", "30", "-nv", "6", "--seed", "777"]
    main([str(data), str(tmp_path / "p_tr"), str(tmp_path / "p_cv")] + args)
    jax_subset(data, tmp_path / "j_tr", tmp_path / "j_cv", 30, 6, 777)
    for split in ("tr", "cv"):
        names = sorted(p.name for p in (tmp_path / f"j_{split}").iterdir())
        assert names == ["feats.scp", "utt2num_frames", "utt2spk"]
        assert names == sorted(
            p.name for p in (tmp_path / f"p_{split}").iterdir())
        for f in names:
            assert (tmp_path / f"p_{split}" / f).read_bytes() \
                == (tmp_path / f"j_{split}" / f).read_bytes()
    assert len((tmp_path / "p_tr" / "utt2spk").read_text().splitlines()) \
        == 30
