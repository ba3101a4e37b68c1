"""The offline decode fixture's inputs and output helpers.

``tests/torch_port_fixtures/offline_golden.npz`` holds the JAX
``Converter``'s uncompressed decode and sweep with the committed golden
checkpoints (flat: ``golden.msgpack``, vqvae2: ``hier_golden.msgpack``) over
the decode dir :func:`offline_decode_dir` makes from its seed. Both the CPU
tests and ``chip_smoke.py`` rebuild that decode dir here, so only JAX's
outputs are committed. The lengths fill three 16-frame buckets, one with a
short last chunk of 4, and one utterance is shorter than the hierarchy's
8-frame minimum.
"""

import json
from pathlib import Path

import numpy as np

OFFLINE_MODELS = {"flat": "golden", "hier": "hier_golden"}
OFFLINE_DECODE = {"decode_bucket_size": 16, "decode_batch_size": 4}
OFFLINE_LENGTHS = (5, 12, 16, 14, 11, 30, 47, 21)
OFFLINE_SPEAKERS = {"spkA": 0, "spkB": 3, "spkC": 1, "spkD": 2}
OFFLINE_TARGETS = ["spkB", "spkC"]
OFFLINE_SEED = 20261017


def offline_config(fixtures, name):
    """The golden fixture ``name``'s config (``<fixtures>/<name>_config.json``)
    with the offline fixture's buckets."""
    cfg = json.loads((Path(fixtures) / f"{name}_config.json").read_text())
    return dict(cfg, **OFFLINE_DECODE)


def offline_decode_dir(root, dim, named=True):
    """A decode dir of seeded normal features (``OFFLINE_LENGTHS`` frames of
    ``dim``), ``trials`` with one to three targets per line (the
    hierarchies' per-level speakers) and, with ``named``, speaker names and
    their ``spk2spk_id``; else the same targets as integer ids."""
    from vae_npvc_tpu_torch.data import kaldi_io

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(OFFLINE_SEED)
    with kaldi_io.ArkWriter(root / "feats.ark", root / "feats.scp") as w:
        for i, T in enumerate(OFFLINE_LENGTHS):
            w.write(f"utt{i}", rng.normal(size=(T, dim)).astype(np.float32))
    names = list(OFFLINE_SPEAKERS)
    lines = []
    for i in range(len(OFFLINE_LENGTHS)):
        tgt = [names[(i + k) % len(names)] for k in range(1 + i % 3)]
        if not named:
            tgt = [str(OFFLINE_SPEAKERS[t]) for t in tgt]
        lines.append(" ".join([f"utt{i}"] + tgt) + "\n")
    (root / "trials").write_text("".join(lines))
    if named:
        kaldi_io.save_dict_data(root / "spk2spk_id", OFFLINE_SPEAKERS)
    return root


def read_outputs(out_dir):
    """``[(key, matrix), ...]`` of a decode's ``feats.scp``, in its order."""
    from vae_npvc_tpu_torch.data import kaldi_io

    return [(k, kaldi_io.load_mat(rx)) for k, rx in
            kaldi_io.read_scp(Path(out_dir) / "feats.scp").items()]


def pack_outputs(prefix, items):
    """``read_outputs`` items as npz arrays: keys, frame counts and the
    matrices stacked along time."""
    return {f"{prefix}/keys": np.array([k for k, _ in items]),
            f"{prefix}/frames": np.array([m.shape[0] for _, m in items]),
            f"{prefix}/mel": np.concatenate([m for _, m in items])}


def unpack_outputs(arrays, prefix):
    """Inverse of :func:`pack_outputs`."""
    bounds = np.cumsum(arrays[f"{prefix}/frames"])[:-1]
    return list(zip(arrays[f"{prefix}/keys"].tolist(),
                    np.split(arrays[f"{prefix}/mel"], bounds)))


def compression_step(mat):
    """Per column, a bound on the error of Kaldi compression method 1 of
    ``mat``: a column's largest code step (its range over 63) plus the
    rounding of the percentile headers to the global 16-bit grid (``CM2``'s
    global step for 8 rows or fewer)."""
    m = np.asarray(mat, np.float64)
    glob = max(float(m.max() - m.min()), 1e-10) / 65535
    if m.shape[0] <= 8:
        return np.full(m.shape[1], glob)
    return (m.max(0) - m.min(0)) / 63 + 2 * glob
