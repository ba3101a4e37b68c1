"""Seeded corpora and parameters of the evaluation fixture.

``tests/torch_port_fixtures/eval_golden*`` holds what the JAX package's
CTC recognizer and character LSTM LM compute from the inputs made here: a
small transformer recognizer trained on :func:`char_corpus` from the
parameters :func:`numpy_params` draws, its per-step losses, final
parameters and transcripts, and the LM's losses. Both the CPU tests and
``chip_smoke.py`` rebuild the corpus and the initial parameters here from
their seeds, so only JAX's outputs are committed.

- :func:`char_corpus`: each character of an alphabet is a fixed feature
  template held for ``frames_per_char`` frames with a little noise (the
  corpus of the JAX package's recognizer tests, the same draws for the same
  arguments), ``feats.scp`` + ``text``.
- :func:`speaker_corpus`: utterances of speakers that differ by a fixed
  offset of their features, ``feats.scp`` + ``utt2spk_id`` (+ ``utt2spk``
  with speaker names).
- :func:`numpy_params`: values for a flax ``params`` tree's shapes from one
  numpy generator, leaves in sorted key order.
"""

from pathlib import Path

import numpy as np

EVAL_SEED = 20261017
EVAL_ALPHABET = "abcd"
# the recognizer of the fixture: heads are fixed at 4 by the recipe's model,
# and the attention kernels take head dims that are multiples of 8
EVAL_WIDTH, EVAL_DIM, EVAL_UTTS = 32, 10, 24
EVAL_STEPS, EVAL_BATCH = 30, 8
EVAL_LM = {"embed": 8, "hidden": 16, "layers": 2, "steps": 6, "batch": 8}


def char_corpus(d, n_utts=60, seed=0, *, alphabet=EVAL_ALPHABET, dim=10,
                chars=(2, 6), frames_per_char=8):
    """Write ``d/feats.ark``, ``feats.scp`` and ``text``; returns {utt:
    text}. Utterances hold ``chars[0]`` to ``chars[1] - 1`` characters."""
    from ..data import kaldi_io

    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    templates = {c: rng.normal(size=(dim,)) * 2.0 for c in alphabet}
    texts = {}
    with kaldi_io.ArkWriter(d / "feats.ark", d / "feats.scp") as w, \
            open(d / "text", "w") as tf:
        for i in range(n_utts):
            n_char = int(rng.integers(*chars))
            text = "".join(rng.choice(list(alphabet), size=n_char))
            frames = []
            for c in text:
                block = templates[c][None, :].repeat(frames_per_char, axis=0)
                frames.append(block + 0.1 * rng.normal(size=block.shape))
            mat = np.concatenate(frames).astype(np.float32)
            utt = f"utt{i:03d}"
            w.write(utt, mat)
            tf.write(f"{utt} {text}\n")
            texts[utt] = text
    return texts


def speaker_corpus(d, n_speakers=3, n_utts=30, seed=0, *, dim=10,
                   frames=(20, 40), prefix="u"):
    """Write ``d/feats.ark``, ``feats.scp``, ``utt2num_frames``,
    ``utt2spk_id`` and ``utt2spk`` (names ``spk{i}``); utterance ``i``
    belongs to speaker ``i % n_speakers``. Returns the speaker offsets."""
    from ..data import kaldi_io

    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    offsets = rng.normal(size=(n_speakers, 1, dim)).astype(np.float32) * 3
    with kaldi_io.ArkWriter(d / "f.ark", d / "feats.scp") as w, \
            open(d / "utt2num_frames", "w") as unf, \
            open(d / "utt2spk_id", "w") as u2s, \
            open(d / "utt2spk", "w") as u2n:
        for i in range(n_utts):
            spk = i % n_speakers
            T = int(rng.integers(*frames))
            mat = (rng.normal(size=(T, dim)).astype(np.float32) * 0.5
                   + offsets[spk])
            utt = f"{prefix}{i:02d}"
            w.write(utt, mat)
            unf.write(f"{utt} {T}\n")
            u2s.write(f"{utt} {spk}\n")
            u2n.write(f"{utt} spk{spk}\n")
    return offsets


def numpy_params(tree, seed):
    """Values for every leaf of a flax ``params`` tree (numpy arrays; only
    their shapes are read), drawn from ``np.random.default_rng(seed)`` in
    sorted key order: kernels and LSTM kernels normal / sqrt(fan-in),
    embeddings normal / sqrt(width), LayerNorm scales 1 + 0.1 normal,
    biases 0.1 normal, float32."""
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        z = rng.normal(size=shape)
        if name == "kernel":
            z = z / np.sqrt(np.prod(shape[:-1]))
        elif name == "embedding":
            z = z / np.sqrt(shape[-1])
        elif name == "scale":
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    def walk(node):
        return {k: walk(node[k]) if isinstance(node[k], dict)
                else draw(k, np.shape(node[k])) for k in sorted(node)}

    return walk(tree)


EVAL_LM_CONTEXTS = ("", "a", "ab", "bcd", "dcba", "aab", "cc")
EVAL_DECODE = {"batch_size": 8, "bucket": 32}
EVAL_BEAM = {"beam_size": 6, "lm_weight": 0.6}


def lm_table(lm):
    """(contexts, vocab + EOS) log-probabilities of ``lm`` (numpy)."""
    syms = list(lm.vocab)
    return np.array([[lm.logp(list(ctx), c) for c in syms]
                     + [lm.logp_eos(list(ctx))] for ctx in EVAL_LM_CONTEXTS])


def fixture_run(root, device):
    """The port's side of the fixture on ``device``: the recognizer trained
    ``EVAL_STEPS`` steps from :func:`numpy_params` on :func:`char_corpus`
    under ``root``, its greedy and beam (neural LM) transcripts, and the LM
    trained ``EVAL_LM["steps"]`` steps. Returns a dict of numpy values and
    the recognizer."""
    from ..eval.asr import CTCTrainer, _ctc_model, build_vocab
    from ..eval.neural_lm import CharLstmLM, _build_vocab
    from .bridge import params_to_flax

    root = Path(root)
    texts = char_corpus(root, EVAL_UTTS, EVAL_SEED, dim=EVAL_DIM)
    vocab = build_vocab(texts.values())
    tpl = params_to_flax(_ctc_model(len(vocab), EVAL_WIDTH,
                                    arch="transformer",
                                    feat_dim=EVAL_DIM).state_dict())
    trainer = CTCTrainer(root, batch_size=EVAL_BATCH, width=EVAL_WIDTH,
                         arch="transformer", device=device,
                         params=numpy_params(tpl, EVAL_SEED))
    losses = [float(trainer.step()) for _ in range(EVAL_STEPS)]
    rec = trainer.recognizer()
    itos, _ = _build_vocab(texts.values())
    lm = CharLstmLM(itos, embed=EVAL_LM["embed"], hidden=EVAL_LM["hidden"],
                    layers=EVAL_LM["layers"], device=device)
    lm_losses = []
    lm.train(texts.values(), steps=EVAL_LM["steps"], batch=EVAL_LM["batch"],
             params=numpy_params(lm.params, EVAL_SEED + 1),
             losses=lm_losses)
    scp = root / "feats.scp"
    greedy = rec.transcribe_scp(scp, **EVAL_DECODE)
    beam = rec.transcribe_scp(scp, lm=lm, **EVAL_DECODE, **EVAL_BEAM)
    utts = sorted(texts)
    return {"losses": np.array(losses), "params": rec.params,
            "greedy": np.array([greedy[u] for u in utts]),
            "beam": np.array([beam[u] for u in utts]),
            "lm_losses": np.array(lm_losses), "lm_logp": lm_table(lm)}, rec


def fixture_config():
    return {"width": EVAL_WIDTH, "dim": EVAL_DIM, "utts": EVAL_UTTS,
            "steps": EVAL_STEPS, "batch": EVAL_BATCH, "seed": EVAL_SEED,
            "lm": EVAL_LM, "decode": EVAL_DECODE, "beam": EVAL_BEAM}


def check_fixture(got, fixtures, lr=1e-3):
    """Hold a :func:`fixture_run` result against ``<fixtures>/eval_golden*``:
    losses within 1e-4 relative, LM log-probabilities within 1e-4, final
    parameters within 1e-3 of each leaf's peak (the key projection's bias,
    whose exact gradient is 0, within Adam's 2 ``lr`` a step), transcripts
    equal. Raises AssertionError; returns the largest deviations."""
    from . import msgpack_io
    from .bridge import _flatten

    fixtures = Path(fixtures)
    want = np.load(fixtures / "eval_golden.npz")
    final = msgpack_io.msgpack_restore(
        (fixtures / "eval_golden_final.msgpack").read_bytes())["params"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["lm_losses"], want["lm_losses"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["lm_logp"], want["lm_logp"], rtol=0,
                               atol=1e-4)
    assert got["greedy"].tolist() == want["greedy"].tolist(), "greedy"
    assert got["beam"].tolist() == want["beam"].tolist(), "beam"
    a, b = {}, {}
    _flatten(got["params"], "", a)
    _flatten(final, "", b)
    assert set(a) == set(b)
    worst = 0.0
    for k in b:
        err = float(np.abs(a[k] - b[k]).max())
        if k.endswith("mha.linear_k.bias"):
            assert err <= 2 * lr * EVAL_STEPS, (k, err)
        else:
            peak = float(np.abs(b[k]).max())
            assert err <= 1e-3 * peak, (k, err, peak)
            worst = max(worst, err / peak)
    return {"loss_max_rel_err": float(np.max(
        np.abs(got["losses"] - want["losses"]) / np.abs(want["losses"]))),
            "lm_loss_max_rel_err": float(np.max(
                np.abs(got["lm_losses"] - want["lm_losses"])
                / np.abs(want["lm_losses"]))),
            "lm_logp_max_abs_err": float(np.abs(
                got["lm_logp"] - want["lm_logp"]).max()),
            "param_max_err_over_peak": worst}
