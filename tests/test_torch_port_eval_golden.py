"""The evaluation fixture: what the JAX package's recognizer and LM compute,
held against the PyTorch port on the CPU (``chip_smoke.py`` holds the card
against the same files).

``tests/torch_port_fixtures/eval_golden.npz`` holds JAX's per-step losses of
a small transformer CTC recognizer (width 32, 4 heads of 8, 3 blocks, fp32)
trained ``EVAL_STEPS`` steps on ``utils/eval_fixture.char_corpus`` from the
parameters ``numpy_params`` draws, its greedy and beam-search transcripts
(beam 6, the neural LM at weight 0.6), and the character LSTM LM's per-step
losses and log-probabilities after ``EVAL_LM["steps"]`` steps;
``eval_golden_final.msgpack`` is the recognizer's checkpoint after the
steps. Regenerate with

    JAX_PLATFORMS=cpu python -m tests.test_torch_port_eval_golden

Tolerances: losses within 1e-4 relative, LM log-probabilities within 1e-4,
final parameters within 1e-3 of each leaf's peak (the key projection's
bias, whose gradient is rounding noise, within 2 lr per step), transcripts
equal.
"""

import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from vae_npvc_tpu_torch.utils.bridge import _flatten
from vae_npvc_tpu_torch.utils.eval_fixture import (EVAL_BATCH, EVAL_BEAM,
                                                   EVAL_DECODE, EVAL_DIM,
                                                   EVAL_LM, EVAL_SEED,
                                                   EVAL_STEPS, EVAL_UTTS,
                                                   EVAL_WIDTH, char_corpus,
                                                   check_fixture,
                                                   fixture_config,
                                                   fixture_run, lm_table,
                                                   numpy_params)

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "torch_port_fixtures"


def test_port_holds_the_fixture_on_the_cpu(tmp_path):
    got, rec = fixture_run(tmp_path, "cpu")
    check_fixture(got, FIXTURES)
    assert rec.arch == "transformer"
    want = np.load(FIXTURES / "eval_golden.npz")
    assert json.loads(str(want["config"])) == fixture_config()


def test_fixture_inputs_match_jax_shapes(tmp_path):
    """The port's initial parameter tree has JAX's keys and shapes, so the
    same numpy draws initialize both; the corpus is the JAX tests' corpus
    for the same arguments."""
    import jax
    import jax.numpy as jnp

    from tests.test_eval_asr import _char_corpus
    from vae_npvc_tpu.eval import asr as jax_asr
    from vae_npvc_tpu_torch.eval import asr
    from vae_npvc_tpu_torch.utils.bridge import params_to_flax

    j_dir, want = _char_corpus(tmp_path, n_utts=7, seed=2)
    texts = char_corpus(tmp_path / "port", 7, 2)
    assert texts == want
    for f in ("text", "feats.ark"):
        assert (tmp_path / "port" / f).read_bytes() \
            == (j_dir / f).read_bytes()
    V = len(asr.build_vocab(texts.values()))
    tpl = jax_asr._ctc_model(V, EVAL_WIDTH, arch="transformer").init(
        jax.random.PRNGKey(0), jnp.zeros((2, 16, EVAL_DIM)),
        jnp.ones((2,), jnp.int32))["params"]
    a, b = {}, {}
    _flatten(jax.tree_util.tree_map(np.shape, tpl), "", a)
    port = params_to_flax(asr._ctc_model(V, EVAL_WIDTH, arch="transformer",
                                         feat_dim=EVAL_DIM).state_dict())
    _flatten(jax.tree_util.tree_map(np.shape, port), "", b)
    assert a == b


def _recording_jit(real, losses):
    """``real`` (``jax.jit``) whose functions append the third output (the
    loss of a ``(params, opt_state, loss)`` training step) to ``losses``."""
    def jit(fn, *a, **k):
        compiled = real(fn, *a, **k)

        def call(*args):
            out = compiled(*args)
            if isinstance(out, tuple) and len(out) == 3:
                losses.append(float(out[2]))
            return out
        return call
    return jit


def generate():
    """Run the JAX package on the fixture's inputs and write the files."""
    import jax
    import jax.numpy as jnp

    from vae_npvc_tpu.eval import asr as jax_asr
    from vae_npvc_tpu.eval import neural_lm as jax_nlm

    jax.config.update("jax_default_matmul_precision", "highest")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        texts = char_corpus(root, EVAL_UTTS, EVAL_SEED, dim=EVAL_DIM)
        V = len(jax_asr.build_vocab(texts.values()))
        tpl = jax_asr._ctc_model(V, EVAL_WIDTH, arch="transformer").init(
            jax.random.PRNGKey(0), jnp.zeros((2, 16, EVAL_DIM)),
            jnp.ones((2,), jnp.int32))["params"]
        init = numpy_params(jax.tree_util.tree_map(np.asarray, tpl),
                            EVAL_SEED)
        orig_model = jax_asr._ctc_model

        class Injected:
            def __init__(self, inner, params):
                self.inner, self.params = inner, params

            def init(self, *a, **k):
                return {"params": self.params}

            def apply(self, *a, **k):
                return self.inner.apply(*a, **k)

        losses, lm_losses = [], []
        real = jax.jit
        jax_asr._ctc_model = lambda *a, **k: Injected(orig_model(*a, **k),
                                                       init)
        jax.jit = _recording_jit(real, losses)
        try:
            rec = jax_asr.train_ctc(root, steps=EVAL_STEPS,
                                    batch_size=EVAL_BATCH, width=EVAL_WIDTH,
                                    seed=0, log_every=0, arch="transformer")
            itos, _ = jax_nlm._build_vocab(texts.values())
            lm = jax_nlm.CharLstmLM(itos, embed=EVAL_LM["embed"],
                                    hidden=EVAL_LM["hidden"],
                                    layers=EVAL_LM["layers"])
            lm_tpl = lm.net.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 4), jnp.int32))["params"]
            lm.net = Injected(lm.net, numpy_params(
                jax.tree_util.tree_map(np.asarray, lm_tpl), EVAL_SEED + 1))
            jax.jit = _recording_jit(real, lm_losses)
            lm.train(texts.values(), steps=EVAL_LM["steps"],
                     batch=EVAL_LM["batch"])
            lm.net = lm.net.inner
        finally:
            jax_asr._ctc_model = orig_model
            jax.jit = real
        scp = root / "feats.scp"
        greedy = rec.transcribe_scp(scp, **EVAL_DECODE)
        beam = rec.transcribe_scp(scp, lm=lm, **EVAL_DECODE, **EVAL_BEAM)
        utts = sorted(texts)
        rec.save(FIXTURES / "eval_golden_final.msgpack")
    np.savez(FIXTURES / "eval_golden.npz", losses=np.array(losses),
             lm_losses=np.array(lm_losses), lm_logp=lm_table(lm),
             greedy=np.array([greedy[u] for u in utts]),
             beam=np.array([beam[u] for u in utts]),
             config=np.array(json.dumps(fixture_config())))
    print(f"losses {losses}\nlm losses {lm_losses}\n"
          f"greedy {[greedy[u] for u in utts]}\n"
          f"beam {[beam[u] for u in utts]}")


if __name__ == "__main__":
    sys.exit(generate())
