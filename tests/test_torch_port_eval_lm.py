"""The PyTorch port's character LSTM LM against the JAX package, on the
CPU.

Flax's ``OptimizedLSTMCell_{i}`` parameters (``utils/eval_fixture``
``numpy_params``) are loaded into the port's ``torch.nn.LSTM`` through
``utils/bridge.params_from_flax``: ``logp``/``logp_eos``/``next_logps``
through the incremental cache agree within 1e-5, the parameter tree comes
back unchanged, and six Adam steps from the same parameters on the same
numpy-drawn batches keep JAX's losses within 1e-4 relative (JAX's are read
from its log lines, printed to 4 decimals: plus 5e-5) and its parameters
within 1e-3 of each leaf's peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_npvc_tpu.eval import neural_lm as jax_nlm
from vae_npvc_tpu_torch.eval import neural_lm
from vae_npvc_tpu_torch.utils.bridge import (_flatten, params_from_flax,
                                             params_to_flax)
from vae_npvc_tpu_torch.utils.eval_fixture import numpy_params

torch.set_num_threads(1)

TEXTS = ["the cat", "a cab", "abc abc", "tac", "bat cat", "cc a"]


def _pair(layers=2, seed=3):
    itos, _ = jax_nlm._build_vocab(TEXTS)
    j = jax_nlm.CharLstmLM(itos, embed=8, hidden=16, layers=layers)
    tpl = j.net.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    params = numpy_params(jax.tree_util.tree_map(np.asarray, tpl["params"]),
                          seed)
    p = neural_lm.CharLstmLM(itos, embed=8, hidden=16, layers=layers,
                             device="cpu")
    return j, p, params


@pytest.mark.parametrize("layers", [1, 2])
def test_logp_through_the_cache_agrees(layers):
    j, p, params = _pair(layers)
    j.params = params
    p.params = params
    assert neural_lm.BOS == jax_nlm.BOS and neural_lm.EOS == jax_nlm.EOS
    assert p.vocab == j.vocab
    for ctx in ["", "t", "the c", "a cab", "abc abc ab", "qz", "cat q"]:
        for c in p.vocab + ["q"]:
            assert abs(p.logp(ctx, c) - j.logp(ctx, c)) <= 1e-5, (ctx, c)
        assert abs(p.logp_eos(ctx) - j.logp_eos(ctx)) <= 1e-5
        np.testing.assert_allclose(p.next_logps(ctx, list("abq")),
                                   j.next_logps(ctx, list("abq")),
                                   rtol=0, atol=1e-5)
    _, logps = p._state(tuple("the"))
    assert abs(float(np.exp(logps).sum()) - 1.0) < 1e-5


def test_bridge_round_trip_and_zero_input_bias():
    _, p, params = _pair()
    sd = params_from_flax(params)
    assert sd["OptimizedLSTMCell_0.weight_ih_l0"].shape == (4 * 16, 8)
    assert sd["OptimizedLSTMCell_1.weight_ih_l0"].shape == (4 * 16, 16)
    assert not any("bias_ih" in k for k in sd)
    back, want = {}, {}
    _flatten(params_to_flax(sd), "", back)
    _flatten(params, "", want)
    assert list(back) == sorted(back) and set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    # flax's cell has no input bias: the port's is a zero buffer, neither
    # saved nor trained, and a state_dict that carries one is refused
    p.params = params
    for i in range(2):
        layer = getattr(p.net, f"OptimizedLSTMCell_{i}")
        assert not layer.bias_ih_l0.any()
        name = f"OptimizedLSTMCell_{i}.bias_ih_l0"
        assert name not in p.net.state_dict()
        assert name not in dict(p.net.named_parameters())
    sd["OptimizedLSTMCell_0.bias_ih_l0"] = torch.ones(4 * 16)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        p.net.load_state_dict(sd)


def test_six_adam_steps_lockstep(capsys):
    j, p, params = _pair()
    inner = j.net

    class Injected:
        def init(self, *a, **k):
            return {"params": params}

        def apply(self, *a, **k):
            return inner.apply(*a, **k)

    j.net = Injected()
    j.train(TEXTS, steps=6, batch=4, lr=2e-3, seed=5, log_every=1)
    want = [float(line.rsplit(" ", 1)[1]) for line in
            capsys.readouterr().out.splitlines() if line.startswith("lm ")]
    losses = []
    p.train(TEXTS, steps=6, batch=4, lr=2e-3, seed=5, params=params,
            losses=losses)
    assert len(want) == len(losses) == 6
    np.testing.assert_allclose(losses, want, rtol=1e-4, atol=5e-5)
    got, ref = {}, {}
    _flatten(p.params, "", got)
    _flatten(jax.tree_util.tree_map(np.asarray, j.params), "", ref)
    assert set(got) == set(ref)
    for k in ref:
        peak = float(np.abs(ref[k]).max())
        assert np.abs(got[k] - ref[k]).max() <= 1e-3 * peak, k
    assert not p.net.OptimizedLSTMCell_0.bias_ih_l0.any()  # never trained


def test_train_char_lm_trains_on_its_own():
    lm = neural_lm.train_char_lm(TEXTS * 3, steps=60, embed=16, hidden=32,
                                 layers=1, device="cpu")
    # "the ca" continues with "t" in the corpus
    assert lm.logp("the ca", "t") > lm.logp("the ca", "b") + 0.3
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        neural_lm.train_char_lm(TEXTS, steps=1)
