"""PyTorch port training forward and data pipeline vs the JAX package.

``Model.forward`` (loss, detail, every parameter gradient) against
``jax.grad`` of the flax model from bridged weights, for the EMA and the
plain-VQ flat model; the dataset's index and batch iterators against the
JAX package's on a toy Kaldi directory. fp32 on the CPU. Tolerances: loss
and detail 1e-5 relative, gradients 2e-5 of each gradient's peak
(summation order through ~10 layers), batches and indices exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.toy_config import toy_config
from vae_npvc_tpu.data import dataset as jds
from vae_npvc_tpu.data.kaldi_io import ArkWriter as JaxArkWriter
from vae_npvc_tpu.models import build_model as jax_build_model
from vae_npvc_tpu.models import codebook_renorm_fn as jax_renorm_fn
from vae_npvc_tpu.ops.vq import EmaVqState
from vae_npvc_tpu_torch.data import dataset as pds
from vae_npvc_tpu_torch.data import kaldi_io
from vae_npvc_tpu_torch.models import build_model, codebook_renorm_fn
from vae_npvc_tpu_torch.utils.bridge import _flatten, from_jax_variables

torch.set_num_threads(1)


def _pair(use_ema, seed=0):
    """(config, flax model, JAX variables, port model, batch)."""
    cfg = dict(toy_config(), compute_dtype="float32", use_ema=use_ema,
               z_num=6)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 24, 10)).astype(np.float32)
    y = np.array([2, 0, 1], np.int32)
    jm = jax_build_model(cfg)
    v = jm.init({"params": jax.random.PRNGKey(0),
                 "vq": jax.random.PRNGKey(1)}, jnp.asarray(x),
                jnp.asarray(y), train=True)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    for name in ("norm_0",):   # GroupNorm affine away from (1, 0)
        p = params["encoder"]["stack_0_0"][name]
        p["scale"] = rng.normal(1.0, 0.2, p["scale"].shape).astype(np.float32)
        p["bias"] = rng.normal(0.0, 0.2, p["bias"].shape).astype(np.float32)
    variables = {"params": params}
    jvars = {"params": params}
    if use_ema:
        z = np.asarray(jm.apply({"params": params, "ema": v["ema"]},
                                jnp.asarray(x),
                                method=lambda m, a: m.encoder(a)))
        emb = z.reshape(-1, z.shape[-1])[::12][:6].copy()
        elem = np.full((6,), 4.0, np.float32)
        q = {"initted": np.array(True), "emb": emb,
             "emb_sum": emb * elem[:, None], "emb_elem": elem}
        variables["ema"] = {"quantizer": q}
        jvars["ema"] = {"quantizer": EmaVqState(**q)}
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return cfg, jm, jvars, pm, (x, y)


@pytest.mark.parametrize("use_ema", [True, False])
def test_model_forward_loss_detail_and_gradients_match_jax(use_ema):
    cfg, jm, jvars, pm, (x, y) = _pair(use_ema)
    mutable = ["ema"] if use_ema else False

    def loss_fn(params):
        out = jm.apply({**jvars, "params": params}, jnp.asarray(x),
                       jnp.asarray(y), train=True, mutable=mutable,
                       rngs={"vq": jax.random.PRNGKey(2)})
        (xhat, loss, detail), mut = out if use_ema else (out, {})
        return loss, (xhat, detail, mut)

    (jloss, (jxhat, jdetail, jmut)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(jvars["params"])
    gen = torch.Generator().manual_seed(0)
    xhat, loss, detail = pm(torch.from_numpy(x), torch.from_numpy(y), True,
                            gen=gen)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(loss, list(pm.parameters()))

    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(xhat.detach().numpy(), np.asarray(jxhat),
                               atol=1e-4)
    assert set(detail) == set(jdetail)
    assert {"Total", "VQ loss", "X like"} <= set(detail)
    for k in detail:
        np.testing.assert_allclose(float(detail[k].detach()),
                                   float(jdetail[k]), rtol=1e-5, atol=1e-6)
    flat = {}
    _flatten(jax.tree_util.tree_map(np.asarray, jgrads), "", flat)
    assert set(flat) == set(names)
    for n, g in zip(names, grads):
        peak = max(float(np.abs(flat[n]).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), flat[n], atol=2e-5 * peak,
                                   err_msg=n)
    if use_ema:
        assert {"entropy", "used_curr", "usage", "diff_emb"} <= set(detail)
        assert float(detail["usage"]) == 6       # no restart: no draws used
        new = jmut["ema"]["quantizer"]
        for a, b in zip(pm.pending_ema[1:], new[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        # the forward left the buffers alone
        np.testing.assert_array_equal(
            pm.quantizer.emb.numpy(), np.asarray(jvars["ema"]["quantizer"].emb))
    else:
        assert pm.pending_ema is None and "entropy" in detail


def test_model_valid_forward_and_remat_and_parallel_keys():
    cfg, jm, jvars, pm, (x, y) = _pair(True, seed=1)
    jx, jl, jd = jm.apply(jvars, jnp.asarray(x), jnp.asarray(y), train=False)
    with torch.no_grad():
        _, loss, detail = pm(torch.from_numpy(x), torch.from_numpy(y), False)
    assert set(detail) == set(jd) == {"Total", "VQ loss", "X like"}
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert pm.pending_ema is None
    # remat recomputes the encoder/decoder in the backward: same gradients
    rm = build_model(dict(cfg, remat=True), device="cpu")
    rm.load_state_dict(pm.state_dict())
    outs = []
    for m in (pm, rm):
        _, loss, _ = m(torch.from_numpy(x), torch.from_numpy(y), True,
                       gen=torch.Generator().manual_seed(0))
        outs.append(torch.autograd.grad(loss, list(m.parameters())))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    # the parallel keys build; the model carries the axis name, and a
    # training forward outside a bound axis raises naming it
    for key in ("seq_axis", "dp_axis"):
        m = build_model(dict(cfg, **{key: "data"}), device="cpu")
        assert getattr(m, key) == "data"
        m.load_state_dict(pm.state_dict())
    with pytest.raises(ValueError, match="'data' is not bound"):
        m(torch.from_numpy(x), torch.from_numpy(y), True,
          gen=torch.Generator().manual_seed(0))


def test_codebook_renorm_matches_jax():
    cfg = dict(toy_config(), use_ema=False)
    assert codebook_renorm_fn(toy_config()) is None
    assert codebook_renorm_fn(dict(cfg, embed_norm=False)) is None
    assert jax_renorm_fn(dict(cfg, embed_norm=False)) is None
    pm = build_model(cfg, device="cpu").init_random(3)
    emb = (pm.quantizer_embedding.detach().numpy() * 3.0).copy()
    with torch.no_grad():
        pm.quantizer_embedding.copy_(torch.from_numpy(emb))
    codebook_renorm_fn(cfg)(pm)
    want = jax_renorm_fn(cfg)({"quantizer_embedding": jnp.asarray(emb)})
    np.testing.assert_allclose(pm.quantizer_embedding.detach().numpy(),
                               np.asarray(want["quantizer_embedding"]),
                               atol=1e-6)


# ----------------------------------------------------------------- dataset
@pytest.fixture(scope="module")
def toy_kaldi_dir(tmp_path_factory):
    """7 utterances of 9..60 frames x 10 dims, written by the JAX
    package's ark writer; one is shorter than the crop."""
    d = tmp_path_factory.mktemp("kaldi")
    rng = np.random.default_rng(0)
    lens = [30, 9, 45, 60, 22, 38, 51]
    with JaxArkWriter(d / "feats.ark", d / "feats.scp") as w:
        for i, n in enumerate(lens):
            w.write(f"utt{i}", rng.normal(size=(n, 10)).astype(np.float32))
    (d / "utt2num_frames").write_text(
        "".join(f"utt{i} {n}\n" for i, n in enumerate(lens)))
    (d / "utt2spk_id").write_text(
        "".join(f"utt{i} {i % 3}\n" for i in range(len(lens))))
    return d


def test_dataset_and_iterators_match_jax(toy_kaldi_dir):
    cfg = {"crop_length": 16, "use_native_loader": False}
    jset = jds.UttMelSpkDataset(toy_kaldi_dir, cfg)
    pset = pds.UttMelSpkDataset(toy_kaldi_dir, cfg)
    assert len(pset) == len(jset) == 7
    assert pset.feat_dim() == jset.feat_dim() == 10
    assert pset.padded_nbytes() == jset.padded_nbytes()
    for a, b in zip(pset.padded_arrays(num_workers=0),
                    jset.padded_arrays(num_workers=0)):
        np.testing.assert_array_equal(a, b)
    kw = dict(shuffle=True, drop_last=True, seed=5, epochs=3)
    pairs_p = list(pds.index_iterator(pset, 3, **kw))
    pairs_j = list(jds.index_iterator(jset, 3, **kw))
    assert len(pairs_p) == len(pairs_j) == 6
    for (pi, ps), (ji, js) in zip(pairs_p, pairs_j):
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(ps, js)
    for workers in (0, 2):
        bp = list(pds.batch_iterator(pset, 3, num_workers=workers, **kw))
        bj = list(jds.batch_iterator(jset, 3, num_workers=workers, **kw))
        for (pf, py), (jf, jy) in zip(bp, bj):
            assert pf.shape == (3, 16, 10) and pf.dtype == np.float32
            np.testing.assert_array_equal(pf, jf)
            np.testing.assert_array_equal(py, jy)
    # validation: start 0, one pass, last partial batch kept
    pv = pds.UttMelSpkDataset(toy_kaldi_dir, dict(cfg, valid_crop_length=12),
                              valid=True)
    jv = jds.UttMelSpkDataset(toy_kaldi_dir, dict(cfg, valid_crop_length=12),
                              valid=True)
    vb = list(pds.batch_iterator(pv, 4, shuffle=False, drop_last=False,
                                 num_workers=0, epochs=1))
    vj = list(jds.batch_iterator(jv, 4, shuffle=False, drop_last=False,
                                 num_workers=0, epochs=1))
    assert [b[0].shape[0] for b in vb] == [4, 3]
    for (pf, py), (jf, jy) in zip(vb, vj):
        np.testing.assert_array_equal(pf, jf)
        np.testing.assert_array_equal(py, jy)
    with pytest.raises(ValueError, match="batch_size"):
        next(pds.index_iterator(pset, 8, shuffle=True, drop_last=True))


def test_kaldi_io_ranges_compressed_and_writer(toy_kaldi_dir, tmp_path):
    scp = kaldi_io.load_dict_data(toy_kaldi_dir / "feats.scp")
    full = kaldi_io.load_mat(scp["utt3"])
    assert full.shape == (60, 10) == kaldi_io.matrix_header(scp["utt3"])
    np.testing.assert_array_equal(
        kaldi_io.load_mat(scp["utt3"] + "[5:20]"), full[5:21])
    np.testing.assert_array_equal(
        kaldi_io.load_mat(scp["utt3"] + "[5:20,2:4]"), full[5:21, 2:5])
    assert kaldi_io.matrix_header(scp["utt3"] + "[5:20,2:4]") == (16, 3)
    assert kaldi_io.load_list_data(toy_kaldi_dir / "utt2spk_id")[1] \
        == ["utt1", "1"]
    # compressed arks as the JAX package writes them
    from vae_npvc_tpu.data import kaldi_io as jio
    for method in (1, 2):
        with JaxArkWriter(tmp_path / f"c{method}.ark",
                          tmp_path / f"c{method}.scp", method) as w:
            w.write("u", full)
        rx = kaldi_io.load_dict_data(tmp_path / f"c{method}.scp")["u"]
        np.testing.assert_array_equal(kaldi_io.load_mat(rx), jio.load_mat(rx))
        np.testing.assert_array_equal(kaldi_io.load_mat(rx + "[3:9]"),
                                      jio.load_mat(rx + "[3:9]"))
        assert kaldi_io.matrix_header(rx) == (60, 10)
    # the port's writer is read back by both packages
    with kaldi_io.ArkWriter(tmp_path / "w.ark", tmp_path / "w.scp") as w:
        w.write("a", full)
        w.write("b", full[:4].astype(np.float64))
    back = kaldi_io.load_dict_data(tmp_path / "w.scp")
    np.testing.assert_array_equal(jio.load_mat(back["a"]), full)
    np.testing.assert_array_equal(kaldi_io.load_mat(back["b"]),
                                  full[:4].astype(np.float64))
    assert dict(kaldi_io.read_ark(tmp_path / "w.ark"))["a"].shape == (60, 10)
