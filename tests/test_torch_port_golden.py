"""The committed JAX golden fixture of the PyTorch port.

``tests/torch_port_fixtures/`` holds a tiny flat EMA VQ-VAE checkpoint in
the JAX package's msgpack format (random weights from fixed seeds, a normal
codebook), a padded input batch, and JAX's ids and mel for it. A host with
the port but without JAX (``chip_smoke.py`` on a GPU machine) holds the
port against these outputs. Regenerate with

    python -m tests.test_torch_port_golden

(from the repo root, with JAX on the CPU at full matmul precision, as
``tests/conftest.py`` sets it).
"""

import json
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)
FIXTURES = Path(__file__).resolve().parent / "torch_port_fixtures"

GOLDEN_CONFIG = {
    "model_type": "vae_npvc.model.vqvae",
    "compute_dtype": "float32",
    "y_dim": 16, "y_num": 4, "z_dim": 16, "z_num": 32,
    "use_ema": True, "beta": 0.01, "mu": 0.9, "jitter_p": 0.0,
    "use_pallas_vq": False,
    "decode_bucket_size": 16, "decode_batch_size": 4,
    "encoder": {"in_channels": [20], "out_channels": [32], "kernel_size": 3,
                "downsample_scales": [1], "z_channels": 16,
                "dilation": False, "stack_kernel_size": 3,
                "stack_layers": 1, "stacks": [2], "use_weight_norm": True},
    "decoder": {"in_channels": [16], "out_channels": [32],
                "cond_channels": 16, "skip_channels": 16,
                "final_channels": 20, "kernel_size": 3,
                "upsample_scales": [1], "dilation": False,
                "stack_kernel_size": 3, "stacks": [2],
                "use_weight_norm": True},
}


def make_golden():
    """Build the fixture with JAX: (checkpoint bytes, arrays dict)."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from vae_npvc_tpu.models import build_model
    from vae_npvc_tpu.ops.vq import EmaVqState

    cfg = GOLDEN_CONFIG
    model = build_model(cfg)
    rng = np.random.default_rng(20261016)
    B, T, D = 3, 48, 20
    feats = rng.normal(size=(B, T, D)).astype(np.float32)
    lengths = np.array([48, 30, 5], np.int32)
    feats[np.arange(T)[None, :] >= lengths[:, None]] = 0.0
    tgts = np.array([0, 3, 1], np.int32)
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "vq": jax.random.PRNGKey(1)},
                           jnp.asarray(feats), jnp.asarray(tgts), train=True)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])

    # GroupNorm affine away from its (1, 0) init, so the test sees it
    def perturb(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = perturb(v)
            elif k == "scale":
                out[k] = (1.0 + 0.2 * rng.normal(size=v.shape)).astype(
                    np.float32)
            elif k == "bias":
                out[k] = (0.2 * rng.normal(size=v.shape)).astype(np.float32)
            else:
                out[k] = v
        return out

    params = perturb(params)
    K, Dz = cfg["z_num"], cfg["z_dim"]
    z = np.asarray(model.apply(
        {"params": params, "ema": variables["ema"]}, jnp.asarray(feats),
        jnp.asarray(lengths),
        method=lambda m, x, n: m.encoder(x, n))).reshape(-1, Dz)
    # a codebook at the latents' scale, so many codes are used
    emb = (rng.normal(size=(K, Dz)) * z.std()).astype(np.float32)
    ema = {"quantizer": {"initted": np.array(True), "emb": emb,
                         "emb_sum": emb.copy(),
                         "emb_elem": np.ones((K,), np.float32)}}
    jvars = {"params": params,
             "ema": {"quantizer": EmaVqState(**ema["quantizer"])}}
    ids = np.asarray(model.apply(jvars, jnp.asarray(feats),
                                 jnp.asarray(lengths), method="encode"))
    mel = np.asarray(model.apply(jvars, jnp.asarray(feats),
                                 jnp.asarray(tgts), jnp.asarray(lengths),
                                 method="infer"))
    dist = (emb.astype(np.float64) ** 2).sum(1)[None] \
        - 2 * z.astype(np.float64) @ emb.T.astype(np.float64)
    top2 = np.sort(dist, axis=1)[:, :2]
    gap = (top2[:, 1] - top2[:, 0]) / np.maximum(np.abs(top2[:, 0]), 1.0)
    payload = {"model": params, "ema": {"ema": ema}, "optimizer": {},
               "iteration": 0, "wn_axis_format": 2}
    return serialization.msgpack_serialize(payload), {
        "feats": feats, "tgts": tgts, "lengths": lengths, "ids": ids,
        "mel": mel, "min_rel_gap": np.float64(gap.min())}


def write_golden(out_dir=FIXTURES):
    ckpt, arrays = make_golden()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "golden.msgpack").write_bytes(ckpt)
    np.savez_compressed(out_dir / "golden.npz", **arrays)
    (out_dir / "golden_config.json").write_text(
        json.dumps(GOLDEN_CONFIG, indent=1) + "\n")


def test_committed_fixture_matches_jax():
    """Regenerating with JAX reproduces the committed fixture."""
    from flax import serialization

    ckpt, arrays = make_golden()
    committed = np.load(FIXTURES / "golden.npz")
    assert json.loads((FIXTURES / "golden_config.json").read_text()) \
        == GOLDEN_CONFIG
    a = serialization.msgpack_restore(ckpt)
    b = serialization.msgpack_restore(
        (FIXTURES / "golden.msgpack").read_bytes())
    import jax
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for k in ("feats", "tgts", "lengths", "ids"):
        np.testing.assert_array_equal(arrays[k], committed[k])
    np.testing.assert_allclose(arrays["mel"], committed["mel"], atol=1e-5)
    # no near ties: exact id comparison on another device is meaningful
    assert float(committed["min_rel_gap"]) > 1e-4
    assert (FIXTURES / "golden.msgpack").stat().st_size \
        + (FIXTURES / "golden.npz").stat().st_size < 200_000


def test_port_matches_fixture_on_cpu():
    """The port's Converter on the CPU reproduces JAX's ids and mel."""
    from vae_npvc_tpu_torch.infer.convert import Converter

    g = np.load(FIXTURES / "golden.npz")
    cv = Converter(GOLDEN_CONFIG, device="cpu")
    cv.load_checkpoint(FIXTURES / "golden.msgpack")
    mel = cv.infer(g["feats"], g["tgts"], g["lengths"])
    with torch.inference_mode():
        ids = cv.model.encode(torch.from_numpy(g["feats"]),
                              torch.from_numpy(g["lengths"])).numpy()
    for b, n in enumerate(g["lengths"]):
        np.testing.assert_array_equal(ids[b, :n], g["ids"][b, :n])
        np.testing.assert_allclose(mel[b, :n], g["mel"][b, :n], atol=1e-4)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    write_golden()
