"""Export checkpoints to the reference PyTorch toolkit's format.

Counterpart of ``vae_npvc_tpu/utils/torch_export.py``, the inverse of
:mod:`utils.torch_convert`: a msgpack checkpoint (the JAX trainer's or the
port's) becomes ``torch.save({'model': state_dict, 'iteration': N})``,
which the reference's ``--checkpoint`` resume path loads. Per layer:

- WNConv1d ``{v (k, in, out), g (out,), b}`` -> a weight-normed Conv1d
  ``weight_v (out, in, k)``, ``weight_g (out, 1, 1)``, ``bias``;
- the ``wn_dim='in'`` forward convs that stand in for stride-1
  ConvTranspose1d -> ``weight_v (in, out, k)`` with the kernel flip undone,
  ``weight_g (in, 1, 1)``; a strided WNConvTranspose1d without the flip;
- GroupNorm scale/bias -> weight/bias, a Dense kernel -> Linear weight.T;
- the EMA codebook state -> ``emb_init`` (bool), ``embeddings``,
  ``emb_sum``, ``emb_elem``.

A checkpoint older than ``utils/migrate.WN_AXIS_FORMAT`` is migrated in
memory first, so the exported ``g`` always follows torch's axis.
"""

from __future__ import annotations

import numpy as np

from .torch_convert import HIERARCHIES, hierarchy_options, model_short_name


def _wn_sd(p, prefix, sd, v):
    """``v`` (already in torch's layout), ``g`` and ``b`` of layer ``p``."""
    if "g" in p:
        sd[f"{prefix}.weight_v"] = v.astype(np.float32)
        sd[f"{prefix}.weight_g"] = np.asarray(p["g"]).reshape(
            -1, 1, 1).astype(np.float32)
    else:
        sd[f"{prefix}.weight"] = v.astype(np.float32)
    sd[f"{prefix}.bias"] = np.asarray(p["b"]).astype(np.float32)


def _conv_sd(p, prefix, sd):
    """WNConv1d (``wn_dim='out'``) -> torch Conv1d (out, in, k)."""
    _wn_sd(p, prefix, sd, np.transpose(np.asarray(p["v"]), (2, 1, 0)).copy())


def _deconv1_sd(p, prefix, sd):
    """Flipped forward conv (``wn_dim='in'``) -> stride-1 ConvTranspose1d
    (in, out, k)."""
    v = np.asarray(p["v"])[::-1]                          # undo the flip
    _wn_sd(p, prefix, sd, np.transpose(v, (1, 2, 0)).copy())


def _deconvs_sd(p, prefix, sd):
    """Strided WNConvTranspose1d (no flip in its layout) -> (in, out, k)."""
    _wn_sd(p, prefix, sd, np.transpose(np.asarray(p["v"]), (1, 2, 0)).copy())


def _norm_sd(p, prefix, sd):
    sd[f"{prefix}.weight"] = np.asarray(p["scale"]).astype(np.float32)
    sd[f"{prefix}.bias"] = np.asarray(p["bias"]).astype(np.float32)


def _dense_sd(p, prefix, sd):
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).T.copy().astype(
        np.float32)
    sd[f"{prefix}.bias"] = np.asarray(p["bias"]).astype(np.float32)


def _encoder_sd(tree, prefix, enc_arch, sd, z_proj_name=None):
    """Inverse of ``torch_convert._encoder_tree``."""
    stacks = enc_arch.get("stacks", [3])
    stack_layers = enc_arch.get("stack_layers", 2)
    seq = 0
    for i, n_stack in enumerate(stacks):
        _conv_sd(tree[f"conv_{i}"], f"{prefix}.encode.{seq}", sd)
        seq += 1
        for j in range(n_stack):
            blk = tree[f"stack_{i}_{j}"]
            base = f"{prefix}.encode.{seq}"
            for layer in range(stack_layers):
                _conv_sd(blk[f"conv_{layer}"],
                         f"{base}.stack.{3 * layer + 1}", sd)
                _norm_sd(blk[f"norm_{layer}"],
                         f"{base}.stack.{3 * layer + 2}", sd)
            _conv_sd(blk["skip"], f"{base}.skip_layer", sd)
            seq += 1
        seq += 1  # LeakyReLU
    _conv_sd(tree["proj"], f"{prefix}.{z_proj_name}" if z_proj_name
             else f"{prefix}.encode.{seq}", sd)


def _decoder_sd(tree, prefix, dec_arch, sd):
    """Inverse of ``torch_convert._decoder_tree``."""
    d_stacks = dec_arch.get("stacks", [3])
    upsample = dec_arch.get("upsample_scales", [1] * len(d_stacks))
    li = 0
    for i, (n_stack, us) in enumerate(zip(d_stacks, upsample)):
        base = f"{prefix}.layers.{li}"
        (_deconv1_sd if us == 1 else _deconvs_sd)(tree[f"up_{i}"], base, sd)
        li += 1
        for j in range(n_stack):
            blk = tree[f"stack_{i}_{j}"]
            base = f"{prefix}.layers.{li}"
            _deconv1_sd(blk["conv_in"], f"{base}.conv_in", sd)
            _norm_sd(blk["norm"], f"{base}.norm_layer", sd)
            _conv_sd(blk["res_skip"], f"{base}.res_skip_layers", sd)
            if "conv_cond" in blk:
                _conv_sd(blk["conv_cond"], f"{base}.conv_cond", sd)
            li += 1
    _conv_sd(tree["final_0"], f"{prefix}.final_layer.1", sd)
    _conv_sd(tree["final_1"], f"{prefix}.final_layer.3", sd)


def _ema_sd(state, prefix, sd):
    """EMA state entries -> the reference's EMA quantizer buffers."""
    sd[f"{prefix}.emb_init"] = np.asarray(state["initted"], bool).reshape(())
    sd[f"{prefix}.embeddings"] = np.asarray(state["emb"]).astype(np.float32)
    sd[f"{prefix}.emb_sum"] = np.asarray(state["emb_sum"]).astype(np.float32)
    sd[f"{prefix}.emb_elem"] = np.asarray(state["emb_elem"]).astype(
        np.float32)


def _gst_sd(tree, prefix, sd):
    sd[f"{prefix}.gst_embs"] = np.asarray(tree["gst_embs"]).astype(np.float32)
    for n in ("linear_q", "linear_k", "linear_v", "linear_out"):
        _dense_sd(tree["mha"][n], f"{prefix}.mha.{n}", sd)


def _embedding(tree):
    return np.asarray(tree["embedding"]).astype(np.float32)


def export_flat_vqvae(params, ema, config):
    """Flat VQ-VAE ``(params, ema collection)`` -> reference state_dict."""
    sd = {}
    _encoder_sd(params["encoder"], "encoder", config.get("encoder", {}), sd)
    _decoder_sd(params["decoder"], "decoder", config.get("decoder", {}), sd)
    sd["embeds._embedding.weight"] = _embedding(params["embeds"])
    if config.get("use_ema", False):
        _ema_sd(ema["quantizer"], "quantizer", sd)
    else:
        sd["quantizer.embeddings"] = np.asarray(
            params["quantizer_embedding"]).astype(np.float32)
    return sd


def export_vqvae2_family(params, ema, config):
    """vqvae2 / vqvae2a / vqvae2b trees -> reference state_dict."""
    short, levels, use_gst, use_ema, use_quantizers, use_embeds = \
        hierarchy_options(config)
    sd = {}
    for i in range(levels):
        _encoder_sd(params[f"encoder_{i}"], f"encoders.{i}",
                    config[f"encoder.{i}"], sd, z_proj_name="z_proj")
        _decoder_sd(params[f"decoder_{i}"], f"decoders.{i}",
                    config[f"decoder.{i}"], sd)
    if short == "vqvae2b":
        _decoder_sd(params["final_decoder"], "final_decoder",
                    config["final_decoder"], sd)

    if short == "vqvae2":
        sd["embeds._embedding.weight"] = _embedding(params["embeds"])
    elif short == "vqvae2b" or use_embeds:
        for i in range(levels):
            sd[f"embeds.{i}._embedding.weight"] = _embedding(
                params[f"embeds_{i}"])
    else:
        sd["embed._embedding.weight"] = _embedding(params["embed"])

    if not use_quantizers:  # one shared quantizer (vqvae2a)
        if use_ema:
            _ema_sd(ema["quantizer"], "quantizer", sd)
        else:
            sd["quantizer.embeddings"] = np.asarray(
                params["quantizer_embedding"]).astype(np.float32)
    else:
        for i in range(levels):
            if use_gst and i == levels - 1:
                _gst_sd(params["gst"], f"quantizers.{i}", sd)
            elif use_ema:
                _ema_sd(ema[f"quantizer_{i}"], f"quantizers.{i}", sd)
            else:
                sd[f"quantizers.{i}.embeddings"] = np.asarray(
                    params[f"quantizer_embedding_{i}"]).astype(np.float32)
    return sd


def export_checkpoint_file(ckpt_path, config, out_path):
    """A msgpack checkpoint -> a reference ``.pt`` file at ``out_path``;
    returns its iteration."""
    import torch

    from . import msgpack_io
    from .migrate import WN_AXIS_FORMAT, maybe_migrate_model

    with open(ckpt_path, "rb") as f:
        payload = msgpack_io.msgpack_restore(f.read())
    template = payload["model"]
    if payload.get("wn_axis_format", 1) < WN_AXIS_FORMAT:
        # the model's own tree tells a per-input g from a per-output one
        from ..models import build_model
        from .bridge import to_jax_variables

        template = to_jax_variables(build_model(
            config, device="cpu").state_dict())["params"]
    model_tree, _ = maybe_migrate_model(payload, template)
    ema_tree = payload.get("ema", {}).get("ema", payload.get("ema", {}))
    if model_short_name(config) in HIERARCHIES:
        sd = export_vqvae2_family(model_tree, ema_tree, config)
    else:
        sd = export_flat_vqvae(model_tree, ema_tree, config)
    state = {k: (torch.from_numpy(np.ascontiguousarray(v)) if v.ndim
                 else torch.tensor(v.item())) for k, v in sd.items()}
    for k in state:
        if k.endswith(".emb_init"):
            state[k] = state[k].bool()
    iteration = int(payload.get("iteration", 0))
    torch.save({"model": state, "iteration": iteration}, out_path)
    return iteration
