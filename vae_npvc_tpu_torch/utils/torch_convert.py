"""Convert reference PyTorch checkpoints to the JAX package's format.

Counterpart of ``vae_npvc_tpu/utils/torch_convert.py``: a
``torch.save({'model': state_dict, 'iteration': N})`` checkpoint of the
reference toolkit's flat VQ-VAE or its vqvae2 / vqvae2a / vqvae2b becomes
the msgpack checkpoint ``bin/train`` writes (``{model, ema, optimizer: {},
iteration, wn_axis_format}``), which the port and the JAX package both
load. The effective weights are kept exactly:

- a weight-normed conv maps its ``(g, v)`` directly (torch normalizes
  over dim 0, which is the output axis of a Conv1d and the input axis of a
  ConvTranspose1d, the port's ``wn_dim='in'``); a conv without weight norm
  has its ``weight`` taken as ``v`` and ``g`` re-derived as its norm;
- Conv1d weights (out, in, k) become (k, in, out);
- the reference's stride-1 ConvTranspose1d layers are forward convs with
  flipped kernels here: (in, out, k) becomes (k, in, out) reversed along
  k; a strided ConvTranspose1d maps without the flip;
- GroupNorm weight/bias become scale/bias, Linear (out, in) a Dense kernel
  (in, out); embeddings and (EMA) codebook buffers map directly.

The checkpoint is written by the port's own msgpack writer, byte for byte
what the JAX package writes for the same file.
"""

from __future__ import annotations

import numpy as np

HIERARCHIES = ("vqvae2", "vqvae2a", "vqvae2b")


def model_short_name(config, default="vae_npvc.model.vqvae"):
    """``vqvae``, ``vqvae2``, ... of a config's ``model_type``."""
    return config.get("model_type", default).split(":")[0].rsplit(".", 1)[-1]


def hierarchy_options(config):
    """``(short, levels, use_gst, use_ema, use_quantizers, use_embeds)`` of
    a vqvae2-family config, with the reference's defaults."""
    short = model_short_name(config, "vae_npvc.model.vqvae2")
    levels = config.get("levels", 3)
    use_gst = (config.get("use_gst", True)
               if levels > 1 or short == "vqvae2" else False)
    use_ema = config.get("use_ema", True)
    use_quantizers = (config.get("use_quantizers", True)
                      if short == "vqvae2a" else True)
    use_embeds = (config.get("use_embeds", True)
                  if short == "vqvae2a" else True)
    return short, levels, use_gst, use_ema, use_quantizers, use_embeds


def _wn_effective(sd, prefix):
    """Effective weight and bias of a (possibly weight-normed) torch conv."""
    if f"{prefix}.weight_v" in sd:
        v = np.asarray(sd[f"{prefix}.weight_v"], np.float64)
        g = np.asarray(sd[f"{prefix}.weight_g"], np.float64)
        axes = tuple(range(1, v.ndim))  # torch weight_norm dim=0
        norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
        w = (g * v / norm).astype(np.float32)
    else:
        w = np.asarray(sd[f"{prefix}.weight"], np.float32)
    b = np.asarray(sd[f"{prefix}.bias"], np.float32)
    return w, b


def _conv_params(sd, prefix):
    """torch Conv1d (out, in, k) -> WNConv1d {v (k, in, out), g (out,), b}.
    Weight-norm ``(g, v)`` map directly (fine-tuning keeps the reference's
    parameterization); otherwise ``g`` is the per-output-channel norm."""
    if f"{prefix}.weight_v" in sd:
        v = np.transpose(np.asarray(sd[f"{prefix}.weight_v"], np.float32),
                         (2, 1, 0)).copy()
        g = np.asarray(sd[f"{prefix}.weight_g"], np.float32).reshape(-1)
        return {"v": v, "g": g,
                "b": np.asarray(sd[f"{prefix}.bias"], np.float32)}
    w, b = _wn_effective(sd, prefix)
    v = np.transpose(w, (2, 1, 0)).astype(np.float32)
    g = np.linalg.norm(v.reshape(-1, v.shape[-1]), axis=0).astype(np.float32)
    return {"v": v, "g": g, "b": b}


def _deconv1_params(sd, prefix):
    """Stride-1 torch ConvTranspose1d (in, out, k) -> forward WNConv1d with
    ``wn_dim='in'``: ``v[k-1-j, i, o] = W[i, o, j]`` (the flip keeps the
    norms, so ``(g, v)`` map directly when present)."""
    if f"{prefix}.weight_v" in sd:
        wv = np.asarray(sd[f"{prefix}.weight_v"], np.float32)
        v = np.transpose(wv, (2, 0, 1))[::-1].copy()
        g = np.asarray(sd[f"{prefix}.weight_g"], np.float32).reshape(-1)
        return {"v": v, "g": g,
                "b": np.asarray(sd[f"{prefix}.bias"], np.float32)}
    w, b = _wn_effective(sd, prefix)
    v = np.transpose(w, (2, 0, 1))[::-1].copy().astype(np.float32)
    g = np.sqrt(np.sum(v * v, axis=(0, 2))).astype(np.float32)  # (in,)
    return {"v": v, "g": g, "b": b}


def _deconvs_params(sd, prefix):
    """Strided torch ConvTranspose1d -> WNConvTranspose1d, ``v[j, i, o] =
    W[i, o, j]`` (the layer flips inside), ``g`` per input channel."""
    if f"{prefix}.weight_v" in sd:
        wv = np.asarray(sd[f"{prefix}.weight_v"], np.float32)
        v = np.transpose(wv, (2, 0, 1)).copy()
        g = np.asarray(sd[f"{prefix}.weight_g"], np.float32).reshape(-1)
        return {"v": v, "g": g,
                "b": np.asarray(sd[f"{prefix}.bias"], np.float32)}
    w, b = _wn_effective(sd, prefix)
    v = np.transpose(w, (2, 0, 1)).copy().astype(np.float32)
    g = np.sqrt(np.sum(v * v, axis=(0, 2))).astype(np.float32)  # (in,)
    return {"v": v, "g": g, "b": b}


def _norm_params(sd, prefix):
    return {"scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
            "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)}


def _encoder_tree(sd, prefix, enc_arch, z_proj_name=None):
    """Reference Encoder (an ``nn.Sequential``: per stage [Conv1d, stacks,
    LeakyReLU], then the 1x1 projection, or a separate ``z_proj_name``
    module in the hierarchies) -> the encoder tree."""
    out = {}
    stacks = enc_arch.get("stacks", [3])
    stack_layers = enc_arch.get("stack_layers", 2)
    seq = 0
    for i, n_stack in enumerate(stacks):
        out[f"conv_{i}"] = _conv_params(sd, f"{prefix}.encode.{seq}")
        seq += 1
        for j in range(n_stack):
            base = f"{prefix}.encode.{seq}"
            blk = {}
            for layer in range(stack_layers):
                # stack indices: [LeakyReLU, Conv1d, GroupNorm] per layer
                blk[f"conv_{layer}"] = _conv_params(
                    sd, f"{base}.stack.{3 * layer + 1}")
                blk[f"norm_{layer}"] = _norm_params(
                    sd, f"{base}.stack.{3 * layer + 2}")
            blk["skip"] = _conv_params(sd, f"{base}.skip_layer")
            out[f"stack_{i}_{j}"] = blk
            seq += 1
        seq += 1  # LeakyReLU
    out["proj"] = _conv_params(sd, f"{prefix}.{z_proj_name}" if z_proj_name
                               else f"{prefix}.encode.{seq}")
    return out


def _decoder_tree(sd, prefix, dec_arch):
    """Reference Decoder (a ``ModuleList`` of [up, GLU stacks] per stage,
    then ``final_layer``) -> the decoder tree."""
    out = {}
    d_stacks = dec_arch.get("stacks", [3])
    upsample = dec_arch.get("upsample_scales", [1] * len(d_stacks))
    li = 0
    for i, (n_stack, us) in enumerate(zip(d_stacks, upsample)):
        base = f"{prefix}.layers.{li}"
        out[f"up_{i}"] = (_deconv1_params(sd, base) if us == 1
                          else _deconvs_params(sd, base))
        li += 1
        for j in range(n_stack):
            base = f"{prefix}.layers.{li}"
            blk = {"conv_in": _deconv1_params(sd, f"{base}.conv_in"),
                   "norm": _norm_params(sd, f"{base}.norm_layer"),
                   "res_skip": _conv_params(sd, f"{base}.res_skip_layers")}
            if (f"{base}.conv_cond.weight" in sd
                    or f"{base}.conv_cond.weight_v" in sd):
                blk["conv_cond"] = _conv_params(sd, f"{base}.conv_cond")
            out[f"stack_{i}_{j}"] = blk
            li += 1
    out["final_0"] = _conv_params(sd, f"{prefix}.final_layer.1")
    out["final_1"] = _conv_params(sd, f"{prefix}.final_layer.3")
    return out


def _dense_params(sd, prefix):
    """torch Linear (out, in) -> Dense {kernel (in, out), bias}."""
    return {"kernel": np.asarray(sd[f"{prefix}.weight"], np.float32).T.copy(),
            "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)}


def _gst_tree(sd, prefix):
    return {"gst_embs": np.asarray(sd[f"{prefix}.gst_embs"], np.float32),
            "mha": {n: _dense_params(sd, f"{prefix}.mha.{n}")
                    for n in ("linear_q", "linear_k", "linear_v",
                              "linear_out")}}


def _ema_state(sd, prefix):
    """The reference's EMA quantizer buffers -> the EMA state entries."""
    return {"initted": np.asarray(sd[f"{prefix}.emb_init"], bool).reshape(()),
            "emb": np.asarray(sd[f"{prefix}.embeddings"], np.float32),
            "emb_sum": np.asarray(sd[f"{prefix}.emb_sum"], np.float32),
            "emb_elem": np.asarray(sd[f"{prefix}.emb_elem"], np.float32)}


def convert_vqvae2_family(state_dict, config):
    """Reference vqvae2 / vqvae2a / vqvae2b state_dict -> ``(params,
    ema)``."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    short, levels, use_gst, use_ema, use_quantizers, use_embeds = \
        hierarchy_options(config)

    params, ema_col = {}, {}
    for i in range(levels):
        params[f"encoder_{i}"] = _encoder_tree(
            sd, f"encoders.{i}", config[f"encoder.{i}"], z_proj_name="z_proj")
        params[f"decoder_{i}"] = _decoder_tree(
            sd, f"decoders.{i}", config[f"decoder.{i}"])
    if short == "vqvae2b":
        params["final_decoder"] = _decoder_tree(sd, "final_decoder",
                                                config["final_decoder"])

    # speaker embeddings
    if short == "vqvae2":
        params["embeds"] = {"embedding": np.asarray(
            sd["embeds._embedding.weight"], np.float32)}
    elif short == "vqvae2b" or use_embeds:
        for i in range(levels):
            params[f"embeds_{i}"] = {"embedding": np.asarray(
                sd[f"embeds.{i}._embedding.weight"], np.float32)}
    else:
        params["embed"] = {"embedding": np.asarray(
            sd["embed._embedding.weight"], np.float32)}

    # quantizers
    if not use_quantizers:  # one shared quantizer (vqvae2a)
        if use_ema:
            ema_col["quantizer"] = _ema_state(sd, "quantizer")
        else:
            params["quantizer_embedding"] = np.asarray(
                sd["quantizer.embeddings"], np.float32)
    else:
        for i in range(levels):
            if use_gst and i == levels - 1:
                params["gst"] = _gst_tree(sd, f"quantizers.{i}")
            elif use_ema:
                ema_col[f"quantizer_{i}"] = _ema_state(sd,
                                                       f"quantizers.{i}")
            else:
                params[f"quantizer_embedding_{i}"] = np.asarray(
                    sd[f"quantizers.{i}.embeddings"], np.float32)
    return params, ({"ema": ema_col} if ema_col else {})


def convert_flat_vqvae(state_dict, config):
    """Reference flat VQ-VAE state_dict -> ``(params, ema)``."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    params = {
        "encoder": _encoder_tree(sd, "encoder", config.get("encoder", {})),
        "decoder": _decoder_tree(sd, "decoder", config.get("decoder", {})),
        "embeds": {"embedding": np.asarray(sd["embeds._embedding.weight"],
                                           np.float32)}}
    ema = {}
    if config.get("use_ema", False):
        ema = {"ema": {"quantizer": _ema_state(sd, "quantizer")}}
    else:
        params["quantizer_embedding"] = np.asarray(
            sd["quantizer.embeddings"], np.float32)
    return params, ema


def convert_checkpoint_file(torch_ckpt_path, config, out_path):
    """A reference ``.pt`` checkpoint -> a msgpack checkpoint at
    ``out_path``; returns its iteration. The file is read on the CPU with
    ``weights_only`` unpickling (tensors, dicts and numbers)."""
    import torch

    from . import msgpack_io
    from .migrate import WN_AXIS_FORMAT

    data = torch.load(torch_ckpt_path, map_location="cpu", weights_only=True)
    sd = {k: v.numpy() for k, v in data["model"].items()}
    if model_short_name(config) in HIERARCHIES:
        params, ema = convert_vqvae2_family(sd, config)
    else:
        params, ema = convert_flat_vqvae(sd, config)
    payload = {"model": params, "ema": ema, "optimizer": {},
               "iteration": int(data.get("iteration", 0)),
               # g per torch dim 0 (utils/migrate.py)
               "wn_axis_format": WN_AXIS_FORMAT}
    with open(out_path, "wb") as f:
        f.write(msgpack_io.msgpack_serialize(payload))
    return payload["iteration"]
