"""Tiny widths of the two recipes, for runs of the harness on the CPU."""

FLAT = {
    "encoder": {"in_channels": [80], "out_channels": [32], "kernel_size": 3,
                "downsample_scales": [1], "z_channels": 16,
                "dilation": False, "stack_kernel_size": 3,
                "stack_layers": 1, "stacks": [2], "use_weight_norm": True},
    "decoder": {"in_channels": [16], "out_channels": [32],
                "cond_channels": 8, "skip_channels": 16,
                "final_channels": 80, "kernel_size": 3,
                "upsample_scales": [1], "dilation": False,
                "stack_kernel_size": 3, "stacks": [2],
                "use_weight_norm": True},
    "z_dim": 16, "z_num": 32, "y_dim": 8, "batch_size": 4,
    "crop_length": 32, "steps_per_call": 4,
}


def _enc(cin, scales, stacks):
    return {"in_channels": [cin] * len(scales),
            "out_channels": [32] * len(scales), "kernel_size": 3,
            "downsample_scales": scales, "z_channels": 16,
            "dilation": False, "stack_kernel_size": 3, "stack_layers": 1,
            "stacks": stacks, "use_weight_norm": True}


def _dec(cin, cond, final):
    return {"in_channels": [cin], "out_channels": [32],
            "cond_channels": cond, "skip_channels": 16,
            "final_channels": final, "kernel_size": 3,
            "upsample_scales": [1], "dilation": False,
            "stack_kernel_size": 3, "stacks": [2], "use_weight_norm": True}


HIER = {
    "encoder.0": _enc(80, [1], [2]), "encoder.1": _enc(32, [2, 2], [1, 1]),
    "encoder.2": _enc(32, [4, 4], [1, 1]),
    "quantizer.0": {"z_dim": 16, "z_num": 32, "normalize": True},
    "quantizer.1": {"z_dim": 16, "z_num": 32, "normalize": True},
    "quantizer.2": {"ref_embed_dim": 16, "gst_tokens": 10,
                    "gst_token_dim": 16, "gst_heads": 4},
    "decoder.0": _dec(48, 8, 80), "decoder.1": _dec(16, 32, 16),
    "decoder.2": _dec(16, 16, 16),
    "y_dim": 8, "batch_size": 4, "crop_length": 64, "steps_per_call": 4,
}

# overrides of each configuration for a run on the CPU
TINY = {
    "vcc20_vqvae": {"recipe": FLAT},
    "vcc20_vqvae2": {"recipe": HIER},
}
