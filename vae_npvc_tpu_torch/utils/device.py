"""Device selection for the port's entry points.

Counterpart of ``vae_npvc_tpu/utils/device.py``. Entry points run on the
GPU unless the caller asks for the CPU; a missing GPU is an error, never a
silent fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``, raising when it is a CUDA device and
    no GPU is present.

    Also turns TF32 off for float32 matrix products and cuDNN convolutions
    (cuDNN defaults to TF32, which keeps ~10 mantissa bits): float32 runs
    of the port are held to the JAX reference at float32 accuracy.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA GPU available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}


def compute_dtype(config, dtype=None) -> torch.dtype:
    """The model's compute dtype: ``dtype`` if given, else the config's
    ``compute_dtype`` (bfloat16/float32), else float32."""
    if dtype is not None:
        return _DTYPES[dtype] if isinstance(dtype, str) else dtype
    return _DTYPES[config.get("compute_dtype") or "float32"]
