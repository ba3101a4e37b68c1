"""PyTorch/CUDA port of vae_npvc_tpu for NVIDIA Hopper (H100).

Module names mirror the JAX package ``vae_npvc_tpu`` so each counterpart is
easy to find. Public functions keep the JAX layout, channels-last
``(B, T, C)``. The package imports ``torch``, numpy and scipy only; it never
imports JAX or the JAX package.

Entry points run on the GPU (``device="cuda"``) and raise when there is no
GPU, unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
