"""The benchmark of ``vae_npvc_tpu_torch`` on one H100 (``run.py``)."""
