"""Objective evaluation: recognizer, language models, MCD, speaker
similarity (counterpart of ``vae_npvc_tpu/eval``)."""
