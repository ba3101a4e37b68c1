"""Global CMVN with Kaldi's stats layout (read, mean/std, apply, reverse).

Counterpart of ``vae_npvc_tpu/data/cmvn.py``. The stats matrix is

    row 0: [sum_1..sum_D, count]
    row 1: [sumsq_1..sumsq_D, 0]
"""

from __future__ import annotations

import numpy as np

from . import kaldi_io


def read_stats(path):
    """Read a cmvn.ark holding one stats matrix (any key)."""
    for _key, mat in kaldi_io.read_ark(path):
        return mat.astype(np.float64)
    raise ValueError(f"no matrix in {path}")


def mean_std(stats, var_floor=1e-20):
    count = stats[0, -1]
    mean = stats[0, :-1] / count
    var = stats[1, :-1] / count - mean ** 2
    std = np.sqrt(np.maximum(var, var_floor))
    return mean.astype(np.float32), std.astype(np.float32)


def apply(feat, stats, norm_vars=True, reverse=False):
    """Normalize (or de-normalize with ``reverse=True``) a (T, D) matrix."""
    mean, std = mean_std(stats)
    if not norm_vars:
        std = np.ones_like(std)
    if reverse:
        return feat * std + mean
    return (feat - mean) / std
