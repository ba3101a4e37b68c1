"""Global CMVN with Kaldi's stats layout: compute, write, read, apply,
reverse.

Counterpart of ``vae_npvc_tpu/data/cmvn.py``. The stats matrix is

    row 0: [sum_1..sum_D, count]
    row 1: [sumsq_1..sumsq_D, 0]

written as a binary ``DM`` (double) matrix under the key ``cmvn``.
"""

from __future__ import annotations

import numpy as np

from . import kaldi_io


def compute_stats(scp_path):
    """Accumulate the stats of every matrix of an scp -> (2, D + 1)."""
    stats = None
    for rx in kaldi_io.read_scp(scp_path).values():
        mat = kaldi_io.load_mat(rx).astype(np.float64)
        if stats is None:
            stats = np.zeros((2, mat.shape[1] + 1), np.float64)
        stats[0, :-1] += mat.sum(axis=0)
        stats[0, -1] += mat.shape[0]
        stats[1, :-1] += np.square(mat).sum(axis=0)
    if stats is None:
        raise ValueError(f"empty scp {scp_path}")
    return stats


def write_stats(path, stats):
    with open(path, "wb") as f:
        f.write(b"cmvn ")
        kaldi_io._write_matrix(f, stats.astype(np.float64))


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
