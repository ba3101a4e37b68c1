"""PLDA training and scoring on speaker embeddings (Kaldi semantics).

The reference's similarity stage scores converted utterances with Kaldi's
``ivector-plda-scoring --normalize-length=true --num-utts=...`` against a
downloaded SITW PLDA model (reference:
egs/vcc20/vae1/local/ob_eval/evaluate_similarity.sh:121-129). No network and
no Kaldi here, so this module trains the PLDA on the experiment's own
embeddings and scores with Kaldi's exact model form:

- training: two-covariance PLDA. Class means are latent with between-class
  covariance B; observations scatter within-class with covariance W. EM over
  per-speaker sufficient statistics (Ioffe 2006 / Kaldi PldaEstimator), then
  simultaneous diagonalization to Kaldi's canonical form: a single transform
  A with A W Aᵀ = I and A B Aᵀ = diag(psi).
- length normalization: Kaldi's ``ivector-normalize-length`` scales each
  (mean-subtracted, transformed) vector to norm sqrt(dim); scoring applies
  the same ``normalize_length=True`` convention.
- scoring: Kaldi PldaScore log-likelihood ratio. For an enrollment mean u
  over n utterances and test vector v (both in the diagonalized space):
  same-speaker: v ~ N(n·psi/(n·psi+1) · u, I + psi/(n·psi+1));
  diff-speaker: v ~ N(0, I + psi). LLR = log p_same − log p_diff.

The port's own copy of ``vae_npvc_tpu/eval/plda.py`` (host numpy; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Sequence

import numpy as np


@dataclass
class Plda:
    mean: np.ndarray        # (D,) global embedding mean
    transform: np.ndarray   # (D, D) rows map centered embeddings to the
                            # diagonalized space (A in the docstring)
    psi: np.ndarray         # (D,) between-class variances, descending

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    def project(self, x: np.ndarray, normalize_length: bool = True):
        """Center, transform, and (Kaldi-style) length-normalize rows."""
        u = (np.atleast_2d(x) - self.mean) @ self.transform.T
        if normalize_length:
            norms = np.linalg.norm(u, axis=1, keepdims=True)
            u = u * (math.sqrt(self.dim) / np.maximum(norms, 1e-12))
        return u


def _sym(m):
    return 0.5 * (m + m.T)


def plda_train(embs: np.ndarray, labels: Sequence, *, em_iters: int = 10,
               within_floor: float = 1e-6) -> Plda:
    """Train a two-covariance PLDA from (N, D) embeddings + speaker labels."""
    embs = np.asarray(embs, np.float64)
    labels = np.asarray(labels)
    mean = embs.mean(axis=0)
    x = embs - mean
    D = x.shape[1]

    classes = {}
    for lab in np.unique(labels):
        classes[lab] = x[labels == lab]
    K = len(classes)
    if K < 2:
        raise ValueError("PLDA needs >= 2 speakers")

    # init: within = pooled within-class scatter, between = scatter of means
    W = np.zeros((D, D))
    B = np.zeros((D, D))
    for rows in classes.values():
        mu = rows.mean(axis=0)
        W += (rows - mu).T @ (rows - mu)
        B += np.outer(mu, mu) * len(rows)
    N = len(x)
    W = _sym(W / max(N - K, 1)) + within_floor * np.eye(D)
    B = _sym(B / N) + within_floor * np.eye(D)

    # EM on per-class sufficient stats: posterior of the class mean y_k given
    # n_k observations is N(m_k, C_k) with C_k = (B^-1 + n_k W^-1)^-1,
    # m_k = C_k W^-1 (sum of class rows)
    for _ in range(em_iters):
        W_inv = np.linalg.inv(W)
        B_inv = np.linalg.inv(B)
        B_new = np.zeros((D, D))
        W_new = np.zeros((D, D))
        for rows in classes.values():
            n_k = len(rows)
            s_k = rows.sum(axis=0)
            C_k = np.linalg.inv(B_inv + n_k * W_inv)
            m_k = C_k @ (W_inv @ s_k)
            B_new += C_k + np.outer(m_k, m_k)
            # E[(x - y)(x - y)^T] summed over the class
            r = rows - m_k
            W_new += r.T @ r + n_k * C_k
        B = _sym(B_new / K) + within_floor * np.eye(D)
        W = _sym(W_new / N) + within_floor * np.eye(D)

    # simultaneous diagonalization: whiten W, then rotate to diagonalize B
    w_vals, w_vecs = np.linalg.eigh(W)
    w_vals = np.maximum(w_vals, within_floor)
    whiten = w_vecs @ np.diag(w_vals ** -0.5) @ w_vecs.T
    B_t = _sym(whiten @ B @ whiten.T)
    psi, rot = np.linalg.eigh(B_t)
    order = np.argsort(psi)[::-1]
    psi = np.maximum(psi[order], 0.0)
    transform = (rot[:, order].T @ whiten)
    return Plda(mean=mean, transform=transform, psi=psi)


def plda_score(plda: Plda, enroll: np.ndarray, test: np.ndarray,
               n_enroll: int = 1, *, normalize_length: bool = True) -> float:
    """Kaldi PldaScore LLR for one (enrollment mean, test) pair.

    ``enroll`` is the raw-embedding mean of ``n_enroll`` enrollment
    utterances (Kaldi's ivector-mean + --num-utts path); both vectors are in
    the original embedding space.
    """
    u = plda.project(enroll, normalize_length)[0]
    v = plda.project(test, normalize_length)[0]
    psi = plda.psi
    n = max(int(n_enroll), 1)

    shrink = n * psi / (n * psi + 1.0)
    mean_same = shrink * u
    var_same = 1.0 + psi / (n * psi + 1.0)
    var_diff = 1.0 + psi

    def logpdf(x, mu, var):
        return -0.5 * np.sum(np.log(2.0 * np.pi * var)
                             + (x - mu) ** 2 / var)

    return float(logpdf(v, mean_same, var_same)
                 - logpdf(v, np.zeros_like(v), var_diff))


def plda_score_trials(plda: Plda, enroll_embs: Mapping[str, np.ndarray],
                      enroll_counts: Mapping[str, int],
                      test_embs: Mapping[str, np.ndarray],
                      trials: Sequence) -> Dict[tuple, float]:
    """Score (enroll_spk, test_utt) trial pairs → {(spk, utt): LLR}."""
    out = {}
    for spk, utt in trials:
        out[(spk, utt)] = plda_score(plda, enroll_embs[spk], test_embs[utt],
                                     enroll_counts.get(spk, 1))
    return out
