"""Multi-resolution STFT loss for training the vocoder.

Counterpart of ``vae_npvc_tpu/ops/stft_loss.py``: spectral convergence and
log-STFT-magnitude L1, averaged over several analysis resolutions
(Yamamoto et al., "Parallel WaveGAN", ICASSP 2020), on the port's
``data/features.stft_magnitude``. The default triplets are the published
ones. Where a frame of the prediction is all zeros (the zero-padded tail of
a short utterance) its magnitude is 0 and its gradient through ``|X|`` is 0,
as JAX's is.
"""

from __future__ import annotations

import torch

from ..data.features import stft_magnitude

# (fft_size, hop, win_length): the published multi-resolution set
DEFAULT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def single_stft_loss(x, y, n_fft, n_shift, win_length):
    """(sc, mag) losses between waveforms x (prediction) and y (target),
    both (B, N)."""
    mx = stft_magnitude(x, n_fft, n_shift, win_length)
    my = stft_magnitude(y, n_fft, n_shift, win_length)
    # spectral convergence: ||My - Mx||_F / ||My||_F, mean over the batch
    num = torch.sqrt(torch.sum((my - mx) ** 2, dim=(1, 2)))
    den = torch.sqrt(torch.sum(my ** 2, dim=(1, 2))) + 1e-8
    sc = torch.mean(num / den)
    # log STFT magnitude L1, floored as the published implementation does
    lx = torch.log(torch.clamp(mx, min=1e-7))
    ly = torch.log(torch.clamp(my, min=1e-7))
    mag = torch.mean(torch.abs(ly - lx))
    return sc, mag


def multi_stft_loss(x, y, resolutions=DEFAULT_RESOLUTIONS):
    """(sc, mag) averaged over the resolutions; x and y (B, N), taken in
    fp32."""
    x, y = x.float(), y.float()
    sc_total = mag_total = 0.0
    for n_fft, n_shift, win in resolutions:
        sc, mag = single_stft_loss(x, y, n_fft, n_shift, win)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = float(len(resolutions))
    return sc_total / n, mag_total / n
