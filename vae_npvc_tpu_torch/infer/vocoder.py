"""Vocoder backends: the native Parallel WaveGAN and the external
``parallel_wavegan`` package.

Counterpart of ``vae_npvc_tpu/infer/vocoder.py`` (Griffin-Lim over a
feats.scp is ``bin/convert_fbank.py``):

- ``jpwg_decode_scp``: the native generator (``models/pwg.py``, trained by
  ``bin/train_pwg.py``; recipe flag ``voc=JPWG``), batched over buckets of
  padded mel length on the device, each wav cut to ``frames * hop``;
- ``external_decode_scp`` (alias ``pwg_decode_scp``): an optional-import
  shim for the recipes' ``voc=PWG``/``voc=MG`` model directories, when the
  ``parallel_wavegan`` package is installed.

The native generator's noise comes from :func:`decode_noise`, a
``torch.Generator`` on the device seeded from ``(seed, draw)``; it is not
``jax.random``'s draw. Stage 6 of ``egs/vcc20/vae*/run.sh`` with
``voc=JPWG`` runs as::

    python -c "from vae_npvc_tpu_torch.infer.vocoder import jpwg_decode_scp; \
        jpwg_decode_scp('dump/denorm/feats.scp', 'dump/denorm/wav', \
                        'conf/train_jpwg.yaml', 'exp/jpwg/model.final')"
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch


def external_decode_scp(feats_scp, out_dir, voc_expdir, device="cuda"):
    """Decode with an external ``parallel_wavegan`` model directory
    (newest ``*.pkl``, ``config.yml``, ``stats.h5``): ``voc=PWG`` or
    ``voc=MG``, on ``device``. The package's ``load_model`` picks the
    generator class from the config; a multi-band generator's sub-band
    output goes through its PQMF synthesis filter, as the package's decoder
    does."""
    try:
        import yaml
        from parallel_wavegan.utils import load_model, read_hdf5
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            "the voc=PWG/voc=MG paths need the 'parallel_wavegan' package "
            "and a pretrained model directory; install parallel_wavegan and "
            "place the model under exp/parallel_wavegan (PWG) or "
            "exp/multiband_melgan (MG), or use an in-framework backend "
            "(voc=GL / voc=JPWG)") from e

    from ..data import kaldi_io
    from ..utils.device import resolve_device

    voc_expdir = Path(voc_expdir)
    ckpts = sorted(voc_expdir.glob("**/*.pkl"),
                   key=lambda p: p.stat().st_mtime)
    confs = sorted(voc_expdir.glob("**/config.yml"))
    stats = sorted(voc_expdir.glob("**/stats.h5"))
    if not (ckpts and confs and stats):
        raise FileNotFoundError(
            f"{voc_expdir} must hold *.pkl, config.yml, stats.h5")
    dev = resolve_device(device)
    with open(confs[0]) as f:
        config = yaml.safe_load(f)
    model = load_model(str(ckpts[-1]), config)
    if hasattr(model, "remove_weight_norm"):  # MelGAN variants may lack it
        model.remove_weight_norm()
    model.eval().to(dev)
    mean = read_hdf5(str(stats[0]), "mean")
    scale = read_hdf5(str(stats[0]), "scale")

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fs = config["sampling_rate"]
    n = 0
    with torch.no_grad():
        for utt, rx in kaldi_io.read_scp(feats_scp).items():
            mel = (kaldi_io.load_mat(rx) - mean) / scale
            wav = model.inference(torch.as_tensor(mel.astype(np.float32),
                                                  device=dev))
            if wav.dim() == 2 and wav.shape[-1] > 1:
                # multi-band generator: (T // bands, bands) -> full band
                pqmf = getattr(model, "pqmf", None)
                if pqmf is None:
                    raise ValueError(
                        "multi-band generator output but the loaded model "
                        "has no PQMF synthesis filter")
                wav = pqmf.synthesis(wav.transpose(1, 0).unsqueeze(0))
            wav = wav.reshape(-1).cpu().numpy()
            _write_wav(out_dir / f"{utt}.wav", wav, fs)
            n += 1
    return n


# the name of the shim before it served multi-band models too
pwg_decode_scp = external_decode_scp


def jpwg_receptive_frames(config) -> int:
    """The generator's receptive field in mel frames, rounded up: the
    dilated stack's ``(k - 1) * 2^(i % cycle)`` samples per layer (half on
    each side), plus one frame per upsampling stage for its smoothing conv.
    The halo of exact chunked synthesis."""
    layers = config.get("layers", 30)
    stacks = config.get("stacks", 3)
    k = config.get("kernel_size", 3)
    cycle = layers // stacks
    rf_samples = sum((k - 1) * 2 ** (i % cycle) for i in range(layers)) // 2
    scales = config.get("upsample_scales", (4, 4, 4, 4))
    return -(-rf_samples // math.prod(scales)) + len(scales)


def load_generator(config, checkpoint, n_mels, device="cuda"):
    """The generator of a vocoder checkpoint (the JAX trainer's or the
    port's ``{generator, ...}`` msgpack) on ``device``, in eval mode."""
    from ..bin.train import load_config
    from ..models.pwg import PWGGenerator
    from ..utils import msgpack_io
    from ..utils.bridge import from_jax_variables
    from ..utils.device import resolve_device

    config = load_config(config)
    dev = resolve_device(device)
    gen = PWGGenerator(config, aux_channels=int(n_mels)).to(dev)
    with open(checkpoint, "rb") as f:
        payload = msgpack_io.msgpack_restore(f.read())
    gen.load_state_dict(from_jax_variables(
        {"params": payload["generator"]}), strict=True)
    return gen.eval()


def decode_noise(seed, draw, shape, device):
    """The ``draw``-th noise tensor of a decode seeded by ``seed``: normal
    ``shape`` from a ``torch.Generator`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(draw)) % (1 << 63))
    return torch.randn(shape, generator=g, device=device)


def run_generator(gen, z, mel):
    """One pass of ``gen`` over noise ``z`` (B, S, 1) and log-mel ``mel``
    (B, T, n_mels) on its device: the (B, S) waveform as numpy."""
    dev = next(gen.parameters()).device
    with torch.inference_mode():
        wav = gen(torch.as_tensor(z, device=dev),
                  torch.as_tensor(mel, device=dev))
    return wav[..., 0].cpu().numpy()


def jpwg_synthesize_stream(gen, mel, z, *, chunk_frames: int,
                           halo_frames: int, hop: int,
                           stop_frame: int | None = None):
    """Chunked synthesis as a generator of ``(start sample, wav chunk)``
    pairs in order, each ``chunk_frames * hop`` samples (the last possibly
    shorter). ``mel`` (T, n_mels), ``z`` the full-length noise (T * hop, 1);
    every window is clamped inside the utterance and carries
    ``halo_frames`` of context on each side. ``stop_frame`` ends the sweep
    early: frames from it on are not synthesized."""
    T = mel.shape[0]
    T_stop = T if stop_frame is None else min(int(stop_frame), T)
    padded = chunk_frames + 2 * halo_frames
    if T <= padded:
        # shorter than one padded window: one full-length pass
        yield 0, run_generator(gen, z[None], mel[None])[0][:T_stop * hop]
        return
    for a in range(0, T_stop, chunk_frames):
        b = min(a + chunk_frames, T_stop)
        # each window edge is either a halo away from the kept samples or
        # the utterance's true edge (zeros past an interior edge would leak
        # through the conv stack into kept samples)
        lo = min(max(a - halo_frames, 0), T - padded)
        hi = lo + padded
        wav = run_generator(gen, z[None, lo * hop:hi * hop],
                            mel[None, lo:hi])[0]
        yield a * hop, wav[(a - lo) * hop:(b - lo) * hop]


def jpwg_synthesize_chunked(gen, mel, z, *, chunk_frames: int,
                            halo_frames: int, hop: int):
    """Long-utterance synthesis in fixed-size chunks with halo overlap:
    with ``halo_frames`` >= :func:`jpwg_receptive_frames` each chunk equals
    the full-length pass on its kept samples. ``z`` is the full-length
    noise, so each chunk reads its own slice of it."""
    out = np.zeros((mel.shape[0] * hop,), np.float32)
    for at, wav in jpwg_synthesize_stream(
            gen, mel, z, chunk_frames=chunk_frames, halo_frames=halo_frames,
            hop=hop):
        out[at:at + wav.size] = wav
    return out


def jpwg_decode_scp(feats_scp, out_dir, config, checkpoint, *,
                    batch_size: int = 8, bucket: int = 64, seed: int = 0,
                    chunk_frames: int | None = None, device="cuda"):
    """Vocode a de-normalized log-mel feats.scp with the native generator.

    ``config`` is the vocoder's training config (dict or path),
    ``checkpoint`` a vocoder checkpoint. Utterances longer than
    ``chunk_frames`` (when given) go through chunked synthesis first, one
    noise draw each; the rest are grouped by their length rounded up to
    ``bucket`` frames, in batches of up to ``batch_size`` zero-padded mels
    (one draw per batch, in order of bucket). A bucket's last batch holds
    only its own utterances: JAX fills it with silent rows to reuse a
    compiled shape, which the card does not need. Each wav is cut to
    ``frames * hop`` samples. Returns the number written."""
    from ..bin.train import load_config
    from ..data import kaldi_io

    config = load_config(config)
    hop = math.prod(config.get("upsample_scales", (4, 4, 4, 4)))
    fs = config.get("fs", 24000)
    items = [(u, kaldi_io.load_mat(rx))
             for u, rx in kaldi_io.read_scp(feats_scp).items()]
    if not items:
        return 0
    n_mels = items[0][1].shape[1]
    gen = load_generator(config, checkpoint, n_mels, device)
    dev = next(gen.parameters()).device

    long_items = []
    if chunk_frames:
        long_items = [it for it in items if it[1].shape[0] > chunk_frames]
        items = [it for it in items if it[1].shape[0] <= chunk_frames]
    buckets: dict = {}
    for u, mel in items:
        T_pad = -(-mel.shape[0] // bucket) * bucket
        buckets.setdefault(T_pad, []).append((u, mel))

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    draw = n = 0
    for u, mel in long_items:
        z = decode_noise(seed, draw, (mel.shape[0] * hop, 1), dev)
        draw += 1
        wav = jpwg_synthesize_chunked(
            gen, mel.astype(np.float32), z, chunk_frames=chunk_frames,
            halo_frames=jpwg_receptive_frames(config), hop=hop)
        _write_wav(out_dir / f"{u}.wav", wav, fs)
        n += 1
    for T_pad in sorted(buckets):
        group = buckets[T_pad]
        for lo in range(0, len(group), batch_size):
            chunk = group[lo:lo + batch_size]
            c = np.zeros((len(chunk), T_pad, n_mels), np.float32)
            for b, (_, mel) in enumerate(chunk):
                c[b, :mel.shape[0]] = mel
            z = decode_noise(seed, draw, (len(chunk), T_pad * hop, 1), dev)
            draw += 1
            wav = run_generator(gen, z, c)
            for b, (u, mel) in enumerate(chunk):
                _write_wav(out_dir / f"{u}.wav",
                           wav[b, :mel.shape[0] * hop], fs)
                n += 1
    return n


def _write_wav(path, x, fs):
    """Mono int16 wav of ``x`` clipped to [-1, 1] (the JAX package's
    writer)."""
    import wave

    pcm = (np.clip(x, -1.0, 1.0) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(pcm.tobytes())
