"""The benchmark's yardstick: the card's peaks, the least time of each
kernel the per-layer metrics read, and the model operations of a step.

The peak table and the bound functions are frozen copies of
``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``FP32_OPS_PER_S``,
``BF16_OPS_PER_S``, ``TF32_OPS_PER_S``, ``_bound``, ``vq_bound_ms``,
``gn_bound_ms``, ``gnb_bound_ms``, ``_valid_frames``), so that the
yardstick does not move when the smoke is edited. The layer walk
(:func:`vqvae_step`) counts, from a recipe's sizes alone, every
convolution, GroupNorm and VQ search of one training step of the flat and
hierarchical VQ-VAEs; it reads no module of the program.
"""

from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32
# operations/s outside the tensor cores, bf16 and TF32 operations/s in them
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12


def _bound(byt, ops, ops_per_s=FP32_OPS_PER_S):
    t_bytes, t_ops = byt / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, (
        "bytes" if t_bytes > t_ops else "operations")


def vq_bound_ms(N, K, D, stats=False, fma=False):
    """Least time for the fused VQ: max(bytes, operations). The ids mode
    reads z and the codebook and writes the ids; the statistics mode also
    writes z_q, the per-code sums and the counts. The 2*N*K*D products run
    as three TF32 products on the tensor cores, or with ``fma`` at the fp32
    FMA rate."""
    byt = 4 * (N * D + K * D + N)
    if stats:
        byt += 4 * (N * D + K * D + K)
    if fma:
        return _bound(byt, 2 * N * K * D, FP32_OPS_PER_S)
    return _bound(byt, 3 * 2 * N * K * D, TF32_OPS_PER_S)


def _valid_frames(B, T, lengths):
    """Frames that GroupNorm reads: lengths clamped to [0, T], or all."""
    if not lengths:
        return B * T
    return sum(min(max(int(n), 0), T) for n in lengths)


def gnb_bound_ms(B, T, C, itemsize, glu, lengths=None):
    """Least time for the GroupNorm(+GLU) backward: one read of x and of
    the cotangent over the valid frames, one write of dx over all T, scale
    and bias read and the parameter gradients written, ~20 fp32 operations
    per valid element."""
    n = _valid_frames(B, T, lengths) * C
    byt = (n + (n // 2 if glu else n)) * itemsize + B * T * C * itemsize \
        + 16 * C
    return _bound(byt, 20 * n)


def gn_bound_ms(B, T, C, itemsize, glu, lengths=None):
    """Least time for GroupNorm(+GLU): one read of x over the valid frames,
    one write of the output over all T, ~8 fp32 operations per valid input
    element (+4 per GLU output)."""
    n = _valid_frames(B, T, lengths) * C
    byt = n * itemsize + B * T * (C // 2 if glu else C) * itemsize \
        + 8 * C + 4 * B
    ops = 8 * n + (4 * n // 2 if glu else 0)
    return _bound(byt, ops)


ITEMSIZE = {"bfloat16": 2, "float32": 4}


class Step:
    """The layers of one training step, counted from the recipe's sizes.

    ``convs``: ``(c_in, c_out, k, frames, needs_dx)`` with ``frames`` the
    output frames over the whole batch; ``gns``: ``(B, T, C, glu)``;
    ``vqs``: ``(N, K, D, stats)``.
    """

    def __init__(self):
        self.convs, self.gns, self.vqs = [], [], []

    def conv(self, cin, cout, k, frames, needs_dx=True):
        self.convs.append((cin, cout, k, frames, needs_dx))

    def train_flops(self):
        """Model operations of a training step: 2*c_in*c_out*k a frame for
        each convolution in the forward, as much again for the weight
        gradient and for the input gradient (none for the first layer,
        whose input is data), plus 2*N*K*D for each VQ search."""
        conv = sum(2 * cin * cout * k * f * (3 if dx else 2)
                   for cin, cout, k, f, dx in self.convs)
        return conv + sum(2 * N * K * D for N, K, D, _ in self.vqs)

    def gn_train_bound_s(self, itemsize):
        """Least time of every GroupNorm forward and backward of a step."""
        return sum(gn_bound_ms(B, T, C, itemsize, glu)[0]
                   + gnb_bound_ms(B, T, C, itemsize, glu)[0]
                   for B, T, C, glu in self.gns) / 1e3

    def vq_bound_s(self):
        return sum(vq_bound_ms(N, K, D, stats=stats)[0]
                   for N, K, D, stats in self.vqs) / 1e3


def _down(t, ds):
    p = ds // 2 + ds % 2
    return max((t + 2 * p - 2 * ds) // ds + 1, 1)


def _encoder(step, arch, B, T, first):
    """An encoder of ``T`` frames; returns its output frames."""
    ins, outs = arch["in_channels"], arch["out_channels"]
    scales = arch.get("downsample_scales", [1] * len(ins))
    k, sk = arch.get("kernel_size", 3), arch.get("stack_kernel_size", 3)
    layers = arch.get("stack_layers", 2)
    ch, t = ins[0], T
    for i, (out, ds, n) in enumerate(zip(outs, scales, arch["stacks"])):
        if ds == 1:
            step.conv(ch, out, k, B * t, needs_dx=not (first and i == 0))
        else:
            t = _down(t, ds)
            step.conv(ch, out, 2 * ds, B * t, needs_dx=not (first and i == 0))
        for _ in range(n):
            for _ in range(layers):
                step.conv(out, out, sk, B * t)
                step.gns.append((B, t, out, False))
            step.conv(out, out, 1, B * t)
        ch = out
    step.conv(ch, arch.get("z_channels", 128), 1, B * t)
    return t


def _decoder(step, arch, B, T, cond_frames):
    """A stride-1 decoder of ``T`` frames conditioned on ``cond_frames``
    frames a row (1: one speaker vector, broadcast over time)."""
    ins, outs = arch["in_channels"], arch["out_channels"]
    if any(us != 1 for us in arch.get("upsample_scales", [1] * len(ins))):
        raise ValueError("the layer walk covers stride-1 decoders only")
    k, sk = arch.get("kernel_size", 3), arch.get("stack_kernel_size", 3)
    cond, skip = arch.get("cond_channels", 128), arch.get("skip_channels", 80)
    ch = ins[0]
    for out, n in zip(outs, arch["stacks"]):
        step.conv(ch, out, k, B * T)
        for _ in range(n):
            step.conv(out, 2 * out, sk, B * T)
            if cond:
                step.conv(cond, 2 * out, 1, B * cond_frames)
            step.gns.append((B, T, 2 * out, True))
            step.conv(out, out + skip, 1, B * T)
        ch = out
    step.conv(skip, skip, 1, B * T)
    step.conv(skip, arch.get("final_channels", 80), 1, B * T)


def vqvae_step(cfg, B, T):
    """The layers of one step of the flat (``vae_npvc.model.vqvae``) or
    hierarchical (``vae_npvc.model.vqvae2``) VQ-VAE on ``B`` rows of ``T``
    frames."""
    step = Step()
    kind = cfg["model_type"].rsplit(".", 1)[-1]
    if kind == "vqvae":
        t = _encoder(step, cfg["encoder"], B, T, first=True)
        step.vqs.append((B * t, cfg["z_num"], cfg["z_dim"],
                         bool(cfg.get("use_ema"))))
        _decoder(step, cfg["decoder"], B, t, cond_frames=1)
        return step
    if kind != "vqvae2":
        raise ValueError(f"no layer walk for {cfg['model_type']}")
    L = cfg["levels"]
    times, t = [], T
    for i in range(L):
        t = _encoder(step, cfg[f"encoder.{i}"], B, t, first=i == 0)
        times.append(t)
    gst = cfg.get("use_gst", True)
    for i in reversed(range(L)):
        if not (gst and i == L - 1):
            q = cfg[f"quantizer.{i}"]
            step.vqs.append((B * times[i], q.get("z_num", 512),
                             q.get("z_dim", 128), bool(cfg.get("use_ema"))))
        if i > 0:
            # decoder i refines level i-1's code at its own frame rate,
            # conditioned frame by frame on the coarser levels
            _decoder(step, cfg[f"decoder.{i}"], B, times[i - 1],
                     cond_frames=times[i - 1])
    _decoder(step, cfg["decoder.0"], B, T, cond_frames=T)
    return step

