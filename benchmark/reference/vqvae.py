"""Plain PyTorch reference of the VQ-VAE training step.

The flat EMA VQ-VAE and the hierarchical VQ-VAE with a GST top level
(``vae_npvc.model.vqvae`` / ``vae_npvc.model.vqvae2``), written from the
recipe's keys as plain ``torch`` operations over a dict of parameters:
weight-normalized convolutions (``g * v / ||v||``), GroupNorm with the
tanh*sigmoid gate, the VQ search by exact distances, the EMA codebook
update, the losses, clip-by-global-norm and Adam. It imports nothing of
the program, no kernel and no JAX.

Parameter names follow the recipe's checkpoint layout (``encoder.conv_0.v``
with ``v`` as (K, in, out)), so one dict of weights made by the benchmark
feeds both sides.

``Precision`` says where values are rounded: at each place where the
program casts to its compute dtype (every convolution's input, weight and
output, every GroupNorm's output). ``fp32`` rounds nowhere; ``fp8`` rounds
there to float8 (e4m3 forward, e5m2 gradients, each tensor scaled by its
largest magnitude), the control that the comparison has to reject.

Departures from the published description, each the same in the program:
the EMA codebook's lazy initialisation and dead-code restarts draw rows of
the encoder output with ``torch.randperm`` from a generator seeded by
``(seed, step)`` (:func:`step_generator`), so both sides draw the same
rows; the GST level runs in float32 whatever the precision.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)


# ----------------------------------------------------------------- rounding
def _scaled_round(x, dtype, fmax):
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    s = fmax / amax
    return ((x.float() * s).to(dtype).float() / s).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _scaled_round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2, 57344.0)


class Precision:
    """The rounding applied where the program casts to its compute dtype."""

    def __init__(self, kind="fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, t):
        return t if self.kind == "fp32" else _Fp8.apply(t)


# ------------------------------------------------------------------ weights
def parameter_shapes(cfg):
    """``{name: shape}`` of every trained parameter, in the layout of the
    recipe's checkpoints."""
    shapes = {}

    def conv(name, cin, cout, k, wn=True, wn_in=False):
        shapes[f"{name}.v"] = (k, cin, cout)
        if wn:
            shapes[f"{name}.g"] = (cin if wn_in else cout,)
        shapes[f"{name}.b"] = (cout,)

    def encoder(pre, a):
        wn = a.get("use_weight_norm", True)
        ch = a["in_channels"][0]
        scales = a.get("downsample_scales", [1] * len(a["in_channels"]))
        for i, (out, ds, n) in enumerate(zip(a["out_channels"], scales,
                                             a["stacks"])):
            conv(f"{pre}.conv_{i}", ch, out,
                 a.get("kernel_size", 3) if ds == 1 else 2 * ds, wn)
            for j in range(n):
                for layer in range(a.get("stack_layers", 2)):
                    conv(f"{pre}.stack_{i}_{j}.conv_{layer}", out, out,
                         a.get("stack_kernel_size", 3), wn)
                    shapes[f"{pre}.stack_{i}_{j}.norm_{layer}.scale"] = (out,)
                    shapes[f"{pre}.stack_{i}_{j}.norm_{layer}.bias"] = (out,)
                conv(f"{pre}.stack_{i}_{j}.skip", out, out, 1, wn)
            ch = out
        conv(f"{pre}.proj", ch, a.get("z_channels", 128), 1, wn)

    def decoder(pre, a):
        wn = a.get("use_weight_norm", True)
        ch = a["in_channels"][0]
        cond, skip = a.get("cond_channels", 128), a.get("skip_channels", 80)
        for i, (out, n) in enumerate(zip(a["out_channels"], a["stacks"])):
            conv(f"{pre}.up_{i}", ch, out, a.get("kernel_size", 5), wn,
                 wn_in=True)
            for j in range(n):
                s = f"{pre}.stack_{i}_{j}"
                conv(f"{s}.conv_in", out, 2 * out,
                     a.get("stack_kernel_size", 3), wn, wn_in=True)
                if cond:
                    conv(f"{s}.conv_cond", cond, 2 * out, 1, wn)
                shapes[f"{s}.norm.scale"] = (2 * out,)
                shapes[f"{s}.norm.bias"] = (2 * out,)
                conv(f"{s}.res_skip", out, out + skip, 1, wn)
            ch = out
        conv(f"{pre}.final_0", skip, skip, 1, wn)
        conv(f"{pre}.final_1", skip, a.get("final_channels", 80), 1, wn)

    kind = cfg["model_type"].rsplit(".", 1)[-1]
    if kind == "vqvae":
        encoder("encoder", cfg["encoder"])
        decoder("decoder", cfg["decoder"])
        if not cfg.get("use_ema"):
            shapes["quantizer_embedding"] = (cfg["z_num"], cfg["z_dim"])
    elif kind == "vqvae2":
        L = cfg["levels"]
        for i in range(L):
            if not _is_gst(cfg, i) and not cfg.get("use_ema"):
                q = cfg[f"quantizer.{i}"]
                shapes[f"quantizer_embedding_{i}"] = (q.get("z_num", 512),
                                                      q.get("z_dim", 128))
        for i in range(L):
            encoder(f"encoder_{i}", cfg[f"encoder.{i}"])
        for i in range(L):
            decoder(f"decoder_{i}", cfg[f"decoder.{i}"])
        if cfg.get("use_gst", True):
            q = cfg[f"quantizer.{L - 1}"]
            d, h = q.get("gst_token_dim", 256), q.get("gst_heads", 4)
            shapes["gst.gst_embs"] = (q.get("gst_tokens", 10), d // h)
            for lin, cin in (("linear_q", q.get("ref_embed_dim", 128)),
                             ("linear_k", d // h), ("linear_v", d // h),
                             ("linear_out", d)):
                shapes[f"gst.mha.{lin}.kernel"] = (cin, d)
                shapes[f"gst.mha.{lin}.bias"] = (d,)
    else:
        raise ValueError(f"no reference for {cfg['model_type']}")
    shapes["embeds.embedding"] = (cfg["y_num"], cfg["y_dim"])
    return shapes


def init_weights(cfg, gen, device):
    """Seeded weights in two draws on ``device``: the PyTorch default
    uniform init of every convolution (``v`` and ``b`` in +-1/sqrt(k*c_in),
    ``g = ||v||`` so the initial weight is ``v``), GroupNorm scale 1 and
    bias 0, standard normal tables, dense kernels normal / sqrt(c_in) with
    zero bias."""
    shapes = parameter_shapes(cfg)
    sizes = {n: math.prod(s) for n, s in shapes.items()}
    total = sum(sizes.values())
    uni = torch.rand(total, generator=gen, device=device) * 2 - 1
    nrm = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = sizes[name]
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("v", "b"):
            k, cin, _ = shapes[name[:-1] + "v"]
            t = uni[off:off + n] / math.sqrt(k * cin)
        elif leaf == "kernel":
            t = nrm[off:off + n] / math.sqrt(shape[0])
        elif leaf in ("scale",):
            t = torch.ones(n, device=device)
        elif leaf in ("bias",):
            t = torch.zeros(n, device=device)
        else:           # embedding tables, codebooks, style tokens
            t = nrm[off:off + n]
        out[name] = t.reshape(shape).clone()
        off += n
    for name, shape in shapes.items():
        if name.endswith(".g"):
            v = out[name[:-1] + "v"]
            dims = (0, 2) if shape[0] == v.shape[1] and \
                _wn_in(name) else (0, 1)
            out[name] = v.square().sum(dims).sqrt()
    return out


def _wn_in(name):
    """Whether a weight-normalized convolution scales its input side (the
    reference's stride-1 transposed convolutions of the decoder)."""
    leaf = name.rsplit(".", 2)[-2]
    return leaf.startswith("up_") or leaf == "conv_in"


def _is_gst(cfg, i):
    return cfg.get("use_gst", True) and i == cfg["levels"] - 1


# ------------------------------------------------------------------ layers
def conv(P, name, x, r, *, stride=1, padding=None, dilation=1):
    """Weight-normalized 1-D convolution of (B, T, C) features."""
    v, b = P[f"{name}.v"], P[f"{name}.b"]
    g = P.get(f"{name}.g")
    k = v.shape[0]
    w = v
    if g is not None:
        if _wn_in(name + ".v"):
            w = v * (g / v.square().sum((0, 2)).sqrt())[None, :, None]
        else:
            w = v * (g / v.square().sum((0, 1)).sqrt())[None, None, :]
    pad = (k - 1) // 2 * dilation if padding is None else padding
    y = F.conv1d(r(x).transpose(1, 2), r(w.permute(2, 1, 0)), stride=stride,
                 padding=pad, dilation=dilation).transpose(1, 2)
    return r(y + b)


def group_norm(x, scale, bias, groups, r, glu=False, eps=1e-5):
    """GroupNorm over (time, channels of a group), biased variance; with
    ``glu`` the gate tanh(first half) * sigmoid(second half)."""
    B, T, C = x.shape
    xg = x.float().reshape(B, T, groups, C // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = r(((xg - mean) / torch.sqrt(var + eps)).reshape(B, T, C) * scale
          + bias)
    if glu:
        y = r(torch.tanh(y[..., :C // 2]) * torch.sigmoid(y[..., C // 2:]))
    return y


def encoder(P, pre, a, x, r):
    """-> (projection (B, T', z), hidden features (B, T', C))."""
    h = x
    scales = a.get("downsample_scales", [1] * len(a["in_channels"]))
    for i, (ds, n) in enumerate(zip(scales, a["stacks"])):
        if ds == 1:
            h = conv(P, f"{pre}.conv_{i}", h, r)
        else:
            h = conv(P, f"{pre}.conv_{i}", h, r, stride=ds,
                     padding=ds // 2 + ds % 2)
        for j in range(n):
            s = f"{pre}.stack_{i}_{j}"
            y = h
            for layer in range(a.get("stack_layers", 2)):
                y = F.leaky_relu(y, 0.2)
                y = conv(P, f"{s}.conv_{layer}", y, r)
                y = group_norm(y, P[f"{s}.norm_{layer}.scale"],
                               P[f"{s}.norm_{layer}.bias"], 1, r)
            h = y + conv(P, f"{s}.skip", h, r)
        h = F.leaky_relu(h, 0.2)
    return conv(P, f"{pre}.proj", h, r), h


def decoder(P, pre, a, z, c, r):
    """Speaker- or code-conditioned GLU residual stacks with summed skips,
    scaled by sqrt(1 / layers), then ReLU, 1x1, ReLU, 1x1."""
    if any(us != 1 for us in a.get("upsample_scales", [1])):
        raise ValueError("the reference covers stride-1 decoders only")
    h, skips = z, 0.0
    for i, n in enumerate(a["stacks"]):
        h = conv(P, f"{pre}.up_{i}", h, r)
        for j in range(n):
            s = f"{pre}.stack_{i}_{j}"
            y = conv(P, f"{s}.conv_in", h, r)
            if f"{s}.conv_cond.v" in P:
                y = y + conv(P, f"{s}.conv_cond", c, r)
            y = group_norm(y, P[f"{s}.norm.scale"], P[f"{s}.norm.bias"], 2,
                           r, glu=True)
            rs = conv(P, f"{s}.res_skip", y, r)
            C = h.shape[-1]
            h = h + rs[..., :C]
            skips = skips + rs[..., C:]
    total = len(a["in_channels"]) + sum(a["stacks"])
    h = skips * math.sqrt(1.0 / total)
    h = conv(P, f"{pre}.final_0", F.relu(h), r)
    return conv(P, f"{pre}.final_1", F.relu(h), r)


def nearest(z, emb):
    """Index of the nearest code of every row by exact squared distance."""
    d = (z.square().sum(1, keepdim=True) - 2 * z @ emb.T
         + emb.square().sum(1)[None, :])
    return d.argmin(dim=1)


def upsample(z, t):
    """Repeat each frame ``t // T`` times, then crop or repeat the last."""
    T = z.shape[1]
    z = torch.repeat_interleave(z, max(t // T, 1), dim=1)
    if z.shape[1] >= t:
        return z[:, :t]
    return torch.cat([z, z[:, -1:].expand(-1, t - z.shape[1], -1)], dim=1)


def gst(P, q, ref):
    """One query (the time mean of the top level) against tanh'd style
    tokens, multi-head, float32."""
    B = ref.shape[0]
    d, H = q.get("gst_token_dim", 256), q.get("gst_heads", 4)
    dk = d // H
    tokens = torch.tanh(P["gst.gst_embs"])[None].expand(B, -1, -1)

    def lin(name, x):
        return x @ P[f"gst.mha.{name}.kernel"] + P[f"gst.mha.{name}.bias"]

    qh = lin("linear_q", ref[:, None, :]).reshape(B, -1, H, dk).transpose(1, 2)
    kh = lin("linear_k", tokens).reshape(B, -1, H, dk).transpose(1, 2)
    vh = lin("linear_v", tokens).reshape(B, -1, H, dk).transpose(1, 2)
    att = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(dk), dim=-1)
    out = (att @ vh).transpose(1, 2).reshape(B, -1, d)
    return lin("linear_out", out)[:, 0]


# ----------------------------------------------------------------- VQ paths
class EmaCodebook:
    """The EMA codebook's state: codes, per-code sums and counts."""

    def __init__(self, K, D, device):
        self.initted = False
        self.emb = torch.zeros(K, D, device=device)
        self.emb_sum = torch.zeros(K, D, device=device)
        self.emb_elem = torch.ones(K, device=device)


def step_generator(seed, step, device):
    """The step's generator of restart and initialisation draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + step) % (1 << 63))
    return gen


def _draw_rows(gen, z, K):
    return z[torch.randperm(z.shape[0], generator=gen, device=z.device)[:K]]


def ema_quantize(book, z, gen, mu):
    """The EMA codebook's training pass over (B, T, D) fp32 ``z``: lazy
    initialisation from rows of the first batch, the nearest codes, the
    EMA of per-code sums and counts, and codes whose count fell under 1
    restarted from drawn rows. Returns (z with straight-through codes,
    commitment loss); updates ``book``."""
    B, T, D = z.shape
    K = book.emb.shape[0]
    zf = z.reshape(B * T, D)
    zs = zf.detach()
    if zs.shape[0] < K:
        raise ValueError("the reference draws restarts from >= K rows")
    emb0 = _draw_rows(gen, zs, K)
    cand = _draw_rows(gen, zs, K)
    if not book.initted:
        book.emb, book.emb_sum = emb0.clone(), emb0.clone()
        book.emb_elem = torch.ones(K, device=z.device)
        book.initted = True
    idx = nearest(zs, book.emb)
    zq = book.emb[idx]
    count = torch.bincount(idx, minlength=K).float()
    sums = torch.zeros(K, D, device=z.device).index_add_(0, idx, zs)
    book.emb_sum = mu * book.emb_sum + (1 - mu) * sums
    book.emb_elem = mu * book.emb_elem + (1 - mu) * count
    used = (book.emb_elem >= 1.0)[:, None]
    book.emb = torch.where(used, book.emb_sum / book.emb_elem[:, None], cand)
    enc = (zq - zf).square().sum() / (B * T)
    return (zf + (zq - zf).detach()).reshape(B, T, D), enc


def _l2n(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(
        min=1e-12)


def plain_quantize(emb, z, normalize):
    """A gradient codebook: (z with straight-through codes, codebook loss,
    commitment loss) of (B, T, D) fp32 ``z``."""
    B, T, D = z.shape
    zf = z.reshape(B * T, D)
    zn, en = (_l2n(zf), _l2n(emb)) if normalize else (zf, emb)
    zq = en[nearest(zn.detach(), en.detach())]
    qut = (zq - zn.detach()).square().sum() / (B * T)
    enc = (zq.detach() - zn).square()
    if normalize:
        enc = enc + (zn - zf).square()
    z_vq = zn + (zq - zn).detach()
    return z_vq.reshape(B, T, D), qut, enc.sum() / (B * T)


# ------------------------------------------------------------------ models
def x_like(xhat, x):
    """Unit-variance Gaussian NLL, summed over bins, mean over frames."""
    B, T, _ = x.shape
    return (0.5 * (LOG_2PI + (x - xhat).square())).sum() / (B * T)


class Reference:
    """The training step of one recipe's model on plain tensors.

    ``params``: ``{name: fp32 tensor}`` (copied); ``seed``: the run's seed,
    which seeds the step generators of the EMA codebook's draws."""

    def __init__(self, cfg, params, seed, precision=None):
        self.cfg = cfg
        self.kind = cfg["model_type"].rsplit(".", 1)[-1]
        self.r = precision or Precision("fp32")
        self.P = {n: p.detach().clone().requires_grad_(True)
                  for n, p in params.items()}
        self.names = list(self.P)
        self.seed = seed
        self.step = 0
        dev = next(iter(self.P.values())).device
        self.book = (EmaCodebook(cfg["z_num"], cfg["z_dim"], dev)
                     if self.kind == "vqvae" and cfg.get("use_ema") else None)
        self.b1, self.b2 = cfg.get("betas", (0.5, 0.999))
        self.m = {n: torch.zeros_like(p) for n, p in self.P.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.P.items()}

    def state(self):
        """The training state after ``self.step`` steps, on the host: the
        form :meth:`load_state` takes."""
        book = None if self.book is None else (
            self.book.initted, self.book.emb.cpu(), self.book.emb_sum.cpu(),
            self.book.emb_elem.cpu())
        return {"params": {n: p.detach().cpu() for n, p in self.P.items()},
                "m": {n: t.cpu() for n, t in self.m.items()},
                "v": {n: t.cpu() for n, t in self.v.items()},
                "step": self.step, "book": book}

    def load_state(self, st):
        """Continue from a training state: parameters, Adam's moments, the
        steps taken and the EMA codebook (``initted, emb, emb_sum,
        emb_elem``)."""
        dev = next(iter(self.P.values())).device
        with torch.no_grad():
            for n in self.names:
                self.P[n].copy_(st["params"][n])
        self.m = {n: st["m"][n].to(dev).clone() for n in self.names}
        self.v = {n: st["v"][n].to(dev).clone() for n in self.names}
        self.step = int(st["step"])
        if self.book is not None:
            initted, emb, emb_sum, emb_elem = st["book"]
            self.book.initted = bool(initted)
            self.book.emb = emb.to(dev).clone()
            self.book.emb_sum = emb_sum.to(dev).clone()
            self.book.emb_elem = emb_elem.to(dev).clone()

    def loss(self, x, spk):
        r, P, cfg = self.r, self.P, self.cfg
        y = r(P["embeds.embedding"][spk])[:, None, :]
        if self.kind == "vqvae":
            z, _ = encoder(P, "encoder", cfg["encoder"], r(x), r)
            gen = step_generator(self.seed, self.step, x.device)
            z_vq, enc = ema_quantize(self.book, z.float(), gen,
                                     cfg.get("mu", 0.9))
            xhat = decoder(P, "decoder", cfg["decoder"], r(z_vq), y,
                           r).float()
            return x_like(xhat, x) + cfg.get("beta", 0.01) * enc
        L = cfg["levels"]
        zs, times, h = [], [x.shape[1]], r(x)
        for i in range(L):
            z, h = encoder(P, f"encoder_{i}", cfg[f"encoder.{i}"], h, r)
            zs.append(z)
            times.append(z.shape[1])
        levels, qut, enc = [], [], []
        z_ = zs.pop()
        for i in reversed(range(L)):
            if _is_gst(cfg, i):
                z_vq = gst(P, cfg[f"quantizer.{i}"],
                           z_.float().mean(dim=1))[:, None, :]
            else:
                z_vq, q, e = plain_quantize(
                    P[f"quantizer_embedding_{i}"], z_.float(),
                    cfg[f"quantizer.{i}"].get("normalize", False))
                qut.append(q)
                enc.append(e)
            levels.append([upsample(z_vq, t) for t in times[:i + 1]])
            if i > 0:
                z_ = zs.pop()
                cond = r(torch.cat([lv[i] for lv in levels], dim=-1))
                z_ = decoder(P, f"decoder_{i}", cfg[f"decoder.{i}"], r(z_),
                             cond, r)
        z_vq = r(torch.cat([lv[0] for lv in levels], dim=-1))
        xhat = decoder(P, "decoder_0", cfg["decoder.0"], z_vq,
                       upsample(y, times[0]), r).float()
        return x_like(xhat, x) + sum(qut) + cfg.get("beta", 0.01) * sum(enc)

    def _renorm(self):
        """Unit-norm rows of the normalized gradient codebooks, before
        each step."""
        if self.kind != "vqvae2":
            return
        with torch.no_grad():
            for i in range(self.cfg["levels"]):
                name = f"quantizer_embedding_{i}"
                q = self.cfg.get(f"quantizer.{i}", {})
                if name in self.P and q.get("normalize", False):
                    self.P[name].copy_(_l2n(self.P[name]))

    def train_step(self, x, spk):
        """One step: loss, gradient, clip by global norm, Adam. Returns
        (loss, the clipped gradient by name)."""
        self._renorm()
        loss = self.loss(x, spk)
        grads = torch.autograd.grad(loss, [self.P[n] for n in self.names])
        cfg = self.cfg
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        clip = cfg.get("max_grad_norm", 5)
        scale = (torch.clamp(clip / (norm + 1e-6), max=1.0) if clip
                 and clip > 0 else torch.ones((), device=norm.device))
        p = cfg.get("lr_param", {"step_size": 100000, "gamma": 0.5})
        lr = cfg.get("learning_rate", 1e-3)
        if cfg.get("lr_scheduler") is not None:
            lr = lr * p.get("gamma", 0.5) ** (self.step
                                              // p.get("step_size", 100000))
        self.step += 1
        c = self.step
        self.grad_norm = float(norm)
        clipped = {}
        with torch.no_grad():
            for n, g in zip(self.names, grads):
                g = g.float() * scale
                clipped[n] = g
                self.m[n] = self.b1 * self.m[n] + (1 - self.b1) * g
                self.v[n] = self.b2 * self.v[n] + (1 - self.b2) * g * g
                mh = self.m[n] / (1 - self.b1 ** c)
                vh = self.v[n] / (1 - self.b2 ** c)
                self.P[n] -= lr * mh / (torch.sqrt(vh) + 1e-8)
        return float(loss.detach()), clipped
