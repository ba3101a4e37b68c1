"""Plot a training run's metrics.jsonl (bin/train.py) to a PNG.

The port's own copy of ``vae_npvc_tpu/utils/plot_metrics.py``: a host tool,
pure matplotlib over the ``metrics.jsonl`` that the port's ``bin/train``
writes (the same rows as the JAX CLI's). Small-multiple line panels, one
metric per panel, one y-axis each (never dual axes); train as a line,
validation as markers on the same panel when the key exists in both
splits. Colors are the validated default dataviz palette slots 1-2 in
fixed order (train=blue, valid=orange); grid and spines recessive; text in
neutral ink.

Usage:
    python -m vae_npvc_tpu_torch.utils.plot_metrics exp/.../metrics.jsonl
        [--out plot.png] [--keys "Total,X like,grad_norm,frames_per_sec"]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK2 = "#52514e"
GRID = "#e6e5e2"
TRAIN_C = "#2a78d6"   # categorical slot 1 (blue)
VALID_C = "#eb6834"   # categorical slot 2 (orange)

PREFERRED = ["Total", "X like", "VQ loss", "grad_norm", "frames_per_sec"]


def load(path):
    rows = [json.loads(ln) for ln in Path(path).read_text().splitlines()
            if ln.strip()]
    train = [r for r in rows if r.get("split") == "train"]
    valid = [r for r in rows if r.get("split") == "valid"]
    return train, valid


def pick_keys(train, valid, requested=None, max_panels=6):
    if requested:
        return [k.strip() for k in requested.split(",") if k.strip()]
    skip = {"iter", "split", "best_iter"}
    present = []
    for r in train + valid:
        for k in r:
            if k not in skip and k not in present:
                present.append(k)
    keys = [k for k in PREFERRED if k in present]
    keys += [k for k in present if k not in keys]
    return keys[:max_panels]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("metrics", help="path to metrics.jsonl")
    ap.add_argument("--out", default=None,
                    help="output PNG (default: <metrics dir>/metrics.png)")
    ap.add_argument("--keys", default=None,
                    help="comma-separated metric keys (default: auto)")
    args = ap.parse_args(argv)

    try:
        import matplotlib
    except ImportError:
        raise SystemExit(
            "plot_metrics needs matplotlib: pip install 'vae-npvc-tpu[plot]'")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    train, valid = load(args.metrics)
    if not train and not valid:
        raise SystemExit("plot_metrics: no rows in the metrics file")
    keys = pick_keys(train, valid, args.keys)
    if not keys:
        raise SystemExit("plot_metrics: no plottable keys")

    ncols = 2 if len(keys) > 1 else 1
    nrows = -(-len(keys) // ncols)
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(6.4 * ncols, 3.2 * nrows), dpi=120)
    fig.patch.set_facecolor(SURFACE)
    axes = [axes] if len(keys) == 1 else list(
        axes.ravel() if hasattr(axes, "ravel") else axes)

    for ax, key in zip(axes, keys):
        ax.set_facecolor(SURFACE)
        xt = [r["iter"] for r in train if key in r]
        yt = [r[key] for r in train if key in r]
        xv = [r["iter"] for r in valid if key in r]
        yv = [r[key] for r in valid if key in r]
        n_series = (1 if xt else 0) + (1 if xv else 0)
        if xt:
            ax.plot(xt, yt, color=TRAIN_C, linewidth=2, label="train",
                    solid_capstyle="round")
        if xv:
            ax.plot(xv, yv, color=VALID_C, linewidth=0, marker="o",
                    markersize=5, label="valid")
        ax.set_title(key, color=INK, fontsize=11, loc="left")
        ax.set_xlabel("iteration", color=INK2, fontsize=9)
        ax.grid(True, color=GRID, linewidth=0.6)
        ax.tick_params(colors=INK2, labelsize=8)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
        for side in ("left", "bottom"):
            ax.spines[side].set_color(GRID)
        if n_series >= 2:          # legend only when identity needs it
            leg = ax.legend(frameon=False, fontsize=8)
            for t in leg.get_texts():
                t.set_color(INK2)
    for ax in axes[len(keys):]:
        ax.set_visible(False)

    out = args.out or str(Path(args.metrics).parent / "metrics.png")
    fig.tight_layout()
    fig.savefig(out, facecolor=SURFACE)
    print(f"Wrote {out} ({len(keys)} panels, "
          f"{len(train)} train / {len(valid)} valid rows)")


if __name__ == "__main__":
    main()
