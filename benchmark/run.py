"""The benchmark of ``vae_npvc_tpu_torch``: one run of one cell.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The run builds the port's kernels (into
``vae_npvc_tpu_torch/_build/``), makes its weights and inputs from
``--seed``, warms the cell's shapes, measures for ``--seconds`` and prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the output check compared,
beside its limit. The same numbers close standard error.

It exits non-zero and prints no result without as many CUDA devices as the
cell asks for, or when JAX or the JAX package was loaded in the process.
"""

from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every compiler cache at a fixed path inside the checkout, so that only
# the first run of a checkout builds
CACHE = ROOT / ".benchcache"


def _process_start():
    """The process's start on the ``time.time()`` clock (from /proc), or
    the moment this module was imported."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return STARTED


def _caches():
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    os.environ["USE_FLAX"] = "0"

    from benchmark import harness

    spec = harness.load_spec(ROOT)
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}
    if args.workload not in chips:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips[args.workload]:
        print(f"needs {chips[args.workload]} CUDA device(s); found {cards} "
              "(no CPU fallback)", file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              args.trace, spec=spec,
                              started=_process_start())
    found = harness.forbidden_modules()
    if found:
        print(f"JAX loaded in the benchmark's process: {found}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
