"""Environment self-check: is this host ready to train and serve the port?

Counterpart of ``vae_npvc_tpu/bin/doctor.py``: the same check names, one
line per check (``ok`` / ``warn`` / ``FAIL``, ``skip`` after a wedged
device), ``--json`` and ``--timeout``, and an exit code that is non-zero
iff a required check failed. Each device-touching probe runs in a daemon
thread with a deadline: a wedged device makes the doctor report ``device
probe timed out`` instead of hanging with it, and the later
device-touching checks are skipped (they would block on the same device).

Checks:
  imports        torch and numpy versions, the CUDA version of the torch
                 build
  platform       the requested ``--device`` (default ``cuda``) through
                 ``utils/device.resolve_device`` (which raises without a
                 GPU and turns TF32 off), ``torch.cuda.is_available()``
  devices        the CUDA device list and a tiny matmul on the requested
                 device, fetched to the host, with its latency
  cpu-fallback   the same matmul on the CPU, the path a caller asks for
                 with ``--device cpu`` (the main path never falls back)
  compile-cache  ``vae_npvc_tpu_torch/_build/`` writable, ``nvcc`` found,
                 every ``csrc/*.cu`` built (``ops/_build.build_all``), the
                 native ark loader's library built
  model (opt.)   --config: build the model on the device with seeded
                 random weights, one ``infer``; K1/K2 launches reported
  bundle (opt.)  --bundle: load a port serving bundle, one ``infer``
                 through its smallest bucket
  server (opt.)  --url: ``/health`` and ``/speakers`` of a running
                 ``bin/serve``

Usage:
  python -m vae_npvc_tpu_torch.bin.doctor [--device cuda|cpu]
      [--config conf.json] [--bundle exp/bundle] [--url http://host:8080]
      [--timeout 120] [--json]

A ``.json`` config works where PyYAML is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time


def _run_with_deadline(fn, timeout):
    """Run ``fn()`` on a daemon thread; return (finished, value, exc).

    Daemon (not a ThreadPoolExecutor): a wedged device op blocks its thread
    forever, and executor threads are joined at interpreter shutdown; the
    doctor process must stay free to exit past a stuck probe.
    """
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — reported to the caller
            box["exc"] = e

    t = threading.Thread(target=run, daemon=True, name="doctor-probe")
    t.start()
    t.join(timeout)
    if t.is_alive():
        _leaked_threads.append(t)
    return (not t.is_alive(), box.get("value"), box.get("exc"))


# probe threads stuck inside a wedged native device op: the CLI entry
# hard-exits when any are still alive
_leaked_threads: list = []

# set by _check_devices on timeout: later device-touching checks would
# block on the same device and each burn a full --timeout
_wedged: dict = {}


def _check_imports():
    import numpy as np
    import torch

    cuda = torch.version.cuda or "none (CPU-only build)"
    return "ok", (f"torch {torch.__version__} (CUDA {cuda}), numpy "
                  f"{np.__version__}, python {sys.version.split()[0]}")


def _check_platform(device):
    import torch

    from ..utils.device import resolve_device

    try:
        dev = resolve_device(device)
    except (RuntimeError, ValueError) as e:
        return "FAIL", (f"--device {device}: {e} (torch.cuda.is_available()"
                        f" = {torch.cuda.is_available()})")
    return "ok", (f"device {dev}, torch.cuda.is_available() = "
                  f"{torch.cuda.is_available()}; TF32 for matmul "
                  f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
                  f"{torch.backends.cudnn.allow_tf32}")


def _device_probe(device):
    """Tiny matmul on ``device``, fetched back to the host. Runs inside a
    worker thread."""
    import torch

    t0 = time.monotonic()
    names = ([torch.cuda.get_device_name(i)
              for i in range(torch.cuda.device_count())]
             if torch.cuda.is_available() else [])
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32
    x = torch.ones((128, 128), dtype=dtype, device=device)
    v = float((x @ x).float()[0, 0].cpu())
    if v != 128.0:
        raise AssertionError(f"matmul returned {v}, expected 128.0")
    return names, time.monotonic() - t0


def _check_devices(device, timeout):
    finished, value, exc = _run_with_deadline(lambda: _device_probe(device),
                                              timeout)
    if not finished:
        _wedged["devices"] = True
        return "FAIL", (f"device probe timed out after {timeout:.0f}s "
                        "(wedged device? every device op may hang)")
    if exc is not None:
        return "FAIL", f"device probe raised {type(exc).__name__}: {exc}"
    names, dt = value
    kinds = {}
    for n in names:
        kinds[n] = kinds.get(n, 0) + 1
    desc = ", ".join(f"{n}x {k}" for k, n in sorted(kinds.items())) \
        or "no CUDA device"
    return "ok", f"{desc}; matmul on {device} round-trip {dt:.2f}s"


def _check_cpu_fallback(timeout):
    def probe():
        import torch

        x = torch.ones((64, 64), dtype=torch.float32)
        return float((x @ x)[0, 0])

    finished, v, exc = _run_with_deadline(probe, timeout)
    if not finished:
        return "FAIL", f"CPU probe timed out after {timeout:.0f}s"
    if exc is not None:
        return "FAIL", f"CPU path broken: {type(exc).__name__}: {exc}"
    return ("ok", "CPU matmul ok (--device cpu)") if v == 64.0 else \
        ("FAIL", f"CPU matmul returned {v}")


def _check_cache(device, timeout):
    """The build directory, the CUDA kernels' libraries and the native
    loader's. Without ``nvcc`` a CPU run is fine (the CPU takes the plain
    versions); a CUDA run is not."""
    from ..data import native_loader
    from ..ops import _build

    d = _build.BUILD_DIR
    try:
        d.mkdir(parents=True, exist_ok=True)
        probe = d / ".doctor_probe"
        probe.write_text("ok")
        probe.unlink()
    except OSError as e:
        return "FAIL", f"build dir {d} not writable: {e}"

    def build():
        loader = native_loader.build()
        try:
            nvcc = _build._nvcc()
        except RuntimeError as e:
            return loader, None, str(e)
        return loader, nvcc, _build.build_all()

    finished, value, exc = _run_with_deadline(build, timeout)
    if not finished:
        return "FAIL", f"builds timed out after {timeout:.0f}s"
    if exc is not None:
        return "FAIL", f"build failed: {type(exc).__name__}: {exc}"
    loader, nvcc, kernels = value
    if nvcc is None:
        status = "FAIL" if device.startswith("cuda") else "warn"
        return status, (f"{d} writable, native loader {loader.name}; "
                        f"{kernels}")
    return "ok", (f"{d} writable, nvcc {nvcc}, {len(kernels)} kernel "
                  f"libraries ({', '.join(sorted(kernels))}), native loader "
                  f"{loader.name}")


def _launch_counters():
    from ..ops.groupnorm import fused_group_norm
    from ..ops.vq_fused import vq_fused

    return {"vq_fused": vq_fused, "fused_group_norm": fused_group_norm}


def _check_model(config_path, device, timeout):
    def probe():
        import numpy as np

        from ..infer.convert import Converter
        from ..infer.export_serving import _feat_dim
        from .train import load_config

        config = load_config(config_path)
        conv = Converter(config, device=device)
        conv.model.init_random(0)
        T = max(64, conv.min_frames)
        x = np.zeros((1, T, _feat_dim(config)), np.float32)
        counters = _launch_counters()
        before = {k: fn.launches for k, fn in counters.items()}
        out = conv.infer(x, np.zeros((1,), np.int32),
                         np.full((1,), T, np.int32))
        launches = {k: fn.launches - before[k] for k, fn in counters.items()}
        n_params = sum(p.numel() for p in conv.model.parameters())
        return n_params, tuple(out.shape), launches

    finished, value, exc = _run_with_deadline(probe, timeout)
    if not finished:
        return "FAIL", f"model build+infer timed out after {timeout:.0f}s"
    if exc is not None:
        return "FAIL", f"model build failed: {type(exc).__name__}: {exc}"
    n_params, shape, launches = value
    mm = (f"{n_params / 1e6:.2f}M" if n_params >= 1e5
          else f"{n_params:,}")
    return "ok", (f"{mm} params, infer out {shape} on {device}, launches "
                  f"K1 {launches['vq_fused']} / K2 "
                  f"{launches['fused_group_norm']}"), {"launches": launches}


def _check_url(url, timeout):
    """Probe a running ``bin/serve`` endpoint: /health + /speakers."""
    def probe():
        import urllib.request

        base = url.rstrip("/")
        with urllib.request.urlopen(base + "/health",
                                    timeout=min(timeout, 30)) as r:
            health = json.loads(r.read().decode())
        with urllib.request.urlopen(base + "/speakers",
                                    timeout=min(timeout, 30)) as r:
            speakers = json.loads(r.read().decode())
        return health, len(speakers)

    finished, value, exc = _run_with_deadline(probe, timeout)
    if not finished:
        return "FAIL", f"server probe timed out after {timeout:.0f}s"
    if exc is not None:
        return "FAIL", f"server unreachable: {type(exc).__name__}: {exc}"
    health, n_spk = value
    if health.get("status") != "ok":
        return "FAIL", f"/health not ok: {health}"
    return "ok", (f"/health ok (iter {health.get('iteration', '?')}, "
                  f"vocoder {health.get('vocoder', '?')}), "
                  f"{n_spk} target speaker(s)")


def _check_bundle(path, device, timeout):
    def probe():
        import numpy as np

        from ..infer.export_serving import ServingBundle

        b = ServingBundle(path, device=device)
        T = b.buckets[0]
        L = max(1, min(T, int(b.meta.get("min_frames", 1))))
        feats = np.zeros((1, T, b.feat_dim), np.float32)
        out = b.infer(feats, np.zeros((1,), np.int32),
                      np.full((1,), L, np.int32))
        return tuple(out.shape), len(b.buckets), b.meta.get("quantize")

    finished, value, exc = _run_with_deadline(probe, timeout)
    if not finished:
        return "FAIL", f"bundle load+infer timed out after {timeout:.0f}s"
    if exc is not None:
        return "FAIL", f"bundle check failed: {type(exc).__name__}: {exc}"
    shape, n_buckets, quant = value
    q = f", {quant} params" if quant else ""
    return "ok", f"infer out {shape}, {n_buckets} bucket(s){q}"


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="vae_npvc_tpu_torch environment self-check")
    ap.add_argument("--device", default="cuda",
                    help="the device the port should run on (cuda or cpu)")
    ap.add_argument("--config", default=None,
                    help="optional experiment YAML or .json: build the "
                         "model and run one infer call")
    ap.add_argument("--bundle", default=None,
                    help="optional serving-bundle dir: load it and run one "
                         "infer through the smallest exported bucket")
    ap.add_argument("--url", default=None,
                    help="optional running bin/serve base URL "
                         "(e.g. http://host:8080): probe /health + "
                         "/speakers")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="deadline (s) for each device-touching check")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable one-line-JSON output")
    args = ap.parse_args(argv)
    _wedged.clear()
    dev = args.device

    # (name, fn, touches_device): device-touching checks are skipped after
    # the devices probe times out
    checks = [("imports", _check_imports, False),
              ("platform", lambda: _check_platform(dev), False),
              ("devices", lambda: _check_devices(dev, args.timeout), False),
              ("cpu-fallback",
               lambda: _check_cpu_fallback(args.timeout), True),
              ("compile-cache", lambda: _check_cache(dev, args.timeout),
               False)]
    if args.config:
        checks.append(("model", lambda: _check_model(
            args.config, dev, args.timeout), True))
    if args.bundle:
        checks.append(("bundle", lambda: _check_bundle(
            args.bundle, dev, args.timeout), True))
    if args.url:
        # pure HTTP: probes the server process, not this host's device
        checks.append(("server",
                       lambda: _check_url(args.url, args.timeout), False))

    results = {}
    failed = False
    for name, fn, touches_device in checks:
        extra = {}
        try:
            if touches_device and _wedged.get("devices"):
                status, detail = "skip", ("device wedged (devices probe "
                                          "timed out); not probing")
            else:
                status, detail, *rest = fn()
                extra = rest[0] if rest else {}
        except Exception as e:  # noqa: BLE001 — a check must never crash
            status, detail = "FAIL", f"{type(e).__name__}: {e}"
        results[name] = {"status": status, "detail": detail, **extra}
        failed |= status == "FAIL"
        if not args.json:
            print(f"{name:14s} {status:4s} {detail}", flush=True)
    if args.json:
        print(json.dumps({"ok": not failed, "checks": results}))
    elif failed:
        print("doctor: FAILED (see above)", flush=True)
    return 1 if failed else 0


def cli(argv=None):
    """Console entry: ``main`` + a hard exit past wedged probe threads."""
    rc = main(argv)
    if any(t.is_alive() for t in _leaked_threads):
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)  # skip finalization: a thread is stuck in native code
    return rc


if __name__ == "__main__":
    sys.exit(cli())
