"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Counterpart of ``vae_npvc_tpu/ops/pallas_common.py``: the one place that
knows how a kernel reaches the device. Each source compiles with ``nvcc``
into its own shared library with a plain C interface, loaded with
``ctypes``: no PyTorch headers, so a build takes seconds. Libraries go to
``vae_npvc_tpu_torch/_build/`` (git-ignored), named by a hash of the
source, so an edited source rebuilds and an unchanged one is reused.

The first call to :func:`library` builds every source at once, one
``nvcc`` process per source, all started together. Nothing here runs at
import time: the CPU-only test host imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all():
    """Compile every ``csrc/*.cu`` whose library is missing, in parallel.

    Returns ``{name: library path}``. Raises with the compiler's output
    when a build fails. The ``-Xptxas -v`` report (registers, shared
    memory, spills) is kept beside each library as ``<name>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = {}
    for src in sources:
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failures = []
    for src, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{src.stem}.log").write_bytes(log)
        if proc.returncode:
            failures.append(f"{src.name}:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    return {src.stem: _target(src) for src in sources}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            for stem, path in paths.items():
                if stem not in _libs:
                    _libs[stem] = ctypes.CDLL(str(path))
            lib = _libs[name]
        return lib


def check(code: int, lib: ctypes.CDLL, err_fn: str, what: str):
    """Raise when a launcher returned a CUDA error code."""
    if code:
        fn = getattr(lib, err_fn)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what} launch failed: CUDA error {code} "
                           f"({fn(code).decode()})")


def stream_of(t):
    """PyTorch's current stream on ``t``'s device, as a pointer int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
