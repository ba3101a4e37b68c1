"""ctypes bridge to the C++ ark batch loader (``native/ark_loader.cc``).

Counterpart of ``vae_npvc_tpu/data/native_loader.py``, with the same
``NativeArkLoader.open / num_frames / load_batch / close``. The shared
library is built with ``g++`` at first use into the git-ignored
``vae_npvc_tpu_torch/_build/``, named by a hash of the source and the
flags (as ``ops/_build.py`` names the kernels' libraries), so an edited
source rebuilds and an unchanged one is reused. Each process compiles to a
temporary path of its own and renames it into place, so processes that
build at once never load a half-written library.

A failed build raises with the compiler's output: a loader the config asks
for does not quietly disappear. :meth:`NativeArkLoader.open` returns
``None`` only for what the C++ reader does not take (double matrices,
range rxspecifiers, mixed feature dims), and the caller reads those with
Python, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "ark_loader.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None


def library_path(build_dir=BUILD_DIR) -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return Path(build_dir) / f"ark_loader-{digest}.so"


def build(build_dir=BUILD_DIR, cxx="g++") -> Path:
    """Compile the loader unless its library exists; returns its path.
    Raises ``RuntimeError`` with the compiler's output when it fails."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
    except OSError as e:
        raise RuntimeError(f"native ark loader: cannot run {cxx!r}: {e}") \
            from e
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native ark loader: {cxx} failed (exit {proc.returncode}):\n"
            + proc.stdout.decode(errors="replace"))
    os.replace(tmp, out)
    return out


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.loader_open.restype = ctypes.c_void_p
        lib.loader_open.argtypes = [ctypes.c_char_p]
        lib.loader_num_utts.restype = ctypes.c_long
        lib.loader_num_utts.argtypes = [ctypes.c_void_p]
        lib.loader_feat_dim.restype = ctypes.c_int
        lib.loader_feat_dim.argtypes = [ctypes.c_void_p]
        lib.loader_num_frames.restype = ctypes.c_long
        lib.loader_num_frames.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.loader_load_batch.restype = ctypes.c_int
        lib.loader_load_batch.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_long, ctypes.c_long,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
        ]
        lib.loader_close.restype = None
        lib.loader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeArkLoader:
    """Windowed batch reads over one feats.scp; thread-parallel in C++."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib
        self.num_utts = lib.loader_num_utts(handle)
        self.feat_dim = lib.loader_feat_dim(handle)

    @classmethod
    def open(cls, feats_scp):
        """A loader, or None when the scp holds what the C++ reader does
        not take (double matrices, range rxspecifiers, mixed dims)."""
        lib = _load_lib()
        h = lib.loader_open(str(feats_scp).encode())
        if not h:
            return None
        return cls(h, lib)

    def num_frames(self, idx):
        return self._lib.loader_num_frames(self._h, int(idx))

    def load_batch(self, indices, starts, crop, out=None, nthreads=8):
        """Fill (n, crop, dim) float32; rows past each utterance end are 0."""
        indices = np.ascontiguousarray(indices, np.int64)
        starts = np.ascontiguousarray(starts, np.int64)
        n = len(indices)
        if len(starts) != n:
            raise ValueError(f"{n} indices but {len(starts)} starts")
        if out is None:
            out = np.empty((n, crop, self.feat_dim), np.float32)
        elif (out.dtype != np.float32 or not out.flags.c_contiguous
              or out.shape != (n, crop, self.feat_dim)):
            raise ValueError(f"out must be C-contiguous float32 of shape "
                             f"{(n, crop, self.feat_dim)}")
        rc = self._lib.loader_load_batch(self._h, indices, starts, n, crop,
                                         out, nthreads)
        if rc != 0:
            raise IOError(f"native ark loader failed with code {rc}")
        return out

    def close(self):
        if self._h:
            self._lib.loader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
