"""The part of Kaldi ark/scp I/O that serving needs, in numpy.

Counterpart of ``vae_npvc_tpu/data/kaldi_io.py`` (the port keeps its own
copy): :func:`load_dict_data` for data-dir text files such as
``spk2spk_id``, and :func:`read_ark` for binary float/double matrices and
vectors (``FM``/``DM``/``FV``/``DV``), which is how CMVN stats are stored.
Compressed matrices and row ranges belong to the offline decode slice.
"""

from __future__ import annotations

import struct

import numpy as np

_BINARY_FLAG = b"\x00B"


def load_dict_data(path):
    """Read ``<key> <rest of line>`` lines into an ordered dict."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                key, rest = line.split(None, 1)
                out[key] = rest
    return out


def _read_token(f):
    tok = b""
    while True:
        c = f.read(1)
        if not c or c == b" ":
            return tok.decode()
        tok += c


def _read_int(f):
    size = f.read(1)[0]
    if size == 4:
        return struct.unpack("<i", f.read(4))[0]
    if size == 8:
        return struct.unpack("<q", f.read(8))[0]
    raise ValueError(f"unsupported int size {size}")


def read_matrix(f):
    """Read one binary matrix or vector at the file's current position."""
    flag = f.read(2)
    if flag != _BINARY_FLAG:
        raise ValueError(f"expected Kaldi binary flag \\0B, got {flag!r}")
    token = _read_token(f)
    if token in ("FM", "DM"):
        dtype = np.dtype("<f4" if token == "FM" else "<f8")
        rows, cols = _read_int(f), _read_int(f)
        data = f.read(rows * cols * dtype.itemsize)
        return np.frombuffer(data, dtype).reshape(rows, cols).copy()
    if token in ("FV", "DV"):
        dtype = np.dtype("<f4" if token == "FV" else "<f8")
        dim = _read_int(f)
        return np.frombuffer(f.read(dim * dtype.itemsize), dtype).copy()
    raise ValueError(f"unsupported Kaldi token {token!r} (only FM/DM/FV/DV)")


def read_ark(path):
    """Yield ``(key, matrix)`` from a binary ark file."""
    with open(path, "rb") as f:
        while True:
            key = b""
            while True:
                c = f.read(1)
                if not c:
                    return
                if c == b" ":
                    break
                key += c
            yield key.decode(), read_matrix(f)
