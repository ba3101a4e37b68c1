"""The part of Kaldi ark/scp I/O that serving and training need, in numpy.

Counterpart of ``vae_npvc_tpu/data/kaldi_io.py`` (the port keeps its own
copy): :func:`load_dict_data` / :func:`load_list_data` for data-dir text
files, :func:`read_ark` for whole arks (CMVN stats), :func:`load_mat` and
:func:`matrix_header` for ``path:offset[s:e]`` specifiers with seek-based
row ranges (the training crops), over binary float/double matrices and
vectors (``FM``/``DM``/``FV``/``DV``) and the three compressed formats
(``CM``/``CM2``/``CM3``). :class:`ArkWriter` writes uncompressed ark + scp;
compressed writing belongs to the offline decode slice.
"""

from __future__ import annotations

import io
import os
import re
import struct

import numpy as np

_BINARY_FLAG = b"\x00B"
_RANGE_RE = re.compile(r"^(.*)\[([^\]]*)\]$")


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


def load_list_data(path):
    """``[[tok, tok, ...], ...]``: whitespace-split non-empty lines."""
    with open(path) as f:
        return [line.strip().split() for line in f if line.strip()]


def _parse_range(range_str, num_rows, num_cols):
    """Parse 's:e' or 's:e,cs:ce' (inclusive, Kaldi-style) into bounds."""
    parts = range_str.split(",")

    def one(p, n):
        p = p.strip()
        if not p or p == ":":
            return 0, n - 1
        s, e = p.split(":")
        return (int(s) if s else 0), (int(e) if e else n - 1)

    rs, re_ = one(parts[0], num_rows)
    cs, ce = one(parts[1], num_cols) if len(parts) > 1 else (0, num_cols - 1)
    return rs, re_, cs, ce


def _split_rxspec(rxspec):
    """Split 'path:offset[range]' into (path, offset, range_str)."""
    rxspec = rxspec.strip()
    m = _RANGE_RE.match(rxspec)
    range_str = None
    if m:
        rxspec, range_str = m.group(1), m.group(2)
    path, offset = rxspec, 0
    idx = rxspec.rfind(":")
    if idx > 0 and rxspec[idx + 1:].isdigit():
        path, offset = rxspec[:idx], int(rxspec[idx + 1:])
    return path, offset, range_str


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


def _uint16_to_float(p, min_value, range_value):
    return min_value + range_value * (p.astype(np.float64) / 65535.0)


def _char_to_float(u8, p0, p25, p75, p100):
    """Piecewise-linear uint8 -> float decode of Kaldi format-1 columns."""
    v = u8.astype(np.float64)
    lo = p0 + (p25 - p0) * (v / 64.0)
    mid = p25 + (p75 - p25) * ((v - 64.0) / 128.0)
    hi = p75 + (p100 - p75) * ((v - 192.0) / 63.0)
    return np.where(v <= 64, lo, np.where(v <= 192, mid, hi))


def _read_compressed(f, token):
    min_value, range_value, num_rows, num_cols = struct.unpack(
        "<ffii", f.read(16))
    if token == "CM":     # per-column headers + uint8, column-major
        headers = np.frombuffer(f.read(8 * num_cols), dtype="<u2") \
            .reshape(num_cols, 4)
        data = np.frombuffer(f.read(num_rows * num_cols), dtype=np.uint8) \
            .reshape(num_cols, num_rows)
        pf = _uint16_to_float(headers, min_value, range_value)
        out = np.empty((num_rows, num_cols), dtype=np.float32)
        for c in range(num_cols):
            out[:, c] = _char_to_float(data[c], *pf[c])
        return out
    if token == "CM2":    # uint16 per element, row-major
        data = np.frombuffer(f.read(2 * num_rows * num_cols), dtype="<u2")
        return _uint16_to_float(data, min_value, range_value) \
            .reshape(num_rows, num_cols).astype(np.float32)
    if token == "CM3":    # uint8 per element, row-major
        data = np.frombuffer(f.read(num_rows * num_cols), dtype=np.uint8)
        return (min_value + range_value * (data.astype(np.float64) / 255.0)) \
            .reshape(num_rows, num_cols).astype(np.float32)
    raise ValueError(f"unknown compressed token {token!r}")


def read_matrix(f, range_str=None):
    """Read one binary matrix or vector at the file's current position;
    ``range_str`` ('s:e' or 's:e,cs:ce', inclusive) reads only those rows
    of an uncompressed matrix."""
    flag = f.read(2)
    if flag != _BINARY_FLAG:
        raise ValueError(f"expected Kaldi binary flag \\0B, got {flag!r}")
    token = _read_token(f)
    if token in ("FM", "DM"):
        dtype = np.dtype("<f4" if token == "FM" else "<f8")
        rows, cols = _read_int(f), _read_int(f)
        rs, re_, cs, ce = (0, rows - 1, 0, cols - 1) if range_str is None \
            else _parse_range(range_str, rows, cols)
        f.seek(rs * cols * dtype.itemsize, io.SEEK_CUR)
        n = (re_ - rs + 1) * cols
        mat = np.frombuffer(f.read(n * dtype.itemsize), dtype) \
            .reshape(re_ - rs + 1, cols)
        return mat[:, cs:ce + 1].copy()
    if token in ("FV", "DV"):
        dtype = np.dtype("<f4" if token == "FV" else "<f8")
        dim = _read_int(f)
        vec = np.frombuffer(f.read(dim * dtype.itemsize), dtype).copy()
        if range_str is not None:
            rs, re_, _, _ = _parse_range(range_str, dim, 1)
            vec = vec[rs:re_ + 1]
        return vec
    if token.startswith("CM"):
        mat = _read_compressed(f, token)
        if range_str is not None:   # decode the whole matrix, then slice
            rs, re_, cs, ce = _parse_range(range_str, *mat.shape)
            mat = np.ascontiguousarray(mat[rs:re_ + 1, cs:ce + 1])
        return mat
    raise ValueError(f"unsupported Kaldi token {token!r}")


def load_mat(rxspec):
    """Load a matrix from 'path:offset' with an optional '[s:e]' range."""
    path, offset, range_str = _split_rxspec(rxspec)
    with open(path, "rb") as f:
        f.seek(offset)
        return read_matrix(f, range_str)


def matrix_header(rxspec):
    """(rows, cols) that :func:`load_mat` on the same specifier would
    give, without reading the data."""
    path, offset, range_str = _split_rxspec(rxspec)
    with open(path, "rb") as f:
        f.seek(offset)
        flag = f.read(2)
        if flag != _BINARY_FLAG:
            raise ValueError(f"expected Kaldi binary flag \\0B, got {flag!r}")
        token = _read_token(f)
        if token in ("FM", "DM"):
            rows, cols = _read_int(f), _read_int(f)
        elif token.startswith("CM"):
            _, _, rows, cols = struct.unpack("<ffii", f.read(16))
        else:
            raise ValueError(f"not a matrix: {token!r}")
    if range_str is not None:
        rs, re_, cs, ce = _parse_range(range_str, rows, cols)
        return re_ - rs + 1, ce - cs + 1
    return rows, cols


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


class ArkWriter:
    """Write (utt, matrix) pairs into an uncompressed ark file (``FM``, or
    ``DM`` for float64) with an optional scp index."""

    def __init__(self, ark_path, scp_path=None):
        self.ark_path = str(ark_path)
        self._ark = open(ark_path, "wb")
        self._scp = open(scp_path, "w") if scp_path else None

    def write(self, utt, mat):
        mat = np.asarray(mat)
        if mat.ndim != 2:
            raise ValueError("only 2-D matrices supported")
        self._ark.write(utt.encode() + b" ")
        offset = self._ark.tell()
        double = mat.dtype == np.float64
        self._ark.write(_BINARY_FLAG + (b"DM " if double else b"FM "))
        for n in mat.shape:
            self._ark.write(b"\x04" + struct.pack("<i", n))
        self._ark.write(np.ascontiguousarray(
            mat, dtype="<f8" if double else "<f4").tobytes())
        if self._scp:
            self._scp.write(
                f"{utt} {os.path.abspath(self.ark_path)}:{offset}\n")

    def close(self):
        self._ark.close()
        if self._scp:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
