"""Kaldi ark/scp and data-dir I/O in numpy.

Counterpart of ``vae_npvc_tpu/data/kaldi_io.py`` (the port keeps its own
copy): :func:`load_dict_data` / :func:`read_scp` / :func:`load_list_data` /
:func:`save_dict_data` for data-dir text files, :func:`read_wav_scp_entry`
for ``wav.scp`` lines (a path or a trailing-pipe command), :func:`read_ark`
for whole arks (:func:`read_rspecifier` for ``ark:``/``scp:``
rspecifiers), :func:`load_mat` and :func:`matrix_header` for
``path:offset[s:e]`` specifiers with seek-based row ranges (the training
crops), over binary float/double matrices and vectors (``FM``/``DM``/
``FV``/``DV``) and the three compressed formats (``CM``/``CM2``/``CM3``).
:class:`ArkWriter` (or :func:`write_helper` from a wspecifier) writes ark +
scp, uncompressed (``FM``, ``DM`` for float64) or with Kaldi compression
method 1 (per-column percentile headers + uint8; ``CM2`` for 8 rows or
fewer) or 2 (``CM2``), byte for byte as the JAX package writes them.
"""

from __future__ import annotations

import io
import os
import re
import struct
import subprocess

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


# the same parse, under the name scp readers use
read_scp = load_dict_data


def save_dict_data(path, d):
    """Write ``{key: value}`` as ``<key> <value>`` lines."""
    with open(path, "w") as f:
        for k, v in d.items():
            f.write(f"{k} {v}\n")


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


def _float_to_uint16(f, min_value, range_value):
    x = (np.asarray(f, dtype=np.float64) - min_value) / max(range_value, 1e-20)
    return np.clip(x * 65535.0 + 0.499, 0, 65535).astype(np.uint16)


def _char_to_float(u8, p0, p25, p75, p100):
    """Piecewise-linear uint8 -> float decode of Kaldi format-1 columns."""
    v = u8.astype(np.float64)
    lo = p0 + (p25 - p0) * (v / 64.0)
    mid = p25 + (p75 - p25) * ((v - 64.0) / 128.0)
    hi = p75 + (p100 - p75) * ((v - 192.0) / 63.0)
    return np.where(v <= 64, lo, np.where(v <= 192, mid, hi))


def _float_to_char(x, p0, p25, p75, p100):
    """Inverse of :func:`_char_to_float` (Kaldi format-1 quantizer)."""
    x = np.asarray(x, dtype=np.float64)
    eps = 1e-20
    lo = np.clip((x - p0) / max(p25 - p0, eps) * 64.0 + 0.5, 0, 64)
    mid = np.clip(64.0 + (x - p25) / max(p75 - p25, eps) * 128.0 + 0.5,
                  65, 192)
    hi = np.clip(192.0 + (x - p75) / max(p100 - p75, eps) * 63.0 + 0.5,
                 193, 255)
    return np.where(x <= p25, lo, np.where(x <= p75, mid, hi)) \
        .astype(np.uint8)


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


def read_rspecifier(rspecifier):
    """Yield ``(key, matrix)`` from ``ark:path``, ``scp:path`` or a bare
    ark path (the JAX package's ``read_ark`` over an rspecifier)."""
    kind, _, path = str(rspecifier).partition(":")
    if not path:
        kind, path = "ark", kind
    kind = kind.split(",")[0]
    if kind == "scp":
        for key, rx in load_dict_data(path).items():
            yield key, load_mat(rx)
        return
    if kind != "ark":
        raise ValueError(f"unsupported rspecifier {rspecifier!r}")
    if path == "-":
        raise ValueError("stdin arks not supported")
    yield from read_ark(path)


def _write_matrix(f, mat, compression_method=None):
    """Write one binary matrix at the file's current position:
    uncompressed ``FM`` (``DM`` for float64), or compressed by Kaldi's
    method 1 (``CM``; ``CM2`` for 8 rows or fewer) or 2 (``CM2``)."""
    mat = np.asarray(mat)
    if mat.ndim != 2:
        raise ValueError("only 2-D matrices supported")
    f.write(_BINARY_FLAG)
    if compression_method in (None, 0):
        double = mat.dtype == np.float64
        f.write(b"DM " if double else b"FM ")
        for n in mat.shape:
            f.write(b"\x04" + struct.pack("<i", n))
        f.write(np.ascontiguousarray(
            mat, dtype="<f8" if double else "<f4").tobytes())
        return
    num_rows, num_cols = mat.shape
    m = np.asarray(mat, dtype=np.float64)
    min_value = float(m.min()) if m.size else 0.0
    max_value = float(m.max()) if m.size else 1.0
    range_value = max(max_value - min_value, 1e-10)
    header = struct.pack("<ffii", np.float32(min_value),
                         np.float32(range_value), num_rows, num_cols)
    if compression_method == 1 and num_rows > 8:
        f.write(b"CM " + header)
        # per-column percentiles on the global uint16 grid, made
        # non-decreasing so the decode map is valid
        q16 = _float_to_uint16(np.percentile(m, [0, 25, 75, 100], axis=0).T,
                               min_value, range_value)
        q16 = np.maximum.accumulate(q16, axis=1)
        f.write(q16.astype("<u2").tobytes())
        pf = _uint16_to_float(q16, min_value, range_value)
        data = np.empty((num_cols, num_rows), dtype=np.uint8)
        for c in range(num_cols):
            data[c] = _float_to_char(m[:, c], *pf[c])
        f.write(data.tobytes())
    else:
        f.write(b"CM2 " + header)
        f.write(_float_to_uint16(m, min_value, range_value)
                .astype("<u2").tobytes())


class ArkWriter:
    """Write (utt, matrix) pairs into an ark file with an optional scp
    index; ``compression_method`` as :func:`_write_matrix` takes it."""

    def __init__(self, ark_path, scp_path=None, compression_method=None):
        self.ark_path = str(ark_path)
        self._ark = open(ark_path, "wb")
        self._scp = open(scp_path, "w") if scp_path else None
        self.compression_method = compression_method

    def write(self, utt, mat):
        self._ark.write(utt.encode() + b" ")
        offset = self._ark.tell()
        _write_matrix(self._ark, mat, self.compression_method)
        if self._scp:
            self._scp.write(
                f"{utt} {os.path.abspath(self.ark_path)}:{offset}\n")

    def __setitem__(self, utt, mat):
        self.write(utt, mat)

    def close(self):
        self._ark.close()
        if self._scp:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_helper(wspecifier, compression_method=None):
    """An :class:`ArkWriter` from a Kaldi wspecifier such as
    ``ark,scp:a.ark,a.scp``."""
    kinds, _, paths = wspecifier.partition(":")
    ark_path = scp_path = None
    for kind, path in zip(kinds.split(","), paths.split(",")):
        if kind == "ark":
            ark_path = path
        elif kind == "scp":
            scp_path = path
    if ark_path is None:
        raise ValueError(f"wspecifier {wspecifier!r} has no ark target")
    return ArkWriter(ark_path, scp_path, compression_method)


def read_wav_scp_entry(entry, dtype=np.float32):
    """One ``wav.scp`` entry, a path or a shell command ending in ``|``
    that writes a RIFF wav to stdout -> (sample rate, samples scaled to
    [-1, 1] from int16/int32/uint8)."""
    from scipy.io import wavfile

    entry = entry.strip()
    if entry.endswith("|"):
        proc = subprocess.run(entry[:-1], shell=True, stdout=subprocess.PIPE,
                              check=True)
        sr, data = wavfile.read(io.BytesIO(proc.stdout))
    else:
        sr, data = wavfile.read(entry)
    if data.dtype == np.int16:
        data = data.astype(dtype) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(dtype) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(dtype) - 128.0) / 128.0
    else:
        data = data.astype(dtype)
    return sr, data
