"""Pure-Python msgpack reader and writer for the JAX package's checkpoints.

Counterpart of ``flax.serialization.msgpack_restore`` /
``msgpack_serialize`` as ``vae_npvc_tpu/train/trainer.py``
``save_checkpoint`` uses them, for the subset flax writes: maps, arrays,
str, bin, int, float, bool and nil, plus two extension types:

- ext 1 (ndarray): payload ``msgpack((shape, dtype_name, raw_bytes))``;
- ext 3 (numpy scalar): the same payload, unpacked to a 0-d value.

``bfloat16`` arrays (no numpy dtype) are widened to float32 on read.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


# ----------------------------------------------------------------- reading
class _Reader:
    def __init__(self, data: bytes):
        self.b = memoryview(data)
        self.i = 0

    def take(self, n):
        if self.i + n > len(self.b):
            raise ValueError("truncated msgpack data")
        out = self.b[self.i:self.i + n]
        self.i += n
        return out

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def obj(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return bytes(self.take(t & 0x1F)).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        if t in (0xC4, 0xC5, 0xC6):                    # bin 8/16/32
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[t])
            return bytes(self.take(n))
        if t in (0xC7, 0xC8, 0xC9):                    # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if t in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):        # fixext 1..16
            n = 1 << (t - 0xD4)
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in nums:
            return self.unpack(nums[t])
        if t in (0xD9, 0xDA, 0xDB):                    # str 8/16/32
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[t])
            return bytes(self.take(n)).decode()
        if t in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if t == 0xDC else ">I"))
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def array(self, n):
        return [self.obj() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _ndarray(payload: bytes):
    shape, dtype_name, raw = msgpack_restore(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _ext(code, payload):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def msgpack_restore(data: bytes):
    """Decode one msgpack object (counterpart of
    ``flax.serialization.msgpack_restore``)."""
    r = _Reader(data)
    out = r.obj()
    if r.i != len(r.b):
        raise ValueError("trailing bytes after msgpack object")
    return out


# ----------------------------------------------------------------- writing
def _pack_len(out, n, small_mask, small_max, codes):
    """Header of a str/bin/array/map: fix form when it fits, else 8/16/32."""
    if small_mask is not None and n <= small_max:
        out.append(small_mask | n)
        return
    for code, fmt, limit in codes:
        if n <= limit:
            out.append(code)
            out.extend(struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack object too large ({n})")


def _pack_int(out, v):
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF),
                                 (0xCF, ">Q", (1 << 64) - 1)):
            if v <= limit:
                out.append(code)
                out.extend(struct.pack(fmt, v))
                return
        raise ValueError(f"int too large for msgpack: {v}")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out.extend(struct.pack(fmt, v))
                return
        raise ValueError(f"int too small for msgpack: {v}")


def _pack_ext(out, code, payload):
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                    (0xC9, ">I", 0xFFFFFFFF)))
    out.extend(struct.pack(">b", code))
    out.extend(payload)


def _ndarray_payload(a: np.ndarray) -> bytes:
    return msgpack_serialize((tuple(int(s) for s in a.shape), a.dtype.name,
                              a.tobytes(order="C")))


def _pack(out, obj):
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise ValueError("object arrays cannot be serialized")
        _pack_ext(out, EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out.extend(struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode()
        _pack_len(out, len(raw), 0xA0, 31, ((0xD9, ">B", 0xFF),
                                            (0xDA, ">H", 0xFFFF),
                                            (0xDB, ">I", 0xFFFFFFFF)))
        out.extend(raw)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, 0, ((0xC4, ">B", 0xFF),
                                           (0xC5, ">H", 0xFFFF),
                                           (0xC6, ">I", 0xFFFFFFFF)))
        out.extend(obj)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, ((0xDC, ">H", 0xFFFF),
                                            (0xDD, ">I", 0xFFFFFFFF)))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, ((0xDE, ">H", 0xFFFF),
                                            (0xDF, ">I", 0xFFFFFFFF)))
        for k in sorted(obj):          # flax's tree flattening sorts keys
            _pack(out, k)
            _pack(out, obj[k])
    else:
        raise TypeError(f"cannot msgpack-serialize {type(obj).__name__}")


def msgpack_serialize(obj) -> bytes:
    """Encode ``obj`` (dict/list/tuple/str/bytes/int/float/bool/None and
    numpy arrays or scalars) as msgpack, map keys sorted as flax writes
    them (counterpart of ``flax.serialization.msgpack_serialize``; arrays
    of 1 GiB or more are not chunked)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)
