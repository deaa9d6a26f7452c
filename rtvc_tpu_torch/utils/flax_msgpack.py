"""Reader of what ``flax.serialization.msgpack_serialize`` writes, in pure
Python: the body of the JAX package's ``.ckpt`` files
(``rtvc_tpu/train/checkpoints.py``). The port imports neither ``flax`` nor
``msgpack``, so it decodes the msgpack format itself.

It reads maps (to dicts), arrays (to lists), str, bin, ints, floats, bool
and nil, and the two ext types of flax that checkpoints hold:

* 1, ndarray: a msgpack triple ``(shape, dtype name, C-order bytes)``,
  read as a numpy array over the file's bytes (read-only, as flax's is);
* 3, numpy scalar: the ndarray triple at shape ``()``, read as a numpy
  scalar.

numpy has no bfloat16, so a ``bfloat16`` leaf is read as ``uint16`` and
viewed as a ``torch.bfloat16`` tensor (a 0-d one for a scalar). flax writes
a leaf over 1 GiB as a dict of chunks (``__msgpack_chunked_array__``); such
a file raises ValueError.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _LENGTHS:
            kind, fmt = _LENGTHS[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack(">b"), n)
        if b in _FIXEXT:
            return self.ext(self.unpack(">b"), _FIXEXT[b])
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        raise ValueError(f"msgpack: byte 0x{b:02x} starts no object")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        if CHUNKED_KEY in out:
            raise ValueError("this checkpoint holds an array of over 1 GiB, which flax writes "
                             "in chunks (__msgpack_chunked_array__); reading chunked arrays "
                             "is not supported")
        return out

    def ext(self, code: int, n: int) -> Any:
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            arr = _ndarray(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        raise ValueError(f"msgpack: unknown ext type {code}")


# the msgpack formats with a length: type byte → (kind, length's struct format)
_LENGTHS = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _ndarray(data: memoryview):
    shape, name, raw = _Reader(data).obj()
    name = name.decode("ascii") if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(raw, np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"msgpack ndarray of unknown dtype {name!r}") from e
    return np.frombuffer(raw, dtype).reshape(shape)


def restore(data: bytes) -> Any:
    """Decode one msgpack object written by ``flax.serialization.
    msgpack_serialize`` (the counterpart of ``msgpack_restore``)."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes after the object")
    return out
