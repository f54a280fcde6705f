"""A small MessagePack encoder and decoder for checkpoint files, so that the
port reads and writes them without the `msgpack` package.

`packb(obj)` (or `dump(obj, f)`, to a file) covers the types the
checkpoint writer emits: dict, list / tuple (as arrays), str, bytes, int,
float (as float64), bool and None. It emits the bytes `msgpack.packb(obj, use_bin_type=True)` emits: the
smallest header of each family (fixint / uint / int, fixstr / str8-32,
bin8-32, fixarray / array16-32, fixmap / map16-32). `unpackb(data)` reads
what `msgpack.unpackb(data, raw=False, strict_map_key=False)` reads: every
format above plus float32, with arrays as lists and str decoded as UTF-8.
Extension types are refused.
"""
from __future__ import annotations

import struct
from typing import Any, List


def _int(n: int, out: List[bytes]) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if n >= low:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit 64 bits")


def _header(n: int, fix: int, fix_max: int, codes, out: List[bytes]) -> None:
    """A length header: the fix form below fix_max (fix None: none), else
    the first of (code, fmt, top) whose top exceeds n."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} is too large for MessagePack")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARR = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def _pack(obj, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(len(raw), 0xA0, 32, _STR, out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _header(len(raw), None, 0, _BIN, out)
        out.append(raw)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 16, _ARR, out)
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj)!r} as MessagePack")


def packb(obj) -> bytes:
    """`obj` as MessagePack bytes (see the module docstring)."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def dump(obj, f) -> None:
    """packb(obj) written to the binary file `f` piece by piece (a large
    checkpoint is never joined into one bytes object)."""
    out: List[bytes] = []
    _pack(obj, out)
    f.writelines(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("MessagePack data ends early")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return bytes(self.take(self.num(lengths[b])))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.num(numbers[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.str(self.num(strs[b]))
        if b in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.num(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.num(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes):
    """The object MessagePack `data` encodes (see the module docstring)."""
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError("extra data after the MessagePack object")
    return obj
