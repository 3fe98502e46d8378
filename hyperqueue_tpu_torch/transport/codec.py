"""msgpack's wire format over the standard library.

Every file this package writes (the event journal, the snapshots, the
output log) and the wire frames of the server's network plane hold msgpack
payloads. The port does not depend on the msgpack package: `packb` and
`unpackb` here produce and accept exactly the bytes of
``msgpack.packb(obj, use_bin_type=True)`` and
``msgpack.unpackb(data, raw=False, strict_map_key=...)`` of msgpack 1.x, so
the files are interchangeable with the JAX package's.

Encoding picks the shortest format for every value, as msgpack does:
positive/negative fixint, then uint8..uint64 for non-negative and
int8..int64 for negative ints; float always as float 64; fixstr, str8, str16,
str32 for str (UTF-8); bin8/16/32 for bytes, bytearray and memoryview;
fixarray/array16/array32 for list and tuple; fixmap/map16/map32 for dict, in
insertion order; nil, true and false. Subclasses of int, float, str, bytes,
dict, list and tuple pack as their base type (msgpack's default
``strict_types=False``); bool is tested before int. Anything else raises
TypeError (a numpy or torch scalar that slips into a record is refused, as
msgpack refuses it), and an int outside [-2**63, 2**64) raises OverflowError.

Decoding returns arrays as lists and str as UTF-8 (invalid UTF-8 raises).
The reserved byte 0xc1, truncated input and trailing bytes raise
`CodecError` (a ValueError). Ext types are not used by any format of this
package, so they raise too (msgpack would return an ExtType). With
``strict_map_key=True`` (msgpack's default) a map key that is neither str
nor bytes raises ValueError.

Two implementations share these semantics: a CPython extension
(`native/codec.cpp`), built at first use with the host's C++ compiler into
`_build/` beside the package, and the Python functions below (`py_packb`,
`py_unpackb`), which stand in where no compiler or no `Python.h` is found
and are the reference the tests hold the extension to. `BACKEND` names the
one behind `packb` and `unpackb`: "native" or "python". This module
imports only the standard library: a task runner boots it under `-S`.
"""

from __future__ import annotations

import struct

__all__ = ["BACKEND", "CodecError", "packb", "unpackb"]


class CodecError(ValueError):
    """Malformed msgpack input: truncated, trailing bytes, a reserved or
    unsupported (ext) type byte."""


_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")
# type byte + big-endian payload in one pack call
_U8 = struct.Struct(">BB")
_U16 = struct.Struct(">BH")
_U32 = struct.Struct(">BI")
_U64 = struct.Struct(">BQ")
_S8 = struct.Struct(">Bb")
_S16 = struct.Struct(">Bh")
_S32 = struct.Struct(">Bi")
_S64 = struct.Struct(">Bq")
_F64 = struct.Struct(">Bd")

# one-byte encodings of the fixints, indexed by value (+32 for negatives)
_FIXPOS = [bytes((v,)) for v in range(128)]
_FIXNEG = [bytes(((v + 256) & 0xFF,)) for v in range(-32, 0)]

# encoded form of short str values (map keys and event kinds repeat in
# every record): a pure function of the str, bounded in size
_STR_CACHE: dict[str, bytes] = {}
_STR_CACHE_MAX = 4096
_STR_CACHE_LEN = 64


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out += _FIXPOS[v]
        elif v <= 0xFF:
            out += _U8.pack(0xCC, v)
        elif v <= 0xFFFF:
            out += _U16.pack(0xCD, v)
        elif v <= 0xFFFFFFFF:
            out += _U32.pack(0xCE, v)
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out += _U64.pack(0xCF, v)
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out += _FIXNEG[v + 32]
    elif v >= -0x80:
        out += _S8.pack(0xD0, v)
    elif v >= -0x8000:
        out += _S16.pack(0xD1, v)
    elif v >= -0x80000000:
        out += _S32.pack(0xD2, v)
    elif v >= -0x8000000000000000:
        out += _S64.pack(0xD3, v)
    else:
        raise OverflowError("Integer value out of range")


def _str_bytes(s: str) -> bytes:
    enc = _STR_CACHE.get(s)
    if enc is not None:
        return enc
    data = s.encode("utf-8")
    n = len(data)
    if n < 32:
        enc = bytes((0xA0 | n,)) + data
    elif n <= 0xFF:
        enc = _U8.pack(0xD9, n) + data
    elif n <= 0xFFFF:
        enc = _U16.pack(0xDA, n) + data
    elif n <= 0xFFFFFFFF:
        enc = _U32.pack(0xDB, n) + data
    else:
        raise ValueError("str is too large")
    if len(s) <= _STR_CACHE_LEN and len(_STR_CACHE) < _STR_CACHE_MAX:
        _STR_CACHE[s] = enc
    return enc


def _bin_header(n: int) -> bytes:
    if n <= 0xFF:
        return _U8.pack(0xC4, n)
    if n <= 0xFFFF:
        return _U16.pack(0xC5, n)
    if n <= 0xFFFFFFFF:
        return _U32.pack(0xC6, n)
    raise ValueError("bytes object is too large")


def _array_header(n: int) -> bytes:
    if n < 16:
        return bytes((0x90 | n,))
    if n <= 0xFFFF:
        return _U16.pack(0xDC, n)
    if n <= 0xFFFFFFFF:
        return _U32.pack(0xDD, n)
    raise ValueError("list is too large")


def _map_header(n: int) -> bytes:
    if n < 16:
        return bytes((0x80 | n,))
    if n <= 0xFFFF:
        return _U16.pack(0xDE, n)
    if n <= 0xFFFFFFFF:
        return _U32.pack(0xDF, n)
    raise ValueError("dict is too large")


def _pack(obj, out: bytearray) -> None:
    # exact types first (the common case), then the subclass rules in
    # msgpack's own order: None, bool, int, float, bytes, str, dict,
    # list/tuple, memoryview
    t = type(obj)
    if t is str:
        out += _str_bytes(obj)
    elif t is int:
        if 0 <= obj < 0x80:
            out += _FIXPOS[obj]
        else:
            _pack_int(obj, out)
    elif t is dict:
        out += _map_header(len(obj))
        for k, v in obj.items():
            if type(k) is str:
                out += _str_bytes(k)
            else:
                _pack(k, out)
            _pack(v, out)
    elif t is float:
        out += _F64.pack(0xCB, obj)
    elif t is list or t is tuple:
        out += _array_header(len(obj))
        for v in obj:
            _pack(v, out)
    elif obj is None:
        out += b"\xc0"
    elif obj is True:
        out += b"\xc3"
    elif obj is False:
        out += b"\xc2"
    elif t is bytes:
        out += _bin_header(len(obj))
        out += obj
    else:
        _pack_other(obj, out)


def _pack_other(obj, out: bytearray) -> None:
    if isinstance(obj, bool):
        out += b"\xc3" if obj else b"\xc2"
    elif isinstance(obj, int):
        _pack_int(int.__int__(obj), out)
    elif isinstance(obj, float):
        out += _F64.pack(0xCB, float.__float__(obj))
    elif isinstance(obj, (bytes, bytearray)):
        out += _bin_header(len(obj))
        out += obj
    elif isinstance(obj, str):
        out += _str_bytes(str.__str__(obj))
    elif isinstance(obj, dict):
        out += _map_header(len(obj))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out += _array_header(len(obj))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, memoryview):
        data = obj.tobytes()
        out += _bin_header(len(data))
        out += data
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """`obj` in msgpack's wire format, byte for byte as
    ``msgpack.packb(obj, use_bin_type=True)``."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------
# fixed-width scalars after the type byte: type byte -> (Struct, width)
_SCALARS = {
    0xCA: (_f, 4), 0xCB: (_d, 8),
    0xCC: (_B, 1), 0xCD: (_H, 2), 0xCE: (_I, 4), 0xCF: (_Q, 8),
    0xD0: (_b, 1), 0xD1: (_h, 2), 0xD2: (_i, 4), 0xD3: (_q, 8),
}
# sized types: type byte -> (kind, length Struct, length width)
_SIZED = {
    0xD9: ("str", _B, 1), 0xDA: ("str", _H, 2), 0xDB: ("str", _I, 4),
    0xC4: ("bin", _B, 1), 0xC5: ("bin", _H, 2), 0xC6: ("bin", _I, 4),
    0xDC: ("array", _H, 2), 0xDD: ("array", _I, 4),
    0xDE: ("map", _H, 2), 0xDF: ("map", _I, 4),
}
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_d_unpack = _d.unpack_from


def _incomplete():
    return CodecError("Unpack failed: incomplete input")


def unpackb(data, *, strict_map_key: bool = True):
    """Decode one msgpack value, as ``msgpack.unpackb(data, raw=False,
    strict_map_key=strict_map_key)``; raises on anything left over."""
    if type(data) is not bytes:
        data = bytes(data)
    end = len(data)
    pos = 0

    def build_map(n: int) -> dict:
        out = {}
        for _ in range(n):
            k = value()
            v = value()
            if (strict_map_key and type(k) is not str
                    and type(k) is not bytes):
                raise ValueError(
                    f"{type(k).__name__} is not allowed for map key when "
                    "strict_map_key=True"
                )
            out[k] = v
        return out

    def value():
        nonlocal pos
        if pos >= end:
            raise _incomplete()
        b = data[pos]
        pos += 1
        if b < 0x80:
            return b
        if b < 0x90:
            return build_map(b & 0x0F)
        if b < 0xA0:
            return [value() for _ in range(b & 0x0F)]
        if b < 0xC0:
            start = pos
            pos += b & 0x1F
            if pos > end:
                raise _incomplete()
            return data[start:pos].decode("utf-8")
        if b >= 0xE0:
            return b - 0x100
        if b == 0xCB:
            start = pos
            pos += 8
            if pos > end:
                raise _incomplete()
            return _d_unpack(data, start)[0]
        scalar = _SCALARS.get(b)
        if scalar is not None:
            st, width = scalar
            start = pos
            pos += width
            if pos > end:
                raise _incomplete()
            return st.unpack_from(data, start)[0]
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        sized = _SIZED.get(b)
        if sized is None:
            if b == 0xC1:
                raise CodecError("Unpack failed: reserved type byte 0xc1")
            # 0xc7-0xc9 ext 8/16/32, 0xd4-0xd8 fixext
            raise CodecError(
                f"Unpack failed: ext type 0x{b:02x} is not used"
            )
        kind, st, width = sized
        start = pos
        pos += width
        if pos > end:
            raise _incomplete()
        n = st.unpack_from(data, start)[0]
        if kind == "array":
            return [value() for _ in range(n)]
        if kind == "map":
            return build_map(n)
        start = pos
        pos += n
        if pos > end:
            raise _incomplete()
        if kind == "str":
            return data[start:pos].decode("utf-8")
        return data[start:pos]

    obj = value()
    if pos != end:
        raise CodecError("unpack(b) received extra data.")
    return obj


# ---------------------------------------------------------------------------
# the native backend
# ---------------------------------------------------------------------------
py_packb = packb
py_unpackb = unpackb


def _load_native():
    """The extension module built from native/codec.cpp, or None where it
    cannot be built or loaded. The file name carries a hash of the source,
    the flags and the interpreter, so an edited source or another Python
    builds anew; a file lock lets concurrent processes share one build."""
    import hashlib
    import os
    import sys
    from importlib.machinery import ExtensionFileLoader
    from importlib.util import module_from_spec, spec_from_loader

    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    source = os.path.join(package, "native", "codec.cpp")
    build = os.path.join(package, "_build")
    try:
        import sysconfig

        include = sysconfig.get_paths()["include"]
        if not os.path.exists(os.path.join(include, "Python.h")):
            return None
        flags = ("-O2", "-std=c++17", "-fPIC", "-shared", f"-I{include}")
        with open(source, "rb") as f:
            key = f.read()
        key += " ".join(flags).encode() + sys.version.encode()
        digest = hashlib.sha256(key).hexdigest()[:16]
        path = os.path.join(build, f"_hqcodec-{digest}.so")
        if not os.path.exists(path):
            import fcntl
            import shutil

            cxx = shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                return None
            os.makedirs(build, exist_ok=True)
            with open(os.path.join(build, "hqcodec.lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not os.path.exists(path):
                    import subprocess

                    tmp = f"{path}.{os.getpid()}.tmp"
                    try:
                        subprocess.run([cxx, *flags, "-o", tmp, source],
                                       capture_output=True, timeout=180,
                                       check=True)
                        os.replace(tmp, path)
                    finally:
                        if os.path.exists(tmp):
                            os.unlink(tmp)
        loader = ExtensionFileLoader("_hqcodec", path)
        module = module_from_spec(spec_from_loader("_hqcodec", loader))
        loader.exec_module(module)
        module.configure(CodecError)
        return module
    except Exception:  # noqa: BLE001 - any failure leaves the Python codec
        return None


_native = _load_native()
native_packb = _native.packb if _native is not None else None
native_unpackb = _native.unpackb if _native is not None else None
BACKEND = "native" if _native is not None else "python"
packb = native_packb or py_packb
unpackb = native_unpackb or py_unpackb
