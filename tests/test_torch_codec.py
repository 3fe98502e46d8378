"""The port's msgpack codec (hyperqueue_tpu_torch.transport.codec) against
msgpack 1.x, which the JAX package calls.

`codec.packb(x)` must equal `msgpack.packb(x, use_bin_type=True)` byte for
byte, and `codec.unpackb` must decode as `msgpack.unpackb(raw=False)` does
and raise exactly where it raises (ext types aside: the codec refuses them,
msgpack returns an ExtType). The fixed-byte tests need no msgpack. Every
test runs over both implementations: the native extension
(`codec.native_packb`/`native_unpackb`, what `packb`/`unpackb` are where it
builds) and the Python reference (`codec.py_packb`/`py_unpackb`).
"""

import math
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hyperqueue_tpu_torch.transport import codec

# one intra-op thread per process: the suite runs in several worker
# processes at once, and torch's default of a thread per core in each
# of them starves the other workers (and their wall-clock gates)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


class Impl:
    def __init__(self, name, packb, unpackb):
        self.name, self.packb, self.unpackb = name, packb, unpackb
        self.CodecError = codec.CodecError


IMPLS = [
    pytest.param(Impl("native", codec.native_packb, codec.native_unpackb),
                 id="native"),
    pytest.param(Impl("python", codec.py_packb, codec.py_unpackb),
                 id="python"),
]
with_impl = pytest.mark.parametrize("codec", IMPLS)

scalars = (
    st.none()
    | st.booleans()
    | st.integers(min_value=-(2**63), max_value=2**64 - 1)
    | st.floats(allow_nan=False)
    | st.text(max_size=40)
    | st.binary(max_size=40)
)
values = st.recursive(
    scalars,
    lambda inner: (
        st.lists(inner, max_size=6)
        | st.tuples(inner, inner)
        | st.dictionaries(st.text(max_size=10) | st.binary(max_size=6),
                          inner, max_size=6)
        | st.dictionaries(st.integers(-300, 70000), inner, max_size=4)
    ),
    max_leaves=30,
)


def _contains_ext(value, ext_types) -> bool:
    if isinstance(value, ext_types):
        return True
    if isinstance(value, list):
        return any(_contains_ext(v, ext_types) for v in value)
    if isinstance(value, dict):
        return any(_contains_ext(k, ext_types) or _contains_ext(v, ext_types)
                   for k, v in value.items())
    return False


def _same(a, b) -> bool:
    """Equality that also holds for NaN floats at the same place."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


@with_impl
@settings(max_examples=300, deadline=None)
@given(values)
def test_pack_matches_msgpack(codec, value):
    msgpack = pytest.importorskip("msgpack")
    want = msgpack.packb(value, use_bin_type=True)
    assert codec.packb(value) == want
    for strict in (True, False):
        try:
            expected = msgpack.unpackb(want, raw=False,
                                       strict_map_key=strict)
        except ValueError:
            with pytest.raises(ValueError):
                codec.unpackb(want, strict_map_key=strict)
            continue
        assert _same(codec.unpackb(want, strict_map_key=strict), expected)


@with_impl
@settings(max_examples=500, deadline=None)
@given(st.binary(max_size=48) | st.lists(
    st.sampled_from([b"\x81", b"\x91", b"\xa1a", b"\xc0", b"\xc1", b"\xc4",
                     b"\xcb", b"\xd4", b"\xd9\x02", b"\xdc\x00", b"\xde",
                     b"\x00", b"\xff", b"\x7f", b"\x92", b"\xc7\x01"]),
    max_size=12).map(b"".join))
def test_unpack_fuzz_matches_msgpack(codec, data):
    msgpack = pytest.importorskip("msgpack")
    ext_types = (msgpack.ExtType, msgpack.Timestamp)
    for strict in (True, False):
        try:
            expected = msgpack.unpackb(data, raw=False, strict_map_key=strict)
        except Exception:  # noqa: BLE001 - any refusal of msgpack's
            with pytest.raises(Exception):
                codec.unpackb(data, strict_map_key=strict)
            continue
        if _contains_ext(expected, ext_types):
            # the codec refuses the ext types no format here uses
            with pytest.raises(codec.CodecError):
                codec.unpackb(data, strict_map_key=strict)
            continue
        assert _same(codec.unpackb(data, strict_map_key=strict), expected)


@with_impl
def test_journal_shaped_records_match_msgpack(codec):
    msgpack = pytest.importorskip("msgpack")
    record = {"time": 1_760_000_000.125, "seq": 70_000, "event":
              "task-started", "job": 1, "task": 2**20, "workers": [17],
              "instance": 2**20, "variant": 0, "queued_at": 0.0,
              "usage": {"cpus": 2.0, "gpus": 0.5},
              "trace": {"id": "a" * 17, "lends": [[1, 2]]},
              "desc": {"array": {"id_range": [0, 16384], "entries": None,
                                 "body": {"cmd": ["true"], "env": {}}}},
              "data": b"\x00\xff"}
    assert codec.packb(record) == msgpack.packb(record, use_bin_type=True)
    assert codec.unpackb(codec.packb(record)) == record


INT_EDGES = [
    (0, "00"), (127, "7f"), (128, "cc80"), (255, "ccff"), (256, "cd0100"),
    (65535, "cdffff"), (65536, "ce00010000"),
    (2**32 - 1, "ceffffffff"), (2**32, "cf0000000100000000"),
    (2**64 - 1, "cfffffffffffffffff"),
    (-1, "ff"), (-32, "e0"), (-33, "d0df"), (-128, "d080"),
    (-129, "d1ff7f"), (-32768, "d18000"), (-32769, "d2ffff7fff"),
    (-(2**31), "d280000000"), (-(2**31) - 1, "d3ffffffff7fffffff"),
    (-(2**63), "d38000000000000000"),
]


@with_impl
@pytest.mark.parametrize("value,hex_bytes", INT_EDGES,
                         ids=[str(v) for v, _h in INT_EDGES])
def test_int_format_boundaries(codec, value, hex_bytes):
    assert codec.packb(value) == bytes.fromhex(hex_bytes)
    assert codec.unpackb(bytes.fromhex(hex_bytes)) == value


# (length, header of str, bin, array, map)
SIZE_EDGES = [
    (15, "af", "c40f", "9f", "8f"),
    (16, "b0", "c410", "dc0010", "de0010"),
    (31, "bf", "c41f", "dc001f", "de001f"),
    (32, "d920", "c420", "dc0020", "de0020"),
    (255, "d9ff", "c4ff", "dc00ff", "de00ff"),
    (256, "da0100", "c50100", "dc0100", "de0100"),
    (65535, "daffff", "c5ffff", "dcffff", "deffff"),
    (65536, "db00010000", "c600010000", "dd00010000", "df00010000"),
]


@with_impl
@pytest.mark.parametrize("n,str_h,bin_h,arr_h,map_h", SIZE_EDGES,
                         ids=[str(e[0]) for e in SIZE_EDGES])
def test_sized_format_boundaries(codec, n, str_h, bin_h, arr_h, map_h):
    text = "x" * n
    blob = b"\x01" * n
    array = [None] * n
    mapping = {f"{i:06d}": None for i in range(n)}
    for value, header in ((text, str_h), (blob, bin_h), (array, arr_h),
                          (mapping, map_h)):
        packed = codec.packb(value)
        assert packed.startswith(bytes.fromhex(header)), type(value)
        assert codec.unpackb(packed) == value
    # tuples pack as arrays, bytearray and memoryview as bin
    assert codec.packb(tuple(array)) == codec.packb(array)
    assert codec.packb(bytearray(blob)) == codec.packb(blob)
    assert codec.packb(memoryview(blob)) == codec.packb(blob)


@with_impl
def test_scalars_and_subclasses(codec):
    assert codec.packb(None) == b"\xc0"
    assert codec.packb(True) == b"\xc3" and codec.packb(False) == b"\xc2"
    assert codec.packb(1.5) == b"\xcb" + struct.pack(">d", 1.5)
    # float 32 on the wire decodes, though nothing here writes it
    assert codec.unpackb(b"\xca" + struct.pack(">f", 0.25)) == 0.25

    class Name(str):
        def __str__(self):
            return "not the data"

    class Count(int):
        pass

    class Table(dict):
        pass

    class Row(list):
        pass

    assert codec.packb(Name("ab")) == codec.packb("ab")
    assert codec.packb(Count(300)) == codec.packb(300)
    assert codec.packb(Table(a=1)) == codec.packb({"a": 1})
    assert codec.packb(Row([1, 2])) == codec.packb([1, 2])


@with_impl
@pytest.mark.parametrize("value", [np.int64(3), torch.tensor(3), {1, 2},
                                   object()],
                         ids=["numpy.int64", "torch.tensor", "set",
                              "object"])
def test_unsupported_types_raise(codec, value):
    with pytest.raises(TypeError):
        codec.packb(value)
    with pytest.raises(TypeError):
        codec.packb({"record": [value]})


@with_impl
@pytest.mark.parametrize("value", [2**64, -(2**63) - 1])
def test_int_out_of_range_raises(codec, value):
    with pytest.raises(OverflowError):
        codec.packb(value)


@pytest.mark.parametrize("data,error", [
    (b"\xc1", codec.CodecError),            # reserved
    (b"\x92\x01", codec.CodecError),        # truncated
    (b"\x01\x02", codec.CodecError),        # trailing bytes
    (b"", codec.CodecError),                # nothing
    (b"\xa1\xff", UnicodeDecodeError),      # invalid UTF-8
    (b"\xd4\x01\x02", codec.CodecError),    # fixext
    (b"\xc7\x01\x05a", codec.CodecError),   # ext 8
    (b"\x81\x01\x02", ValueError),          # int key, strict
], ids=["reserved", "truncated", "trailing", "empty", "utf8", "fixext",
        "ext8", "strict-key"])
@with_impl
def test_malformed_input_raises(codec, data, error):
    with pytest.raises(error):
        codec.unpackb(data)


@with_impl
def test_map_keys_without_strict(codec):
    assert codec.unpackb(b"\x81\x01\x02", strict_map_key=False) == {1: 2}
    assert codec.unpackb(b"\x81\xc0\x01", strict_map_key=False) == {None: 1}
    assert codec.unpackb(b"\x81\xc4\x01a\x01") == {b"a": 1}
    with pytest.raises(TypeError):  # an array key is unhashable
        codec.unpackb(b"\x81\x90\x01", strict_map_key=False)


def test_modules_import_without_msgpack():
    """The journal's modules and the server's bootstrap import where
    msgpack is not installed (the card's machine has none)."""
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "import hyperqueue_tpu_torch.events.journal\n"
        "import hyperqueue_tpu_torch.events.snapshot\n"
        "import hyperqueue_tpu_torch.events.restore\n"
        "import hyperqueue_tpu_torch.events.outputlog\n"
        "import hyperqueue_tpu_torch.server.bootstrap\n"
        "import hyperqueue_tpu_torch.server.journal_plane\n"
        "import hyperqueue_tpu_torch.server.accounting\n"
        "from hyperqueue_tpu_torch.transport import codec\n"
        "assert codec.unpackb(codec.packb({'a': [1]})) == {'a': [1]}\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_native_backend_loads_here():
    """The extension builds wherever a C++ compiler and Python.h are found
    (this machine and the card's), and then stands behind packb/unpackb."""
    assert codec.BACKEND == "native"
    assert codec.packb is codec.native_packb
    assert codec.unpackb is codec.native_unpackb


@settings(max_examples=300, deadline=None)
@given(values)
def test_native_bytes_equal_python_and_msgpack(value):
    msgpack = pytest.importorskip("msgpack")
    data = codec.native_packb(value)
    assert data == codec.py_packb(value)
    assert data == msgpack.packb(value, use_bin_type=True)
    for strict in (True, False):
        try:
            want = codec.py_unpackb(data, strict_map_key=strict)
        except ValueError as e:
            with pytest.raises(type(e)):
                codec.native_unpackb(data, strict_map_key=strict)
            continue
        assert _same(codec.native_unpackb(data, strict_map_key=strict), want)


def _outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - the exception is the outcome
        return (type(e), str(e))


@settings(max_examples=500, deadline=None)
@given(st.binary(max_size=48) | st.lists(
    st.sampled_from([b"\x81", b"\x91", b"\xa1a", b"\xc0", b"\xc1", b"\xc4",
                     b"\xcb", b"\xd4", b"\xd9\x02", b"\xdc\x00", b"\xde",
                     b"\x00", b"\xff", b"\x7f", b"\x92", b"\xc7\x01",
                     b"\xa2\xc3\x28", b"\x81\x90"]),
    max_size=12).map(b"".join))
def test_native_and_python_decoders_fail_alike(data):
    """On any input both decoders give the same value, or raise the same
    exception with the same message."""
    for strict in (True, False):
        native = _outcome(codec.native_unpackb, data, strict_map_key=strict)
        python = _outcome(codec.py_unpackb, data, strict_map_key=strict)
        if native[0] == "ok" and python[0] == "ok":
            assert _same(native[1], python[1])
        else:
            assert native == python


class _Weird(dict):
    def items(self):
        return [("k", 1)]


@pytest.mark.parametrize("value", [
    np.int64(3), object(), {1, 2}, 2**64, -(2**63) - 1, "\ud800",
    [1, [2, {"a": object()}]], _Weird(a=2), bytearray(b"ab"),
    memoryview(b"abcdef")[::2],
], ids=["numpy", "object", "set", "2^64", "-2^63-1", "surrogate", "nested",
        "dict-items", "bytearray", "strided-view"])
def test_native_and_python_encoders_fail_alike(value):
    assert _outcome(codec.native_packb, value) == \
        _outcome(codec.py_packb, value)


@pytest.mark.parametrize("impl", ["native", "python"])
def test_deep_nesting_raises_and_does_not_crash(impl):
    """A 10,000-deep list, packed and unpacked, raises RecursionError in a
    child process that lives on."""
    code = (
        "from hyperqueue_tpu_torch.transport import codec\n"
        f"packb, unpackb = codec.{'native' if impl == 'native' else 'py'}"
        f"_packb, codec.{'native' if impl == 'native' else 'py'}_unpackb\n"
        "deep = []\n"
        "for _ in range(10_000):\n"
        "    deep = [deep]\n"
        "for fn, arg in ((packb, deep), (unpackb, b'\\x91' * 10_000 + b'\\x90')):\n"
        "    try:\n"
        "        fn(arg)\n"
        "    except RecursionError:\n"
        "        print('raised')\n"
        "print('alive')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["raised", "raised", "alive"]
