"""Numpy-vectorized ChaCha20-Poly1305 AEAD (RFC 8439).

The middle tier of the wire-path backend ladder (transport/aead.py):
containers without the `cryptography` wheel but with numpy (this
framework's baseline — the solver needs it) get a vectorized
implementation instead of the ~6 us/wire-byte pure-python fallback in
`transport/_chacha.py`.

What is (and is not) vectorized, both paths exact:

- **ChaCha20 across the counter axis.** The whole keystream of a message
  (Poly1305 one-time key = block 0, cipher stream = blocks 1..) is one
  batched computation on a ``(16, n)`` uint32 state whose quarter rounds
  run as allocation-free single-row ufunc calls (``out=`` everywhere,
  diagonals addressed by index quadruple instead of np.roll copies),
  chunked so the working state stays cache-resident. The ~1.3k numpy
  calls are a fixed cost per chunk, so the per-byte cost collapses for
  anything beyond a couple of blocks (~10 ns/byte at 64 KiB vs ~4500 for
  the pure-python block function).

- **Poly1305 stays a scalar Horner loop** — deliberately. The candidate
  batched form (Kronecker-packing T coefficients and the powers
  ``r^1..r^T`` into lane-aligned big integers so one CPython big-int
  multiplication yields a T-block dot product) was measured SLOWER than
  the plain loop at every T on CPython 3.11 (38-146 ns/byte vs 23):
  CPython's 30-bit-digit multiplication makes the one big multiply cost
  more than T small ``(acc + c) * r % p`` steps. The loop here is the
  tight-local-variable form of the fallback's, ~23 ns/byte.

Wire format is bit-identical to `cryptography`'s ChaCha20Poly1305 and to
the pure-python fallback (parity pinned in tests/test_wire_backends.py).
"""

from __future__ import annotations

import hmac
import struct

import numpy as np

from hyperqueue_tpu_torch.transport import _chacha as _scalar

_P1305 = (1 << 130) - 5
_CLAMP = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
_CONST = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)

# below this many keystream blocks the fixed ~650 us numpy-call cost of
# the batched rounds loses to the scalar block function (~90 us/block,
# measured on the 2-core bench box; see --wire-smoke)
_MIN_VECTOR_BLOCKS = 8

# the 8 quarter-round index quadruples of one double round: 4 columns,
# then 4 diagonals (RFC 8439 section 2.3) — single-row views, so the
# diagonal rounds need no np.roll copies
_QUADS = (
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
)
# rotation amounts as uint32 scalars so `out=` never fights promotion
_ROT = {k: (np.uint32(k), np.uint32(32 - k)) for k in (16, 12, 8, 7)}

# keystream chunk (blocks per batched round computation): big enough to
# amortize the ~1.3k-numpy-call fixed cost per chunk, small enough that
# the 16-row uint32 working state (16 * 4 * _CHUNK bytes) stays
# cache-resident
_CHUNK = 4096


def _rot_inplace(v: np.ndarray, k: int, tmp: np.ndarray) -> None:
    left, right = _ROT[k]
    np.left_shift(v, left, out=tmp)
    np.right_shift(v, right, out=v)
    np.bitwise_or(v, tmp, out=v)


def _rounds(x: np.ndarray, tmp: np.ndarray) -> None:
    """20 ChaCha rounds in place on a (16, n) state, allocation-free."""
    rows = [x[i] for i in range(16)]
    for _ in range(10):
        for ai, bi, ci, di in _QUADS:
            a, b, c, d = rows[ai], rows[bi], rows[ci], rows[di]
            np.add(a, b, out=a)
            np.bitwise_xor(d, a, out=d)
            _rot_inplace(d, 16, tmp)
            np.add(c, d, out=c)
            np.bitwise_xor(b, c, out=b)
            _rot_inplace(b, 12, tmp)
            np.add(a, b, out=a)
            np.bitwise_xor(d, a, out=d)
            _rot_inplace(d, 8, tmp)
            np.add(c, d, out=c)
            np.bitwise_xor(b, c, out=b)
            _rot_inplace(b, 7, tmp)


def _keystream(key: bytes, nonce: bytes, counter: int, nblocks: int) -> bytes:
    """`nblocks` ChaCha20 keystream blocks, vectorized across the counter."""
    if nblocks <= 0:
        return b""
    if nblocks < _MIN_VECTOR_BLOCKS:
        return _scalar._chacha20_stream(key, nonce, counter, nblocks * 64)
    key_words = np.frombuffer(key, dtype="<u4")
    nonce_words = np.frombuffer(nonce, dtype="<u4")
    out = np.empty((nblocks, 16), dtype=np.uint32)
    init = np.empty((16, min(nblocks, _CHUNK)), dtype=np.uint32)
    work = np.empty_like(init)
    tmp = np.empty(init.shape[1], dtype=np.uint32)
    for lo in range(0, nblocks, _CHUNK):
        n = min(_CHUNK, nblocks - lo)
        st = init[:, :n]
        st[0:4] = _CONST[:, None]
        st[4:12] = key_words[:, None]
        st[12] = (
            counter + lo + np.arange(n, dtype=np.uint64)
        ).astype(np.uint32)
        st[13:16] = nonce_words[:, None]
        x = work[:, :n]
        x[:] = st
        _rounds(x, tmp[:n])
        x += st
        # block j is column j: transpose into per-block word order
        out[lo:lo + n] = x.T
    if out.dtype.byteorder not in ("<", "="):  # pragma: no cover
        out = out.astype("<u4")
    return out.tobytes()


def _xor_stream(data, stream: bytes) -> bytes:
    n = len(data)
    if n < 256:
        # big-int XOR beats numpy's buffer setup below a few hundred bytes
        return (
            int.from_bytes(data, "little")
            ^ int.from_bytes(stream[:n], "little")
        ).to_bytes(n, "little")
    a = np.frombuffer(data, dtype=np.uint8)
    b = np.frombuffer(stream, dtype=np.uint8, count=n)
    return (a ^ b).tobytes()


def _poly1305(msg: bytes, key: bytes) -> bytes:
    r = int.from_bytes(key[:16], "little") & _CLAMP
    s = int.from_bytes(key[16:32], "little")
    n = len(msg)
    acc = 0
    frm = int.from_bytes  # local binding: this loop runs per 16 bytes
    pad = 1 << 128
    end = n // 16 * 16
    for i in range(0, end, 16):
        acc = (acc + frm(msg[i:i + 16], "little") + pad) * r % _P1305
    if end < n:
        acc = (acc + frm(msg[end:] + b"\x01", "little")) * r % _P1305
    return ((acc + s) & (pad - 1)).to_bytes(16, "little")


def _pad16(n: int) -> bytes:
    rem = n % 16
    return b"" if rem == 0 else b"\x00" * (16 - rem)


class ChaCha20Poly1305:
    """Drop-in for cryptography.hazmat...aead.ChaCha20Poly1305."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)

    def _mac(self, otk: bytes, ciphertext, aad: bytes) -> bytes:
        mac_data = b"".join((
            aad, _pad16(len(aad)),
            bytes(ciphertext), _pad16(len(ciphertext)),
            struct.pack("<QQ", len(aad), len(ciphertext)),
        ))
        return _poly1305(mac_data, otk)

    def encrypt(self, nonce: bytes, data, associated_data) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        aad = associated_data or b""
        n = len(data)
        # one keystream pass: block 0 is the Poly1305 one-time key,
        # blocks 1.. are the cipher stream
        ks = _keystream(self._key, nonce, 0, 1 + (n + 63) // 64)
        ct = _xor_stream(data, ks[64:64 + n])
        return ct + self._mac(ks[:32], ct, aad)

    def decrypt(self, nonce: bytes, data, associated_data) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        if len(data) < 16:
            raise ValueError("ciphertext too short")
        aad = associated_data or b""
        view = memoryview(data)
        ct, tag = view[:-16], view[-16:]
        ks = _keystream(self._key, nonce, 0, 1 + (len(ct) + 63) // 64)
        if not hmac.compare_digest(self._mac(ks[:32], ct, aad), bytes(tag)):
            raise ValueError("MAC check failed")
        return _xor_stream(ct, ks[64:64 + len(ct)])
