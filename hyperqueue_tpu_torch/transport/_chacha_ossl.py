"""ChaCha20-Poly1305 AEAD via the system OpenSSL libcrypto (ctypes).

The `openssl` tier of the wire-path backend ladder (transport/aead.py):
this framework's baseline container ships no `cryptography` wheel, but
CPython itself links OpenSSL (the `ssl` module), so libcrypto — with its
assembly ChaCha20-Poly1305 — is always on disk. Binding EVP through
ctypes gets native-speed AEAD (~1-3 ns/wire-byte, ~10 us fixed cost per
call) with zero new dependencies.

Every call uses its own EVP_CIPHER_CTX (thread-safe by construction —
the fan-out sender pool seals from several threads). Prototypes are
declared explicitly: a defaulted int restype would truncate the context
pointer on 64-bit and segfault.

Raises ImportError at import when libcrypto (or the cipher) is missing,
which is exactly how transport/aead.py walks its ladder.
"""

from __future__ import annotations

import ctypes
import ctypes.util


def _load_libcrypto():
    candidates = []
    found = ctypes.util.find_library("crypto")
    if found:
        candidates.append(found)
    candidates += ["libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so"]
    for name in candidates:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise ImportError("libcrypto not loadable")


try:
    _LIB = _load_libcrypto()
    _LIB.EVP_chacha20_poly1305  # noqa: B018 - probe the symbol
except (ImportError, AttributeError) as e:  # pragma: no cover
    raise ImportError(f"OpenSSL ChaCha20-Poly1305 unavailable: {e}") from e

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_char_p = ctypes.c_char_p

_LIB.EVP_CIPHER_CTX_new.restype = _c_void_p
_LIB.EVP_CIPHER_CTX_new.argtypes = ()
_LIB.EVP_CIPHER_CTX_free.restype = None
_LIB.EVP_CIPHER_CTX_free.argtypes = (_c_void_p,)
_LIB.EVP_chacha20_poly1305.restype = _c_void_p
_LIB.EVP_chacha20_poly1305.argtypes = ()
for _name in (
    "EVP_EncryptInit_ex", "EVP_DecryptInit_ex",
):
    fn = getattr(_LIB, _name)
    fn.restype = _c_int
    fn.argtypes = (_c_void_p, _c_void_p, _c_void_p, _c_char_p, _c_char_p)
for _name in ("EVP_EncryptUpdate", "EVP_DecryptUpdate"):
    fn = getattr(_LIB, _name)
    fn.restype = _c_int
    fn.argtypes = (
        _c_void_p, _c_char_p, ctypes.POINTER(_c_int), _c_char_p, _c_int,
    )
for _name in ("EVP_EncryptFinal_ex", "EVP_DecryptFinal_ex"):
    fn = getattr(_LIB, _name)
    fn.restype = _c_int
    fn.argtypes = (_c_void_p, _c_char_p, ctypes.POINTER(_c_int))
_LIB.EVP_CIPHER_CTX_ctrl.restype = _c_int
_LIB.EVP_CIPHER_CTX_ctrl.argtypes = (_c_void_p, _c_int, _c_int, _c_void_p)

_CIPHER = _c_void_p(_LIB.EVP_chacha20_poly1305())
_CTRL_AEAD_SET_IVLEN = 0x9
_CTRL_AEAD_GET_TAG = 0x10
_CTRL_AEAD_SET_TAG = 0x11
_TAG_LEN = 16


class _Ctx:
    __slots__ = ("ptr",)

    def __init__(self):
        self.ptr = _c_void_p(_LIB.EVP_CIPHER_CTX_new())
        if not self.ptr:  # pragma: no cover - allocation failure
            raise MemoryError("EVP_CIPHER_CTX_new failed")

    def __enter__(self):
        return self.ptr

    def __exit__(self, *exc):
        _LIB.EVP_CIPHER_CTX_free(self.ptr)


class ChaCha20Poly1305:
    """Drop-in for cryptography.hazmat...aead.ChaCha20Poly1305."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)

    def encrypt(self, nonce: bytes, data, associated_data) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        data = bytes(data)
        aad = bytes(associated_data or b"")
        outl = _c_int(0)
        with _Ctx() as ctx:
            if not (
                _LIB.EVP_EncryptInit_ex(ctx, _CIPHER, None, None, None)
                and _LIB.EVP_CIPHER_CTX_ctrl(
                    ctx, _CTRL_AEAD_SET_IVLEN, 12, None
                )
                and _LIB.EVP_EncryptInit_ex(
                    ctx, None, None, self._key, nonce
                )
            ):  # pragma: no cover - init cannot fail with valid sizes
                raise RuntimeError("EVP encrypt init failed")
            if aad and not _LIB.EVP_EncryptUpdate(
                ctx, None, ctypes.byref(outl), aad, len(aad)
            ):  # pragma: no cover
                raise RuntimeError("EVP aad update failed")
            out = ctypes.create_string_buffer(len(data) + _TAG_LEN)
            if not _LIB.EVP_EncryptUpdate(
                ctx, out, ctypes.byref(outl), data, len(data)
            ):  # pragma: no cover
                raise RuntimeError("EVP encrypt update failed")
            n = outl.value
            fin = ctypes.create_string_buffer(16)
            if not _LIB.EVP_EncryptFinal_ex(
                ctx, fin, ctypes.byref(outl)
            ):  # pragma: no cover
                raise RuntimeError("EVP encrypt final failed")
            n += outl.value  # stream cipher: always 0
            tag = (ctypes.c_char * _TAG_LEN).from_buffer(out, n)
            if not _LIB.EVP_CIPHER_CTX_ctrl(
                ctx, _CTRL_AEAD_GET_TAG, _TAG_LEN, tag
            ):  # pragma: no cover
                raise RuntimeError("EVP get tag failed")
            return out.raw[: n + _TAG_LEN]

    def decrypt(self, nonce: bytes, data, associated_data) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        data = bytes(data)
        if len(data) < _TAG_LEN:
            raise ValueError("ciphertext too short")
        aad = bytes(associated_data or b"")
        ct, tag = data[:-_TAG_LEN], data[-_TAG_LEN:]
        outl = _c_int(0)
        with _Ctx() as ctx:
            if not (
                _LIB.EVP_DecryptInit_ex(ctx, _CIPHER, None, None, None)
                and _LIB.EVP_CIPHER_CTX_ctrl(
                    ctx, _CTRL_AEAD_SET_IVLEN, 12, None
                )
                and _LIB.EVP_CIPHER_CTX_ctrl(
                    ctx, _CTRL_AEAD_SET_TAG, _TAG_LEN,
                    ctypes.create_string_buffer(tag, _TAG_LEN),
                )
                and _LIB.EVP_DecryptInit_ex(
                    ctx, None, None, self._key, nonce
                )
            ):  # pragma: no cover
                raise RuntimeError("EVP decrypt init failed")
            if aad and not _LIB.EVP_DecryptUpdate(
                ctx, None, ctypes.byref(outl), aad, len(aad)
            ):  # pragma: no cover
                raise RuntimeError("EVP aad update failed")
            out = ctypes.create_string_buffer(len(ct) or 1)
            if not _LIB.EVP_DecryptUpdate(
                ctx, out, ctypes.byref(outl), ct, len(ct)
            ):  # pragma: no cover
                raise RuntimeError("EVP decrypt update failed")
            n = outl.value
            fin = ctypes.create_string_buffer(16)
            if not _LIB.EVP_DecryptFinal_ex(ctx, fin, ctypes.byref(outl)):
                # tag mismatch — same exception contract as the other
                # backends (and cryptography's InvalidTag is a ValueError
                # subclass in spirit; StreamSeal callers catch broadly)
                raise ValueError("MAC check failed")
            return out.raw[:n]
