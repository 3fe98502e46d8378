"""Wire-path AEAD backend selection.

One ChaCha20-Poly1305 implementation is chosen at import time for the
whole process (server, worker and client all seal/open with the same
RFC 8439 wire format, so any mix of backends interoperates):

- ``native`` — `cryptography`'s ChaCha20Poly1305 (OpenSSL), ~1 ns/byte.
  Used whenever the wheel is importable.
- ``openssl`` — the same OpenSSL primitive bound directly through
  ctypes (`transport/_chacha_ossl.py`): CPython links libcrypto for the
  `ssl` module, so this tier is native speed with ZERO new dependencies
  — the default on this framework's baseline image.
- ``numpy`` — the vectorized implementation in `transport/_chacha_np.py`
  (~30 ns/byte at batch sizes, see its docstring), for the hypothetical
  box with numpy but no loadable libcrypto.
- ``python`` — the original pure-python fallback in
  `transport/_chacha.py` (~6 us/wire-byte; correctness reference).

``HQ_WIRE_BACKEND`` forces a specific backend (``native``, ``openssl``,
``numpy``, ``python``, or ``auto``) — the compat-path CI lever: a suite run with
``HQ_WIRE_BACKEND=python`` exercises the fallback even where the faster
tiers are installed. The selected name is surfaced in ``hq server info``
(``wire_backend``) and in the bench rows.
"""

from __future__ import annotations

import os

_PREFERENCE = ("native", "openssl", "numpy", "python")


def _load(name: str):
    if name == "native":
        from cryptography.hazmat.primitives.ciphers.aead import (
            ChaCha20Poly1305 as impl,
        )
        return impl
    if name == "openssl":
        from hyperqueue_tpu_torch.transport._chacha_ossl import (
            ChaCha20Poly1305 as impl,
        )
        return impl
    if name == "numpy":
        from hyperqueue_tpu_torch.transport._chacha_np import (
            ChaCha20Poly1305 as impl,
        )
        return impl
    if name == "python":
        from hyperqueue_tpu_torch.transport._chacha import (
            ChaCha20Poly1305 as impl,
        )
        return impl
    raise ValueError(
        f"unknown wire backend {name!r} (expected one of "
        f"{', '.join(_PREFERENCE)}, or auto)"
    )


def available_backends() -> list[str]:
    """Backends importable in this process, best first."""
    out = []
    for name in _PREFERENCE:
        try:
            _load(name)
        except ImportError:
            continue
        out.append(name)
    return out


def select_backend(name: str | None = None):
    """(backend_name, ChaCha20Poly1305 class) for `name`, the
    HQ_WIRE_BACKEND environment override, or auto-preference order.
    A forced backend that cannot import raises — a deployment that pins
    ``native`` must not silently run 1000x slower."""
    forced = name or os.environ.get("HQ_WIRE_BACKEND") or "auto"
    if forced != "auto":
        return forced, _load(forced)
    for candidate in _PREFERENCE:
        try:
            return candidate, _load(candidate)
        except ImportError:
            continue
    raise RuntimeError("no AEAD backend importable")  # pragma: no cover


WIRE_BACKEND, ChaCha20Poly1305 = select_backend()
