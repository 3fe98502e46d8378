"""The port's transport (frames, the msgpack codec on the wire, the
handshake, the AEAD backend ladder) against the JAX package's, on the CPU.

The cases of tests/test_transport.py and tests/test_wire_backends.py run
twinned: each against both packages (`pkg` parametrizes them). Then the
cross-package cases: the port's frame payloads byte-equal to msgpack's on
hypothesis payloads, the handshake across the packages in both directions
for both roles (encrypted and in plaintext, under each AEAD backend
forced), and tampered, replayed and reordered frames refused across them.
"""

from __future__ import annotations

import asyncio
import os
import secrets
import subprocess
import sys
import types
from pathlib import Path

import msgpack
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hyperqueue_tpu.transport import aead as jax_aead
from hyperqueue_tpu.transport import auth as jax_auth
from hyperqueue_tpu.transport import framing as jax_framing
from hyperqueue_tpu_torch.transport import aead as port_aead
from hyperqueue_tpu_torch.transport import auth as port_auth
from hyperqueue_tpu_torch.transport import framing as port_framing

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

REPO_ROOT = Path(__file__).resolve().parent.parent

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", module="hyperqueue_tpu", aead=jax_aead, auth=jax_auth,
        framing=jax_framing),
    "port": types.SimpleNamespace(
        name="port", module="hyperqueue_tpu_torch", aead=port_aead,
        auth=port_auth, framing=port_framing),
}

# every backend importable here, per package; the ladders are the same
BACKENDS = {
    name: {n: pkg.aead.select_backend(n)[1]
           for n in pkg.aead.available_backends()}
    for name, pkg in PKGS.items()
}
BACKEND_NAMES = sorted(BACKENDS["port"])

# how long one handshake case may take before it fails
CASE_TIMEOUT_S = 20.0


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, CASE_TIMEOUT_S))


async def _pipe_pair():
    """Two in-process connected (reader, writer) pairs over a real socket."""
    server_side = asyncio.Queue()

    async def on_connect(reader, writer):
        await server_side.put((reader, writer))

    server = await asyncio.start_server(on_connect, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    client = await asyncio.open_connection("127.0.0.1", port)
    srv = await server_side.get()
    return client, srv, server


# ---------------------------------------------------------------------------
# tests/test_transport.py, twinned
# ---------------------------------------------------------------------------
def test_frame_roundtrip(pkg):
    fr = pkg.framing

    async def go():
        (cr, cw), (sr, sw), server = await _pipe_pair()
        payload = fr.pack_payload({"op": "hello", "data": b"\x00\xff",
                                   "n": 42})
        await fr.write_frame(cw, payload)
        got = fr.unpack_payload(await fr.read_frame(sr))
        assert got == {"op": "hello", "data": b"\x00\xff", "n": 42}
        with pytest.raises(fr.FrameError):
            await fr.write_frame(cw, b"x" * (129 * 1024 * 1024))
        server.close()

    run(go())


def _handshake(server_pkg, client_pkg, server_key, client_key,
               server_role=None, client_role=None, expect_at_server=None,
               expect_at_client=None):
    """tests/test_transport.py `_handshake`, with each side's package
    named: the server side runs `server_pkg`'s do_authentication, the
    client side `client_pkg`'s, and a ping-pong crosses the connection."""
    sa, ca = server_pkg.auth, client_pkg.auth
    server_role = server_role or sa.ROLE_SERVER
    client_role = client_role or ca.ROLE_WORKER
    expect_at_server = expect_at_server or sa.ROLE_WORKER
    expect_at_client = expect_at_client or ca.ROLE_SERVER

    async def go():
        (cr, cw), (sr, sw), server = await _pipe_pair()
        server_task = asyncio.create_task(
            sa.do_authentication(sr, sw, server_role, expect_at_server,
                                 server_key)
        )
        client_task = asyncio.create_task(
            ca.do_authentication(cr, cw, client_role, expect_at_client,
                                 client_key)
        )
        try:
            sconn, cconn = await asyncio.gather(server_task, client_task)
            await cconn.send({"msg": "ping", "blob": b"abc", 7: [1, 2.5]})
            assert await sconn.recv() == {"msg": "ping", "blob": b"abc",
                                          7: [1, 2.5]}
            await sconn.send({"msg": "pong"})
            assert await cconn.recv() == {"msg": "pong"}
        finally:
            for t in (server_task, client_task):
                t.cancel()
            cw.close()
            sw.close()
            server.close()

    run(go())


def test_auth_roundtrip_encrypted(pkg):
    key = os.urandom(32)
    _handshake(pkg, pkg, key, key)


def test_auth_roundtrip_plaintext(pkg):
    _handshake(pkg, pkg, None, None)


def test_auth_wrong_key_rejected(pkg):
    with pytest.raises(pkg.auth.AuthError):
        _handshake(pkg, pkg, os.urandom(32), os.urandom(32))


def test_auth_role_confusion_rejected(pkg):
    # a client presenting itself as a worker must be refused
    key = os.urandom(32)
    with pytest.raises(pkg.auth.AuthError):
        _handshake(pkg, pkg, key, key, client_role=pkg.auth.ROLE_CLIENT)


def test_auth_encryption_mismatch_rejected(pkg):
    with pytest.raises(pkg.auth.AuthError):
        _handshake(pkg, pkg, os.urandom(32), None)


def _authenticated_pair(server_pkg, client_pkg, key):
    async def go():
        (cr, cw), (sr, sw), server = await _pipe_pair()
        sconn, cconn = await asyncio.gather(
            server_pkg.auth.do_authentication(
                sr, sw, server_pkg.auth.ROLE_SERVER,
                server_pkg.auth.ROLE_WORKER, key),
            client_pkg.auth.do_authentication(
                cr, cw, client_pkg.auth.ROLE_WORKER,
                client_pkg.auth.ROLE_SERVER, key),
        )
        return sconn, cconn, cw, server
    return go


def test_tampered_frame_rejected(pkg):
    async def go():
        key = os.urandom(32)
        sconn, cconn, cw, server = await _authenticated_pair(pkg, pkg, key)()
        # send a sealed frame, flip a byte in transit by writing raw garbage
        sealed = cconn._sealer.seal(pkg.framing.pack_payload({"x": 1}))
        tampered = bytes([sealed[0] ^ 0xFF]) + sealed[1:]
        await pkg.framing.write_frame(cw, tampered)
        with pytest.raises(Exception):
            await sconn.recv()
        server.close()

    run(go())


# ---------------------------------------------------------------------------
# tests/test_wire_backends.py, twinned
# ---------------------------------------------------------------------------
# RFC 8439 section 2.8.2 test vector
_RFC_KEY = bytes(range(0x80, 0xA0))
_RFC_NONCE = bytes([0x07, 0, 0, 0, 0x40, 0x41, 0x42, 0x43,
                    0x44, 0x45, 0x46, 0x47])
_RFC_AAD = bytes([0x50, 0x51, 0x52, 0x53, 0xC0, 0xC1, 0xC2, 0xC3,
                  0xC4, 0xC5, 0xC6, 0xC7])
_RFC_PT = (
    b"Ladies and Gentlemen of the class of '99: If I could offer you "
    b"only one tip for the future, sunscreen would be it."
)
_RFC_TAG = "1ae10b594f09e26a7e902ecbd0600691"


def test_backend_ladder_sane(pkg):
    backends = BACKENDS[pkg.name]
    # numpy and python are always importable on the baseline image;
    # native rides along where the wheel exists
    assert "numpy" in backends
    assert "python" in backends
    assert pkg.aead.WIRE_BACKEND in backends
    # one ladder, in one order, in both packages
    assert pkg.aead._PREFERENCE == jax_aead._PREFERENCE


@pytest.mark.parametrize("name", BACKEND_NAMES)
def test_rfc8439_vector(pkg, name):
    impl = BACKENDS[pkg.name][name]
    out = impl(_RFC_KEY).encrypt(_RFC_NONCE, _RFC_PT, _RFC_AAD)
    assert out[-16:].hex() == _RFC_TAG
    assert impl(_RFC_KEY).decrypt(_RFC_NONCE, out, _RFC_AAD) == _RFC_PT


def test_backend_parity_both_directions(pkg):
    """seal with A, open with B — every ordered pair of this package's
    backends AND the other package's, sizes straddling every internal
    threshold (scalar/vector crossover, xor paths, partial Poly1305
    blocks, multi-chunk keystream)."""
    sizes = (0, 1, 15, 16, 17, 63, 64, 65, 255, 256, 257,
             1000, 4096, 70000)
    impls = list(BACKENDS[pkg.name].values())
    others = list(BACKENDS["jax" if pkg.name == "port" else "port"].values())
    for size in sizes:
        key = secrets.token_bytes(32)
        nonce = secrets.token_bytes(12)
        data = secrets.token_bytes(size)
        aad = None if size % 2 == 0 else secrets.token_bytes(size % 29)
        sealed = [impl(key).encrypt(nonce, data, aad)
                  for impl in impls + others]
        # identical ciphertext+tag across backends and packages
        assert len(set(sealed)) == 1, f"size {size}"
        for opener in impls:
            for ct in sealed:
                assert opener(key).decrypt(nonce, ct, aad) == data


@pytest.mark.parametrize("name", BACKEND_NAMES)
def test_tamper_rejected(pkg, name):
    impl = BACKENDS[pkg.name][name]
    key = secrets.token_bytes(32)
    nonce = secrets.token_bytes(12)
    ct = bytearray(impl(key).encrypt(nonce, b"payload", None))
    ct[-1] ^= 1
    with pytest.raises(Exception):
        impl(key).decrypt(nonce, bytes(ct), None)


def test_stream_seal_replay_and_reorder_rejected(pkg):
    """The counter nonce makes replay/reorder within a connection fail
    closed: frame N opens only as the N-th open() call."""
    StreamSeal = pkg.auth.StreamSeal
    key = secrets.token_bytes(32)
    sealer = StreamSeal(key, b"dirA")
    frames = [sealer.seal(f"frame-{i}".encode()) for i in range(3)]

    # in-order opens succeed
    opener = StreamSeal(key, b"dirA")
    for i, frame in enumerate(frames):
        assert opener.open(frame) == f"frame-{i}".encode()

    # replay: opening frame 0 twice fails on the second (counter moved)
    opener = StreamSeal(key, b"dirA")
    assert opener.open(frames[0]) == b"frame-0"
    with pytest.raises(Exception):
        opener.open(frames[0])

    # reorder: frame 1 first fails immediately
    opener = StreamSeal(key, b"dirA")
    with pytest.raises(Exception):
        opener.open(frames[1])

    # direction confusion: dirB cannot open dirA's frames
    opener = StreamSeal(key, b"dirB")
    with pytest.raises(Exception):
        opener.open(frames[0])


def test_open_accepts_memoryview(pkg):
    """The zero-copy read path hands memoryviews through seal/open."""
    key = secrets.token_bytes(32)
    data = secrets.token_bytes(5000)
    sealed = pkg.auth.StreamSeal(key, b"dirA").seal(data)
    assert pkg.auth.StreamSeal(key, b"dirA").open(memoryview(sealed)) == data


def _forced_backend(pkg, forced):
    script = (
        f"import sys; from {pkg.module}.transport import aead; "
        "print(aead.WIRE_BACKEND); "
        "print(any(m == 'jax' or m.startswith('jax.') for m in sys.modules))"
    )
    return subprocess.run(
        [sys.executable, "-c", script],
        env={**os.environ, "HQ_WIRE_BACKEND": forced,
             "PYTHONPATH": str(REPO_ROOT)},
        capture_output=True, text=True, timeout=60,
    )


def test_forced_backend_env(pkg):
    """HQ_WIRE_BACKEND pins the selection at import (the CI lever that
    keeps the compat path covered where faster tiers are installed);
    an unknown name fails loudly instead of silently downgrading."""
    for forced in ("python", "numpy"):
        out = _forced_backend(pkg, forced)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split()[0] == forced
        if pkg.name == "port":
            # the port's ladder imports no jax
            assert out.stdout.split()[1] == "False"
    bad = _forced_backend(pkg, "turbo")
    assert bad.returncode != 0
    assert "turbo" in bad.stderr


def test_select_backend_direct(pkg):
    name, impl = pkg.aead.select_backend("python")
    assert name == "python"
    assert impl.__module__ == f"{pkg.module}.transport._chacha"
    name, impl = pkg.aead.select_backend("numpy")
    assert name == "numpy"
    assert impl.__module__ == f"{pkg.module}.transport._chacha_np"


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------
_scalars = (
    st.none() | st.booleans()
    | st.integers(min_value=-(2 ** 63), max_value=2 ** 64 - 1)
    | st.floats(allow_nan=False) | st.text(max_size=40)
    | st.binary(max_size=300)
)
_payloads = st.recursive(
    _scalars,
    lambda inner: (
        st.lists(inner, max_size=6)
        | st.dictionaries(st.text(max_size=8) | st.integers(-50, 300)
                          | st.binary(max_size=4), inner, max_size=6)
    ),
    max_leaves=30,
)


@settings(max_examples=300, deadline=None)
@given(_payloads)
def test_frames_byte_equal_to_msgpack(obj):
    """The port's frame payload is msgpack's (`use_bin_type=True`), and
    either package decodes the other's (`strict_map_key=False`: non-str
    keys, bytes as bin)."""
    ours = port_framing.pack_payload(obj)
    assert ours == jax_framing.pack_payload(obj)
    assert ours == msgpack.packb(obj, use_bin_type=True)
    back = msgpack.unpackb(ours, raw=False, strict_map_key=False)
    assert port_framing.unpack_payload(ours) == back
    assert port_framing.unpack_payload(memoryview(ours)) == back
    assert jax_framing.unpack_payload(ours) == back


def test_frame_bytes_cross_the_socket_both_ways():
    """A frame the port writes is read by the JAX package's reader, and
    the other way round, length prefix included."""
    obj = {"op": "compute", "tasks": [{"id": 1 << 40, "b": 0}],
           "shared_bodies": [{"cmd": ["echo", "x"], "env": {}}], 3: b"\x00"}

    async def go():
        (cr, cw), (sr, sw), server = await _pipe_pair()
        for writer_fr, reader_fr in ((port_framing, jax_framing),
                                     (jax_framing, port_framing)):
            await writer_fr.write_frame(cw, writer_fr.pack_payload(obj))
            raw = await reader_fr.read_frame(sr)
            assert raw == msgpack.packb(obj, use_bin_type=True)
            assert reader_fr.unpack_payload(raw) == obj
        cw.close()
        server.close()

    run(go())


@pytest.mark.parametrize("backend", BACKEND_NAMES)
@pytest.mark.parametrize("encrypted", [True, False],
                         ids=["encrypted", "plaintext"])
@pytest.mark.parametrize("role", ["worker", "client"])
@pytest.mark.parametrize("initiator", ["jax", "port"])
def test_handshake_across_packages(monkeypatch, backend, encrypted, role,
                                   initiator):
    """A JAX initiator against a port responder and a port initiator
    against a JAX responder, for the worker and the client role,
    encrypted and in plaintext, with each AEAD backend forced on both
    sides."""
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.auth, "ChaCha20Poly1305",
                            BACKENDS[pkg.name][backend])
    responder = PKGS["port" if initiator == "jax" else "jax"]
    client = PKGS[initiator]
    key = os.urandom(32) if encrypted else None
    peer = "ROLE_WORKER" if role == "worker" else "ROLE_CLIENT"
    _handshake(responder, client, key, key,
               client_role=getattr(client.auth, peer),
               expect_at_server=getattr(responder.auth, peer))
    # the wrong key and a role mismatch are refused across packages too
    if encrypted:
        with pytest.raises((jax_auth.AuthError, port_auth.AuthError)):
            _handshake(responder, client, key, os.urandom(32),
                       client_role=getattr(client.auth, peer),
                       expect_at_server=getattr(responder.auth, peer))
    other = "ROLE_CLIENT" if role == "worker" else "ROLE_WORKER"
    with pytest.raises((jax_auth.AuthError, port_auth.AuthError)):
        _handshake(responder, client, key, key,
                   client_role=getattr(client.auth, other),
                   expect_at_server=getattr(responder.auth, peer))


@pytest.mark.parametrize("sender", ["jax", "port"])
def test_tampered_replayed_reordered_rejected_across_packages(sender):
    """Frames sealed by one package and opened by the other: in order
    they open; a flipped byte, a replayed frame and a reordered frame are
    refused."""
    receiver = "port" if sender == "jax" else "jax"
    key = secrets.token_bytes(32)
    seal = PKGS[sender].auth.StreamSeal(key, b"dirA")
    frames = [seal.seal(PKGS[sender].framing.pack_payload({"n": i}))
              for i in range(3)]
    Open = PKGS[receiver].auth.StreamSeal
    unpack = PKGS[receiver].framing.unpack_payload

    opener = Open(key, b"dirA")
    assert [unpack(opener.open(f)) for f in frames] == \
        [{"n": 0}, {"n": 1}, {"n": 2}]
    tampered = bytes([frames[0][0] ^ 0x01]) + frames[0][1:]
    with pytest.raises(Exception):
        Open(key, b"dirA").open(tampered)
    opener = Open(key, b"dirA")
    opener.open(frames[0])
    with pytest.raises(Exception):
        opener.open(frames[0])          # replay
    with pytest.raises(Exception):
        Open(key, b"dirA").open(frames[2])   # reorder

    # the same over a live authenticated connection: the port's sealed
    # frame, tampered in transit, is refused by the JAX reader and back
    async def go():
        sconn, cconn, cw, server = await _authenticated_pair(
            PKGS[receiver], PKGS[sender], key)()
        sealed = cconn._sealer.seal(PKGS[sender].framing.pack_payload(
            {"x": 1}))
        await PKGS[sender].framing.write_frame(
            cw, bytes([sealed[0] ^ 0xFF]) + sealed[1:])
        with pytest.raises(Exception):
            await sconn.recv()
        server.close()

    run(go())
