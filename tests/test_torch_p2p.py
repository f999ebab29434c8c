"""The port's p2p stack (cometbft_tpu_torch/p2p) held against the JAX
package's and the standards, on the CPU.

- X25519 against RFC 7748 §5.2 (both vectors, one ladder iteration) and
  §6.1 (both public keys and the shared secret); HKDF-SHA256 against
  RFC 5869 test case 1; ChaCha20-Poly1305 (csrc/host/aead.cc, built by
  g++) against RFC 8439 §2.8.2, and against the `cryptography` wheel
  over random lengths 0-1,041 where the wheel is present (the port never
  imports it).
- A tampered frame and an oversized frame raise ConnectionError.
- The port's SecretConnection against the JAX package's over a
  `socket.socketpair()`, each side initiating: each sees the other's
  identity; messages of 0, 1, 1,024, 1,025 and 100,000 bytes round-trip
  both ways; the bytes on the wire never hold the plaintext.
- MConnection: channels multiplexed and reassembled (port to port and
  port to JAX), the send rate limited by the token bucket.
- Switch: a port Switch and a JAX Switch handshake over localhost TCP,
  each side dialling, and their reactors talk; a wrong network is
  refused in both directions.

Every result is bytes, an identity or an exception, so the tolerance is
none; timings are lower bounds only where the rate limit sets them.
"""

import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.p2p import conn as jconn
from cometbft_tpu.p2p import mconn as jmconn
from cometbft_tpu.p2p import switch as jswitch

from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as PPriv
from cometbft_tpu_torch.p2p import conn as pconn
from cometbft_tpu_torch.p2p import mconn as pmconn
from cometbft_tpu_torch.p2p import switch as pswitch

SEED = 5


def _h(s: str) -> bytes:
    return bytes.fromhex(s)


@pytest.mark.parametrize("scalar,u,out", [
    # RFC 7748 §5.2
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
    # §5.2, one iteration from k = u = 9
    ("09" + "00" * 31, "09" + "00" * 31,
     "422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079"),
])
def test_x25519_rfc7748_vectors(scalar, u, out):
    assert pconn.x25519(_h(scalar), _h(u)) == _h(out)


def test_x25519_rfc7748_diffie_hellman():
    a = _h("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    b = _h("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
    pa, pb = pconn.x25519_base(a), pconn.x25519_base(b)
    assert pa == _h("8520f0098930a754748b7ddcb43ef75a"
                    "0dbf3a0d26381af4eba4a98eaa9b4e6a")
    assert pb == _h("de9edb7d7b7dc1b4d35b61c2ece43537"
                    "3f8343c85b78674dadfc7e146f882b4f")
    k = _h("4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")
    assert pconn.x25519(a, pb) == pconn.x25519(b, pa) == k


def test_hkdf_sha256_rfc5869_case1():
    okm = pconn.hkdf_sha256(b"\x0b" * 22, bytes(range(13)),
                            bytes(range(0xf0, 0xfa)), 42)
    assert okm == _h("3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db0"
                     "2d56ecc4c5bf34007208d5b887185865")


_RFC8439_CT = (
    "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d63dbea45e"
    "8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b3692ddbd7f2d778b8c"
    "9803aee328091b58fab324e4fad675945585808b4831d7bc3ff4def08e4b7a9de576d265"
    "86cec64b6116")


def test_chacha20poly1305_rfc8439_2_8_2():
    key = bytes(range(0x80, 0xa0))
    nonce = _h("070000004041424344454647")
    aad = _h("50515253c0c1c2c3c4c5c6c7")
    pt = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
          b"only one tip for the future, sunscreen would be it.")
    sealed = pconn.chacha20poly1305_seal(key, nonce, pt, aad)
    assert sealed[:-16] == _h(_RFC8439_CT)
    assert sealed[-16:] == _h("1ae10b594f09e26a7e902ecbd0600691")
    assert pconn.chacha20poly1305_open(key, nonce, sealed, aad) == pt
    for i in (0, len(pt) - 1, len(sealed) - 1):
        bad = bytearray(sealed)
        bad[i] ^= 1
        with pytest.raises(ValueError):
            pconn.chacha20poly1305_open(key, nonce, bytes(bad), aad)
    with pytest.raises(ValueError):
        pconn.chacha20poly1305_open(key, nonce, sealed, aad[:-1])


def test_chacha20poly1305_against_cryptography():
    aead = pytest.importorskip(
        "cryptography.hazmat.primitives.ciphers.aead")
    rng = np.random.default_rng(SEED)
    lengths = [0, 1, 15, 16, 17, 63, 64, 65, 1024, 1025, 1041] + [
        int(n) for n in rng.integers(0, 1042, 40)]
    for n in lengths:
        key, nonce = rng.bytes(32), rng.bytes(12)
        pt, aad = rng.bytes(n), rng.bytes(int(rng.integers(0, 40)))
        want = aead.ChaCha20Poly1305(key).encrypt(nonce, pt, aad or None)
        assert pconn.chacha20poly1305_seal(key, nonce, pt, aad) == want, n
        assert pconn.chacha20poly1305_open(key, nonce, want, aad) == pt


def _pair(cls_a, key_a, cls_b, key_b, sock_a=None):
    """Handshake two SecretConnections over a socketpair, each in its own
    thread; -> (a, b, raw socket of a)."""
    sa, sb = socket.socketpair()
    out = {}

    def side(name, cls, sock, key):
        out[name] = cls(sock, key)
    ts = [threading.Thread(target=side, args=("a", cls_a,
                                              sock_a(sa) if sock_a else sa,
                                              key_a)),
          threading.Thread(target=side, args=("b", cls_b, sb, key_b))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert "a" in out and "b" in out, "handshake did not complete"
    return out["a"], out["b"], sa


def _roundtrip(src, dst, msg):
    t = threading.Thread(target=src.send_message, args=(msg,))
    t.start()
    got = dst.recv_message()
    t.join(10)
    return got


@pytest.mark.parametrize("first", ["port", "jax"])
def test_secret_connection_interop(first):
    rng = np.random.default_rng(SEED + 1)
    pk, jk = PPriv(rng.bytes(32)), JPriv(rng.bytes(32))
    captured = []

    class Tap:
        def __init__(self, inner):
            self.inner = inner

        def sendall(self, b):
            captured.append(bytes(b))
            self.inner.sendall(b)

        def recv(self, n):
            return self.inner.recv(n)

        def close(self):
            self.inner.close()

    if first == "port":
        p, j, _ = _pair(pconn.SecretConnection, pk, jconn.SecretConnection,
                        jk, sock_a=Tap)
    else:
        j, p, _ = _pair(jconn.SecretConnection, jk, pconn.SecretConnection,
                        pk, sock_a=Tap)
    assert p.peer_pubkey.bytes_() == jk.pub_key().bytes_()
    assert j.peer_pubkey.bytes_() == pk.pub_key().bytes_()
    for n in (0, 1, 1024, 1025, 100_000):
        msg = rng.bytes(n)
        assert _roundtrip(p, j, msg) == msg
        assert _roundtrip(j, p, msg) == msg
    secret = b"the secret consensus vote payload"
    assert _roundtrip(p, j, secret) == secret
    assert _roundtrip(j, p, secret) == secret
    assert not any(secret in blob for blob in captured)
    p.close()
    j.close()


def test_tampered_and_oversized_frames_raise():
    rng = np.random.default_rng(SEED + 2)
    key = PPriv(rng.bytes(32))
    a, b, raw = _pair(pconn.SecretConnection, key, pconn.SecretConnection,
                      PPriv(rng.bytes(32)))
    assert _roundtrip(a, b, b"payload-one") == b"payload-one"
    # the next frame a would send, one ciphertext bit flipped in transit
    frame = bytearray(a._sealer.frames(b"corrupt-me"))
    frame[-1] ^= 1
    raw.sendall(bytes(frame))
    with pytest.raises(ConnectionError, match="AEAD open failed"):
        b.recv_message()
    a2, b2, raw2 = _pair(pconn.SecretConnection, key,
                         pconn.SecretConnection, PPriv(rng.bytes(32)))
    raw2.sendall(struct.pack("<I", pconn.DATA_MAX_SIZE + 18))
    with pytest.raises(ConnectionError, match="oversized frame"):
        b2.recv_message()
    # the JAX package's side reads the port's tampered frame the same way
    a3, j3, raw3 = _pair(pconn.SecretConnection, key,
                         jconn.SecretConnection, JPriv(rng.bytes(32)))
    frame = bytearray(a3._sealer.frames(b"x" * 2000))
    frame[10] ^= 1
    raw3.sendall(bytes(frame))
    with pytest.raises(ConnectionError):
        j3.recv_message()
    for c in (a, b, a2, b2, a3, j3):
        c.close()


@pytest.mark.parametrize("peer", ["port", "jax"])
def test_mconnection_multiplex_and_reassembly(peer):
    rng = np.random.default_rng(SEED + 3)
    jside = peer == "jax"
    a, b, _ = _pair(pconn.SecretConnection, PPriv(rng.bytes(32)),
                    jconn.SecretConnection if jside else
                    pconn.SecretConnection,
                    (JPriv if jside else PPriv)(rng.bytes(32)))
    got = []
    done = threading.Event()

    def on_recv(cid, msg):
        got.append((cid, msg))
        if len(got) == 3:
            done.set()
    m = jmconn if jside else pmconn
    descs_a = [pmconn.ChannelDescriptor(id=0x20, priority=5),
               pmconn.ChannelDescriptor(id=0x21, priority=1)]
    descs_b = [m.ChannelDescriptor(id=0x20, priority=5),
               m.ChannelDescriptor(id=0x21, priority=1)]
    ma = pmconn.MConnection(a, descs_a, on_receive=lambda c, x: None)
    mb = m.MConnection(b, descs_b, on_receive=on_recv)
    ma.start()
    mb.start()
    big = rng.bytes(5000)          # several packets of 1,400 bytes
    ma.send(0x20, b"votes")
    ma.send(0x21, big)
    ma.send(0x20, b"more-votes")
    assert done.wait(10), f"only received {got}"
    by_chan = {}
    for cid, msg in got:
        by_chan.setdefault(cid, []).append(msg)
    assert by_chan[0x20] == [b"votes", b"more-votes"]
    assert by_chan[0x21] == [big]
    with pytest.raises(ValueError):
        ma.send(0x99, b"unknown channel")
    ma.stop()
    mb.stop()


def test_mconnection_send_rate_limited():
    rng = np.random.default_rng(SEED + 4)
    a, b, _ = _pair(pconn.SecretConnection, PPriv(rng.bytes(32)),
                    pconn.SecretConnection, PPriv(rng.bytes(32)))
    done = threading.Event()
    got = []

    def on_recv(cid, msg):
        got.append(msg)
        done.set()
    descs = [pmconn.ChannelDescriptor(id=0x30)]
    # 40 KB at 40 KB/s with a 0.1 s burst: at least ~0.9 s
    ma = pmconn.MConnection(a, descs, on_receive=lambda c, m: None,
                            send_rate=40_000)
    mb = pmconn.MConnection(b, descs, on_receive=on_recv)
    ma.start()
    mb.start()
    payload = b"R" * 40_000
    t0 = time.monotonic()
    ma.send(0x30, payload)
    assert done.wait(30)
    dt = time.monotonic() - t0
    assert got == [payload]
    assert dt > 0.8, f"40 KB at 40 KB/s arrived in {dt:.2f}s: unthrottled"
    assert pmconn.DEFAULT_SEND_RATE == pmconn.DEFAULT_RECV_RATE == \
        jmconn.DEFAULT_SEND_RATE == 5_120_000
    ma.stop()
    mb.stop()


class _Echo:
    """Echoes every message back on the same channel."""

    def __init__(self, desc_cls, cid=0x42):
        self.desc_cls = desc_cls
        self.cid = cid
        self.received = []

    def get_channels(self):
        return [self.desc_cls(id=self.cid, priority=1)]

    def add_peer(self, peer):
        pass

    def remove_peer(self, peer, reason):
        pass

    def receive(self, channel_id, peer, msg):
        self.received.append(msg)
        if not msg.startswith(b"echo:"):
            peer.send(channel_id, b"echo:" + msg)


def _switch(pkg, key, network, moniker):
    sw_mod, desc = ((pswitch, pmconn.ChannelDescriptor) if pkg == "port"
                    else (jswitch, jmconn.ChannelDescriptor))
    sw = sw_mod.Switch(key, network, moniker)
    r = _Echo(desc)
    sw.add_reactor(r)
    return sw, r


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


@pytest.mark.parametrize("listener", ["port", "jax"])
def test_switch_interop_over_tcp(listener):
    from cometbft_tpu_torch.libs.metrics import Registry
    from cometbft_tpu_torch.libs.metrics_gen import P2PMetrics
    rng = np.random.default_rng(SEED + 5)
    pk, jk = PPriv(rng.bytes(32)), JPriv(rng.bytes(32))
    ps, pr = _switch("port", pk, "net-1", "port")
    js, jr = _switch("jax", jk, "net-1", "jax")
    ps.metrics = P2PMetrics(Registry())
    try:
        if listener == "port":
            js.dial(*ps.listen())
        else:
            ps.dial(*js.listen())
        assert _wait(lambda: ps.peers() and js.peers()), "never connected"
        assert ps.peers()[0].id == jk.pub_key().address().hex()
        assert js.peers()[0].id == pk.pub_key().address().hex()
        ps.peers()[0].send(0x42, b"from-port")
        js.peers()[0].send(0x42, b"from-jax")
        assert _wait(lambda: b"echo:from-port" in pr.received
                     and b"echo:from-jax" in jr.received), \
            (pr.received, jr.received)
        assert ps.metrics.peers.value() == 1
        assert ps.metrics.message_send_bytes_total.value(ch_id="0x42") > 0
        assert ps.metrics.message_receive_bytes_total.value(
            ch_id="0x42") > 0
    finally:
        ps.stop()
        js.stop()


@pytest.mark.parametrize("listener", ["port", "jax"])
def test_switch_rejects_wrong_network(listener):
    rng = np.random.default_rng(SEED + 6)
    ps, _ = _switch("port", PPriv(rng.bytes(32)), "net-1", "port")
    js, _ = _switch("jax", JPriv(rng.bytes(32)), "net-OTHER", "jax")
    try:
        if listener == "port":
            js.dial(*ps.listen())
        else:
            ps.dial(*js.listen())
        time.sleep(0.5)
        assert not ps.peers() and not js.peers()
    finally:
        ps.stop()
        js.stop()


def test_switch_stop_peer_ban():
    rng = np.random.default_rng(SEED + 7)
    a, _ = _switch("port", PPriv(rng.bytes(32)), "net-1", "a")
    b, _ = _switch("port", PPriv(rng.bytes(32)), "net-1", "b")
    try:
        addr = a.listen()
        b.dial(*addr)
        assert _wait(lambda: a.peers() and b.peers())
        peer = b.peers()[0]
        b.stop_peer(peer, "test ban", ban=True)
        assert peer.id in b.banned and not b.peers()
        b.dial(*addr)                      # a banned peer is refused
        time.sleep(0.3)
        assert not b.peers()
    finally:
        a.stop()
        b.stop()
