"""The port's key agreement (``net/dtls.py``, ``net/zrtp.py`` over
``net/openssl.py``) against the JAX package's: DTLS-SRTP endpoints of the
two packages complete a handshake with equal exported keys and suite; a
ZRTP exchange is message-for-message byte-equal to the JAX one under
fixed randomness (``os.urandom`` a seeded stream on both sides, the JAX
side's X25519 key drawn from the same stream where it calls
``X25519PrivateKey.generate()``); a port ZRTP endpoint against a JAX one
agrees on the SAS and the keys; libcrypto's X25519 and AES-CFB128 against
RFC 7748's and NIST SP 800-38A's vectors; ports of
``tests/test_zrtp_foreign_bytes.py``, of ``tests/test_zrtp.py`` and of the
DTLS part of ``tests/test_dtls_sdes.py``. Tests that need libssl or
libcrypto skip where it is missing."""
import ctypes
import os
import random
import struct

import pytest
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey

from mediastreamer2_tpu.net import dtls as jdtls
from mediastreamer2_tpu.net import zrtp as jzrtp
from mediastreamer2_tpu_torch.net import dtls as tdtls
from mediastreamer2_tpu_torch.net import openssl
from mediastreamer2_tpu_torch.net import zrtp as tzrtp
from mediastreamer2_tpu_torch.net.rtp import LoopbackPair, RtpPacket, RtpSession
from mediastreamer2_tpu_torch.net.srtp import SrtpContext, SrtpTransport
from test_zrtp_foreign_bytes import build_foreign_hello, crc32c_bitwise

h = bytes.fromhex


@pytest.fixture
def crypto():
    if openssl.libcrypto() is None:
        pytest.skip("libcrypto missing")


@pytest.fixture
def ssl_lib(crypto):
    if not tdtls.dtls_available():
        pytest.skip("libssl missing")


# -- libcrypto's primitives against the published vectors ---------------------------
def test_x25519_rfc7748_vectors(crypto):
    # §5.2: the function on two (scalar, u-coordinate) inputs
    for k, u, out in (
            ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
             "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
             "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
            ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
             "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
             "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957")):
        assert openssl.x25519(h(k), h(u)) == h(out)
    # §6.1: Alice and Bob
    a = h("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    b = h("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
    a_pub, b_pub = openssl.x25519_public(a), openssl.x25519_public(b)
    assert a_pub == h("8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
    assert b_pub == h("de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
    k = h("4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")
    assert openssl.x25519(a, b_pub) == openssl.x25519(b, a_pub) == k
    with pytest.raises(ValueError):              # an all-zero shared secret
        openssl.x25519(a, bytes(32))


def test_aes128_cfb_sp800_38a_vectors(crypto):
    """F.3.13 CFB128-AES128.Encrypt and F.3.14 .Decrypt, and a message that
    ends inside a block (the Confirm messages' 40 bytes)."""
    key = h("2b7e151628aed2a6abf7158809cf4f3c")
    iv = h("000102030405060708090a0b0c0d0e0f")
    pt = h("6bc1bee22e409f96e93d7e117393172a" "ae2d8a571e03ac9c9eb76fac45af8e51"
           "30c81c46a35ce411e5fbc1191a0a52ef" "f69f2445df4f9b17ad2b417be66c3710")
    ct = h("3b3fd92eb72dad20333449f8e83cfb4a" "c8a64537a0b3a93fcde3cdad9f1ce58b"
           "26751f67a3cbb140b1808cf187a4f4df" "c04b05357c5d1c0eeac4c66f9ff7f2e6")
    assert openssl.aes128_cfb(key, iv, pt, encrypt=True) == ct
    assert openssl.aes128_cfb(key, iv, ct, encrypt=False) == pt
    assert openssl.aes128_cfb(key, iv, pt[:40], encrypt=True) == ct[:40]
    assert openssl.aes128_cfb(key, iv, ct[:40], encrypt=False) == pt[:40]


def test_missing_libraries_are_named(monkeypatch):
    monkeypatch.setattr(openssl, "libcrypto", lambda: None)
    monkeypatch.setattr(openssl, "libssl", lambda: None)
    assert not tdtls.dtls_available()
    with pytest.raises(RuntimeError, match="libcrypto"):
        tzrtp.ZrtpSession(send=lambda m: None)
    with pytest.raises(RuntimeError, match="libssl"):
        tdtls.DtlsSrtpSession(is_server=False)


# -- DTLS-SRTP -----------------------------------------------------------------------
def _handshake(client, server):
    for _ in range(10):
        client.handshake_step()
        for p in client.pop_packets():
            server.put_packet(p)
        server.handshake_step()
        for p in server.pop_packets():
            client.put_packet(p)
        if client.is_established and server.is_established:
            break
    return client, server


@pytest.mark.parametrize("client_mod, server_mod", [(tdtls, tdtls), (tdtls, jdtls),
                                                    (jdtls, tdtls)],
                         ids=["port-port", "port-jax", "jax-port"])
def test_dtls_handshake_and_key_export(ssl_lib, client_mod, server_mod):
    """The port's endpoint against itself and against the JAX one: equal
    exported keys and suite on both ends, each side's fingerprint the one
    its peer sees."""
    client, server = _handshake(client_mod.DtlsSrtpSession(is_server=False),
                                server_mod.DtlsSrtpSession(is_server=True))
    assert client.is_established and server.is_established
    assert client.export_srtp_keys() == server.export_srtp_keys()
    assert client.srtp_suite() == server.srtp_suite() == "AEAD_AES_128_GCM"
    assert client.local_fingerprint() == server.peer_fingerprint()
    assert server.local_fingerprint() == client.peer_fingerprint()
    ck, cs, sk, ss = client.export_srtp_keys()
    assert (len(ck), len(cs), len(sk), len(ss)) == (16, 12, 16, 12)


def test_dtls_certificate_has_the_jax_form(ssl_lib):
    """An EC P-256 self-signed certificate with the JAX module's CN, serial
    and a year's validity, as the JAX module's own reads."""
    from cryptography import x509
    from cryptography.hazmat.primitives.asymmetric import ec
    certs = []
    for mod in (jdtls, tdtls):
        s = mod.DtlsSrtpSession(is_server=True)
        cert = openssl.require_libssl().SSL_get_certificate(s.ssl)
        buf = ctypes.create_string_buffer(8192)
        pp = ctypes.c_void_p(ctypes.addressof(buf))
        n = openssl.require_libcrypto().i2d_X509(cert, ctypes.byref(pp))
        certs.append(x509.load_der_x509_certificate(buf.raw[:n]))
    j, t = certs
    for cert in (j, t):
        assert isinstance(cert.public_key(), ec.EllipticCurvePublicKey)
        assert cert.public_key().curve.name == "secp256r1"
        cert.public_key().verify(cert.signature, cert.tbs_certificate_bytes,
                                 ec.ECDSA(cert.signature_hash_algorithm))   # self-signed
    assert t.subject == j.subject == t.issuer
    assert t.serial_number == j.serial_number == 1 and t.version == j.version
    assert t.signature_hash_algorithm.name == j.signature_hash_algorithm.name == "sha256"
    assert t.not_valid_after_utc - t.not_valid_before_utc == \
        j.not_valid_after_utc - j.not_valid_before_utc


def test_dtls_demux_predicate(ssl_lib):
    client = tdtls.DtlsSrtpSession(is_server=False)
    client.handshake_step()
    packets = client.pop_packets()
    assert packets and all(tdtls.is_dtls(p) for p in packets)
    assert not tdtls.is_dtls(RtpPacket(0, 1, 2, 3, b"x").pack())
    client.close()


def test_dtls_derived_srtp_media_flow(ssl_lib):
    """Full chain: handshake -> exported keys -> SRTP transports -> RTP."""
    client, server = _handshake(tdtls.DtlsSrtpSession(is_server=False),
                                tdtls.DtlsSrtpSession(is_server=True))
    ck, cs, sk, ss = client.export_srtp_keys()
    suite = client.srtp_suite()
    pair = LoopbackPair()
    t_client = SrtpTransport(pair.endpoint(0), tx=SrtpContext(ck, cs, suite),
                             rx=SrtpContext(sk, ss, suite))
    t_server = SrtpTransport(pair.endpoint(1), tx=SrtpContext(sk, ss, suite),
                             rx=SrtpContext(ck, cs, suite))
    a = RtpSession(t_client, payload_type=0)
    b = RtpSession(t_server, payload_type=0)
    got = []
    b.on_packet = lambda pkt: got.append(pkt.payload)
    for i in range(5):
        a.send_payload(bytes([i]) * 60, 80)
    b.poll()
    assert got == [bytes([i]) * 60 for i in range(5)]
    assert t_server.auth_failures == 0
    client.close()
    server.close()


# -- ZRTP ----------------------------------------------------------------------------
def _fixed_session(monkeypatch, mod, rng):
    """Sessions of ``mod`` drawing every random byte from ``rng``."""
    monkeypatch.setattr(os, "urandom", lambda n: rng.randbytes(n))
    if mod is jzrtp:
        monkeypatch.setattr(jzrtp.X25519PrivateKey, "generate", staticmethod(
            lambda: X25519PrivateKey.from_private_bytes(rng.randbytes(32))))


def _exchange(a, b, wires, tamper=lambda m: m, log=None):
    for _ in range(30):
        moved = False
        for src, dst in (("a", b), ("b", a)):
            q = list(wires[src])
            wires[src].clear()
            for m in q:
                if log is not None:
                    log.append((src, m))
                dst.process(tamper(m))
                moved = True
        if (a.secrets_ready and b.secrets_ready) or not moved:
            break


def _pair(mod_a, mod_b, cache_a=None, cache_b=None):
    wires = {"a": [], "b": []}
    a = mod_a.ZrtpSession(send=wires["a"].append, cache=cache_a)
    b = mod_b.ZrtpSession(send=wires["b"].append, cache=cache_b)
    out = {}
    a.on_secrets = lambda *k: out.__setitem__("a", k)
    b.on_secrets = lambda *k: out.__setitem__("b", k)
    a.start()
    b.start()
    return a, b, wires, out


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_zrtp_exchange_is_byte_equal_to_jax(crypto, monkeypatch, seed):
    """Hello, HelloACK, Commit (both sides', then the contention), DHPart1/2,
    Confirm1/2 (AES-CFB under random IVs) and Conf2ACK, byte for byte."""
    runs = []
    for mod in (jzrtp, tzrtp):
        _fixed_session(monkeypatch, mod, random.Random(seed))
        a, b, wires, out = _pair(mod, mod)
        log = []
        _exchange(a, b, wires, log=log)
        runs.append((log, a.sas, b.sas, out, a.state, b.state, a.cache, b.cache))
    assert runs[1] == runs[0]
    log, sas_a, sas_b, out, state_a, state_b, _, _ = runs[1]
    assert state_a == state_b == "secure" and sas_a == sas_b and len(log) >= 10
    assert out["a"][:2] == out["b"][2:] and out["a"][2:] == out["b"][:2]


@pytest.mark.parametrize("mod_a, mod_b", [(tzrtp, jzrtp), (jzrtp, tzrtp)],
                         ids=["port-jax", "jax-port"])
def test_zrtp_port_against_jax_agrees(crypto, mod_a, mod_b):
    a, b, wires, out = _pair(mod_a, mod_b)
    _exchange(a, b, wires)
    assert a.state == b.state == "secure"
    assert a.sas == b.sas and len(a.sas) == 4
    assert out["a"][:2] == out["b"][2:] and out["a"][2:] == out["b"][:2]
    tx, rx = SrtpContext(*out["a"][:2]), SrtpContext(*out["b"][2:])
    pkt = RtpPacket(0, 1, 0, 9, b"secret media").pack()
    assert rx.unprotect(tx.protect(pkt)) == pkt


def test_zrtp_key_continuity_cache(crypto):
    cache_a, cache_b = {}, {}
    a, b, wires, _ = _pair(tzrtp, tzrtp, cache_a, cache_b)
    _exchange(a, b, wires)
    assert a.peer_zid in cache_a and b.peer_zid in cache_b
    assert cache_a[a.peer_zid] == cache_b[b.peer_zid]
    rs = cache_a[a.peer_zid]
    tzrtp.ZrtpSession(send=lambda m: None, zid=a.zid, cache=cache_a)
    assert cache_a[a.peer_zid] == rs               # unchanged until the next completion


def test_zrtp_wire_format_rfc6189(crypto):
    assert tzrtp.crc32c(b"123456789") == 0xE3069283 == jzrtp.crc32c(b"123456789")
    msg = tzrtp.make_message(tzrtp.T_HELLO, b"\x01\x02\x03")
    assert msg == jzrtp.make_message(jzrtp.T_HELLO, b"\x01\x02\x03") and len(msg) % 4 == 0
    pkt = tzrtp.wrap_packet(msg, seq=42, ssrc=0xDEADBEEF)
    assert pkt == jzrtp.wrap_packet(msg, seq=42, ssrc=0xDEADBEEF)
    assert tzrtp.is_zrtp(pkt) and tzrtp.unwrap_packet(pkt) == msg
    assert tzrtp.unwrap_packet(pkt[:-1] + bytes([pkt[-1] ^ 1])) is None
    assert tzrtp.parse_message(msg)[0] == tzrtp.T_HELLO
    assert not tzrtp.is_zrtp(RtpPacket(0, 1, 2, 3, b"x").pack())
    assert tzrtp.sas_b32(b"\x00\x00\x00\x00") == "yyyy"
    for v in (b"\xff\xff\xf0", b"\x12\x34\x56", b"\xab\xcd\xef"):
        assert tzrtp.sas_b32(v) == jzrtp.sas_b32(v)
        assert tzrtp._kdf(v * 4, b"label", v, 20) == jzrtp._kdf(v * 4, b"label", v, 20)


def test_goclear_authenticated_downgrade(crypto):
    a, b, wires, _ = _pair(tzrtp, tzrtp)
    _exchange(a, b, wires)
    assert a.state == b.state == "secure"
    cleared = []
    a.on_goclear = lambda: cleared.append("a")
    b.on_goclear = lambda: cleared.append("b")
    b.process(tzrtp.wrap_packet(tzrtp.make_message(tzrtp.T_GOCLEAR, b"\x00" * 8), 1, 7))
    assert b.state == "secure" and cleared == []            # forged: ignored
    a.go_clear()
    _exchange(a, b, wires)
    assert a.state == b.state == "clear" and sorted(cleared) == ["a", "b"]


def test_zrtp_tampered_handshake_fails(crypto):
    a, b, wires, _ = _pair(tzrtp, tzrtp)
    tampered = [False]

    def tamper(m):
        t, body = tzrtp.parse_message(tzrtp.unwrap_packet(m))
        if t == tzrtp.T_DH2 and not tampered[0]:
            tampered[0] = True
            return tzrtp.wrap_packet(tzrtp.make_message(tzrtp.T_DH2, body[:64] + b"\x99" * 32
                                                        + body[96:]), 1, 1)
        return m
    _exchange(a, b, wires, tamper)
    assert tampered[0]
    assert (b.state == "failed" or not b.secrets_ready
            or a.state == "failed" or not a.secrets_ready)


# -- tests/test_zrtp_foreign_bytes.py ----------------------------------------------
def test_session_accepts_foreign_hello(crypto):
    sent = []
    s = tzrtp.ZrtpSession(send=sent.append)
    s.start()
    pkt, zid = build_foreign_hello()
    s.process(pkt)
    assert s.peer_zid == zid
    assert [m for m in sent if tzrtp.parse_message(tzrtp.unwrap_packet(m))[0] == b"HelloACK"]


def test_our_packets_verify_under_foreign_arithmetic(crypto):
    sent = []
    s = tzrtp.ZrtpSession(send=sent.append)
    s.start()
    pkt = sent[0]
    b0, _, _, magic, _ = struct.unpack("!BBHII", pkt[:12])
    assert b0 == 0x10 and magic == 0x5A525450
    assert struct.unpack("!I", pkt[-4:])[0] == crc32c_bitwise(pkt[:-4])
    pre, words = struct.unpack("!HH", pkt[12:16])
    assert pre == 0x505A and 12 + words * 4 + 4 == len(pkt)
    assert pkt[16:24] == b"Hello   "
    body = pkt[24:-4]
    assert body[:4] == b"1.10" and body[20:52] == s.h[3] and body[52:64] == s.zid
    assert len(body) >= 4 + 16 + 32 + 12 + 4 + 20 + 8


def test_corrupted_crc_rejected():
    pkt, _ = build_foreign_hello()
    assert tzrtp.unwrap_packet(pkt[:-1] + bytes([pkt[-1] ^ 0x01])) is None
    assert tzrtp.unwrap_packet(pkt) is not None


def test_zrtp_session_times_its_framing(crypto):
    """The port's ``crc_seconds`` (not in the JAX module) sums the time of a
    session's packet wrapping and unwrapping; it grows with the exchange
    and changes nothing on the wire (the byte-equality test above)."""
    assert tzrtp.ZrtpSession(send=lambda m: None).crc_seconds == 0.0
    a, b, wires, _ = _pair(tzrtp, tzrtp)
    started = (a.crc_seconds, b.crc_seconds)               # each wrapped its Hello
    assert min(started) > 0.0
    _exchange(a, b, wires)
    assert a.state == b.state == "secure"
    assert a.crc_seconds > started[0] and b.crc_seconds > started[1]
