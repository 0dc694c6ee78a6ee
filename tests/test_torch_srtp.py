"""The port's SRTP (``net/srtp.py``, AES from its native library, no
``cryptography``) on the CPU: the RFC known-answer vectors of
``tests/test_srtp_kat.py``, byte equality with the JAX package's Python
contexts (``mediastreamer2_tpu/net/srtp.py``) for every suite, replay and
tamper rejection, SDES, EKT, and the port's batched edge with SRTP against
the JAX package's contexts in both directions. Every comparison is exact
(bytes; tolerance 0). These tests never import the JAX package's native
module."""
import base64
import hashlib
import hmac
import socket
import time

import numpy as np
import pytest

from mediastreamer2_tpu.net import srtp as J
from mediastreamer2_tpu.net.rtp import RtpPacket
from mediastreamer2_tpu_torch import native
from mediastreamer2_tpu_torch.net import srtp as P
from mediastreamer2_tpu_torch.net.rtp import LoopbackPair

H = bytes.fromhex
SUITES = sorted(P.SUITES)


# -- tests/test_srtp_kat.py: RFC 3711 B.2 -------------------------------------
def test_rfc3711_b2_aes_cm_keystream():
    ks = P._aes_cm_keystream(H("2B7E151628AED2A6ABF7158809CF4F3C"),
                             H("F0F1F2F3F4F5F6F7F8F9FAFBFCFD0000"), 48)
    assert ks == H("E03EAD0935C95E80E166B16DD92B4EB4"
                   "D23513162B02D0F72A43A2FE4A5F97AB"
                   "41E95B3BB0A2E8DD477901E4FCA894C0")


def test_rfc3711_b2_keystream_iv_construction():
    ctx = P.SrtpContext(H("2B7E151628AED2A6ABF7158809CF4F3C"),
                        H("F0F1F2F3F4F5F6F7F8F9FAFBFCFD"))
    ctx.k_s = H("F0F1F2F3F4F5F6F7F8F9FAFBFCFD")    # bypass the KDF for this check
    assert ctx._keystream_iv(0, 0) == H("F0F1F2F3F4F5F6F7F8F9FAFBFCFD0000")


# -- RFC 3711 B.3 --------------------------------------------------------------
MASTER_KEY_B3 = H("E1F97A0D3E018BE0D64FA32C06DE4139")
MASTER_SALT_B3 = H("0EC675AD498AFEEBB6960B3AABE6")


@pytest.mark.parametrize("label,length,want", [
    (P.LABEL_RTP_ENCRYPTION, 16, "C61E7A93744F39EE10734AFE3FF7A087"),
    (P.LABEL_RTP_SALT, 14, "30CBBC08863D8C85D49DB34A9AE1"),
    (P.LABEL_RTP_AUTH, 20, "CEBE321F6FF7716B6FD4AB49AF256A156D38BAA4"),
], ids=["cipher_key", "cipher_salt", "auth_key"])
def test_rfc3711_b3_kdf(label, length, want):
    assert P.derive_key(MASTER_KEY_B3, MASTER_SALT_B3, label, length) == H(want)


def test_rfc3711_b3_context_uses_kdf():
    ctx = P.SrtpContext(MASTER_KEY_B3, MASTER_SALT_B3, P.AES_CM_128_HMAC_SHA1_80)
    assert ctx.k_e == H("C61E7A93744F39EE10734AFE3FF7A087")
    assert ctx.k_s == H("30CBBC08863D8C85D49DB34A9AE1")
    assert ctx.k_a == H("CEBE321F6FF7716B6FD4AB49AF256A156D38BAA4")


# -- RFC 6188 §7 ---------------------------------------------------------------
MASTER_KEY_6188 = H("f0f04914b513f2763a1b1fa130f10e2998f6f6e43e4309d1e622a0e332b9f1b6")
MASTER_SALT_6188 = H("3b04803de51ee7c96423ab5b78d2")


def test_rfc6188_aes256_cm_keystream():
    ks = P._aes_cm_keystream(H("57f82fe3613fd170a85ec93c40b1f0922ec4cb0dc025b58272147cc438944a98"),
                             H("f0f1f2f3f4f5f6f7f8f9fafbfcfd0000"), 48)
    assert ks == H("92bdd28a93c3f52511c677d08b5515a4"
                   "9da71b2378a854f67050756ded165bac"
                   "63c4868b7096d88421b563b8c94c9a31")


@pytest.mark.parametrize("label,length,want", [
    (P.LABEL_RTP_ENCRYPTION, 32, "5ba1064e30ec51613cad926c5a28ef731ec7fb397f70a960653caf06554cd8c4"),
    (P.LABEL_RTP_AUTH, 20, "fd9c32d39ed5fbb5a9dc96b30818454d1313dc05"),
    (P.LABEL_RTP_SALT, 14, "fa31791685ca444a9e07c6c64e93"),
], ids=["cipher_key", "auth_key", "cipher_salt"])
def test_rfc6188_kdf(label, length, want):
    assert P.derive_key(MASTER_KEY_6188, MASTER_SALT_6188, label, length) == H(want)


def test_rfc6188_context_roundtrip_256():
    tx = P.SrtpContext(MASTER_KEY_6188, MASTER_SALT_6188, P.AES_256_CM_HMAC_SHA1_80)
    rx = P.SrtpContext(MASTER_KEY_6188, MASTER_SALT_6188, P.AES_256_CM_HMAC_SHA1_80)
    pkt = H("800060001234567811223344") + b"payload-bytes-here"
    assert rx.unprotect(tx.protect(pkt)) == pkt


# -- RFC 7714 §16.1 ------------------------------------------------------------
GCM_KEY = H("000102030405060708090a0b0c0d0e0f")
GCM_SALT = H("517569642070726f2071756f")
GCM_HDR = H("8040f17b8041f8d35501a0b2")
GCM_PLAIN = b"Gallia est omnis divisa in partes tres"
GCM_CT_TAG = H("f24de3a3fb34de6cacba861c9d7e4bcabe633bd50d294e6f42a5f47a51c7d19b"
               "36de3adf8833899d7f27beb16a9152cf765ee4390cce")


def _raw_gcm_context():
    """§16.1's key and salt are session keys: a context built without the
    KDF (as tests/test_srtp_kat.py builds it)."""
    ctx = P.SrtpContext.__new__(P.SrtpContext)
    ctx.suite, ctx.kind = P.AEAD_AES_128_GCM, "gcm"
    ctx.k_e, ctx.k_s = GCM_KEY, GCM_SALT
    ctx._gcm = P.AESGCM(GCM_KEY)
    ctx.roc, ctx.last_seq, ctx.replay = {}, {}, {}
    return ctx


def test_rfc7714_iv_construction():
    ctx = P.SrtpContext(GCM_KEY, GCM_SALT, P.AEAD_AES_128_GCM)
    ctx.k_s = GCM_SALT
    assert ctx._gcm_iv(0x5501A0B2, 0, 0xF17B) == H("51753c6580c2726f20718414")


def test_rfc7714_srtp_packet_protect():
    out = _raw_gcm_context().protect(GCM_HDR + GCM_PLAIN)
    assert out[:12] == GCM_HDR and out[12:] == GCM_CT_TAG


def test_rfc7714_srtp_packet_unprotect():
    ctx = _raw_gcm_context()
    assert ctx.unprotect(GCM_HDR + GCM_CT_TAG) == GCM_HDR + GCM_PLAIN
    bad = bytearray(GCM_HDR + GCM_CT_TAG)
    bad[20] ^= 1
    ctx.replay.clear()
    assert ctx.unprotect(bytes(bad)) is None


# -- RFC 2202 and the truncated tags -------------------------------------------
def test_hmac_sha1_truncation():
    mac = hmac.new(b"Jefe", b"what do ya want for nothing?", hashlib.sha1).digest()
    assert mac == H("effcdf6ae5eb2fa2d27416d5f184df9c259a7c79")
    assert mac[:10] == H("effcdf6ae5eb2fa2d274") and mac[:4] == H("effcdf6a")


@pytest.mark.parametrize("suite,tag", [(P.AES_CM_128_HMAC_SHA1_80, 10),
                                       (P.AES_CM_128_HMAC_SHA1_32, 4)])
def test_truncated_auth_suites_roundtrip(suite, tag):
    tx = P.SrtpContext(MASTER_KEY_B3, MASTER_SALT_B3, suite)
    rx = P.SrtpContext(MASTER_KEY_B3, MASTER_SALT_B3, suite)
    pkt = H("800060011234567811223344") + b"0123456789abcdef"
    prot = tx.protect(pkt)
    assert len(prot) == len(pkt) + tag
    assert rx.unprotect(prot) == pkt


# -- byte equality with the JAX package ----------------------------------------
def _keys(suite, seed):
    _, klen, slen, _ = P.SUITES[suite]
    rng = np.random.default_rng(seed)
    return rng.bytes(klen), rng.bytes(slen)


def _packets(seed, n=40, ssrc=0x5EED):
    """A seeded RTP packet run whose sequence numbers cross the 16-bit wrap
    (the ROC steps to 1), with payloads of 1..300 bytes."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        seq = (65520 + i) & 0xFFFF
        size = int(rng.integers(1, 300))
        yield RtpPacket(0, seq, 160 * i, ssrc, rng.bytes(size)).pack()


@pytest.mark.parametrize("suite", SUITES)
def test_srtp_protect_matches_jax(suite):
    """The port's protect writes the JAX package's bytes, packet for
    packet across a ROC wrap; each side's unprotect opens the other's."""
    key, salt = _keys(suite, 1)
    tp, tj = P.SrtpContext(key, salt, suite), J.SrtpContext(key, salt, suite)
    rp, rj = P.SrtpContext(key, salt, suite), J.SrtpContext(key, salt, suite)
    for pkt in _packets(2):
        wire = tp.protect(pkt)
        assert wire == tj.protect(pkt)
        assert rp.unprotect(wire) == pkt and rj.unprotect(wire) == pkt
    assert tp.roc == tj.roc == {0x5EED: 1}
    assert rp.roc == rj.roc and rp.last_seq == rj.last_seq


@pytest.mark.parametrize("suite", SUITES)
def test_srtcp_protect_matches_jax(suite):
    key, salt = _keys(suite, 3)
    tp, tj = P.SrtcpContext(key, salt, suite), J.SrtcpContext(key, salt, suite)
    rp, rj = P.SrtcpContext(key, salt, suite), J.SrtcpContext(key, salt, suite)
    rng = np.random.default_rng(4)
    for i in range(12):
        pkt = bytes([0x80, 200, 0, 6]) + (0x5EED).to_bytes(4, "big") + rng.bytes(4 * (i + 1))
        wire = tp.protect(pkt)
        assert wire == tj.protect(pkt)
        assert rp.unprotect(wire) == pkt and rj.unprotect(wire) == pkt
        assert rp.unprotect(wire) is None                 # replay


@pytest.mark.parametrize("suite", SUITES)
def test_replay_and_tamper_rejected(suite):
    key, salt = _keys(suite, 5)
    tx, rx = P.SrtpContext(key, salt, suite), P.SrtpContext(key, salt, suite)
    pkt = RtpPacket(0, 1, 160, 7, b"payload").pack()
    prot = tx.protect(pkt)
    for pos in (2, 12, len(prot) - 1):                    # header, payload, tag
        bad = bytearray(prot)
        bad[pos] ^= 1
        assert rx.unprotect(bytes(bad)) is None
    assert rx.unprotect(prot) == pkt
    assert rx.unprotect(prot) is None                     # replay
    other = P.SrtpContext(*_keys(suite, 6), suite)
    assert other.unprotect(tx.protect(RtpPacket(0, 2, 320, 7, b"x").pack())) is None


@pytest.mark.parametrize("suite", SUITES)
def test_sdes_roundtrip(suite):
    line, key, salt = P.sdes_generate(suite)
    assert P.sdes_parse("1 " + line) == (suite, key, salt)
    assert J.sdes_parse("1 " + line) == (suite, key, salt)     # the JAX package reads it
    with pytest.raises(ValueError):
        P.sdes_parse(f"1 {suite} inline:{base64.b64encode(key).decode()}")


def test_aes_gcm_and_key_wrap_match_the_standards():
    """The AES-GCM object and the RFC 3394 key wrap against RFC 3394 §4.1
    and a GCM test vector (NIST SP 800-38D test case 3)."""
    kek = H("000102030405060708090A0B0C0D0E0F")
    key = H("00112233445566778899AABBCCDDEEFF")
    wrapped = H("1FA68B0A8112B447AEF34BD8FB5A7B829D3E862371D2CFE5")
    assert P.aes_key_wrap(kek, key) == wrapped
    assert P.aes_key_unwrap(kek, wrapped) == key
    with pytest.raises(P.InvalidUnwrap):
        P.aes_key_unwrap(kek, wrapped[:-1] + bytes([wrapped[-1] ^ 1]))
    g = P.AESGCM(H("feffe9928665731c6d6a8f9467308308"))
    pt = H("d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
           "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255")
    ct = g.encrypt(H("cafebabefacedbaddecaf888"), pt, b"")
    assert ct[-16:] == H("4d5c2af327cd64a62cf35abd2ba6fab4")
    assert g.decrypt(H("cafebabefacedbaddecaf888"), ct, b"") == pt
    with pytest.raises(P.InvalidTag):
        g.decrypt(H("cafebabefacedbaddecaf888"), ct[:-1] + b"\x00", b"")


def test_ekt_transport_matches_jax():
    """EktTransport over an outer SRTP layer: the port's wire bytes equal
    the JAX package's (the RFC 3394 wrap is deterministic), and each side
    learns the inner key from the other's full tags."""
    ekt_key = bytes(range(16))
    inner, outer = (bytes(range(40, 56)), bytes(range(14))), (bytes(range(60, 76)),
                                                               bytes(range(20, 34)))

    class Cap:
        def __init__(self):
            self.out = []

        def send(self, d):
            self.out.append(d)

        def recv_all(self):
            out, self.out = self.out, []
            return out

        def close(self):
            pass

    def sender(mod, cap):
        outer_t = mod.SrtpTransport(cap, tx=mod.SrtpContext(*outer), rx=mod.SrtpContext(*outer))
        ekt = mod.EktTransport(outer_t, ekt_key=ekt_key, spi=7, send_master_key=inner[0],
                               full_period=4)
        return mod.SrtpTransport(ekt, tx=mod.SrtpContext(*inner), rx=mod.SrtpContext(*inner))
    caps = {"port": Cap(), "jax": Cap()}
    tx = {"port": sender(P, caps["port"]), "jax": sender(J, caps["jax"])}
    for pkt in _packets(7, n=20, ssrc=0x1234):
        for t in tx.values():
            t.send(pkt)
    assert caps["port"].out == caps["jax"].out
    wires = list(caps["port"].out)
    for mod in (P, J):
        cap = Cap()
        cap.out = list(wires)
        learned = {}
        rx = mod.EktTransport(mod.SrtpTransport(cap, tx=mod.SrtpContext(*outer),
                                                rx=mod.SrtpContext(*outer)),
                              recv_keys={7: ekt_key},
                              on_key=lambda s, k, r: learned.update({s: (k, r)}))
        ctx = mod.SrtpContext(*inner)
        plain = [ctx.unprotect(w) for w in rx.recv_all()]
        assert plain == list(_packets(7, n=20, ssrc=0x1234))
        assert learned == {0x1234: (inner[0], 0)}


# -- the port's batched edge against the JAX package's contexts ----------------
PSZ = 80


def _udp_pair():
    a = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    b = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for s in (a, b):
        s.bind(("127.0.0.1", 0))
    b.setblocking(False)
    return a, b


@pytest.mark.parametrize("suite", [P.AES_CM_128_HMAC_SHA1_80, P.AEAD_AES_128_GCM])
def test_batch_edge_srtp_interoperates_with_jax_contexts(suite):
    """The port's BatchRtpTx protects in C; the JAX package's Python
    SrtpContext opens every packet. The JAX package's context protects;
    the port's BatchRtpRx authenticates and decrypts, counts a tampered
    packet as an authentication failure and a repeated one as a replay."""
    if not native.rtp_edge_available():
        pytest.skip("g++ is not installed")
    legs, ticks = 3, 6
    keys = [_keys(suite, 10 + i) for i in range(legs)]
    rng = np.random.default_rng(11)
    pays = [rng.integers(0, 256, (legs, PSZ), dtype=np.uint8) for _ in range(ticks)]

    # port -> JAX
    s_tx, s_rx = _udp_pair()
    tx = native.BatchRtpTx(s_tx, legs, PSZ)
    try:
        for i in range(legs):
            tx.config(i, "127.0.0.1", s_rx.getsockname()[1], ssrc=0x7000 + i, pt=9)
            tx.set_srtp(i, *keys[i], suite)
        for pay in pays:
            assert tx.send(pay, ts_inc=PSZ) == legs
        time.sleep(0.05)
        ctxs = [J.SrtpContext(*keys[i], suite) for i in range(legs)]
        got = {i: [] for i in range(legs)}
        while True:
            try:
                wire = s_rx.recv(2048)
            except BlockingIOError:
                break
            leg = int.from_bytes(wire[8:12], "big") - 0x7000
            plain = ctxs[leg].unprotect(wire)
            assert plain is not None
            got[leg].append(plain[12:])
        for i in range(legs):
            assert got[i] == [p[i].tobytes() for p in pays]
    finally:
        tx.close()
        s_tx.close()
        s_rx.close()

    # JAX -> port
    s_tx, s_rx = _udp_pair()
    rx = native.BatchRtpRx(legs, PSZ, ring_depth=64)
    try:
        rx.add_socket(s_rx)
        for i in range(legs):
            rx.map_ssrc(0x7100 + i, i)
            rx.set_prefill(i, 1)
            rx.set_srtp(i, *keys[i], suite)
        ctxs = [J.SrtpContext(*keys[i], suite) for i in range(legs)]
        dest = s_rx.getsockname()
        for t, pay in enumerate(pays):
            for i in range(legs):
                wire = ctxs[i].protect(RtpPacket(9, 100 + t, PSZ * t, 0x7100 + i,
                                                 pay[i].tobytes()).pack())
                s_tx.sendto(wire, dest)
                if t == 2 and i == 0:
                    s_tx.sendto(wire, dest)                       # a replay
                if t == 3 and i == 1:
                    s_tx.sendto(wire[:-1] + bytes([wire[-1] ^ 1]), dest)   # tampered
        time.sleep(0.05)
        rx.poll()
        rx.read_tick()                                            # prefill
        for t in range(ticks - 1):
            out, flags = rx.read_tick()
            assert flags.all()
            np.testing.assert_array_equal(out, pays[t])
        assert rx.replay_drops(0) == 1 and rx.auth_failures(0) == 0
        assert rx.auth_failures(1) == 1 and rx.replay_drops(1) == 0
        assert rx.auth_failures(2) == 0 and rx.replay_drops(2) == 0
    finally:
        rx.close()
        s_tx.close()
        s_rx.close()


def test_srtp_transport_over_loopback():
    """SrtpTransport with SRTCP contexts: RTP and RTCP both protected on
    the wire and opened on the far side; a wrong-key peer counts
    authentication failures."""
    key, salt = _keys(P.AES_CM_128_HMAC_SHA1_80, 12)
    pair = LoopbackPair()
    mk = lambda ep, k=key: P.SrtpTransport(  # noqa: E731
        pair.endpoint(ep), tx=P.SrtpContext(k, salt), rx=P.SrtpContext(k, salt),
        tx_rtcp=P.SrtcpContext(k, salt), rx_rtcp=P.SrtcpContext(k, salt))
    a, b = mk(0), mk(1)
    rtp = RtpPacket(0, 5, 800, 0x42, b"media").pack()
    rtcp = bytes([0x80, 201, 0, 1]) + (0x42).to_bytes(4, "big")
    a.send(rtp)
    a.send(rtcp)
    assert pair.queues[1][0][1] != rtp                      # encrypted on the wire
    assert b.recv_all() == [rtp, rtcp]
    c = mk(0, bytes(16))
    c.send(rtp)
    assert b.recv_all() == [] and b.auth_failures == 1
