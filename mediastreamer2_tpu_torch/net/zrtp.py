"""ZRTP (RFC 6189) — Diffie-Hellman media-path key agreement with SAS (port
of ``mediastreamer2_tpu/net/zrtp.py``: the same messages, keys and SAS).

Reference: src/crypto/zrtp.c (1,298 LoC bzrtp wrapper): handshake packets
ride the RTP port via a transport modifier (:178), derived SRTP keys feed
ms_srtp (:198-213), SAS surfaces to the user, cache enables key continuity.

Wire format follows RFC 6189 §5: each handshake message travels in an
RTP-lookalike packet (version 0 marker byte 0x10, sequence number, the
0x5a525450 'ZRTP' magic cookie, SSRC) ending in a CRC-32C; messages carry
the 0x505a preamble, a length in 32-bit words and an 8-octet type block
('Hello   ', 'Commit  ', 'DHPart1 ', ...).  Handshake per §4: Hello/
HelloACK exchange (H3 hash chain tip, ZID, algorithm lists), Commit with
hvi commitment (hash of the initiator's DHPart2 || responder's Hello,
§4.4.1.1), DHPart1/DHPart2 (X25519, key-agreement type 'X255'),
Confirm1/Confirm2 encrypted with the derived zrtpkeys (§5.7) and MAC'd
with the hmac keys, Conf2ACK.  s0 and the session keys follow §4.4.1.4 /
§4.5 (KDF labels, total_hash over responder-Hello||Commit||DHPart1||
DHPart2); hash-chain message MACs are verified retroactively as each H_n
is revealed (§8).  SAS is the B32 z-base-32 short string (§5.1.6).

Interop caveat: validated against itself and by structural wire tests;
no bzrtp endpoint exists in this image to cross-check against.

Where the JAX module takes AES-CFB and X25519 from the ``cryptography``
package, the port takes both from libcrypto's EVP through ctypes
(``net/openssl.py``): ``EVP_aes_128_cfb128`` for the Confirm messages and
X25519 through ``EVP_PKEY_new_raw_private_key``,
``EVP_PKEY_get_raw_public_key`` and ``EVP_PKEY_derive``. The private scalar
is ``os.urandom(32)``, drawn where the JAX module calls
``X25519PrivateKey.generate()``. Without libcrypto a session raises
``RuntimeError`` naming it; nothing runs in its place. The CRC-32C is the
JAX module's per-byte Python loop; beside the JAX module, a session sums
the seconds of its packets' wrapping and unwrapping, nearly all of them
that loop, in ``crc_seconds``.
"""
from __future__ import annotations

import hashlib
import hmac
import os
import struct
import time
from typing import Callable, Dict, Optional

from mediastreamer2_tpu_torch.net import openssl

ZRTP_MAGIC = 0x5A525450                 # 'ZRTP' (RFC 6189 §5)
MSG_PREAMBLE = 0x505A
VERSION = b"1.10"
CLIENT_ID = b"ms2tpu          "[:16].ljust(16)

T_HELLO = b"Hello   "
T_HELLO_ACK = b"HelloACK"
T_COMMIT = b"Commit  "
T_DH1 = b"DHPart1 "
T_DH2 = b"DHPart2 "
T_CONF1 = b"Confirm1"
T_CONF2 = b"Confirm2"
T_CONF2_ACK = b"Conf2ACK"
T_GOCLEAR = b"GoClear "
T_CLEAR_ACK = b"ClearACK"

# algorithm blocks we offer/use (one of each; X255 = curve25519 key
# agreement as registered by RFC 7748-era ZRTP implementations incl. bzrtp)
ALG_HASH, ALG_CIPHER, ALG_AUTH, ALG_KEYAGR, ALG_SAS = \
    b"S256", b"AES1", b"HS80", b"X255", b"B32 "

_B32 = "ybndrfg8ejkmcpqxot1uwisza345h769"   # z-base-32 (RFC 6189 SAS)


# ------------------------------------------------------------- CRC-32C
def _crc32c_table():
    poly = 0x82F63B78
    tbl = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        tbl.append(c)
    return tbl


_CRC_TBL = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, RFC 3309) — the ZRTP packet checksum."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TBL[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _kdf(key: bytes, label: bytes, context: bytes, length: int) -> bytes:
    """RFC 6189 §4.5.1 KDF (HMAC-SHA256 counter mode)."""
    out = b""
    counter = 1
    while len(out) < length:
        out += hmac.new(key, struct.pack("!I", counter) + label + b"\x00"
                        + context + struct.pack("!I", length * 8),
                        hashlib.sha256).digest()
        counter += 1
    return out[:length]


def sas_b32(sas_value: bytes) -> str:
    """Short authentication string: 4 z-base-32 chars from 20 bits."""
    bits = int.from_bytes(sas_value[:3], "big") >> 4
    return "".join(_B32[(bits >> s) & 31] for s in (15, 10, 5, 0))


# ----------------------------------------------------------- wire layer
def wrap_packet(message: bytes, seq: int, ssrc: int) -> bytes:
    """RFC 6189 §5 ZRTP packet: 0x10 0x00 | seq | magic | ssrc | msg | CRC."""
    hdr = struct.pack("!BBHII", 0x10, 0x00, seq & 0xFFFF, ZRTP_MAGIC, ssrc)
    body = hdr + message
    return body + struct.pack("!I", crc32c(body))


def unwrap_packet(data: bytes) -> Optional[bytes]:
    """-> message bytes, or None if not a valid ZRTP packet."""
    if len(data) < 16 or data[0] != 0x10:
        return None
    if struct.unpack("!I", data[4:8])[0] != ZRTP_MAGIC:
        return None
    body, crc = data[:-4], struct.unpack("!I", data[-4:])[0]
    if crc32c(body) != crc:
        return None
    return body[12:]


def make_message(mtype: bytes, body: bytes) -> bytes:
    """§5.1 message block: preamble | length (32-bit words) | type | body."""
    if len(body) % 4:
        body += b"\x00" * (4 - len(body) % 4)
    length_words = (4 + 8 + len(body)) // 4
    return struct.pack("!HH", MSG_PREAMBLE, length_words) + mtype + body


def parse_message(msg: bytes):
    """-> (type, body) or (None, None)."""
    if len(msg) < 12:
        return None, None
    pre, words = struct.unpack("!HH", msg[:4])
    if pre != MSG_PREAMBLE or words * 4 > len(msg):
        return None, None
    return msg[4:12], msg[12:words * 4]


def is_zrtp(data: bytes) -> bool:
    return (len(data) >= 8 and data[0] == 0x10
            and struct.unpack("!I", data[4:8])[0] == ZRTP_MAGIC)


def _mac8(key: bytes, data: bytes) -> bytes:
    """§8: message MACs are the first 8 octets of HMAC-SHA256."""
    return hmac.new(key, data, hashlib.sha256).digest()[:8]


class ZrtpSession:
    """One endpoint. Drive with process(); outbound via send callback.

    on_secrets(tx_key, tx_salt, rx_key, rx_salt) fires when SRTP keys are
    ready; on_sas(sas) surfaces the 4-char SAS for user verification."""

    def __init__(self, send: Callable[[bytes], None],
                 zid: Optional[bytes] = None,
                 cache: Optional[Dict[bytes, bytes]] = None,
                 ssrc: Optional[int] = None):
        self._send_raw = send
        self.zid = zid or os.urandom(12)
        self.ssrc = ssrc if ssrc is not None \
            else int.from_bytes(os.urandom(4), "big")
        self.cache = cache if cache is not None else {}   # peer zid -> rs1
        self.priv = os.urandom(32)                # X25519 private scalar
        self.pub = openssl.x25519_public(self.priv)
        self.h = [os.urandom(32)]                 # hash chain H0..H3
        for _ in range(3):
            self.h.append(hashlib.sha256(self.h[-1]).digest())
        self.seq = int.from_bytes(os.urandom(2), "big")
        self.state = "idle"
        self.is_initiator = False
        self.peer_zid: Optional[bytes] = None
        self.peer_pub: Optional[bytes] = None
        self.peer_hello: Optional[bytes] = None   # full message bytes
        self.peer_h3: Optional[bytes] = None
        self.my_hello: Optional[bytes] = None
        self.my_commit: Optional[bytes] = None
        self.my_dh1: Optional[bytes] = None
        self.my_dh2: Optional[bytes] = None
        self.peer_commit: Optional[bytes] = None
        self.peer_dh1: Optional[bytes] = None
        self.peer_hvi: Optional[bytes] = None
        self.s0: Optional[bytes] = None
        self.sas: Optional[str] = None
        self.on_secrets = None
        self.on_sas = None
        self.on_goclear = None      # fired when the call drops to clear RTP
        self.secrets_ready = False
        self.crc_seconds = 0.0

    # -- wire helpers -----------------------------------------------------
    def _send(self, message: bytes):
        self.seq = (self.seq + 1) & 0xFFFF
        t = time.perf_counter()
        packet = wrap_packet(message, self.seq, self.ssrc)
        self.crc_seconds += time.perf_counter() - t
        self._send_raw(packet)

    # -- message builders ---------------------------------------------------
    def _build_hello(self) -> bytes:
        # §5.2: version | client id | H3 | ZID | flags+counts | algos | MAC
        flags = bytes([0x00, 0x11, 0x11, 0x11])   # 1 hash,cipher,auth,ka,sas
        body = (VERSION + CLIENT_ID + self.h[3] + self.zid + flags
                + ALG_HASH + ALG_CIPHER + ALG_AUTH + ALG_KEYAGR + ALG_SAS)
        msg_wo_mac = make_message(T_HELLO, body + b"\x00" * 8)[:-8]
        return msg_wo_mac + _mac8(self.h[2], msg_wo_mac)

    def _build_dh(self, mtype: bytes) -> bytes:
        # §5.5/§5.6: H1 | rs1ID rs2ID auxID pbxID | pv | MAC (keyed H0)
        rs1 = self.cache.get(self.peer_zid or b"", b"")
        rs1id = hmac.new(rs1 or b"\x00", b"rs1ID",
                         hashlib.sha256).digest()[:8]
        ids = rs1id + b"\x00" * 24               # rs2/aux/pbx: none
        body = self.h[1] + ids + self.pub
        msg_wo_mac = make_message(mtype, body + b"\x00" * 8)[:-8]
        return msg_wo_mac + _mac8(self.h[0], msg_wo_mac)

    def _build_commit(self) -> bytes:
        # §5.4 (DH mode): H2 | ZID | algos | hvi | MAC (keyed H1)
        self.my_dh2 = self._build_dh(T_DH2)
        hvi = hashlib.sha256(self.my_dh2 + (self.peer_hello or b"")).digest()
        body = (self.h[2] + self.zid + ALG_HASH + ALG_CIPHER + ALG_AUTH
                + ALG_KEYAGR + ALG_SAS + hvi)
        msg_wo_mac = make_message(T_COMMIT, body + b"\x00" * 8)[:-8]
        return msg_wo_mac + _mac8(self.h[1], msg_wo_mac)

    def _build_confirm(self, mtype: bytes) -> bytes:
        # §5.7: confirm_mac | CFB IV | E(H0 | flags | cache expiry)
        enc_key, mac_key = self._conf_keys(mine=True)
        plain = self.h[0] + bytes([0, 0, 0, 0]) + struct.pack("!I", 0xFFFFFFFF)
        iv = os.urandom(16)
        ct = openssl.aes128_cfb(enc_key, iv, plain, encrypt=True)
        conf_mac = _mac8(mac_key, ct)
        return make_message(mtype, conf_mac + iv + ct)

    def _conf_keys(self, mine: bool):
        """(zrtpkey, hmac key) for my or the peer's Confirm (§4.5.3)."""
        i_am_init = self.is_initiator
        use_init = i_am_init if mine else (not i_am_init)
        role = b"Initiator" if use_init else b"Responder"
        return (self._keys[role + b" ZRTP key"],
                self._keys[role + b" HMAC key"])

    # -- protocol -----------------------------------------------------------
    def start(self):
        """cf. ms_zrtp channel start: both sides send Hello."""
        self.my_hello = self._build_hello()
        self._send(self.my_hello)
        self.state = "hello_sent"

    def process(self, data: bytes):
        t = time.perf_counter()
        msg = unwrap_packet(data)
        self.crc_seconds += time.perf_counter() - t
        if msg is None:
            return
        t, body = parse_message(msg)
        if t is None:
            return
        if t == T_HELLO:
            if len(body) < 4 + 16 + 32 + 12:
                return
            self.peer_h3 = body[20:52]
            self.peer_zid = body[52:64]
            self.peer_hello = msg
            self._send(make_message(T_HELLO_ACK, b""))
            if self.my_hello is None:
                self.start()
            self._maybe_commit()
        elif t == T_HELLO_ACK:
            self._maybe_commit()
        elif t == T_COMMIT:
            if len(body) < 32 + 12 + 20 + 32 or self.peer_h3 is None:
                return
            h2 = body[:32]
            # hash chain: H3 = H(H2) must match the peer's Hello (§8)
            if hashlib.sha256(h2).digest() != self.peer_h3:
                self.state = "failed"
                return
            # retroactive Hello MAC check now that H2 is known
            if not hmac.compare_digest(
                    _mac8(h2, self.peer_hello[:-8]), self.peer_hello[-8:]):
                self.state = "failed"
                return
            peer_hvi = body[64:96]
            # contention (§4.2): both committed -> larger hvi initiates
            if self.my_commit is not None:
                my_hvi = self.my_commit[12 + 64:12 + 96]
                if my_hvi > peer_hvi:
                    return                      # stay initiator, ignore theirs
                self.is_initiator = False
                self.my_commit = None
            self.peer_commit = msg
            self.peer_hvi = peer_hvi
            # responder sends DHPart1
            dh1 = self._build_dh(T_DH1)
            self._send(dh1)
            self.my_dh1 = dh1
            self.state = "dh1_sent"
        elif t == T_DH1:
            if not self.is_initiator or len(body) < 32 + 32 + 32:
                return
            self.peer_dh1 = msg
            h1 = body[:32]
            self._peer_h1 = h1
            # chain: H2 = H(H1) lets us verify the responder's Hello MAC
            # (the responder never sends a Commit, §8)
            h2 = hashlib.sha256(h1).digest()
            if hashlib.sha256(h2).digest() != self.peer_h3 \
                    or not hmac.compare_digest(
                        _mac8(h2, self.peer_hello[:-8]),
                        self.peer_hello[-8:]):
                self.state = "failed"
                return
            self.peer_pub = body[64:96]
            self._send(self.my_dh2)
            self._derive()
            self.state = "dh2_sent"
        elif t == T_DH2:
            if self.is_initiator or self.peer_commit is None \
                    or len(body) < 96:
                return
            # commitment check (§4.4.1.1): hvi = H(DHPart2 || my Hello)
            if hashlib.sha256(msg + self.my_hello).digest() != self.peer_hvi:
                self.state = "failed"
                return
            h1 = body[:32]
            self._peer_h1 = h1
            # hash chain: H2 = H(H1) must match the Commit
            if hashlib.sha256(h1).digest() != self.peer_commit[12:44]:
                self.state = "failed"
                return
            if not hmac.compare_digest(_mac8(h1, self.peer_commit[:-8]),
                                       self.peer_commit[-8:]):
                self.state = "failed"
                return
            self.peer_pub = body[64:96]
            self._last_peer_dh2 = msg
            self._derive()
            # responder sends Confirm1 (§4.6)
            self._send(self._build_confirm(T_CONF1))
            self.state = "confirm1_sent"
        elif t in (T_CONF1, T_CONF2):
            if self.s0 is None or len(body) < 8 + 16:
                return
            conf_mac, iv, ct = body[:8], body[8:24], body[24:]
            enc_key, mac_key = self._conf_keys(mine=False)
            if not hmac.compare_digest(_mac8(mac_key, ct), conf_mac):
                self.state = "failed"
                return
            plain = openssl.aes128_cfb(enc_key, iv, ct, encrypt=False)
            peer_h0 = plain[:32]
            # full chain check: H1 = H(H0) against the peer's DHPart H1
            if getattr(self, "_peer_h1", None) is not None \
                    and hashlib.sha256(peer_h0).digest() != self._peer_h1:
                self.state = "failed"
                return
            if t == T_CONF1:
                self._send(self._build_confirm(T_CONF2))
                self._finish()
            else:
                self._send(make_message(T_CONF2_ACK, b""))
                self._finish()
        elif t == T_CONF2_ACK:
            self._finish()
        elif t == T_GOCLEAR:
            # RFC 6189 §4.7.2: authenticated downgrade to clear RTP; the
            # clear_hmac (keyed from the shared secret) prevents an
            # attacker from forcing the call off SRTP
            if self.s0 is None or not hmac.compare_digest(
                    body[:8], self._goclear_mac(peer=True)):
                return                           # forged GoClear: ignore
            self._send(make_message(T_CLEAR_ACK, b""))
            self._to_clear()
        elif t == T_CLEAR_ACK:
            if self.state == "clear_sent":
                self._to_clear()

    def _maybe_commit(self):
        if self.state != "hello_sent" or self.peer_zid is None \
                or self.peer_hello is None:
            return
        # both try to initiate; contention resolved on Commit receipt
        self.is_initiator = True
        self.my_commit = self._build_commit()
        self._send(self.my_commit)
        self.state = "commit_sent"

    # -- key derivation (RFC 6189 §4.4) -------------------------------------
    def _derive(self):
        dh = openssl.x25519(self.priv, self.peer_pub)
        zids = (self.zid + self.peer_zid if self.is_initiator
                else self.peer_zid + self.zid)
        rs1 = self.cache.get(self.peer_zid, b"")
        # §4.4.1.4: total_hash = H(responder Hello || Commit || DHPart1 ||
        # DHPart2), full message bytes — both sides hold all four by now
        if self.is_initiator:
            th_parts = (self.peer_hello, self.my_commit,
                        self.peer_dh1, self.my_dh2)
        else:
            th_parts = (self.my_hello, self.peer_commit,
                        self.my_dh1, self._last_peer_dh2)
        total_hash = hashlib.sha256(b"".join(th_parts)).digest()
        s0 = hashlib.sha256(
            struct.pack("!I", 1) + dh + b"ZRTP-HMAC-KDF" + zids + total_hash
            + struct.pack("!I", len(rs1)) + rs1
            + struct.pack("!I", 0) + struct.pack("!I", 0)).digest()
        self.s0 = s0
        ctx = zids + total_hash
        self._keys = {
            b"Initiator SRTP master key":
                _kdf(s0, b"Initiator SRTP master key", ctx, 16),
            b"Initiator SRTP master salt":
                _kdf(s0, b"Initiator SRTP master salt", ctx, 14),
            b"Responder SRTP master key":
                _kdf(s0, b"Responder SRTP master key", ctx, 16),
            b"Responder SRTP master salt":
                _kdf(s0, b"Responder SRTP master salt", ctx, 14),
            b"Initiator ZRTP key": _kdf(s0, b"Initiator ZRTP key", ctx, 16),
            b"Responder ZRTP key": _kdf(s0, b"Responder ZRTP key", ctx, 16),
            b"Initiator HMAC key": _kdf(s0, b"Initiator HMAC key", ctx, 32),
            b"Responder HMAC key": _kdf(s0, b"Responder HMAC key", ctx, 32),
        }
        self.sas = sas_b32(_kdf(s0, b"SAS", ctx, 4))
        # key continuity: retained secret for next call (bzrtp cache role)
        self.cache[self.peer_zid] = _kdf(s0, b"retained secret", ctx, 32)

    def go_clear(self):
        """Initiate the authenticated switch back to clear RTP
        (cf. bzrtp GoClear support referenced from src/crypto/zrtp.c)."""
        if self.state != "secure":
            raise RuntimeError("GoClear only valid from secure state")
        self._send(make_message(T_GOCLEAR, self._goclear_mac()))
        self.state = "clear_sent"

    def _goclear_mac(self, peer: bool = False) -> bytes:
        # §5.11 clear_hmac, keyed with the sender's HMAC key
        use_init = self.is_initiator if not peer else (not self.is_initiator)
        role = b"Initiator" if use_init else b"Responder"
        return _mac8(self._keys[role + b" HMAC key"], b"GoClear ")

    def _to_clear(self):
        self.state = "clear"
        self.secrets_ready = False
        if self.on_goclear:
            self.on_goclear()

    def _finish(self):
        if self.secrets_ready or self.s0 is None:
            return
        self.secrets_ready = True
        self.state = "secure"
        k = self._keys
        if self.is_initiator:
            tx = (k[b"Initiator SRTP master key"],
                  k[b"Initiator SRTP master salt"])
            rx = (k[b"Responder SRTP master key"],
                  k[b"Responder SRTP master salt"])
        else:
            tx = (k[b"Responder SRTP master key"],
                  k[b"Responder SRTP master salt"])
            rx = (k[b"Initiator SRTP master key"],
                  k[b"Initiator SRTP master salt"])
        if self.on_secrets:
            self.on_secrets(tx[0], tx[1], rx[0], rx[1])
        if self.on_sas:
            self.on_sas(self.sas)
