"""SRTP (RFC 3711/6188/7714): CM+HMAC and AEAD-GCM protect/unprotect (port
of ``mediastreamer2_tpu/net/srtp.py``; the reference's src/crypto/ms_srtp.cpp
around libsrtp2).

The same contexts, transports and wire bytes as the JAX package, without
the ``cryptography`` package (the machine with the card does not have it):
AES comes from the port's native library (``native.aes_ecb`` /
``native.aes_gcm``, the crypto layer the batched edge's per-leg SRTP
already uses: AES-NI and PCLMUL where the CPU has them, libcrypto's EVP
otherwise), HMAC-SHA1 from Python's ``hmac`` and ``hashlib``. On top of
them, here: the AES-CM keystream (ECB over counter blocks, as AES-CTR), an
AES-GCM object with ``cryptography``'s ``AESGCM`` interface, and the RFC 3394
key wrap of EKT.

Implements: session key derivation (RFC 3711 §4.3; 96-bit GCM master
salts right-padded per RFC 7714 §11), AES-CM keystream encryption
(§4.1.1) with HMAC-SHA1 authentication over packet||ROC (§4.2),
AEAD_AES_128/256_GCM per RFC 7714 (§8 RTP IV/AAD, §9 RTCP),
AES_256_CM per RFC 6188, ROC/seq tracking with the §3.3.1 index
estimation, replay-window check, SDES inline keys (RFC 4568), double
encryption (wrap the transport twice) and EKT tags (RFC 8870).
"""
from __future__ import annotations

import hmac
import hashlib
import struct
from typing import Dict, Optional, Tuple

from mediastreamer2_tpu_torch import native
from mediastreamer2_tpu_torch.net.rtp import Transport

AES_CM_128_HMAC_SHA1_80 = "AES_CM_128_HMAC_SHA1_80"
AES_CM_128_HMAC_SHA1_32 = "AES_CM_128_HMAC_SHA1_32"
AES_256_CM_HMAC_SHA1_80 = "AES_256_CM_HMAC_SHA1_80"
AES_256_CM_HMAC_SHA1_32 = "AES_256_CM_HMAC_SHA1_32"
AEAD_AES_128_GCM = "AEAD_AES_128_GCM"
AEAD_AES_256_GCM = "AEAD_AES_256_GCM"

#: suite -> (cipher kind, key bytes, master-salt bytes, auth-tag bytes)
SUITES = {
    AES_CM_128_HMAC_SHA1_80: ("ctr", 16, 14, 10),
    AES_CM_128_HMAC_SHA1_32: ("ctr", 16, 14, 4),
    AES_256_CM_HMAC_SHA1_80: ("ctr", 32, 14, 10),   # RFC 6188
    AES_256_CM_HMAC_SHA1_32: ("ctr", 32, 14, 4),
    AEAD_AES_128_GCM: ("gcm", 16, 12, 16),          # RFC 7714
    AEAD_AES_256_GCM: ("gcm", 32, 12, 16),
}
TAG_LEN = {s: p[3] for s, p in SUITES.items()}

LABEL_RTP_ENCRYPTION = 0x00
LABEL_RTP_AUTH = 0x01
LABEL_RTP_SALT = 0x02
LABEL_RTCP_ENCRYPTION = 0x03
LABEL_RTCP_AUTH = 0x04
LABEL_RTCP_SALT = 0x05


class InvalidTag(Exception):
    """An AEAD tag that does not authenticate."""


class InvalidUnwrap(Exception):
    """A wrapped key that fails RFC 3394's integrity check."""


_M128 = (1 << 128) - 1


def _xor(a: bytes, b: bytes) -> bytes:
    """a XOR b over len(a) bytes (b at least as long)."""
    n = len(a)
    return (int.from_bytes(a, "big") ^ int.from_bytes(b[:n], "big")).to_bytes(n, "big")


def _aes_cm_keystream(key: bytes, iv16: bytes, n: int) -> bytes:
    """``n`` bytes of AES-CTR keystream from the 128-bit counter ``iv16``
    (big-endian, incremented per block): ECB over the counter blocks."""
    if n <= 0:
        return b""
    base = int.from_bytes(iv16, "big")
    ctr = b"".join(((base + k) & _M128).to_bytes(16, "big") for k in range((n + 15) // 16))
    return native.aes_ecb(key, ctr)[:n]


class AESGCM:
    """AEAD_AES_{128,256}_GCM with ``cryptography``'s interface: 12-byte
    nonces, ``encrypt`` returns ciphertext||16-byte tag, ``decrypt`` raises
    ``InvalidTag``."""

    def __init__(self, key: bytes):
        if len(key) not in (16, 32):
            raise ValueError("AESGCM key must be 128 or 256 bits")
        self._key = bytes(key)

    def encrypt(self, nonce: bytes, data: bytes, associated_data: bytes) -> bytes:
        ct, tag = native.aes_gcm(self._key, nonce, data, associated_data or b"")
        return ct + tag

    def decrypt(self, nonce: bytes, data: bytes, associated_data: bytes) -> bytes:
        if len(data) < 16:
            raise InvalidTag()
        pt = native.aes_gcm(self._key, nonce, data[:-16], associated_data or b"",
                            tag=data[-16:])
        if pt is None:
            raise InvalidTag()
        return pt


_KW_IV = bytes.fromhex("A6A6A6A6A6A6A6A6")


def aes_key_wrap(wrapping_key: bytes, key_to_wrap: bytes) -> bytes:
    """RFC 3394 AES key wrap (a multiple of 8 bytes, at least 16)."""
    if len(key_to_wrap) < 16 or len(key_to_wrap) % 8:
        raise ValueError("the key to wrap must be a multiple of 8 bytes, at least 16")
    r = [key_to_wrap[i:i + 8] for i in range(0, len(key_to_wrap), 8)]
    n, a = len(r), _KW_IV
    for j in range(6):
        for i in range(n):
            b = native.aes_ecb(wrapping_key, a + r[i])
            a = (int.from_bytes(b[:8], "big") ^ (n * j + i + 1)).to_bytes(8, "big")
            r[i] = b[8:]
    return a + b"".join(r)


def aes_key_unwrap(wrapping_key: bytes, wrapped_key: bytes) -> bytes:
    """RFC 3394 AES key unwrap; raises ``InvalidUnwrap``."""
    if len(wrapped_key) < 24 or len(wrapped_key) % 8:
        raise InvalidUnwrap("the wrapped key must be a multiple of 8 bytes, at least 24")
    a = wrapped_key[:8]
    r = [wrapped_key[i:i + 8] for i in range(8, len(wrapped_key), 8)]
    n = len(r)
    for j in range(5, -1, -1):
        for i in range(n - 1, -1, -1):
            at = (int.from_bytes(a, "big") ^ (n * j + i + 1)).to_bytes(8, "big")
            b = native.aes_ecb(wrapping_key, at + r[i], decrypt=True)
            a, r[i] = b[:8], b[8:]
    if not hmac.compare_digest(a, _KW_IV):
        raise InvalidUnwrap()
    return b"".join(r)


def _rtp_header_len(packet: bytes) -> int:
    """Unencrypted-portion length: 12 + CSRCs + header extension if X set.

    RFC 3711 §3.1 — the extension header is NOT part of the Encrypted
    Portion; skipping it keeps interop with compliant stacks.
    """
    n = 12 + 4 * (packet[0] & 0x0F)
    if (packet[0] >> 4) & 1 and len(packet) >= n + 4:
        ext_words = struct.unpack("!H", packet[n + 2:n + 4])[0]
        n += 4 + 4 * ext_words
    return min(n, len(packet))


def derive_key(master_key: bytes, master_salt: bytes, label: int,
               length: int) -> bytes:
    """RFC 3711 §4.3.1 key derivation (KDR=0).

    96-bit (GCM) master salts are right-padded to 112 bits before the
    XOR, per RFC 7714 §11."""
    salt = master_salt.ljust(14, b"\x00")
    x = int.from_bytes(salt, "big") ^ (label << 48)
    iv = (x << 16).to_bytes(16, "big")
    return _aes_cm_keystream(master_key, iv, length)


class SrtpContext:
    """One direction (tx or rx) of one SSRC-agnostic session."""

    def __init__(self, master_key: bytes, master_salt: bytes,
                 suite: str = AES_CM_128_HMAC_SHA1_80):
        kind, klen, slen, _tag = SUITES[suite]
        assert len(master_key) == klen and len(master_salt) == slen, \
            f"{suite}: need {klen}B key + {slen}B salt"
        self.suite = suite
        self.kind = kind
        self.k_e = derive_key(master_key, master_salt, LABEL_RTP_ENCRYPTION, klen)
        self.k_a = derive_key(master_key, master_salt, LABEL_RTP_AUTH, 20)
        self.k_s = derive_key(master_key, master_salt, LABEL_RTP_SALT, slen)
        self._gcm = AESGCM(self.k_e) if kind == "gcm" else None
        self.roc: Dict[int, int] = {}            # ssrc -> rollover counter
        self.last_seq: Dict[int, int] = {}
        self.replay: Dict[int, set] = {}

    # -- packet index (RFC 3711 §3.3.1) -----------------------------------
    def _estimate_index(self, ssrc: int, seq: int) -> Tuple[int, int]:
        roc = self.roc.get(ssrc, 0)
        s_l = self.last_seq.get(ssrc)
        if s_l is None:
            return roc, seq
        if s_l < 32768:
            if seq - s_l > 32768:
                v = roc - 1
            else:
                v = roc
        else:
            if s_l - seq > 32768:
                v = roc + 1
            else:
                v = roc
        return max(v, 0), seq

    def _keystream_iv(self, ssrc: int, index: int) -> bytes:
        x = (int.from_bytes(self.k_s, "big") << 16) ^ (ssrc << 64) ^ (index << 16)
        return (x & ((1 << 128) - 1)).to_bytes(16, "big")

    def _auth(self, data: bytes, roc: int) -> bytes:
        mac = hmac.new(self.k_a, data + struct.pack("!I", roc),
                       hashlib.sha1).digest()
        return mac[: TAG_LEN[self.suite]]

    def _gcm_iv(self, ssrc: int, roc: int, seq: int) -> bytes:
        """RFC 7714 §8.1: 12-byte IV = (00 00||SSRC||ROC||SEQ) XOR salt."""
        x = (ssrc << 48) | (roc << 16) | seq
        return (x ^ int.from_bytes(self.k_s, "big")).to_bytes(12, "big")

    # -- protect / unprotect ------------------------------------------------
    def protect(self, packet: bytes) -> bytes:
        hdr_len = _rtp_header_len(packet)
        ssrc, seq = struct.unpack("!I", packet[8:12])[0], \
            struct.unpack("!H", packet[2:4])[0]
        roc = self.roc.get(ssrc, 0)
        s_l = self.last_seq.get(ssrc)
        if s_l is not None and seq < s_l and s_l - seq > 32768:
            roc += 1
            self.roc[ssrc] = roc
        self.last_seq[ssrc] = seq
        index = (roc << 16) | seq
        if self._gcm is not None:
            # RFC 7714 §8: AAD = unencrypted portion; ct||tag replaces payload
            ct = self._gcm.encrypt(self._gcm_iv(ssrc, roc, seq),
                                   packet[hdr_len:], packet[:hdr_len])
            return packet[:hdr_len] + ct
        iv = self._keystream_iv(ssrc, index)
        ks = _aes_cm_keystream(self.k_e, iv, len(packet) - hdr_len)
        payload = _xor(packet[hdr_len:], ks)
        out = packet[:hdr_len] + payload
        return out + self._auth(out, roc)

    def _gcm_open(self, data: bytes, hdr_len: int, ssrc: int, roc: int,
                  seq: int) -> Optional[bytes]:
        try:
            pt = self._gcm.decrypt(self._gcm_iv(ssrc, roc, seq),
                                   data[hdr_len:], data[:hdr_len])
            return data[:hdr_len] + pt
        except InvalidTag:
            return None

    def unprotect(self, packet: bytes) -> Optional[bytes]:
        tag_len = TAG_LEN[self.suite]
        if len(packet) < 12 + tag_len:
            return None
        if self._gcm is not None:
            data = packet                       # tag lives inside the AEAD ct
        else:
            data, tag = packet[:-tag_len], packet[-tag_len:]
        hdr_len = _rtp_header_len(data)
        if len(data) < hdr_len + (tag_len if self._gcm is not None else 0):
            return None
        ssrc = struct.unpack("!I", data[8:12])[0]
        seq = struct.unpack("!H", data[2:4])[0]
        roc, _ = self._estimate_index(ssrc, seq)
        plain: Optional[bytes] = None
        if self._gcm is not None:
            plain = self._gcm_open(data, hdr_len, ssrc, roc, seq)
            if plain is None:
                for r in (roc + 1, max(roc - 1, 0)):
                    plain = self._gcm_open(data, hdr_len, ssrc, r, seq)
                    if plain is not None:
                        roc = r
                        break
                else:
                    return None                 # auth failure
        elif not hmac.compare_digest(self._auth(data, roc), tag):
            # try adjacent ROCs (resync after long loss)
            for r in (roc + 1, max(roc - 1, 0)):
                if hmac.compare_digest(self._auth(data, r), tag):
                    roc = r
                    break
            else:
                return None                     # auth failure
        index = (roc << 16) | seq
        win = self.replay.setdefault(ssrc, set())
        if index in win:
            return None                         # replay
        win.add(index)
        if len(win) > 1024:
            for old in sorted(win)[:512]:
                win.discard(old)
        s_l = self.last_seq.get(ssrc)
        if s_l is None or seq > s_l or s_l - seq > 32768:
            self.last_seq[ssrc] = seq
            self.roc[ssrc] = roc
        if plain is not None:
            return plain
        iv = self._keystream_iv(ssrc, index)
        ks = _aes_cm_keystream(self.k_e, iv, len(data) - hdr_len)
        payload = _xor(data[hdr_len:], ks)
        return data[:hdr_len] + payload


def sdes_generate(suite: str = AES_CM_128_HMAC_SHA1_80) -> Tuple[str, bytes, bytes]:
    """Generate an SDES a=crypto inline key (RFC 4568).

    Returns (crypto_line_suffix, master_key, master_salt)."""
    import base64
    import os as _os
    _kind, klen, slen, _tag = SUITES[suite]
    key = _os.urandom(klen)
    salt = _os.urandom(slen)
    inline = base64.b64encode(key + salt).decode()
    return f"{suite} inline:{inline}", key, salt


def sdes_parse(crypto_attr: str) -> Tuple[str, bytes, bytes]:
    """Parse '<suite> inline:<b64>' (leading RFC 4568 tag stripped)."""
    import base64
    parts = crypto_attr.strip().split()
    if parts and parts[0].isdigit():
        parts = parts[1:]                 # leading tag
    suite = parts[0]
    if suite not in SUITES:
        raise ValueError(f"unsupported crypto suite {suite}")
    _kind, klen, slen, _tag = SUITES[suite]
    inline = next(p for p in parts[1:] if p.startswith("inline:"))
    km = base64.b64decode(inline[len("inline:"):].split("|")[0])
    if len(km) != klen + slen:
        raise ValueError("bad SDES key length")
    return suite, km[:klen], km[klen:klen + slen]


class SrtcpContext:
    """SRTCP (RFC 3711 §3.4): E-bit + 31-bit index trailer, own KDF labels."""

    def __init__(self, master_key: bytes, master_salt: bytes,
                 suite: str = AES_CM_128_HMAC_SHA1_80):
        kind, klen, slen, _tag = SUITES[suite]
        self.suite = suite
        self.kind = kind
        self.k_e = derive_key(master_key, master_salt, LABEL_RTCP_ENCRYPTION, klen)
        self.k_a = derive_key(master_key, master_salt, LABEL_RTCP_AUTH, 20)
        self.k_s = derive_key(master_key, master_salt, LABEL_RTCP_SALT, slen)
        self._gcm = AESGCM(self.k_e) if kind == "gcm" else None
        self.tx_index = 0
        self.replay: set = set()
        self._replay_max = -1            # highest index seen (window anchor)
        self.REPLAY_WINDOW = 1024

    def _iv(self, ssrc: int, index: int) -> bytes:
        x = (int.from_bytes(self.k_s, "big") << 16) ^ (ssrc << 64) ^ (index << 16)
        return (x & ((1 << 128) - 1)).to_bytes(16, "big")

    def _replay_ok(self, index: int) -> bool:
        # bounded sliding window (like the RTP side): anything older than the
        # window is rejected outright, so pruning never re-admits a replay,
        # and a long-lived call holds at most REPLAY_WINDOW entries.
        if index <= self._replay_max - self.REPLAY_WINDOW:
            return False
        if index in self.replay:
            return False
        self.replay.add(index)
        if index > self._replay_max:
            self._replay_max = index
            floor = self._replay_max - self.REPLAY_WINDOW
            if len(self.replay) > self.REPLAY_WINDOW:
                self.replay = {i for i in self.replay if i > floor}
        return True

    def _gcm_iv(self, ssrc: int, index: int) -> bytes:
        """RFC 7714 §9.1: 12-byte IV = (00 00||SSRC||00 00||index) XOR salt."""
        x = (ssrc << 48) | index
        return (x ^ int.from_bytes(self.k_s, "big")).to_bytes(12, "big")

    def protect(self, packet: bytes) -> bytes:
        if len(packet) < 8:
            return packet
        ssrc = struct.unpack("!I", packet[4:8])[0]
        index = self.tx_index
        self.tx_index = (self.tx_index + 1) & 0x7FFFFFFF
        trailer = struct.pack("!I", 0x80000000 | index)     # E-bit set
        if self._gcm is not None:
            # RFC 7714 §9.2: AAD = RTCP header(8) || E+index word
            ct = self._gcm.encrypt(self._gcm_iv(ssrc, index),
                                   packet[8:], packet[:8] + trailer)
            return packet[:8] + ct + trailer
        ks = _aes_cm_keystream(self.k_e, self._iv(ssrc, index),
                               len(packet) - 8)
        body = packet[:8] + _xor(packet[8:], ks)
        tag = hmac.new(self.k_a, body + trailer,
                       hashlib.sha1).digest()[: TAG_LEN[self.suite]]
        return body + trailer + tag

    def unprotect(self, packet: bytes) -> Optional[bytes]:
        tag_len = TAG_LEN[self.suite]
        if self._gcm is not None:
            # layout: header(8) || ct+tag || E+index(4)
            if len(packet) < 8 + tag_len + 4:
                return None
            trailer = packet[-4:]
            body = packet[:-4]
            word = struct.unpack("!I", trailer)[0]
            index = word & 0x7FFFFFFF
            if not (word & 0x80000000):          # we always encrypt on tx
                return None
            ssrc = struct.unpack("!I", body[4:8])[0]
            try:
                pt = self._gcm.decrypt(self._gcm_iv(ssrc, index),
                                       body[8:], body[:8] + trailer)
            except InvalidTag:
                return None
            if not self._replay_ok(index):
                return None
            return body[:8] + pt
        if len(packet) < 8 + 4 + tag_len:
            return None
        tag = packet[-tag_len:]
        trailer = packet[-tag_len - 4: -tag_len]
        body = packet[: -tag_len - 4]
        mac = hmac.new(self.k_a, body + trailer,
                       hashlib.sha1).digest()[:tag_len]
        if not hmac.compare_digest(mac, tag):
            return None
        word = struct.unpack("!I", trailer)[0]
        index = word & 0x7FFFFFFF
        if not self._replay_ok(index):
            return None
        if not (word & 0x80000000):          # E-bit clear: unencrypted
            return body
        ssrc = struct.unpack("!I", body[4:8])[0]
        ks = _aes_cm_keystream(self.k_e, self._iv(ssrc, index),
                               len(body) - 8)
        return body[:8] + _xor(body[8:], ks)


class SrtpTransport(Transport):
    """Transport wrapper: protect on send, unprotect on recv
    (the modifier-pair layering of ms_srtp.cpp:1004-1019; stack two for
    double encryption). RTCP on the same transport is protected as SRTCP
    when rtcp contexts are supplied."""

    # marks this transport as satisfying encryption-mandatory mode
    # (RtpSession._cleartext_blocked duck-types on this attribute)
    encrypting = True

    def __init__(self, inner: Transport, tx: SrtpContext, rx: SrtpContext,
                 tx_rtcp: Optional[SrtcpContext] = None,
                 rx_rtcp: Optional[SrtcpContext] = None):
        self.inner = inner
        self.tx = tx
        self.rx = rx
        self.tx_rtcp = tx_rtcp
        self.rx_rtcp = rx_rtcp
        self.auth_failures = 0

    @staticmethod
    def _is_rtcp(data: bytes) -> bool:
        return len(data) >= 2 and 200 <= data[1] <= 207

    def send(self, data: bytes):
        if self._is_rtcp(data):
            self.inner.send(self.tx_rtcp.protect(data)
                            if self.tx_rtcp else data)
            return
        self.inner.send(self.tx.protect(data))

    def recv_all(self):
        out = []
        for data in self.inner.recv_all():
            if self._is_rtcp(data):
                if self.rx_rtcp is not None:
                    plain = self.rx_rtcp.unprotect(data)
                    if plain is None:
                        self.auth_failures += 1
                    else:
                        out.append(plain)
                else:
                    out.append(data)
                continue
            plain = self.rx.unprotect(data)
            if plain is None:
                self.auth_failures += 1
            else:
                out.append(plain)
        return out

    def close(self):
        self.inner.close()


# ------------------------------------------------------------------ EKT
# Encrypted Key Transport (RFC 8870), the reference's mechanism for
# carrying the INNER SRTP master key inside the (outer-protected) packets
# of a relayed double-encrypted conference (ms_srtp.cpp:53-56 msg types,
# :395-460 tag construction): a relay or late joiner holding only the EKT
# key learns each sender's inner key from the first full tag it sees.
EKT_MSG_SHORT = 0x00
EKT_MSG_FULL = 0x02


def _ekt_full_tag(ekt_key: bytes, master_key: bytes, ssrc: int, roc: int,
                  spi: int, epoch: int = 0) -> bytes:
    """FullEKTField: AESKW(keylen|key|ssrc|roc) || SPI || Epoch || Len || 0x02
    (exactly ms_srtp.cpp:414-450)."""
    plain = bytes([len(master_key)]) + master_key \
        + struct.pack("!II", ssrc, roc)
    if len(plain) % 8:
        plain += b"\x00" * (8 - len(plain) % 8)      # KW needs 8-byte blocks
    ct = aes_key_wrap(ekt_key, plain)
    size = len(ct) + 7            # + SPI(2) Epoch(2) Length(2) MsgType(1)
    return ct + struct.pack("!HHH", spi, epoch, size) + bytes([EKT_MSG_FULL])


def _ekt_parse_tag(packet: bytes, keys: Dict[int, bytes]):
    """-> (packet_without_tag, None | (spi, master_key, ssrc, roc)).
    `keys` maps SPI -> EKT key (the receiver's SPI pool)."""
    if not packet:
        return packet, None
    msg = packet[-1]
    if msg == EKT_MSG_SHORT:
        return packet[:-1], None
    if msg != EKT_MSG_FULL or len(packet) < 8:
        return packet, None                        # no EKT field
    size = struct.unpack("!H", packet[-3:-1])[0]
    if size > len(packet):
        return packet, None
    tag = packet[-size:]
    spi, epoch = struct.unpack("!HH", tag[-7:-3])
    key = keys.get(spi)
    if key is None:
        return packet[:-size], None                # unknown SPI: drop tag
    try:
        plain = aes_key_unwrap(key, tag[:-7])
    except (InvalidUnwrap, ValueError):
        return packet[:-size], None
    klen = plain[0]
    if 1 + klen + 8 > len(plain):
        return packet[:-size], None
    mkey = plain[1:1 + klen]
    ssrc, roc = struct.unpack("!II", plain[1 + klen:9 + klen])
    return packet[:-size], (spi, mkey, ssrc, roc)


class EktTransport(Transport):
    """Transport layer between the inner and outer SRTP wrappers of a
    double-encrypted relayed stream: appends EKT tags on send (full tag on
    first packet / ROC change / every `full_period` packets, short tag
    otherwise) and strips them on receive, announcing learned inner keys
    via `on_key(ssrc, master_key, roc)`."""

    def __init__(self, inner: Transport, ekt_key: bytes = None,
                 spi: int = 0, send_master_key: bytes = None,
                 recv_keys: Optional[Dict[int, bytes]] = None,
                 on_key=None, full_period: int = 50,
                 initial_roc: int = 0):
        """initial_roc seeds the advertised rollover counter for streams
        that started before this transport existed — the tester's 'ekt,
        skip initial ROC' case: a late joiner must learn a non-zero ROC
        from the tag or every inner auth fails."""
        self.inner = inner
        self.ekt_key = ekt_key
        self.spi = spi
        self.send_master_key = send_master_key
        self.recv_keys = dict(recv_keys or {})
        if ekt_key is not None and spi not in self.recv_keys:
            self.recv_keys[self.spi] = ekt_key
        self.on_key = on_key
        self.full_period = full_period
        self.initial_roc = initial_roc
        self._sent: Dict[int, int] = {}            # ssrc -> packets since full
        self._tag_cache: Dict[int, tuple] = {}     # ssrc -> (roc, tag)
        self._last_seq: Dict[int, int] = {}        # ssrc -> last sent seq
        self.learned: Dict[int, tuple] = {}        # ssrc -> (key, roc)

    @staticmethod
    def _is_rtcp(data: bytes) -> bool:
        return len(data) >= 2 and 200 <= data[1] <= 207

    def send(self, data: bytes):
        if self._is_rtcp(data) or self.send_master_key is None \
                or len(data) < 12:
            self.inner.send(data)
            return
        ssrc = struct.unpack("!I", data[8:12])[0]
        seq = struct.unpack("!H", data[2:4])[0]
        n = self._sent.get(ssrc, 0)
        cached = self._tag_cache.get(ssrc)
        roc = self.initial_roc if cached is None else cached[0]
        # seq rollover: the inner context's ROC just incremented, and the
        # tag must advertise the new value immediately (full tag forced)
        last = self._last_seq.get(ssrc)
        rolled = last is not None and last > 0xF000 and seq < 0x1000
        if rolled:
            roc += 1
        self._last_seq[ssrc] = seq
        if cached is None or rolled or n >= self.full_period:
            tag = _ekt_full_tag(self.ekt_key, self.send_master_key, ssrc,
                                roc, self.spi)
            self._tag_cache[ssrc] = (roc, tag)
            self._sent[ssrc] = 0
            self.inner.send(data + tag)
        else:
            self._tag_cache[ssrc] = (roc, cached[1])
            self._sent[ssrc] = n + 1
            self.inner.send(data + bytes([EKT_MSG_SHORT]))

    def recv_all(self):
        out = []
        for data in self.inner.recv_all():
            if self._is_rtcp(data):
                out.append(data)
                continue
            stripped, info = _ekt_parse_tag(data, self.recv_keys)
            if info is not None:
                _spi, mkey, ssrc, roc = info
                if self.learned.get(ssrc, (None,))[0] != mkey:
                    self.learned[ssrc] = (mkey, roc)
                    if self.on_key is not None:
                        self.on_key(ssrc, mkey, roc)
            out.append(stripped)
        return out

    def close(self):
        self.inner.close()
