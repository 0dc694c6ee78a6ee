"""DTLS-SRTP (RFC 5764) — handshake over the RTP path, SRTP key export (port
of ``mediastreamer2_tpu/net/dtls.py``: OpenSSL through ctypes, loaded by
``net/openssl.py``).

Reference: src/crypto/dtls_srtp.cpp (882 LoC on mbedtls via bctoolbox):
DTLS multiplexed with RTP on the same socket via transport modifiers, SRTP
keys exported from the handshake (:76-89, 244-255, 362-386), role
auto-detection, packet buffering queues.

Implementation: OpenSSL's libssl via ctypes with **memory BIOs** — the
framework owns the socket, so DTLS records are shuttled between OpenSSL and
the Transport by hand (exactly the transport-modifier layering of the
reference).  `use_srtp` negotiates SRTP_AEAD_AES_128_GCM or
SRTP_AES128_CM_SHA1_80 and `SSL_export_keying_material("EXTRACTOR-dtls_srtp")`
derives the SRTP client/server key+salt pairs per RFC 5764 §4.2.

The certificate is the JAX module's (a self-signed EC P-256 key, CN
``mediastreamer2_tpu``, serial 1, a year's validity, signed with
ECDSA-SHA256). Unlike the JAX module, ``close()`` frees the SSL objects,
key and certificate.
"""
from __future__ import annotations

import ctypes
import hashlib
from typing import List, Optional, Tuple

from mediastreamer2_tpu_torch.net import openssl


def dtls_available() -> bool:
    return openssl.libssl() is not None


SSL_ERROR_WANT_READ = 2
#: default offer: AEAD-GCM preferred, classic CM as fallback
#: (mirrors ms_srtp.cpp supporting both suite families)
SRTP_PROFILE = b"SRTP_AEAD_AES_128_GCM:SRTP_AES128_CM_SHA1_80"
EXTRACTOR = b"EXTRACTOR-dtls_srtp"
SSL_VERIFY_PEER = 1
SSL_VERIFY_FAIL_IF_NO_PEER_CERT = 2

#: RFC 5764/7714 use_srtp profile name -> SDES suite name + key/salt bytes
PROFILE_SUITES = {
    "SRTP_AES128_CM_SHA1_80": ("AES_CM_128_HMAC_SHA1_80", 16, 14),
    "SRTP_AES128_CM_SHA1_32": ("AES_CM_128_HMAC_SHA1_32", 16, 14),
    "SRTP_AEAD_AES_128_GCM": ("AEAD_AES_128_GCM", 16, 12),
    "SRTP_AEAD_AES_256_GCM": ("AEAD_AES_256_GCM", 32, 12),
}


# Accept any (self-signed) certificate at the TLS layer; the caller
# (CallSetup) MUST verify peer_fingerprint() against the SDP a=fingerprint
# after the handshake — that comparison, not X.509 chain validation, is the
# RFC 5763 trust model the reference uses (dtls_srtp.cpp fingerprint check).
_accept_any = openssl.VERIFY_CALLBACK(lambda ok, store: 1)


def _make_self_signed():
    """Self-signed EC cert+key (the reference generates one per device)."""
    c = openssl.require_libcrypto()
    pkey = c.EVP_PKEY_Q_keygen(None, None, b"EC", b"P-256")
    if not pkey:
        raise RuntimeError("libcrypto could not make a P-256 key")
    x509 = c.X509_new()
    c.X509_set_version(x509, 2)
    c.ASN1_INTEGER_set(c.X509_get_serialNumber(x509), 1)
    c.X509_gmtime_adj(c.X509_getm_notBefore(x509), 0)
    c.X509_gmtime_adj(c.X509_getm_notAfter(x509), 365 * 24 * 3600)
    name = c.X509_get_subject_name(x509)
    c.X509_NAME_add_entry_by_txt(name, b"CN", 0x1000 | 1,   # MBSTRING_UTF8
                                 b"mediastreamer2_tpu", -1, -1, 0)
    c.X509_set_issuer_name(x509, name)
    c.X509_set_pubkey(x509, pkey)
    if c.X509_sign(x509, pkey, c.EVP_sha256()) <= 0:
        c.X509_free(x509)
        c.EVP_PKEY_free(pkey)
        raise RuntimeError("libcrypto could not sign the certificate")
    return x509, pkey


class DtlsSrtpSession:
    """One endpoint of a DTLS-SRTP handshake over memory BIOs.

    Drive with: feed inbound DTLS records via `put_packet`, send the records
    `pop_packets` returns, call `handshake_step` until `is_established`;
    then `export_srtp_keys(is_client)` yields (tx_key, tx_salt, rx_key,
    rx_salt) for SrtpContext.
    """

    def __init__(self, is_server: bool):
        s = openssl.require_libssl()
        c = openssl.require_libcrypto()
        self._ssl_lib, self._crypto = s, c
        self.is_server = is_server
        self.ctx = s.SSL_CTX_new(s.DTLS_method())
        self.x509, self.pkey = _make_self_signed()
        self.ssl = None
        s.SSL_CTX_use_certificate(self.ctx, self.x509)
        s.SSL_CTX_use_PrivateKey(self.ctx, self.pkey)
        if s.SSL_CTX_set_tlsext_use_srtp(self.ctx, SRTP_PROFILE) != 0:
            self.close()
            raise RuntimeError("use_srtp failed")
        s.SSL_CTX_set_verify(self.ctx, SSL_VERIFY_PEER, _accept_any)
        self.ssl = s.SSL_new(self.ctx)
        self.rbio = c.BIO_new(c.BIO_s_mem())
        self.wbio = c.BIO_new(c.BIO_s_mem())
        s.SSL_set_bio(self.ssl, self.rbio, self.wbio)   # the SSL owns both
        if is_server:
            s.SSL_set_accept_state(self.ssl)
        else:
            s.SSL_set_connect_state(self.ssl)
        self.established = False
        self._buf = ctypes.create_string_buffer(4096)

    def close(self):
        """Free the SSL (and its BIOs), its context, key and certificate."""
        if self.ssl:
            self._ssl_lib.SSL_free(self.ssl)
            self.ssl = None
        if self.ctx:
            self._ssl_lib.SSL_CTX_free(self.ctx)
            self.ctx = None
        if self.x509:
            self._crypto.X509_free(self.x509)
            self._crypto.EVP_PKEY_free(self.pkey)
            self.x509 = self.pkey = None

    # -- record shuttling --------------------------------------------------
    def put_packet(self, data: bytes):
        self._crypto.BIO_write(self.rbio, data, len(data))

    def pop_packets(self) -> List[bytes]:
        out = []
        while True:
            n = self._crypto.BIO_read(self.wbio, self._buf, len(self._buf))
            if n <= 0:
                break
            out.append(self._buf.raw[:n])
        return out

    def handshake_step(self) -> bool:
        r = self._ssl_lib.SSL_do_handshake(self.ssl)
        if r == 1:
            self.established = True
        return self.established

    @property
    def is_established(self) -> bool:
        return self.established

    # -- SRTP key export (RFC 5764 §4.2) -------------------------------------
    def selected_srtp_profile(self) -> str:
        """Name of the negotiated use_srtp protection profile."""
        p = self._ssl_lib.SSL_get_selected_srtp_profile(self.ssl)
        if not p:
            raise RuntimeError("no srtp profile negotiated")
        return p.contents.name.decode()

    def srtp_suite(self) -> str:
        """SDES-style suite name for SrtpContext/SrtcpContext."""
        return PROFILE_SUITES[self.selected_srtp_profile()][0]

    def export_srtp_keys(self) -> Tuple[bytes, bytes, bytes, bytes]:
        """Returns (client_key, client_salt, server_key, server_salt),
        sized for the negotiated profile (RFC 5764 §4.2 layout)."""
        _suite, klen, slen = PROFILE_SUITES[self.selected_srtp_profile()]
        total = 2 * (klen + slen)
        buf = ctypes.create_string_buffer(total)
        r = self._ssl_lib.SSL_export_keying_material(
            self.ssl, buf, total, EXTRACTOR, len(EXTRACTOR), None, 0, 0)
        if r != 1:
            raise RuntimeError("export_keying_material failed")
        km = buf.raw
        ck, sk = km[0:klen], km[klen:2 * klen]
        cs = km[2 * klen:2 * klen + slen]
        ss = km[2 * klen + slen:2 * klen + 2 * slen]
        return ck, cs, sk, ss

    def local_fingerprint(self) -> str:
        """SHA-256 fingerprint of our cert for the SDP a=fingerprint line."""
        return _cert_fingerprint(self._ssl_lib.SSL_get_certificate(self.ssl))

    def peer_fingerprint(self) -> Optional[str]:
        cert = self._ssl_lib.SSL_get1_peer_certificate(self.ssl)
        if not cert:
            return None
        try:
            return _cert_fingerprint(cert)
        finally:
            self._crypto.X509_free(cert)


def _cert_fingerprint(cert) -> str:
    c = openssl.require_libcrypto()
    buf = ctypes.create_string_buffer(8192)
    pp = ctypes.c_void_p(ctypes.addressof(buf))
    n = c.i2d_X509(cert, ctypes.byref(pp))
    der = buf.raw[:n]
    h = hashlib.sha256(der).hexdigest().upper()
    return ":".join(h[i:i + 2] for i in range(0, len(h), 2))


def is_dtls(data: bytes) -> bool:
    """RFC 5764 §5.1.2 demux: DTLS record content types 20..63."""
    return len(data) >= 1 and 20 <= data[0] <= 63
