"""The system's OpenSSL through ctypes: one loader for libcrypto and libssl,
shared by ``net/dtls.py`` (DTLS-SRTP over libssl) and ``net/zrtp.py``
(X25519 and AES-CFB128 from libcrypto's EVP, in place of the
``cryptography`` package that the JAX package's ZRTP imports and the
machine with the card does not have).

The libraries are looked up on first use, never when the module is
imported. The calls are OpenSSL 3's (``EVP_PKEY_Q_keygen``,
``SSL_get1_peer_certificate``), as the JAX module's are. Where a
library is missing, ``libcrypto()`` / ``libssl()`` return None and
``require_libcrypto`` / ``require_libssl`` raise ``RuntimeError`` naming it:
no pure-Python fallback runs in its place.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Optional

_P = ctypes.c_void_p
_I = ctypes.c_int
_S = ctypes.c_size_t
_B = ctypes.c_char_p

EVP_PKEY_X25519 = 1034              # NID_X25519

_CRYPTO_SIGNATURES = {
    "OpenSSL_version": (_B, [_I]),
    # EVP_PKEY: X25519 raw keys and derivation, the certificates' EC key
    # (EVP_PKEY_Q_keygen is variadic: its fourth argument is the curve's name)
    "EVP_PKEY_Q_keygen": (_P, [_P, _B, _B, _B]),
    "EVP_PKEY_new_raw_private_key": (_P, [_I, _P, _B, _S]),
    "EVP_PKEY_new_raw_public_key": (_P, [_I, _P, _B, _S]),
    "EVP_PKEY_get_raw_public_key": (_I, [_P, _B, ctypes.POINTER(_S)]),
    "EVP_PKEY_CTX_new": (_P, [_P, _P]),
    "EVP_PKEY_CTX_free": (None, [_P]),
    "EVP_PKEY_derive_init": (_I, [_P]),
    "EVP_PKEY_derive_set_peer": (_I, [_P, _P]),
    "EVP_PKEY_derive": (_I, [_P, _B, ctypes.POINTER(_S)]),
    "EVP_PKEY_free": (None, [_P]),
    # symmetric ciphers
    "EVP_aes_128_cfb128": (_P, []),
    "EVP_CIPHER_CTX_new": (_P, []),
    "EVP_CIPHER_CTX_free": (None, [_P]),
    "EVP_CipherInit_ex": (_I, [_P, _P, _P, _B, _B, _I]),
    "EVP_CipherUpdate": (_I, [_P, _B, ctypes.POINTER(_I), _B, _I]),
    "EVP_CipherFinal_ex": (_I, [_P, _B, ctypes.POINTER(_I)]),
    "EVP_sha256": (_P, []),
    # X.509 certificates
    "X509_new": (_P, []),
    "X509_free": (None, [_P]),
    "X509_set_version": (_I, [_P, ctypes.c_long]),
    "X509_get_serialNumber": (_P, [_P]),
    "ASN1_INTEGER_set": (_I, [_P, ctypes.c_long]),
    "X509_getm_notBefore": (_P, [_P]),
    "X509_getm_notAfter": (_P, [_P]),
    "X509_gmtime_adj": (_P, [_P, ctypes.c_long]),
    "X509_get_subject_name": (_P, [_P]),
    "X509_NAME_add_entry_by_txt": (_I, [_P, _B, _I, _B, _I, _I, _I]),
    "X509_set_issuer_name": (_I, [_P, _P]),
    "X509_set_pubkey": (_I, [_P, _P]),
    "X509_sign": (_I, [_P, _P, _P]),
    "i2d_X509": (_I, [_P, ctypes.POINTER(_P)]),
    # memory BIOs
    "BIO_s_mem": (_P, []),
    "BIO_new": (_P, [_P]),
    "BIO_write": (_I, [_P, _B, _I]),
    "BIO_read": (_I, [_P, _B, _I]),
}

VERIFY_CALLBACK = ctypes.CFUNCTYPE(_I, _I, _P)


class SrtpProtectionProfile(ctypes.Structure):
    _fields_ = [("name", ctypes.c_char_p), ("id", ctypes.c_ulong)]


_SSL_SIGNATURES = {
    "DTLS_method": (_P, []),
    "SSL_CTX_new": (_P, [_P]),
    "SSL_CTX_free": (None, [_P]),
    "SSL_CTX_use_certificate": (_I, [_P, _P]),
    "SSL_CTX_use_PrivateKey": (_I, [_P, _P]),
    "SSL_CTX_set_tlsext_use_srtp": (_I, [_P, _B]),
    "SSL_CTX_set_verify": (None, [_P, _I, VERIFY_CALLBACK]),
    "SSL_new": (_P, [_P]),
    "SSL_free": (None, [_P]),
    "SSL_set_bio": (None, [_P, _P, _P]),
    "SSL_set_accept_state": (None, [_P]),
    "SSL_set_connect_state": (None, [_P]),
    "SSL_do_handshake": (_I, [_P]),
    "SSL_export_keying_material": (_I, [_P, _B, _S, _B, _S, _B, _S, _I]),
    "SSL_get_certificate": (_P, [_P]),
    "SSL_get1_peer_certificate": (_P, [_P]),
    "SSL_get_selected_srtp_profile": (ctypes.POINTER(SrtpProtectionProfile), [_P]),
}


def _bind(lib, signatures):
    for name, (res, args) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


@functools.lru_cache(maxsize=None)
def libcrypto() -> Optional[ctypes.CDLL]:
    """The system's libcrypto with every function used here declared, or
    None when there is none (or it lacks one of them)."""
    path = ctypes.util.find_library("crypto")
    if not path:
        return None
    try:
        lib = ctypes.CDLL(path, mode=ctypes.RTLD_GLOBAL)
        _bind(lib, _CRYPTO_SIGNATURES)
    except (OSError, AttributeError):
        return None
    return lib


@functools.lru_cache(maxsize=None)
def libssl() -> Optional[ctypes.CDLL]:
    """The system's libssl (with libcrypto loaded first), or None."""
    path = ctypes.util.find_library("ssl")
    if not path or libcrypto() is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        _bind(lib, _SSL_SIGNATURES)
    except (OSError, AttributeError):
        return None
    return lib


def require_libcrypto() -> ctypes.CDLL:
    lib = libcrypto()
    if lib is None:
        raise RuntimeError("libcrypto (OpenSSL) not available")
    return lib


def require_libssl() -> ctypes.CDLL:
    lib = libssl()
    if lib is None:
        raise RuntimeError("libssl (OpenSSL) not available")
    return lib


def openssl_version() -> Optional[str]:
    """``OpenSSL_version(OPENSSL_VERSION)``, or None without libcrypto."""
    lib = libcrypto()
    return None if lib is None else lib.OpenSSL_version(0).decode()


# -- X25519 (RFC 7748) --------------------------------------------------------
def _raw_key(lib, private: bool, key: bytes):
    make = lib.EVP_PKEY_new_raw_private_key if private else lib.EVP_PKEY_new_raw_public_key
    pkey = make(EVP_PKEY_X25519, None, key, len(key))
    if not pkey:
        raise ValueError("libcrypto refused an X25519 key")
    return pkey


def x25519_public(private: bytes) -> bytes:
    """The public key of a 32-byte X25519 private scalar (clamped by
    libcrypto as RFC 7748 §5 says)."""
    lib = require_libcrypto()
    pkey = _raw_key(lib, True, private)
    try:
        out, n = ctypes.create_string_buffer(32), _S(32)
        if lib.EVP_PKEY_get_raw_public_key(pkey, out, ctypes.byref(n)) != 1:
            raise ValueError("X25519 public key")
        return out.raw[:n.value]
    finally:
        lib.EVP_PKEY_free(pkey)


def x25519(private: bytes, peer_public: bytes) -> bytes:
    """The X25519 shared secret. Raises ``ValueError`` where libcrypto
    refuses it (an all-zero result, as ``cryptography`` does)."""
    lib = require_libcrypto()
    mine = _raw_key(lib, True, private)
    peer = ctx = None
    try:
        peer = _raw_key(lib, False, peer_public)
        ctx = lib.EVP_PKEY_CTX_new(mine, None)
        out, n = ctypes.create_string_buffer(32), _S(32)
        if not (ctx and lib.EVP_PKEY_derive_init(ctx) == 1
                and lib.EVP_PKEY_derive_set_peer(ctx, peer) == 1
                and lib.EVP_PKEY_derive(ctx, out, ctypes.byref(n)) == 1):
            raise ValueError("X25519 key exchange failed")
        return out.raw[:n.value]
    finally:
        if ctx:
            lib.EVP_PKEY_CTX_free(ctx)
        if peer:
            lib.EVP_PKEY_free(peer)
        lib.EVP_PKEY_free(mine)


# -- AES-128 in CFB128 mode (NIST SP 800-38A §6.3) ---------------------------
def aes128_cfb(key: bytes, iv: bytes, data: bytes, encrypt: bool) -> bytes:
    if len(key) != 16 or len(iv) != 16:
        raise ValueError("AES-128-CFB needs a 16-byte key and a 16-byte IV")
    lib = require_libcrypto()
    ctx = lib.EVP_CIPHER_CTX_new()
    if not ctx:
        raise MemoryError("EVP_CIPHER_CTX_new")
    try:
        out = ctypes.create_string_buffer(len(data) + 16)
        n, tail = _I(0), _I(0)
        if not (lib.EVP_CipherInit_ex(ctx, lib.EVP_aes_128_cfb128(), None, key, iv,
                                      1 if encrypt else 0) == 1
                and lib.EVP_CipherUpdate(ctx, out, ctypes.byref(n), data, len(data)) == 1
                and lib.EVP_CipherFinal_ex(ctx, ctypes.cast(ctypes.byref(out, n.value), _B),
                                           ctypes.byref(tail)) == 1):
            raise RuntimeError("libcrypto AES-128-CFB failed")
        return out.raw[:n.value + tail.value]
    finally:
        lib.EVP_CIPHER_CTX_free(ctx)
