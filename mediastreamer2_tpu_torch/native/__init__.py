"""The batched native RTP edge (port of ``mediastreamer2_tpu/native``'s
``BatchRtpTx`` / ``BatchRtpRx`` bindings), the port's AES and the native
receive pump (``NativeIoPump``).

``rtp_edge.cpp`` and ``aesni_crypto.h`` started as copies of the JAX
package's sources: header pack + sendmmsg, recvmmsg drain + jitter-ring
insert, and per-tick playout, three C calls per tick for N legs, with
per-leg SRTP inline. At first use g++ compiles them into
``mediastreamer2_tpu_torch/_build/`` (named by a hash of the sources, the
flags and the CPU's features; nothing is built when this module is
imported) and ``ctypes`` loads the library.

Differences from the JAX package:

* the port's ``rtp_edge.cpp`` adds two C exports, ``ms2_aes_ecb`` and
  ``ms2_aes_gcm``: one-shot AES-ECB (both ways) and AEAD-GCM seal/open over
  the crypto layer ``SrtpLeg`` already uses (AES-NI/PCLMUL when the build
  has them, libcrypto's EVP otherwise). They give ``net/srtp.py`` its AES
  without the ``cryptography`` package, which the machine with the card
  does not have: the key derivation, the AES-CM keystream, the EKT key wrap
  and GCM. ``aesni_crypto.h`` is unchanged;
* no silent fallback: a failed build raises with g++'s output (the JAX
  package returns None and its callers skip). ``-O3 -march=native`` is
  retried as ``-O2`` on a g++ that rejects it;
* ``set_srtp`` raises on a suite or key the edge refuses (a leg is never
  sent in plaintext); the session keys come from the port's ``derive_key``.

``NativeIoPump`` binds ``io_pump.cpp``, the epoll receive pump on a native
thread (a copy of the JAX package's source, built the same way into
``_build/``: ``build_pump``). It departs from the JAX binding in four
places:

* ``add_socket`` raises when epoll refuses the socket (the JAX binding
  drops ``epoll_ctl``'s result, and the pump then never reads it);
* ``read``, ``dropped`` and ``truncated`` raise for a socket the pump does
  not know (the JAX ``read`` turns the C side's -1 into ``[]``);
* ``read`` copies only the bytes the C side wrote (the JAX binding copies
  the whole 1 MB buffer with ``.raw`` on every call: ~1 GB a tick at
  1,024 sockets, before a packet is looked at);
* a datagram longer than 2,048 bytes is still cut to 2,048, as in the JAX
  pump, but it is counted: the C side receives with ``MSG_TRUNC`` and
  ``truncated(sock)`` reports the count beside ``dropped(sock)``.
"""
from __future__ import annotations

import ctypes
import errno
import hashlib
import os
import shutil
import socket
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SOURCES = (_DIR / "rtp_edge.cpp", _DIR / "aesni_crypto.h")
_PUMP_SOURCES = (_DIR / "io_pump.cpp",)
BUILD_DIR = _DIR.parent / "_build"
_FLAG_SETS = (("-O3", "-march=native"), ("-O2",))

_UDP_SEGMENT = 103          # linux/udp.h
_GSO_PROBE_SEG = 12

_lib = None
_pump_lib = None
_build_lock = threading.Lock()


def _cpu_flags() -> bytes:
    """This CPU's feature flags: ``-march=native`` compiles for them, so a
    library built on another host is not reused."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def _compile(stem: str, sources, what: str) -> Path:
    """Compile ``sources[0]`` (the rest are headers it includes) into
    ``_build/<stem>_<hash>.so`` unless a build of these sources, flags and
    CPU exists; returns the library's path. Raises with g++'s output when
    no flag set compiles."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.read_bytes())
    digest.update(repr(_FLAG_SETS).encode() + _cpu_flags())
    out = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the {what} is built from source")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    logs = []
    for flags in _FLAG_SETS:
        res = subprocess.run([gxx, *flags, "-shared", "-fPIC", "-pthread",
                              str(sources[0]), "-o", str(tmp), "-ldl"],
                             capture_output=True, text=True, timeout=300)
        if res.returncode == 0:
            os.replace(tmp, out)
            return out
        logs.append(f"g++ {' '.join(flags)} ({res.returncode}):\n{res.stdout}{res.stderr}")
    raise RuntimeError(f"{what} build failed:\n" + "\n".join(logs))


def build() -> Path:
    """Compile the edge unless a build of these sources, flags and CPU
    exists; returns the library's path. Raises with g++'s output when no
    flag set compiles."""
    return _compile("libms2rtp", _SOURCES, "native RTP edge")


def build_pump() -> Path:
    """Compile the receive pump (``io_pump.cpp``) as ``build`` does the
    edge; returns the library's path."""
    return _compile("libms2io", _PUMP_SOURCES, "native receive pump")


def _load():
    global _lib
    with _build_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
            u64p = ctypes.POINTER(ctypes.c_uint64)
            lib.ms2_rtptx_create.restype = vp
            lib.ms2_rtptx_create.argtypes = [i] * 3
            lib.ms2_rtptx_destroy.argtypes = [vp]
            lib.ms2_rtptx_config.argtypes = [vp, i, ctypes.c_char_p, i, u32,
                                             ctypes.c_uint16, u32, ctypes.c_uint8]
            lib.ms2_rtptx_send.argtypes = [vp, vp, vp, u32]
            lib.ms2_rtptx_set_gso.argtypes = [vp, i]
            lib.ms2_rtptx_set_threads.argtypes = [vp, i]
            lib.ms2_rtprx_create.restype = vp
            lib.ms2_rtprx_create.argtypes = [i] * 3
            lib.ms2_rtprx_destroy.argtypes = [vp]
            lib.ms2_rtprx_add_fd.argtypes = [vp, i]
            lib.ms2_rtprx_map_ssrc.argtypes = [vp, u32, i]
            lib.ms2_rtprx_set_prefill.argtypes = [vp, i, i]
            lib.ms2_rtprx_set_threads.argtypes = [vp, i]
            lib.ms2_rtprx_poll.argtypes = [vp]
            lib.ms2_rtprx_read_tick.argtypes = [vp, vp, vp]
            lib.ms2_rtprx_stats.argtypes = [vp, i, u64p, u64p, u64p, u64p]
            srtp_args = [vp, i, ctypes.c_char_p, i, ctypes.c_char_p, ctypes.c_char_p, i, i]
            lib.ms2_rtptx_set_srtp.argtypes = srtp_args
            lib.ms2_rtprx_set_srtp.argtypes = srtp_args
            for fn in (lib.ms2_rtprx_auth_failures, lib.ms2_rtprx_replay_drops):
                fn.argtypes = [vp, i]
                fn.restype = ctypes.c_uint64
            lib.ms2_aes_ecb.argtypes = [ctypes.c_char_p, i, i, ctypes.c_char_p, vp, i]
            lib.ms2_aes_gcm.argtypes = [ctypes.c_char_p, i, i, ctypes.c_char_p,
                                        ctypes.c_char_p, i, ctypes.c_char_p, vp, i, vp]
            _lib = lib
    return _lib


def udp_gso_supported() -> bool:
    """Whether this kernel takes UDP_SEGMENT (GSO) sends: one two-segment
    send between two throwaway localhost sockets. Some kernels refuse the
    option (gVisor's netstack answers EINVAL), and the edge's GSO path
    would then drop every packet."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rcv, \
            socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as snd:
        rcv.bind(("127.0.0.1", 0))
        snd.connect(rcv.getsockname())
        try:
            snd.sendmsg([bytes(2 * _GSO_PROBE_SEG)],
                        [(socket.SOL_UDP, _UDP_SEGMENT, struct.pack("=H", _GSO_PROBE_SEG))])
        except OSError as e:
            if e.errno in (errno.EINVAL, errno.ENOPROTOOPT, errno.EOPNOTSUPP):
                return False
            raise
    return True


def hw_crypto() -> bool:
    """True when the edge's library carries the AES-NI/SHA-NI/PCLMUL path
    (``aesni_crypto.h``), False when its AES is libcrypto's EVP."""
    return bool(_load().ms2_rtp_hw_crypto())


def aes_ecb(key: bytes, data: bytes, decrypt: bool = False) -> bytes:
    """AES-128/256 over whole 16-byte blocks, each on its own (the CM
    keystream's counter blocks, the key wrap)."""
    if len(data) % 16:
        raise ValueError(f"aes_ecb: {len(data)} bytes is not whole blocks")
    out = ctypes.create_string_buffer(len(data))
    rc = _load().ms2_aes_ecb(key, len(key), int(decrypt), data, out, len(data) // 16)
    if rc != 0:
        raise RuntimeError(f"aes_ecb failed ({rc}): bad key length or no AES backend")
    return out.raw


def aes_gcm(key: bytes, iv: bytes, data: bytes, aad: bytes, tag: bytes = None):
    """AEAD-GCM with a 12-byte IV. Seal (``tag`` None): returns (ciphertext,
    16-byte tag). Open: returns the plaintext, or None when the tag does
    not authenticate."""
    if len(iv) != 12:
        raise ValueError("aes_gcm: the IV is 12 bytes")
    out = ctypes.create_string_buffer(len(data) or 1)
    tbuf = ctypes.create_string_buffer(tag if tag is not None else bytes(16), 16)
    rc = _load().ms2_aes_gcm(key, len(key), int(tag is None), iv, aad, len(aad), data,
                             out, len(data), tbuf)
    if rc < 0:
        raise RuntimeError(f"aes_gcm failed ({rc}): bad key length or no AES backend")
    if tag is None:
        return out.raw[:len(data)], tbuf.raw
    return out.raw[:len(data)] if rc == 0 else None


def _srtp_session_keys(master_key: bytes, master_salt: bytes, suite: str):
    """(k_e, k_s, k_a, tag_len, gcm) of one SRTP direction, by the port's
    RFC 3711 KDF (``net/srtp.derive_key``; RFC 7714 §11 pads 96-bit GCM
    master salts inside it). Raises on an unknown suite or a key or salt of
    the wrong length."""
    from mediastreamer2_tpu_torch.net.srtp import (LABEL_RTP_AUTH, LABEL_RTP_ENCRYPTION,
                                                   LABEL_RTP_SALT, SUITES, derive_key)
    if suite not in SUITES:
        raise ValueError(f"unknown SRTP suite {suite!r}")
    kind, klen, slen, tag = SUITES[suite]
    if len(master_key) != klen or len(master_salt) != slen:
        raise ValueError(f"{suite}: need a {klen}-byte key and a {slen}-byte salt")
    k_e = derive_key(master_key, master_salt, LABEL_RTP_ENCRYPTION, klen)
    if kind == "gcm":
        return k_e, derive_key(master_key, master_salt, LABEL_RTP_SALT, 12), bytes(20), tag, 1
    return (k_e, derive_key(master_key, master_salt, LABEL_RTP_SALT, 14),
            derive_key(master_key, master_salt, LABEL_RTP_AUTH, 20), tag, 0)


def _set_srtp(fn, handle, leg, master_key, master_salt, suite):
    k_e, k_s, k_a, tag, gcm = _srtp_session_keys(master_key, master_salt, suite)
    if not fn(handle, leg, k_e, len(k_e), k_s, k_a, tag, gcm):
        raise RuntimeError(f"leg {leg}: the edge refused SRTP suite {suite} (no AES "
                           f"backend, or a payload too large for its counter scratch)")


def rtp_edge_available() -> bool:
    """True when the edge is built or can be: g++ is installed. A build
    that then fails raises (no silent fallback)."""
    if shutil.which("g++") is None:
        return False
    _load()
    return True


class BatchRtpTx:
    """Batched RTP sender: one sendmmsg-backed socket carries N legs
    (per-message destination addresses). ``send`` takes a [N, psz] uint8
    array, once per tick."""

    def __init__(self, sock, n_legs: int, payload_size: int):
        self._lib = _load()
        self._sock = sock
        self.n_legs = n_legs
        self.payload_size = payload_size
        self._h = self._lib.ms2_rtptx_create(sock.fileno(), n_legs, payload_size)

    def config(self, leg: int, ip: str, port: int, ssrc: int,
               seq0: int = 0, ts0: int = 0, pt: int = 0):
        self._lib.ms2_rtptx_config(self._h, leg, ip.encode(), port, ssrc, seq0, ts0, pt)

    def set_srtp(self, leg: int, master_key: bytes, master_salt: bytes,
                 suite: str = "AES_CM_128_HMAC_SHA1_80"):
        """Protect the leg's packets inline (AES-CM + HMAC-SHA1 or AEAD-GCM)
        with session keys derived from the master key and salt. Raises
        when the edge refuses them."""
        _set_srtp(self._lib.ms2_rtptx_set_srtp, self._h, leg, master_key, master_salt, suite)

    def set_threads(self, t: int):
        """Shard pack + send over ``t`` native worker threads (legs in
        contiguous ranges, each leg's state touched by one worker)."""
        self._lib.ms2_rtptx_set_threads(self._h, t)

    def enable_gso(self, remote):
        """Single-destination fast path: connect() the socket and let the
        kernel split one 64-segment send into datagrams (UDP_SEGMENT).
        Only valid when every leg targets ``remote``, and on a kernel that
        takes UDP_SEGMENT (``udp_gso_supported``)."""
        self._sock.connect(remote)
        self._lib.ms2_rtptx_set_gso(self._h, 1)

    def send(self, payloads, ts_inc: int, mask=None) -> int:
        payloads = np.ascontiguousarray(payloads, dtype=np.uint8)
        if payloads.shape != (self.n_legs, self.payload_size):
            raise ValueError(f"payloads {payloads.shape}, expected "
                             f"{(self.n_legs, self.payload_size)}")
        mptr = None
        if mask is not None:
            mask = np.ascontiguousarray(mask, dtype=np.uint8)
            mptr = mask.ctypes.data_as(ctypes.c_void_p)
        return self._lib.ms2_rtptx_send(
            self._h, payloads.ctypes.data_as(ctypes.c_void_p), mptr, ts_inc)

    def close(self):
        if self._h:
            self._lib.ms2_rtptx_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


class BatchRtpRx:
    """Batched RTP receiver + fixed-ring jitter buffer for N legs.

    ``poll`` drains all registered sockets with recvmmsg and inserts into
    per-leg seq rings; ``read_tick`` pops one tick of payloads into a
    [N, psz] uint8 matrix plus a present/missing flag vector (both reused
    by the next call)."""

    def __init__(self, n_legs: int, payload_size: int, ring_depth: int = 64):
        if ring_depth & (ring_depth - 1):
            raise ValueError(f"ring_depth {ring_depth} is not a power of two")
        self._lib = _load()
        self.n_legs = n_legs
        self.payload_size = payload_size
        self._h = self._lib.ms2_rtprx_create(n_legs, payload_size, ring_depth)
        self._out = np.zeros((n_legs, payload_size), np.uint8)
        self._flags = np.zeros((n_legs,), np.uint8)
        self._socks = []

    def add_socket(self, sock, gro: bool = False):
        self._socks.append(sock)               # keep the fd alive
        if gro:
            try:                               # UDP_GRO: the kernel coalesces
                sock.setsockopt(socket.IPPROTO_UDP, 104, 1)
            except OSError:
                pass
        self._lib.ms2_rtprx_add_fd(self._h, sock.fileno())

    def map_ssrc(self, ssrc: int, leg: int):
        self._lib.ms2_rtprx_map_ssrc(self._h, ssrc, leg)

    def set_prefill(self, leg: int, packets: int):
        self._lib.ms2_rtprx_set_prefill(self._h, leg, packets)

    def set_srtp(self, leg: int, master_key: bytes, master_salt: bytes,
                 suite: str = "AES_CM_128_HMAC_SHA1_80"):
        """Authenticate, check for replay and decrypt the leg's packets
        before the jitter-ring insert. Raises when the edge refuses the
        keys."""
        _set_srtp(self._lib.ms2_rtprx_set_srtp, self._h, leg, master_key, master_salt, suite)

    def auth_failures(self, leg: int) -> int:
        """Packets of the leg that failed authentication (dropped)."""
        return self._lib.ms2_rtprx_auth_failures(self._h, leg)

    def replay_drops(self, leg: int) -> int:
        """Authenticated packets of the leg dropped as replays (RFC 3711
        §3.3.2, a 64-packet sliding window)."""
        return self._lib.ms2_rtprx_replay_drops(self._h, leg)

    def set_threads(self, t: int):
        """Shard insert and playout over ``t`` native worker threads
        (packets partitioned by leg)."""
        self._lib.ms2_rtprx_set_threads(self._h, t)

    def poll(self) -> int:
        return self._lib.ms2_rtprx_poll(self._h)

    def read_tick(self):
        self._lib.ms2_rtprx_read_tick(
            self._h, self._out.ctypes.data_as(ctypes.c_void_p),
            self._flags.ctypes.data_as(ctypes.c_void_p))
        return self._out, self._flags

    def stats(self, leg: int) -> dict:
        got, lost, late, recv = (ctypes.c_uint64() for _ in range(4))
        self._lib.ms2_rtprx_stats(self._h, leg, ctypes.byref(got), ctypes.byref(lost),
                                  ctypes.byref(late), ctypes.byref(recv))
        return {"got": got.value, "lost": lost.value,
                "late": late.value, "recv": recv.value}

    def close(self):
        if self._h:
            self._lib.ms2_rtprx_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


# ---------------------------------------------------------------------------
# The receive pump (io_pump.cpp): an epoll loop on a native thread drains
# every registered socket as data lands and queues stamped datagrams, which
# the tick loop empties with one call a socket.
# ---------------------------------------------------------------------------
def _load_pump():
    global _pump_lib
    with _build_lock:
        if _pump_lib is None:
            lib = ctypes.CDLL(str(build_pump()))
            vp, i = ctypes.c_void_p, ctypes.c_int
            u64p = ctypes.POINTER(ctypes.c_uint64)
            lib.ms2_pump_create.restype = vp
            lib.ms2_pump_create.argtypes = []
            lib.ms2_pump_destroy.argtypes = [vp]
            lib.ms2_pump_add_socket.argtypes = [vp, i]
            lib.ms2_pump_remove_socket.argtypes = [vp, i]
            lib.ms2_pump_read.argtypes = [vp, i, ctypes.c_char_p, i]
            lib.ms2_pump_counters.argtypes = [vp, i, u64p, u64p]
            for fn in (lib.ms2_pump_add_socket, lib.ms2_pump_remove_socket,
                       lib.ms2_pump_read, lib.ms2_pump_counters):
                fn.restype = i
            _pump_lib = lib
    return _pump_lib


def native_available() -> bool:
    """True when the pump is built or can be: g++ is installed. A build
    that then fails raises (no silent fallback)."""
    if shutil.which("g++") is None:
        return False
    _load_pump()
    return True


_FRAME = struct.Struct("<QI")          # t_ns, len: io_pump.cpp's framing


class NativeIoPump:
    """Epoll-based datagram pump on a native thread (``io_pump.cpp``).

    ``read(sock)`` returns ``[(t_ns, bytes), ...]`` drained since the last
    call, stamped with CLOCK_MONOTONIC nanoseconds when the pump took
    them off the socket. Each socket queues at most 4,096 datagrams;
    beyond that the oldest is dropped and counted (``dropped``). The
    module docstring lists where this binding departs from the JAX
    package's."""

    def __init__(self, read_buf_size: int = 1 << 20):
        self._lib = _load_pump()
        self._pump = self._lib.ms2_pump_create()
        self._buf = ctypes.create_string_buffer(read_buf_size)

    def add_socket(self, sock) -> None:
        rc = self._lib.ms2_pump_add_socket(self._pump, sock.fileno())
        if rc != 0:
            raise OSError(-rc, f"pump: epoll refused socket {sock.fileno()}: "
                               f"{os.strerror(-rc)}")

    def remove_socket(self, sock) -> None:
        self._lib.ms2_pump_remove_socket(self._pump, sock.fileno())

    def read(self, sock) -> list:
        n = self._lib.ms2_pump_read(self._pump, sock.fileno(), self._buf, len(self._buf))
        if n < 0:
            raise KeyError(f"pump: socket {sock.fileno()} was never added")
        if n == 0:
            return []
        raw = ctypes.string_at(self._buf, n)        # only the bytes written
        out = []
        off = 0
        while off < n:
            t_ns, ln = _FRAME.unpack_from(raw, off)
            off += _FRAME.size
            out.append((t_ns, raw[off:off + ln]))
            off += ln
        return out

    def _counters(self, sock):
        dropped, truncated = ctypes.c_uint64(), ctypes.c_uint64()
        if self._lib.ms2_pump_counters(self._pump, sock.fileno(), ctypes.byref(dropped),
                                       ctypes.byref(truncated)) != 0:
            raise KeyError(f"pump: socket {sock.fileno()} was never added")
        return dropped.value, truncated.value

    def dropped(self, sock) -> int:
        """Datagrams of ``sock`` dropped because its queue was full."""
        return self._counters(sock)[0]

    def truncated(self, sock) -> int:
        """Datagrams of ``sock`` longer than 2,048 bytes, cut to 2,048."""
        return self._counters(sock)[1]

    def close(self):
        if self._pump:
            self._lib.ms2_pump_destroy(self._pump)
            self._pump = None

    def __del__(self):
        if getattr(self, "_pump", None):
            self.close()
