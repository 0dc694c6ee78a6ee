"""The batched native RTP edge (port of ``mediastreamer2_tpu/native``'s
``BatchRtpTx`` / ``BatchRtpRx`` bindings).

``rtp_edge.cpp`` and ``aesni_crypto.h`` are copies of the JAX package's
sources: header pack + sendmmsg, recvmmsg drain + jitter-ring insert, and
per-tick playout, three C calls per tick for N legs. At first use g++
compiles them into ``mediastreamer2_tpu_torch/_build/`` (named by a hash of
the sources, the flags and the CPU's features; nothing is built when this
module is imported) and
``ctypes`` loads the library.

Differences from the JAX package:

* no silent fallback: a failed build raises with g++'s output (the JAX
  package returns None and its callers skip). ``-O3 -march=native`` is
  retried as ``-O2`` on a g++ that rejects it;
* SRTP is not ported: its key derivation needs the ``cryptography``
  package, which the machine with the card does not have, so ``set_srtp``
  raises ``NotImplementedError`` (``ROADMAP.md`` Queue 1, "SRTP without
  cryptography");
* ``NativeIoPump`` (``io_pump.cpp``) is not on the port's path and is not
  ported yet.
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
BUILD_DIR = _DIR.parent / "_build"
_FLAG_SETS = (("-O3", "-march=native"), ("-O2",))
SRTP_NOT_PORTED = ("SRTP is not ported to mediastreamer2_tpu_torch: its key "
                   "derivation needs the 'cryptography' package (ROADMAP.md, "
                   "Queue 1, 'SRTP without cryptography')")

_UDP_SEGMENT = 103          # linux/udp.h
_GSO_PROBE_SEG = 12

_lib = None
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


def build() -> Path:
    """Compile the edge unless a build of these sources, flags and CPU
    exists; returns the library's path. Raises with g++'s output when no
    flag set compiles."""
    digest = hashlib.sha256()
    for src in _SOURCES:
        digest.update(src.read_bytes())
    digest.update(repr(_FLAG_SETS).encode() + _cpu_flags())
    out = BUILD_DIR / f"libms2rtp_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native RTP edge is built from source")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    logs = []
    for flags in _FLAG_SETS:
        res = subprocess.run([gxx, *flags, "-shared", "-fPIC", "-pthread",
                              str(_SOURCES[0]), "-o", str(tmp), "-ldl"],
                             capture_output=True, text=True, timeout=300)
        if res.returncode == 0:
            os.replace(tmp, out)
            return out
        logs.append(f"g++ {' '.join(flags)} ({res.returncode}):\n{res.stdout}{res.stderr}")
    raise RuntimeError("native RTP edge build failed:\n" + "\n".join(logs))


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
        raise NotImplementedError(SRTP_NOT_PORTED)

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
        raise NotImplementedError(SRTP_NOT_PORTED)

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
