"""TURN over TCP/TLS — framed STUN/ChannelData stream transport (port of
``mediastreamer2_tpu/net/turn_tcp.py``: plain Python and the standard
``ssl`` module).

Reference: src/voip/turn_tcp.cpp (748 LoC): a TCP (optionally TLS)
connection to the TURN server carrying STUN messages and ChannelData
frames, drained by a background worker; the path that survives
UDP-hostile NATs.  RFC 5766 §11.5: over stream transports ChannelData
frames are padded to 4-byte boundaries; STUN messages are self-framing
(length at header offset 2).

This module gives TurnClient (net/turn.py, transport-agnostic by design)
a stream transport: ``TurnTcpConnection`` frames outgoing data, reassembles
inbound STUN/ChannelData from the byte stream, and pumps them to the
client from a receiver thread (the reference uses an MSWorkerThread).

Departure from the JAX module's threading, not from its wire behaviour:
there ``send`` writes the socket from the caller's thread while the
receiver thread reads it, and OpenSSL does not make one ``SSLSocket`` safe
to use from two threads at once (its TLS test fails now and then). Here
every read and write of the socket happens on the receiver thread: ``send``
queues the frame and wakes the thread, which writes the queue out before
it waits for input. Frames sent before ``start()`` go out once it runs.
"""
from __future__ import annotations

import collections
import select
import socket
import ssl
import struct
import threading
from typing import Callable, Optional


def _frame_len(buf: bytes) -> Optional[int]:
    """Length of the first complete frame in buf, or None if incomplete."""
    if len(buf) < 4:
        return None
    first = buf[0]
    if first < 4:                       # STUN message (RFC 5389 §6)
        if len(buf) < 20:
            return None
        mlen = struct.unpack("!H", buf[2:4])[0]
        total = 20 + mlen
        return total if len(buf) >= total else None
    if 0x40 <= first <= 0x7F:           # ChannelData (RFC 5766 §11)
        dlen = struct.unpack("!H", buf[2:4])[0]
        total = 4 + dlen
        total += (-total) % 4           # stream padding (§11.5)
        return total if len(buf) >= total else None
    return -1                           # protocol error


class TurnTcpConnection:
    """One framed TURN control/data connection over TCP or TLS.

    Use as the send_fn/feed pair for TurnClient:
        conn = TurnTcpConnection(host, port)
        client = TurnClient(conn.send, ...)
        conn.on_frame = client.handle
        conn.start()
    """

    def __init__(self, host: str, port: int, use_tls: bool = False,
                 tls_context: Optional[ssl.SSLContext] = None,
                 connect_timeout: float = 5.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=connect_timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if use_tls:
            ctx = tls_context
            if ctx is None:
                # TURN servers commonly use certs outside the web PKI; the
                # reference verifies via its own trust config — callers pass
                # tls_context for real verification.
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self.sock = ctx.wrap_socket(self.sock, server_hostname=host)
        self.sock.settimeout(0.2)
        self.on_frame: Optional[Callable[[bytes], None]] = None
        self.on_error: Optional[Callable[[Exception], None]] = None
        self._buf = b""
        self._outbox = collections.deque()      # frames for the receiver thread
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.frames_rx = 0
        self.protocol_errors = 0

    def send(self, data: bytes):
        """Queue one STUN message or ChannelData frame (padded per §11.5)
        for the receiver thread to write."""
        if data and 0x40 <= data[0] <= 0x7F:
            data += b"\x00" * ((-len(data)) % 4)
        self._outbox.append(data)
        try:
            self._wake_w.send(b"\x00")
        except OSError:                  # a wake-up already pending, or closed
            pass

    def _flush(self):
        while self._outbox:
            data = self._outbox.popleft()
            try:
                self.sock.sendall(data)
            except OSError as e:
                if self.on_error:
                    self.on_error(e)

    def _feed(self, chunk: bytes):
        self._buf += chunk
        while True:
            n = _frame_len(self._buf)
            if n is None:
                return
            if n < 0:
                self.protocol_errors += 1
                self._buf = b""          # unrecoverable desync: drop buffer
                return
            frame, self._buf = self._buf[:n], self._buf[n:]
            self.frames_rx += 1
            if self.on_frame:
                self.on_frame(frame)

    def _wait_readable(self) -> bool:
        """Wait up to 0.2 s for input or a queued send; True when the
        socket has input (TLS may hold a decrypted record already)."""
        pending = getattr(self.sock, "pending", None)        # TLS only
        if pending is not None and pending():
            return True
        ready, _, _ = select.select([self.sock, self._wake_r], [], [], 0.2)
        if self._wake_r in ready:
            try:
                while self._wake_r.recv(4096):
                    pass
            except BlockingIOError:
                pass
        return self.sock in ready

    def _rx_loop(self):
        while not self._stop.is_set():
            self._flush()
            if not self._wait_readable():
                continue
            try:
                chunk = self.sock.recv(65536)
            except socket.timeout:       # a partial TLS record: wait for more
                continue
            except OSError as e:         # ssl.SSLError included
                if not self._stop.is_set() and self.on_error:
                    self.on_error(e)
                return
            if not chunk:                # server closed
                if not self._stop.is_set() and self.on_error:
                    self.on_error(ConnectionResetError("turn tcp closed"))
                return
            self._feed(chunk)

    def start(self):
        self._thread = threading.Thread(target=self._rx_loop,
                                        name="turn-tcp-rx", daemon=True)
        self._thread.start()

    def close(self):
        self._stop.set()
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass
        if self._thread:
            self._thread.join(timeout=1.0)
            self._thread = None
        for s in (self.sock, self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
