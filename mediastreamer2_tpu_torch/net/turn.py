"""TURN client (RFC 5766) — relay allocation for ICE (a copy of
``mediastreamer2_tpu/net/turn.py``: plain Python).

Reference: TURN inside src/voip/ice.c (+TCP transport in turn_tcp.cpp).
Scope: UDP TURN — Allocate (with long-term-credential auth on 401),
Refresh, CreatePermission, Send/Data indications, and ChannelBind with
channel-data framing; the relayed address feeds the ICE check list as a
"relay" candidate.  TURN over TCP/TLS reuses the same message layer over
``net/turn_tcp.py``'s framed stream.
"""
from __future__ import annotations

import hashlib
import os
import struct
import time
from typing import Callable, Dict, List, Optional, Tuple

from mediastreamer2_tpu_torch.net import stun

METHOD_ALLOCATE = 0x003
METHOD_REFRESH = 0x004
METHOD_SEND = 0x006
METHOD_DATA = 0x007
METHOD_CREATE_PERMISSION = 0x008
METHOD_CHANNEL_BIND = 0x009

CLS_REQUEST = 0x0000
CLS_INDICATION = 0x0010
CLS_SUCCESS = 0x0100
CLS_ERROR = 0x0110

ATTR_LIFETIME = 0x000D
ATTR_XOR_PEER_ADDRESS = 0x0012
ATTR_DATA = 0x0013
ATTR_REALM = 0x0014
ATTR_NONCE = 0x0015
ATTR_XOR_RELAYED_ADDRESS = 0x0016
ATTR_REQUESTED_TRANSPORT = 0x0019
ATTR_CHANNEL_NUMBER = 0x000C


def _method_type(method: int, cls: int) -> int:
    # RFC 5389 §6 method/class bit packing
    return (((method & 0xF80) << 2) | ((method & 0x070) << 1)
            | (method & 0x00F) | cls)


def _xor_addr(attrs: Dict[int, bytes], attr_id: int) -> Optional[Tuple[str, int]]:
    v = attrs.get(attr_id)
    if not v or v[1] != 1:
        return None
    port = struct.unpack("!H", v[2:4])[0] ^ (stun.MAGIC_COOKIE >> 16)
    ip = bytes(b ^ m for b, m in zip(v[4:8],
                                     struct.pack("!I", stun.MAGIC_COOKIE)))
    return ".".join(str(b) for b in ip), port


def _pack_xor_addr(host: str, port: int) -> bytes:
    ip = bytes(int(x) for x in host.split("."))
    xport = port ^ (stun.MAGIC_COOKIE >> 16)
    xip = bytes(b ^ m for b, m in zip(ip, struct.pack("!I", stun.MAGIC_COOKIE)))
    return struct.pack("!BBH", 0, 1, xport) + xip


class TurnClient:
    """One allocation on one TURN server. send_fn transmits to the server;
    call handle() with every datagram from the server."""

    def __init__(self, send_fn: Callable[[bytes], None],
                 username: str = "", password: str = "", realm: str = ""):
        self.send_fn = send_fn
        self.username = username
        self.password = password
        self.realm = realm
        self.nonce = b""
        self.relayed_addr: Optional[Tuple[str, int]] = None
        self.mapped_addr: Optional[Tuple[str, int]] = None
        self.lifetime = 0
        self.state = "idle"
        self.on_data: Optional[Callable[[bytes, Tuple[str, int]], None]] = None
        self.on_allocated: Optional[Callable[[Tuple[str, int]], None]] = None
        self.channels: Dict[Tuple[str, int], int] = {}
        self._next_channel = 0x4000
        self._pending: Dict[bytes, tuple] = {}    # txid -> (method, peer)
        self._permission_peers: Dict[Tuple[str, int], float] = {}
        self._perm_sent: Dict[Tuple[str, int], float] = {}
        self._allocated_at = 0.0
        self._refresh_sent_at = -1e9

    # -- auth key (long-term credential, RFC 5389 §15.4) -------------------
    def _key(self) -> Optional[str]:
        if not self.username:
            return None
        return None  # integrity key handled as raw md5 below

    def _send_req(self, method: int, attrs: Dict[int, bytes], peer=None):
        m = stun.StunMessage(_method_type(method, CLS_REQUEST))
        m.attrs.update(attrs)
        key = None
        if self.nonce and self.username:
            m.attrs[stun.ATTR_USERNAME] = self.username.encode()
            m.attrs[ATTR_REALM] = self.realm.encode()
            m.attrs[ATTR_NONCE] = self.nonce
            # long-term credential key (RFC 5389 §15.4)
            key = hashlib.md5(f"{self.username}:{self.realm}:"
                              f"{self.password}".encode()).digest()
        self._pending[m.transaction_id] = (method, peer)
        self.send_fn(m.pack(password=key, fingerprint=False))

    # -- public ops ----------------------------------------------------------
    def allocate(self, lifetime: int = 600):
        self.state = "allocating"
        self._send_req(METHOD_ALLOCATE, {
            ATTR_REQUESTED_TRANSPORT: struct.pack("!BBBB", 17, 0, 0, 0),
            ATTR_LIFETIME: struct.pack("!I", lifetime),
        })

    def refresh(self, lifetime: int = 600):
        self._send_req(METHOD_REFRESH,
                       {ATTR_LIFETIME: struct.pack("!I", lifetime)})

    def create_permission(self, peer: Tuple[str, int]):
        # provisional stamp so maintain() has an anchor even pre-response;
        # the success response re-anchors (lost request -> early resend)
        self._permission_peers.setdefault(peer, -1e9)
        self._perm_sent[peer] = self._now()
        self._send_req(METHOD_CREATE_PERMISSION,
                       {ATTR_XOR_PEER_ADDRESS: _pack_xor_addr(*peer)},
                       peer=peer)

    # -- keepalive lifecycle (RFC 5766 §7/§9: allocations expire at
    # `lifetime`, permissions at 300 s; churned legs keep adding peers so
    # both must refresh continuously — ice.c's TURN refresh timers) -------
    PERMISSION_LIFETIME_S = 300.0

    @staticmethod
    def _now() -> float:
        import time as _t
        return _t.monotonic()

    RESEND_THROTTLE_S = 2.0

    def maintain(self, now: Optional[float] = None):
        """Call periodically (the check-list process cadence is fine):
        re-REFRESH the allocation at 80% of its lifetime and re-send
        CreatePermission at 80% of the 5-minute permission lifetime for
        every active peer.  Expiry anchors advance on the SUCCESS RESPONSE
        (handle()), not on send — a lost UDP request retries at the next
        maintain() (throttled) instead of silently letting the server-side
        state lapse."""
        now = self._now() if now is None else now
        if self.state == "allocated" and self.lifetime:
            if (now - self._allocated_at >= 0.8 * self.lifetime
                    and now - self._refresh_sent_at
                    >= self.RESEND_THROTTLE_S):
                self._refresh_sent_at = now
                self.refresh(self.lifetime)
        for peer, t0 in list(self._permission_peers.items()):
            if (now - t0 >= 0.8 * self.PERMISSION_LIFETIME_S
                    and now - self._perm_sent.get(peer, -1e9)
                    >= self.RESEND_THROTTLE_S):
                self._perm_sent[peer] = now
                self._send_req(METHOD_CREATE_PERMISSION,
                               {ATTR_XOR_PEER_ADDRESS: _pack_xor_addr(*peer)},
                               peer=peer)

    def drop_peer(self, peer: Tuple[str, int]):
        """Leg churned away: stop refreshing its permission (it lapses on
        the server after the 5-minute lifetime)."""
        self._permission_peers.pop(peer, None)
        self._perm_sent.pop(peer, None)
        self.channels.pop(peer, None)

    def channel_bind(self, peer: Tuple[str, int]) -> int:
        ch = self._next_channel
        self._next_channel += 1
        self.channels[peer] = ch
        self._send_req(METHOD_CHANNEL_BIND, {
            ATTR_CHANNEL_NUMBER: struct.pack("!HH", ch, 0),
            ATTR_XOR_PEER_ADDRESS: _pack_xor_addr(*peer),
        })
        return ch

    def send_to_peer(self, peer: Tuple[str, int], data: bytes):
        ch = self.channels.get(peer)
        if ch is not None:
            self.send_fn(struct.pack("!HH", ch, len(data)) + data
                         + b"\x00" * ((4 - len(data) % 4) % 4))
            return
        m = stun.StunMessage(_method_type(METHOD_SEND, CLS_INDICATION))
        m.attrs[ATTR_XOR_PEER_ADDRESS] = _pack_xor_addr(*peer)
        m.attrs[ATTR_DATA] = data
        self.send_fn(m.pack(fingerprint=False))

    # -- inbound ---------------------------------------------------------------
    def handle(self, data: bytes):
        if len(data) >= 4 and 0x4000 <= struct.unpack("!H", data[:2])[0] < 0x8000:
            ch, ln = struct.unpack("!HH", data[:4])
            peer = next((p for p, c in self.channels.items() if c == ch), None)
            if peer and self.on_data:
                self.on_data(data[4:4 + ln], peer)
            return
        try:
            msg = stun.StunMessage.unpack(data)
        except ValueError:
            return
        cls = msg.msg_type & 0x0110
        method, req_peer = self._pending.pop(msg.transaction_id,
                                             (None, None))
        if cls == CLS_ERROR:
            code = msg.get_error()
            if code == 401 and ATTR_NONCE in msg.attrs and method is not None:
                self.nonce = msg.attrs[ATTR_NONCE]
                self.realm = msg.attrs.get(ATTR_REALM, b"").decode()
                if method == METHOD_ALLOCATE:
                    self.allocate()                 # retry with credentials
            else:
                self.state = "failed"
            return
        if cls == CLS_SUCCESS and method == METHOD_REFRESH:
            lt = msg.attrs.get(ATTR_LIFETIME)
            if lt:
                self.lifetime = struct.unpack("!I", lt)[0]
            self._allocated_at = self._now()
        elif cls == CLS_SUCCESS and method == METHOD_CREATE_PERMISSION \
                and req_peer is not None:
            self._permission_peers[req_peer] = self._now()
        elif cls == CLS_SUCCESS and method == METHOD_ALLOCATE:
            self.relayed_addr = _xor_addr(msg.attrs, ATTR_XOR_RELAYED_ADDRESS)
            self.mapped_addr = msg.get_xor_mapped_address()
            lt = msg.attrs.get(ATTR_LIFETIME)
            self.lifetime = struct.unpack("!I", lt)[0] if lt else 600
            self.state = "allocated"
            self._allocated_at = self._now()
            if self.on_allocated and self.relayed_addr:
                self.on_allocated(self.relayed_addr)
        elif (msg.msg_type & ~0x0110) == _method_type(METHOD_DATA, 0) \
                or msg.msg_type == _method_type(METHOD_DATA, CLS_INDICATION):
            peer = _xor_addr(msg.attrs, ATTR_XOR_PEER_ADDRESS)
            payload = msg.attrs.get(ATTR_DATA, b"")
            if self.on_data and peer:
                self.on_data(payload, peer)


class MiniTurnServer:
    """In-process TURN server for tests (UDP semantics over callables)."""

    def __init__(self, relay_base: Tuple[str, int] = ("198.51.100.1", 50000),
                 require_auth: bool = False, username: str = "",
                 password: str = "", realm: str = "ms2"):
        self.relay_base = relay_base
        self.require_auth = require_auth
        self.username = username
        self.password = password
        self.realm = realm
        self.allocations: Dict[int, Tuple[str, int]] = {}
        self.permissions: List[Tuple[str, int]] = []
        self.channels: Dict[int, Tuple[str, int]] = {}
        self._next_relay = relay_base[1]
        # peers: relay <-> outside world hook for tests
        self.peer_rx: List[Tuple[Tuple[str, int], bytes]] = []

    def handle(self, data: bytes, reply: Callable[[bytes], None]):
        if len(data) >= 4 and 0x4000 <= struct.unpack("!H", data[:2])[0] < 0x8000:
            ch, ln = struct.unpack("!HH", data[:4])
            peer = self.channels.get(ch)
            if peer:
                self.peer_rx.append((peer, data[4:4 + ln]))
            return
        msg = stun.StunMessage.unpack(data)
        cls = msg.msg_type & 0x0110
        method = msg.msg_type & ~0x0110
        if method == _method_type(METHOD_ALLOCATE, 0) and cls == CLS_REQUEST:
            if self.require_auth and stun.ATTR_MESSAGE_INTEGRITY not in msg.attrs:
                err = stun.StunMessage(_method_type(METHOD_ALLOCATE, CLS_ERROR),
                                       msg.transaction_id)
                err.set_error(401, "Unauthorized")
                err.attrs[ATTR_NONCE] = b"nonce123"
                err.attrs[ATTR_REALM] = self.realm.encode()
                reply(err.pack(fingerprint=False))
                return
            relay = (self.relay_base[0], self._next_relay)
            self._next_relay += 1
            ok = stun.StunMessage(_method_type(METHOD_ALLOCATE, CLS_SUCCESS),
                                  msg.transaction_id)
            ok.attrs[ATTR_XOR_RELAYED_ADDRESS] = _pack_xor_addr(*relay)
            ok.set_xor_mapped_address("192.0.2.1", 40000)
            ok.attrs[ATTR_LIFETIME] = struct.pack("!I", 600)
            reply(ok.pack(fingerprint=False))
        elif method == _method_type(METHOD_CREATE_PERMISSION, 0):
            self.permissions.append(_xor_addr(msg.attrs, ATTR_XOR_PEER_ADDRESS))
            ok = stun.StunMessage(
                _method_type(METHOD_CREATE_PERMISSION, CLS_SUCCESS),
                msg.transaction_id)
            reply(ok.pack(fingerprint=False))
        elif method == _method_type(METHOD_CHANNEL_BIND, 0):
            ch = struct.unpack("!H", msg.attrs[ATTR_CHANNEL_NUMBER][:2])[0]
            self.channels[ch] = _xor_addr(msg.attrs, ATTR_XOR_PEER_ADDRESS)
            ok = stun.StunMessage(_method_type(METHOD_CHANNEL_BIND, CLS_SUCCESS),
                                  msg.transaction_id)
            reply(ok.pack(fingerprint=False))
        elif method == _method_type(METHOD_SEND, 0) and cls == CLS_INDICATION:
            peer = _xor_addr(msg.attrs, ATTR_XOR_PEER_ADDRESS)
            self.peer_rx.append((peer, msg.attrs.get(ATTR_DATA, b"")))

    def inject_from_peer(self, peer: Tuple[str, int], data: bytes,
                         reply: Callable[[bytes], None]):
        """Simulate data arriving at the relay from a remote peer."""
        ch = next((c for c, p in self.channels.items() if p == peer), None)
        if ch is not None:
            pad = b"\x00" * ((4 - len(data) % 4) % 4)
            reply(struct.pack("!HH", ch, len(data)) + data + pad)
        else:
            m = stun.StunMessage(_method_type(METHOD_DATA, CLS_INDICATION))
            m.attrs[ATTR_XOR_PEER_ADDRESS] = _pack_xor_addr(*peer)
            m.attrs[ATTR_DATA] = data
            reply(m.pack(fingerprint=False))
