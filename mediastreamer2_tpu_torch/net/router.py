"""Packet router — the SFU core (selective forwarding unit), host side (a
copy of ``mediastreamer2_tpu/net/router.py``: plain Python and numpy).

Reference: src/videofilters/packet-router.cpp (1,222 LoC; public
mspacketrouter.h): RouterInput/RouterOutput per pin, audio mode = top-N
speaker selection using RFC6464 volume ranks, video mode = active-speaker
switching on key-frame boundaries with key-frame request/indication,
seq-num/timestamp rewriting, full-packet vs payload routing, end-to-end
encryption passthrough.  Older C variants: videorouter.c / videoswitcher.c.

Device split: routing is pure packet shuffling -> host; but the volume
ranking comes from the device (`audio_levels` filter energies), so the SFU
decision input is computed in the batched graph.

Changes from the JAX module, none to what is forwarded: a member's last
forwarded source is the dataclass field ``RouterMember.last_src`` instead
of an attribute set on the instance (``_last_src``), and
``AudioPacketRouter.route`` no longer sorts the other members into a list
it never reads.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from mediastreamer2_tpu_torch.net.rtp import RtpPacket

ROUTER_MAX_OUTPUTS = 20          # parity: mspacketrouter.h ROUTER_MAX_*


@dataclasses.dataclass
class RouterMember:
    idx: int
    send: Callable[[bytes], None]          # toward this member
    active: bool = True
    volume: float = 0.0                    # device-computed energy
    wants_keyframe: bool = False
    # seq/ts rewriting state (continuity across switches)
    out_seq: int = 0
    last_in_seq: Optional[int] = None
    ts_offset: int = 0
    current_source: Optional[int] = None
    last_src: Optional[int] = None         # source of the last packet forwarded


class AudioPacketRouter:
    """Top-N speaker forwarding (audio SFU).

    Each member receives the packets of the N loudest *other* members.
    Volumes come from the device batch (update_volumes).
    """

    def __init__(self, top_n: int = 3):
        self.top_n = top_n
        self.members: Dict[int, RouterMember] = {}

    def add_member(self, idx: int, send: Callable[[bytes], None]):
        self.members[idx] = RouterMember(idx, send)

    def remove_member(self, idx: int):
        self.members.pop(idx, None)

    def update_volumes(self, energies: np.ndarray):
        """energies: [batch] from the audio_levels filter state."""
        for m in self.members.values():
            if m.idx < len(energies):
                m.volume = float(energies[m.idx])

    def note_level_extension(self, from_idx: int, pkt: RtpPacket,
                             ext_id: int = 1):
        """RFC 6464 client-to-mixer level straight off the packet — lets
        a pure packet router rank speakers with no device round-trip
        (packet-router.h volume-ranked selection using the level ext).
        Lower dBov = louder; map to a positive volume key."""
        if pkt.extensions and ext_id in pkt.extensions:
            dbov = pkt.extensions[ext_id][0] & 0x7F
            m = self.members.get(from_idx)
            if m is not None:
                m.volume = 127.0 - dbov

    def route(self, from_idx: int, pkt: RtpPacket):
        self.note_level_extension(from_idx, pkt)
        speakers = {m.idx for m in sorted(
            (m for m in self.members.values() if m.active),
            key=lambda m: -m.volume)[: self.top_n]}
        if from_idx not in speakers:
            return 0
        n = 0
        for m in self.members.values():
            if m.idx == from_idx or not m.active:
                continue
            m.send(pkt.pack())
            n += 1
        return n


class VideoPacketRouter:
    """Active-speaker video switching on key-frame boundaries.

    cf. packet-router.cpp: an output switches to a new focus source only
    when that source delivers a key frame; until then it keeps relaying the
    old one and a key-frame request is emitted for the new source.
    """

    def __init__(self, request_keyframe: Callable[[int], None]):
        self.members: Dict[int, RouterMember] = {}
        self.request_keyframe = request_keyframe
        self.focus: Optional[int] = None
        self._pending_focus: Dict[int, int] = {}   # member -> awaited source

    def add_member(self, idx: int, send: Callable[[bytes], None]):
        self.members[idx] = RouterMember(idx, send)

    def remove_member(self, idx: int):
        self.members.pop(idx, None)
        if self.focus == idx:
            self.focus = None

    def set_focus(self, source_idx: int):
        """Active speaker changed (volume ranking or UI pin)."""
        if source_idx == self.focus:
            return
        for m in self.members.values():
            if m.idx != source_idx:
                self._pending_focus[m.idx] = source_idx
        self.request_keyframe(source_idx)

    def route(self, from_idx: int, pkt: RtpPacket, is_keyframe_start: bool):
        for m in self.members.values():
            if m.idx == from_idx or not m.active:
                continue
            awaited = self._pending_focus.get(m.idx)
            if awaited == from_idx and is_keyframe_start:
                del self._pending_focus[m.idx]
                m.current_source = from_idx
            elif awaited is not None and m.current_source != from_idx:
                continue                     # still waiting for keyframe
            elif m.current_source is None:
                m.current_source = from_idx
            if m.current_source != from_idx:
                continue
            # seq/ts continuity rewrite across switches
            if m.last_in_seq is not None and from_idx != m.last_src:
                m.ts_offset = pkt.timestamp   # restart ts base on switch
            m.last_src = from_idx
            out = RtpPacket(pkt.payload_type, m.out_seq,
                            pkt.timestamp, pkt.ssrc, pkt.payload, pkt.marker)
            m.out_seq = (m.out_seq + 1) & 0xFFFF
            m.last_in_seq = pkt.seq
            m.send(out.pack())
