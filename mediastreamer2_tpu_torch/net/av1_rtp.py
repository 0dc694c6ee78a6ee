"""AV1 RTP payload format — OBU packetization (AOM AV1 RTP spec v1.0) (a copy of
``mediastreamer2_tpu/net/av1_rtp.py``: plain Python).

Reference: src/videofilters/av1/obu/ (obu packer/unpacker feeding the aom
encoder / dav1d decoder filters).  A temporal unit is split into OBUs;
temporal-delimiter OBUs are removed and size fields stripped (lengths ride
as LEB128 element prefixes); each payload starts with the aggregation
header  |Z|Y|W(2)|N|-(3)| :

  Z  first OBU element continues a fragment from the previous packet
  Y  last OBU element continues into the next packet
  W  number of elements (0 => every element carries a length prefix)
  N  first packet of a new coded video sequence (keyframes)

The depacketizer reassembles OBUs across fragments and re-serializes them
with explicit size fields, which is what libaom/dav1d expect from a raw
stream.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

OBU_TEMPORAL_DELIMITER = 2


def leb128_encode(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def leb128_decode(data: bytes, off: int = 0) -> Tuple[int, int]:
    """Returns (value, bytes_consumed_offset_after)."""
    v = 0
    shift = 0
    while off < len(data):
        b = data[off]
        off += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, off
        shift += 7
    raise ValueError("truncated leb128")


def split_obus(tu: bytes) -> List[bytes]:
    """Split a temporal unit into OBUs (headers + payload, size stripped)."""
    out = []
    off = 0
    n = len(tu)
    while off < n:
        hdr = tu[off]
        if hdr & 0x80:
            raise ValueError("forbidden bit set")
        has_ext = bool(hdr & 0x04)
        has_size = bool(hdr & 0x02)
        head_len = 2 if has_ext else 1
        if has_size:
            size, body_off = leb128_decode(tu, off + head_len)
            body = tu[body_off: body_off + size]
            nxt = body_off + size
        else:
            body = tu[off + head_len:]
            nxt = n
        # re-emit with has_size=0 (RTP carries lengths itself)
        out.append(bytes([hdr & ~0x02]) + tu[off + 1: off + head_len] + body)
        off = nxt
    return out


def join_obus(obus: List[bytes]) -> bytes:
    """Re-serialize OBUs with explicit size fields (decoder-ready TU)."""
    out = bytearray()
    for obu in obus:
        if not obu:
            continue
        hdr = obu[0]
        head_len = 2 if hdr & 0x04 else 1
        body = obu[head_len:]
        out.append(hdr | 0x02)
        out += obu[1:head_len]
        out += leb128_encode(len(body))
        out += body
    return bytes(out)


def obu_type(obu: bytes) -> int:
    return (obu[0] >> 3) & 0x0F if obu else -1


def packetize(tu: bytes, mtu: int = 1200,
              new_sequence: bool = False) -> List[bytes]:
    """Temporal unit -> RTP payloads."""
    obus = [o for o in split_obus(tu) if obu_type(o) != OBU_TEMPORAL_DELIMITER]
    payloads: List[bytes] = []
    cur = bytearray()
    cur_z = False

    def flush(y: bool):
        nonlocal cur, cur_z
        if not cur:
            return
        agg = (0x80 if cur_z else 0) | (0x40 if y else 0) | \
            (0x08 if (new_sequence and not payloads) else 0)
        payloads.append(bytes([agg]) + bytes(cur))
        cur = bytearray()
        cur_z = False

    budget = mtu - 1
    for obu in obus:
        pos = 0
        first_frag = True
        while True:
            remaining = len(obu) - pos
            space = budget - len(cur) - len(leb128_encode(remaining))
            if remaining <= space:
                cur += leb128_encode(remaining) + obu[pos:]
                break
            # fragment: fill this packet, continue in the next (Y/Z bits)
            if space < 16 and cur:          # too little room: flush first
                flush(y=False)
                continue
            take = max(space, 1)
            cur += leb128_encode(take) + obu[pos: pos + take]
            pos += take
            flush(y=True)
            cur_z = True
            first_frag = False
        if len(cur) >= budget - 4:
            flush(y=False)
    flush(y=False)
    return payloads


class Depacketizer:
    """Reassembles temporal units from AV1 RTP payloads (one TU per
    marker-delimited packet run; caller feeds payloads in seq order)."""

    def __init__(self):
        self._obus: List[bytes] = []
        self._frag: Optional[bytearray] = None
        self.errors = 0

    def push(self, payload: bytes):
        if not payload:
            return
        agg = payload[0]
        z, y = bool(agg & 0x80), bool(agg & 0x40)
        w = (agg >> 4) & 0x03
        off = 1
        elems: List[bytes] = []
        idx = 0
        while off < len(payload):
            if w and idx == w - 1:
                elems.append(payload[off:])
                off = len(payload)
            else:
                try:
                    ln, off = leb128_decode(payload, off)
                except ValueError:
                    self.errors += 1
                    return
                elems.append(payload[off: off + ln])
                off += ln
            idx += 1
        for i, el in enumerate(elems):
            first, last = i == 0, i == len(elems) - 1
            if first and z:
                if self._frag is None:
                    self.errors += 1     # lost the start fragment
                    continue
                self._frag += el
                if last and y:
                    return
                self._obus.append(bytes(self._frag))
                self._frag = None
                continue
            if last and y:
                self._frag = bytearray(el)
            else:
                self._obus.append(el)

    def pop_tu(self) -> Optional[bytes]:
        """Call at the marker packet: returns the decoder-ready TU."""
        if not self._obus:
            return None
        obus, self._obus = self._obus, []
        return join_obus(obus)
