"""Matroska (MKV/WebM) muxer + demuxer — host-side container I/O (a copy
of ``mediastreamer2_tpu/io/mkv.py``, the standard library only; the
writer's default ``writing_app`` stays the JAX package's name, so both
packages write the same bytes).

Reference: MSMKVRecorder/MSMKVPlayer (src/videofilters/mkv.cpp, 2,888 LoC on
libmatroska-c, + utils/mkv_reader.cpp).  Scope: the subset the reference's
recorder actually writes — EBML header, Segment/Info/Tracks, clustered
SimpleBlocks with relative timestamps — for Opus audio and VP8 video tracks
(WebM-compatible), plus a demuxer that reads our own files and
libmatroska-style output (known top-level paths, unknown elements skipped).
Seek without cues = linear cluster scan (parity: mkv.cpp seek w/o cues).
"""
from __future__ import annotations

import dataclasses
import io
import struct
from typing import Dict, Iterator, List, Optional

# EBML element IDs (with marker bits, as written on the wire)
EBML_HEADER = 0x1A45DFA3
SEGMENT = 0x18538067
SEG_INFO = 0x1549A966
TIMECODE_SCALE = 0x2AD7B1
MUX_APP = 0x4D80
WRITE_APP = 0x5741
DURATION = 0x4489
TRACKS = 0x1654AE6B
TRACK_ENTRY = 0xAE
TRACK_NUMBER = 0xD7
TRACK_UID = 0x73C5
TRACK_TYPE = 0x83
CODEC_ID = 0x86
CODEC_PRIVATE = 0x63A2
T_AUDIO = 0xE1
A_SAMPLING = 0xB5
A_CHANNELS = 0x9F
T_VIDEO = 0xE0
V_PIXEL_W = 0xB0
V_PIXEL_H = 0xBA
CLUSTER = 0x1F43B675
CLU_TIMECODE = 0xE7
SIMPLE_BLOCK = 0xA3
DOC_TYPE = 0x4282
EBML_VERSION = 0x4286

TRACK_TYPE_VIDEO = 1
TRACK_TYPE_AUDIO = 2


def _id_bytes(eid: int) -> bytes:
    n = (eid.bit_length() + 7) // 8
    return eid.to_bytes(n, "big")


def _size_bytes(size: int) -> bytes:
    """EBML variable-size integer (1-8 bytes)."""
    for n in range(1, 9):
        if size < (1 << (7 * n)) - 1:
            return ((1 << (7 * n)) | size).to_bytes(n, "big")
    raise ValueError("size too large")


def _elem(eid: int, payload: bytes) -> bytes:
    return _id_bytes(eid) + _size_bytes(len(payload)) + payload


def _uint(eid: int, v: int) -> bytes:
    n = max(1, (v.bit_length() + 7) // 8)
    return _elem(eid, v.to_bytes(n, "big"))


def _float(eid: int, v: float) -> bytes:
    return _elem(eid, struct.pack(">d", v))


def _string(eid: int, s: str) -> bytes:
    return _elem(eid, s.encode())


@dataclasses.dataclass
class MkvTrack:
    number: int
    type: int                   # TRACK_TYPE_AUDIO/VIDEO
    codec_id: str               # "A_OPUS", "V_VP8", "A_PCM/INT/LIT"...
    sampling_rate: float = 0.0
    channels: int = 0
    width: int = 0
    height: int = 0
    codec_private: bytes = b""


class MkvWriter:
    """Clustered muxer; one cluster per second (like the reference)."""

    CLUSTER_MS = 1000

    def __init__(self, path: str, tracks: List[MkvTrack],
                 writing_app: str = "mediastreamer2_tpu"):
        self.f = open(path, "wb")
        self.tracks = tracks
        self._cluster_buf = io.BytesIO()
        self._cluster_tc: Optional[int] = None
        self._max_ts = 0
        hdr = _elem(EBML_HEADER,
                    _uint(EBML_VERSION, 1) + _string(DOC_TYPE, "matroska"))
        self.f.write(hdr)
        # segment with unknown size (streaming-friendly, like live recording)
        self.f.write(_id_bytes(SEGMENT) + b"\x01\xff\xff\xff\xff\xff\xff\xff")
        info = (_uint(TIMECODE_SCALE, 1_000_000)         # 1 ms ticks
                + _string(MUX_APP, writing_app)
                + _string(WRITE_APP, writing_app))
        self.f.write(_elem(SEG_INFO, info))
        tr = b""
        for t in tracks:
            entry = (_uint(TRACK_NUMBER, t.number) + _uint(TRACK_UID, t.number)
                     + _uint(TRACK_TYPE, t.type) + _string(CODEC_ID, t.codec_id))
            if t.codec_private:
                entry += _elem(CODEC_PRIVATE, t.codec_private)
            if t.type == TRACK_TYPE_AUDIO:
                entry += _elem(T_AUDIO, _float(A_SAMPLING, t.sampling_rate)
                               + _uint(A_CHANNELS, t.channels))
            else:
                entry += _elem(T_VIDEO, _uint(V_PIXEL_W, t.width)
                               + _uint(V_PIXEL_H, t.height))
            tr += _elem(TRACK_ENTRY, entry)
        self.f.write(_elem(TRACKS, tr))

    def write_frame(self, track: int, ts_ms: int, data: bytes,
                    keyframe: bool = True):
        self._max_ts = max(self._max_ts, ts_ms)
        if (self._cluster_tc is None
                or ts_ms - self._cluster_tc >= self.CLUSTER_MS):
            self._flush_cluster()
            self._cluster_tc = ts_ms
            self._cluster_buf.write(_uint(CLU_TIMECODE, ts_ms))
        rel = ts_ms - self._cluster_tc
        blk = (_size_bytes(track)            # track number as vint
               + struct.pack(">h", rel)
               + bytes([0x80 if keyframe else 0x00])
               + data)
        self._cluster_buf.write(_elem(SIMPLE_BLOCK, blk))

    def _flush_cluster(self):
        buf = self._cluster_buf.getvalue()
        if buf:
            self.f.write(_elem(CLUSTER, buf))
        self._cluster_buf = io.BytesIO()

    def close(self):
        self._flush_cluster()
        self.f.close()


# ------------------------------------------------------------------ reader
def _read_id(f) -> Optional[int]:
    b0 = f.read(1)
    if not b0:
        return None
    v = b0[0]
    if v == 0:
        return None
    n = 8 - v.bit_length() + 1
    rest = f.read(n - 1)
    return int.from_bytes(b0 + rest, "big")


def _read_size(f) -> Optional[int]:
    b0 = f.read(1)
    if not b0:
        return None
    v = b0[0]
    if v == 0:
        return None
    n = 8 - v.bit_length() + 1
    rest = f.read(n - 1)
    raw = int.from_bytes(b0 + rest, "big")
    mask = 1 << (7 * n)
    size = raw & (mask - 1)
    if size == mask - 1:
        return -1              # unknown size
    return size


@dataclasses.dataclass
class MkvFrame:
    track: int
    ts_ms: int
    data: bytes
    keyframe: bool


class MkvReader:
    """Demuxer: tracks + frame iterator; linear seek (no cues)."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        self.tracks: Dict[int, MkvTrack] = {}
        self.timecode_scale = 1_000_000
        self._frames_start = None
        self._parse_headers()

    def _parse_headers(self):
        f = self.f
        while True:
            pos = f.tell()
            eid = _read_id(f)
            if eid is None:
                break
            size = _read_size(f)
            if eid == SEGMENT:
                continue                    # descend (unknown size ok)
            if eid == SEG_INFO:
                self._parse_info(f.read(size))
            elif eid == TRACKS:
                self._parse_tracks(f.read(size))
            elif eid == CLUSTER:
                f.seek(pos)
                self._frames_start = pos
                return
            else:
                if size in (-1, None):
                    break
                f.seek(size, 1)

    def _parse_info(self, data: bytes):
        for eid, payload in _iter_elems(data):
            if eid == TIMECODE_SCALE:
                self.timecode_scale = int.from_bytes(payload, "big")

    def _parse_tracks(self, data: bytes):
        for eid, payload in _iter_elems(data):
            if eid != TRACK_ENTRY:
                continue
            t = MkvTrack(0, 0, "")
            for e2, p2 in _iter_elems(payload):
                if e2 == TRACK_NUMBER:
                    t.number = int.from_bytes(p2, "big")
                elif e2 == TRACK_TYPE:
                    t.type = int.from_bytes(p2, "big")
                elif e2 == CODEC_ID:
                    t.codec_id = p2.decode()
                elif e2 == CODEC_PRIVATE:
                    t.codec_private = p2
                elif e2 == T_AUDIO:
                    for e3, p3 in _iter_elems(p2):
                        if e3 == A_SAMPLING:
                            t.sampling_rate = struct.unpack(
                                ">d" if len(p3) == 8 else ">f", p3)[0]
                        elif e3 == A_CHANNELS:
                            t.channels = int.from_bytes(p3, "big")
                elif e2 == T_VIDEO:
                    for e3, p3 in _iter_elems(p2):
                        if e3 == V_PIXEL_W:
                            t.width = int.from_bytes(p3, "big")
                        elif e3 == V_PIXEL_H:
                            t.height = int.from_bytes(p3, "big")
            self.tracks[t.number] = t

    def frames(self, from_ms: int = 0) -> Iterator[MkvFrame]:
        """Linear scan of clusters (seek without cues, cf. mkv.cpp:2327)."""
        f = self.f
        f.seek(self._frames_start)
        while True:
            eid = _read_id(f)
            if eid is None:
                return
            size = _read_size(f)
            if eid != CLUSTER:
                if size in (-1, None):
                    return
                f.seek(size, 1)
                continue
            cluster = f.read(size)
            tc = 0
            for e2, p2 in _iter_elems(cluster):
                if e2 == CLU_TIMECODE:
                    tc = int.from_bytes(p2, "big")
                elif e2 == SIMPLE_BLOCK:
                    bio = io.BytesIO(p2)
                    track = _read_size(bio)      # track vint (values < 127)
                    rel = struct.unpack(">h", bio.read(2))[0]
                    flags = bio.read(1)[0]
                    ts = tc + rel
                    if ts >= from_ms:
                        yield MkvFrame(track, ts, bio.read(),
                                       bool(flags & 0x80))


def _iter_elems(data: bytes):
    bio = io.BytesIO(data)
    while True:
        eid = _read_id(bio)
        if eid is None:
            return
        size = _read_size(bio)
        if size is None or size < 0:
            return
        yield eid, bio.read(size)
