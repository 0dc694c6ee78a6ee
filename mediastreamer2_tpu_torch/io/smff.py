"""SMFF — Simple Multimedia File Format, wire-compatible with the
reference's in-house container (src/videofilters/smff/smff.cpp); a copy
of ``mediastreamer2_tpu/io/smff.py``, the standard library only.

Layout (smff.cpp:33-52):
  SMFFRoot   : magic 'SMFF' | u32 version(0) | u32 trackPosition(BE) |
               u32 dataPosition(BE)                            (16 bytes)
  data part  : raw record payloads back-to-back, from dataPosition
  track part : at trackPosition, ONE zlib deflate stream
               (FileWriter::close smff.cpp:252-266) containing per track:
    SMFFTrackDescriptor: char codecName[16] | u8 type(0=audio,1=video) |
               u8 channels | u8 trackID | u8 unused |
               u32 clockrate(BE) | u32 recordsCount(BE)        (28 bytes)
    then recordsCount × SMFFRecord:
               u32 timestamp(BE, track clock units) |
               u32 position(BE, relative to dataPosition) | u32 size(BE)

Record timestamps are in the track's clock-rate units (TrackWriter::
toAbsoluteTimestamp smff.cpp:79); the reader API below converts to ms.
The descriptor carries no video geometry or keyframe flags — decoders
take dimensions from the bitstream, exactly like the reference player.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Iterator, List

MAGIC = b"SMFF"
KIND_AUDIO, KIND_VIDEO = 0, 1          # TrackInterface::MediaType

_ROOT = struct.Struct("!4sIII")        # magic, version, trackPos, dataPos
_TRACK = struct.Struct("!16sBBBBII")   # codec, type, ch, id, pad, rate, nrec
_REC = struct.Struct("!III")           # timestamp, position, size

VIDEO_CLOCK = 90000                    # RTP video clock (recorder.cpp fmt)


@dataclasses.dataclass
class SmffTrack:
    kind: int
    codec: str
    a: int = 0          # audio: sample rate; video: width hint (not stored)
    b: int = 0          # audio: channels;   video: height hint (not stored)


def _track_clock(t: SmffTrack) -> int:
    """Wire clock for a track: audio uses its sample rate; video always
    uses the 90 kHz RTP clock (like the reference recorder's fmt->rate)."""
    if t.kind == KIND_VIDEO:
        return VIDEO_CLOCK
    return t.a or 48000


@dataclasses.dataclass
class SmffFrame:
    track: int
    ts_ms: int
    data: bytes
    keyframe: bool = True


class SmffWriter:
    def __init__(self, path: str, tracks: List[SmffTrack]):
        self.f = open(path, "wb")
        self.tracks = list(tracks)
        self._rates = [_track_clock(t) for t in tracks]
        self._records: List[List[tuple]] = [[] for _ in tracks]
        self._data_start = _ROOT.size
        self._pos = _ROOT.size
        self.f.write(b"\x00" * _ROOT.size)      # placeholder root

    def write_frame(self, track: int, ts_ms: int, data: bytes,
                    keyframe: bool = True):
        # keyframe is bitstream-derivable; SMFF stores no flag for it
        ts = (ts_ms * self._rates[track]) // 1000
        self._records[track].append((ts, self._pos - self._data_start,
                                     len(data)))
        self.f.write(data)
        self._pos += len(data)

    def close(self):
        track_pos = self._pos
        z = zlib.compressobj()
        out = bytearray()
        for tid, (t, recs) in enumerate(zip(self.tracks, self._records)):
            out += z.compress(_TRACK.pack(t.codec.encode()[:15], t.kind,
                                          t.b if t.kind == KIND_AUDIO else 0,
                                          tid, 0, self._rates[tid],
                                          len(recs)))
            for ts, pos, size in recs:
                out += z.compress(_REC.pack(ts, pos, size))
        out += z.flush()
        self.f.write(bytes(out))
        self.f.seek(0)
        self.f.write(_ROOT.pack(MAGIC, 0, track_pos, self._data_start))
        self.f.close()


class SmffReader:
    def __init__(self, path: str):
        self.f = open(path, "rb")
        root = self.f.read(_ROOT.size)
        if len(root) < _ROOT.size:
            raise ValueError("truncated SMFF root")
        magic, _version, track_pos, data_pos = _ROOT.unpack(root)
        if magic != MAGIC:
            raise ValueError("not an SMFF file")
        self.f.seek(0, 2)
        file_size = self.f.tell()
        if track_pos > file_size or data_pos > file_size:
            raise ValueError("SMFF segment beyond end of file")
        self._data_start = data_pos
        self._data_end = track_pos
        self.f.seek(track_pos)
        try:
            section = zlib.decompress(self.f.read())
        except zlib.error as e:
            raise ValueError(f"bad SMFF track section: {e}") from None
        self.tracks: List[SmffTrack] = []
        self._rates: List[int] = []
        self._records: List[List[tuple]] = []
        off = 0
        while off + _TRACK.size <= len(section):
            codec, kind, ch, _tid, _pad, rate, nrec = _TRACK.unpack_from(
                section, off)
            off += _TRACK.size
            if off + nrec * _REC.size > len(section):
                raise ValueError("truncated SMFF record table")
            recs = []
            for _ in range(nrec):
                ts, pos, size = _REC.unpack_from(section, off)
                off += _REC.size
                if data_pos + pos + size > self._data_end:
                    raise ValueError("SMFF record outside data segment")
                recs.append((ts, pos, size))
            codec_s = codec.split(b"\x00")[0].decode(errors="replace")
            if kind == KIND_AUDIO:
                self.tracks.append(SmffTrack(kind, codec_s, rate, ch))
            else:
                self.tracks.append(SmffTrack(kind, codec_s, 0, 0))
            self._rates.append(rate or 48000)
            self._records.append(recs)

    def frames(self, from_ms: int = 0) -> Iterator[SmffFrame]:
        # merge tracks back into file (data-part) order
        merged = [(pos, tidx, ts, size)
                  for tidx, recs in enumerate(self._records)
                  for ts, pos, size in recs]
        merged.sort()
        for pos, tidx, ts, size in merged:
            ts_ms = (ts * 1000) // self._rates[tidx]
            if ts_ms < from_ms:
                continue
            self.f.seek(self._data_start + pos)
            yield SmffFrame(tidx, ts_ms, self.f.read(size))

    def duration_ms(self, track: int = 0) -> int:
        """TrackReader::getDurationMs parity (smff.cpp:436-439)."""
        recs = self._records[track]
        if not recs:
            return 0
        return (recs[-1][0] * 1000) // self._rates[track]
