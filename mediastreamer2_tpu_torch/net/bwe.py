"""Receive-side bandwidth estimators (a copy of
``mediastreamer2_tpu/net/bwe.py``: plain Python) -- oRTP's
OrtpVideoBandwidthEstimator / OrtpAudioBandwidthEstimator, which feed
MSBandwidthController's ``download_*_bandwidth_available_estimated``.

Principle: a multi-packet burst leaving the sender back-to-back arrives
spread out by the bottleneck's serialization rate, so
``bytes * 8 / (t_last - t_first)`` measures the *available* link bandwidth
even when nothing is lost and average throughput is far below it.

* Video frames are naturally multi-packet (same RTP timestamp, marker on
  the last) — `VideoBandwidthEstimator` measures every frame with enough
  packets and reports a trust-percentile over recent frames.
* Audio packets are small and paced, so the SENDER must create clusters:
  with the estimator enabled it periodically emits a duplicate of the
  previous packet glued to the next send (the receiver's jitter buffer
  drops the duplicate seq anyway); `AudioBandwidthEstimator` measures the
  duplicate pair's spacing.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class BweParams:
    """cf. OrtpVideoBandwidthEstimatorParams / OrtpAudioBandwidth...Params."""
    enabled: bool = True
    packet_count_min: int = 5        # frames with fewer packets don't count
    packets_history_size: int = 30   # measurements kept
    trust_percentage: int = 90       # report this percentile of history
    duplicate_every: int = 25        # audio: one duplicate per N packets


class VideoBandwidthEstimator:
    """Groups received packets by RTP timestamp (one video frame), measures
    burst rate per complete frame, reports a percentile over history."""

    def __init__(self, params: Optional[BweParams] = None):
        self.p = params or BweParams()
        self._cur_ts: Optional[int] = None
        self._first_t = 0.0
        self._last_t = 0.0
        self._bytes = 0
        self._count = 0
        self.measurements: List[float] = []
        self.frames_measured = 0

    def on_packet(self, recv_time: float, size_bytes: int, rtp_ts: int,
                  marker: bool):
        if rtp_ts != self._cur_ts:
            self._finalize()
            self._cur_ts = rtp_ts
            self._first_t = recv_time
            self._bytes = 0
            self._count = 0
        self._last_t = recv_time
        self._bytes += size_bytes
        self._count += 1
        if marker:                     # frame complete
            self._finalize()
            self._cur_ts = None

    def _finalize(self):
        if self._cur_ts is None or self._count < self.p.packet_count_min:
            return
        dt = self._last_t - self._first_t
        if dt <= 0:
            return
        self.measurements.append(self._bytes * 8.0 / dt)
        self.frames_measured += 1
        if len(self.measurements) > self.p.packets_history_size:
            self.measurements.pop(0)

    def available_bw_bps(self) -> float:
        """Trust-percentile of recent frame measurements (0 = no data)."""
        if not self.measurements:
            return 0.0
        s = sorted(self.measurements)
        idx = min(len(s) - 1, len(s) * self.p.trust_percentage // 100)
        return s[idx]


class AudioBandwidthEstimator:
    """Receiver half: a duplicate-seq packet arriving right after its
    original forms a 2-packet cluster whose spacing is one serialization
    time of the original packet."""

    def __init__(self, params: Optional[BweParams] = None):
        self.p = params or BweParams()
        self._last_seq: Optional[int] = None
        self._dup_t: Optional[float] = None
        self.measurements: List[float] = []
        self.duplicates_seen = 0

    def on_packet(self, recv_time: float, size_bytes: int, seq: int) -> bool:
        """Feed every received packet. Returns True if this packet was a
        measurement duplicate (callers skip jitter-buffer delivery).

        The sender glues the duplicate to the FOLLOWING packet (oRTP's
        cluster), so the measurement is the spacing between the duplicate
        and the packet after it — pure serialization time."""
        dup = self._last_seq is not None and seq == self._last_seq
        if dup:
            self.duplicates_seen += 1
            self._dup_t = recv_time
        else:
            if self._dup_t is not None:
                dt = recv_time - self._dup_t
                if dt > 0:
                    self.measurements.append(size_bytes * 8.0 / dt)
                    if len(self.measurements) > self.p.packets_history_size:
                        self.measurements.pop(0)
                self._dup_t = None
            self._last_seq = seq
        return dup

    def available_bw_bps(self) -> float:
        if not self.measurements:
            return 0.0
        s = sorted(self.measurements)
        idx = min(len(s) - 1, len(s) * self.p.trust_percentage // 100)
        return s[idx]
