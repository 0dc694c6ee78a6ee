"""QoS and adaptation (a copy of ``mediastreamer2_tpu/models/qos.py``:
plain Python): bitrate control, bandwidth control, the quality indicator,
one instance per leg, driven from ``AudioStreamBatch.iterate()``.

Reference mapping:
* MSQosAnalyzer simple/stateful (src/voip/qosanalyzer.c): loss/RTT/jitter ->
  actions {DoNothing, DecreaseBitrate, DecreasePacketRate, IncreaseQuality}
* MSBitrateDriver (src/voip/bitratedriver.c): applies actions to encoder
  bitrate / ptime ladders
* MSBitrateController (src/voip/bitratecontrol.c): the glue
* MSBandwidthController (src/voip/bandwidthcontroller.c): cross-stream
  download congestion -> TMMBR/REMB emission
* MSQualityIndicator (src/voip/qualityindicator.c): MOS-like 0-5 rating
* MSIFrameRequestsLimiter (msiframerequestslimiter.c), VideoStarter
  (videostarter.c)
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

# ---------------------------------------------------------------- analyzer
ACTION_NOTHING = "nothing"
ACTION_DECREASE_BITRATE = "decrease_bitrate"
ACTION_DECREASE_PACKET_RATE = "decrease_packet_rate"
ACTION_INCREASE_QUALITY = "increase_quality"


@dataclasses.dataclass
class QosStats:
    loss_rate: float = 0.0        # fraction 0..1 over last interval
    rtt_ms: float = 0.0
    jitter_ms: float = 0.0
    bandwidth_bps: float = 0.0


class SimpleQosAnalyzer:
    """Parity with the 'Simple' analyzer: thresholds on loss/RTT."""
    LOSS_HIGH = 0.10
    LOSS_MED = 0.03
    RTT_HIGH_MS = 800

    def __init__(self):
        self.history: List[QosStats] = []

    def analyze(self, s: QosStats) -> str:
        self.history.append(s)
        if s.loss_rate >= self.LOSS_HIGH or s.rtt_ms > self.RTT_HIGH_MS:
            return ACTION_DECREASE_BITRATE
        if s.loss_rate >= self.LOSS_MED:
            return ACTION_DECREASE_PACKET_RATE
        recent = self.history[-4:]
        if len(recent) >= 4 and all(r.loss_rate < 0.01 for r in recent):
            return ACTION_INCREASE_QUALITY
        return ACTION_NOTHING


class StatefulQosAnalyzer(SimpleQosAnalyzer):
    """Burst-aware variant (reference 'stateful' analyzer): separates
    congestion loss (correlated, rising jitter) from random loss."""

    def analyze(self, s: QosStats) -> str:
        self.history.append(s)
        if len(self.history) >= 2:
            djit = s.jitter_ms - self.history[-2].jitter_ms
            if s.loss_rate >= self.LOSS_MED and djit > 5.0:
                return ACTION_DECREASE_BITRATE       # congestion signature
        if s.loss_rate >= self.LOSS_HIGH:
            return ACTION_DECREASE_PACKET_RATE       # random loss: bigger pkts
        recent = self.history[-6:]
        if len(recent) >= 6 and all(r.loss_rate < 0.01 for r in recent):
            return ACTION_INCREASE_QUALITY
        return ACTION_NOTHING


# ---------------------------------------------------------------- driver
class AudioBitrateDriver:
    """Applies actions to an audio encoder config (bitrate+ptime ladder),
    parity with bitratedriver.c's audio driver."""
    PTIMES = [20, 40, 60, 80, 100]

    def __init__(self, set_bitrate, set_ptime, nominal_bps: int = 64000):
        self.set_bitrate = set_bitrate
        self.set_ptime = set_ptime
        self.bps = nominal_bps
        self.nominal = nominal_bps
        self.ptime_idx = 0

    def apply(self, action: str):
        if action == ACTION_DECREASE_BITRATE:
            self.bps = max(int(self.bps * 0.7), 8000)
            self.set_bitrate(self.bps)
        elif action == ACTION_DECREASE_PACKET_RATE:
            if self.ptime_idx < len(self.PTIMES) - 1:
                self.ptime_idx += 1
                self.set_ptime(self.PTIMES[self.ptime_idx])
        elif action == ACTION_INCREASE_QUALITY:
            if self.bps < self.nominal:
                self.bps = min(int(self.bps * 1.15), self.nominal)
                self.set_bitrate(self.bps)
            elif self.ptime_idx > 0:
                self.ptime_idx -= 1
                self.set_ptime(self.PTIMES[self.ptime_idx])


class BitrateController:
    """MSBitrateController glue: analyzer + driver, call update() per
    RTCP interval (cf. ms_bitrate_controller_update from
    media_stream_iterate, mediastream.c:562)."""

    def __init__(self, analyzer, driver):
        self.analyzer = analyzer
        self.driver = driver
        self.last_action = ACTION_NOTHING

    def update(self, stats: QosStats):
        self.last_action = self.analyzer.analyze(stats)
        self.driver.apply(self.last_action)
        return self.last_action


# ------------------------------------------------------- bandwidth control
class BandwidthController:
    """Download-side congestion control across streams: estimate recv
    bandwidth, detect congestion, compute TMMBR/REMB target
    (cf. src/voip/bandwidthcontroller.c:30-160)."""

    def __init__(self, emit_feedback):
        self.emit_feedback = emit_feedback      # fn(bps)
        self.est_bps = 0.0
        self.congested = False
        self._window: List[float] = []
        # fed by the packet-cluster bandwidth estimators (net/bwe.py); the
        # reference's bandwidthcontroller reads the same figure from oRTP
        self.download_video_bandwidth_available_estimated = 0.0
        self.download_audio_bandwidth_available_estimated = 0.0

    def update_estimate(self, bps: float, kind: str = "video"):
        """Feed a VideoBandwidthEstimator/AudioBandwidthEstimator reading
        (rtp_session_get_*_bandwidth_estimator result)."""
        if kind == "video":
            self.download_video_bandwidth_available_estimated = bps
        else:
            self.download_audio_bandwidth_available_estimated = bps

    def _available(self) -> float:
        return max(self.download_video_bandwidth_available_estimated,
                   self.download_audio_bandwidth_available_estimated)

    def on_interval(self, recv_bytes: int, interval_s: float,
                    jitter_rising: bool, loss_rate: float):
        bps = recv_bytes * 8 / max(interval_s, 1e-3)
        self._window.append(bps)
        if len(self._window) > 10:
            self._window.pop(0)
        self.est_bps = 0.7 * self.est_bps + 0.3 * bps if self.est_bps else bps
        was = self.congested
        # a bandwidth edge shows as a receive-rate drop with delay growth
        # and often NO loss (the bottleneck buffers) — the reference's
        # detector keys on exactly that (bandwidthcontroller.c congestion
        # state from the oRTP video bandwidth estimator)
        med = sorted(self._window)[len(self._window) // 2]
        rate_drop = len(self._window) >= 5 and bps < 0.75 * med
        self.congested = (loss_rate > 0.05) \
            or (jitter_rising and (loss_rate > 0.01 or rate_drop))
        if self.congested:
            # prefer the cluster estimator's available-bandwidth figure
            # (the reference sends TMMBR at 0.7x the estimated bandwidth)
            base = self._available() or self.est_bps
            target = max(base * 0.7, 16000)
            self.emit_feedback(int(target))
        elif was and not self.congested:
            base = self._available()
            # congestion over: 0.9x the measured available bandwidth when
            # an estimator is feeding us, else open up the EWMA cap
            self.emit_feedback(int(base * 0.9 if base
                                   else self.est_bps * 1.5))


# ---------------------------------------------------------- quality (MOS)
class QualityIndicator:
    """MOS-like rating 0..5 from loss/RTT (parity: qualityindicator.c —
    same shape: rating degraded by loss and latency, EWMA over time)."""

    def __init__(self):
        self.rating = 5.0
        self.lq_rating = 5.0          # listening quality (ignores RTT)

    def update(self, s: QosStats) -> float:
        base = 5.0
        base -= min(4.5, 40.0 * s.loss_rate)                 # loss dominates
        if s.rtt_ms > 300:
            base -= min(1.5, (s.rtt_ms - 300) / 600)
        lq = 5.0 - min(4.5, 40.0 * s.loss_rate)
        self.rating = 0.7 * self.rating + 0.3 * max(0.0, base)
        self.lq_rating = 0.7 * self.lq_rating + 0.3 * max(0.0, lq)
        return self.rating


# -------------------------------------------------- video helper policies
class IFrameRequestLimiter:
    """Rate-limits FIR/PLI (cf. msiframerequestslimiter.c)."""

    def __init__(self, min_interval_s: float = 2.0):
        self.min_interval_s = min_interval_s
        self._last = float("-inf")       # first request always allowed

    def request_allowed(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        if now - self._last >= self.min_interval_s:
            self._last = now
            return True
        return False


class VideoStarter:
    """Decides when the first I-frame must be (re)requested
    (cf. videostarter.c: fire ~2 s after start if nothing decodable)."""

    def __init__(self, timeout_s: float = 2.0):
        self.timeout_s = timeout_s
        self.started_at: Optional[float] = None
        self.got_frame = False

    def activate(self, now: Optional[float] = None):
        self.started_at = time.monotonic() if now is None else now
        self.got_frame = False

    def on_frame_decoded(self):
        self.got_frame = True

    def need_iframe(self, now: Optional[float] = None) -> bool:
        if self.started_at is None or self.got_frame:
            return False
        now = time.monotonic() if now is None else now
        if now - self.started_at > self.timeout_s:
            self.started_at = now                 # re-arm
            return True
        return False
