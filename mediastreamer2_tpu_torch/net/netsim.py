"""Network simulator — fault injection for tests and soak runs (a copy of
``mediastreamer2_tpu/net/netsim.py``: plain Python).

Reference: oRTP's network simulator (`rtp_session_enable_network_simulation`
with loss %, bandwidth caps, latency, jitter), used pervasively by the
reference testers (e.g. tester/mediastreamer2_audio_stream_tester.c:731,
…_video_stream_tester.c:243).  Same parameter surface here, applied to any
Transport (loopback or UDP) by shaping the outgoing packet list.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Tuple


@dataclasses.dataclass
class NetSimParams:
    """cf. OrtpNetworkSimulatorParams."""
    enabled: bool = True
    loss_rate: float = 0.0           # percent 0..100
    consecutive_loss_probability: float = 0.0
    max_bandwidth_bps: float = 0.0   # 0 = unlimited
    latency_ms: int = 0
    jitter_strength_ms: float = 0.0  # uniform extra delay
    max_buffer_size_bytes: int = 256 * 1024
    seed: int = 0


class NetworkSimulator:
    def __init__(self, params: NetSimParams):
        self.p = params
        self.rng = random.Random(params.seed)
        self._in_burst = False
        self._bw_budget_time = 0.0   # token-bucket style next-free-time

    def shape(self, now: float, data: bytes) -> List[Tuple[float, bytes]]:
        """Return [(deliver_time, packet)] — possibly empty (loss/overflow)."""
        if not self.p.enabled:
            return [(now, data)]
        # loss (with burstiness, cf. consecutive_loss_probability)
        if self._in_burst:
            if self.rng.random() < self.p.consecutive_loss_probability:
                return []
            self._in_burst = False
        if self.rng.random() * 100.0 < self.p.loss_rate:
            self._in_burst = self.p.consecutive_loss_probability > 0
            return []
        deliver = now + self.p.latency_ms / 1e3
        if self.p.jitter_strength_ms > 0:
            deliver += self.rng.random() * self.p.jitter_strength_ms / 1e3
        if self.p.max_bandwidth_bps > 0:
            tx_time = len(data) * 8.0 / self.p.max_bandwidth_bps
            start = max(deliver, self._bw_budget_time)
            if start - now > self.p.max_buffer_size_bytes * 8.0 / self.p.max_bandwidth_bps:
                return []            # queue overflow -> drop
            self._bw_budget_time = start + tx_time
            deliver = start + tx_time
        return [(deliver, data)]
