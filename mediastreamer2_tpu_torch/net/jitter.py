"""Jitter buffers — host side (a copy of ``mediastreamer2_tpu/net/jitter.py``:
plain Python).

* ``JitterBuffer`` (with ``JBParams`` and the ``_Rls`` drift fit): the
  per-leg buffer of the ``RtpSession`` path. Once per tick it gives the
  next in-order payload or a loss, which the graph's PLC conceals.
  Algorithms: ``basic`` (prebuffer to the nominal depth, drop when
  persistently over-full) and ``rls`` (recursive-least-squares fit of
  arrival time against sequence number; the positive residual envelope
  sets the target depth each refresh window).
* ``BatchEdgeJitterController``: adaptive prefill for the native batched
  edge's jitter ring.
* ``replay_capture``: a pcap/pcapng capture through a ``JitterBuffer`` in
  capture time (``io/pcap.py`` reads it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from mediastreamer2_tpu_torch.net.rtp import RtpPacket


@dataclasses.dataclass
class JBParams:
    """cf. JBParameters (jitterbuffer tester :99-108)."""
    min_depth_ticks: int = 2          # 20 ms at 10 ms ticks
    nom_depth_ticks: int = 4
    max_depth_ticks: int = 100        # 1000 ms envelope
    adaptive: bool = True
    algorithm: str = "basic"          # "basic" | "rls"
    tick_ms: int = 10                 # playout slot duration
    refresh_ticks: int = 500          # cf. params.refresh_ms = 5000


class _Rls:
    """2-parameter RLS: y ≈ m*x + c with exponential forgetting."""

    def __init__(self, lam: float = 0.999):
        self.lam = lam
        self.m = 0.0
        self.c = 0.0
        self.p00 = 1e6
        self.p01 = 0.0
        self.p11 = 1e6
        self._init = False

    def update(self, x: float, y: float) -> float:
        if not self._init:
            self.c = y
            self.m = 0.0
            self._init = True
        e = y - (self.m * x + self.c)
        # K = P·[x,1] / (lam + [x,1]ᵀ P [x,1])
        px0 = self.p00 * x + self.p01
        px1 = self.p01 * x + self.p11
        denom = self.lam + x * px0 + px1
        k0 = px0 / denom
        k1 = px1 / denom
        self.m += k0 * e
        self.c += k1 * e
        # P = (P - K·[x,1]ᵀP) / lam
        self.p00 = (self.p00 - k0 * px0) / self.lam
        self.p01 = (self.p01 - k0 * px1) / self.lam
        self.p11 = (self.p11 - k1 * px1) / self.lam
        return e


class JitterBuffer:
    """Sequence-ordered payload buffer with per-tick pull.

    put(pkt, now): insert packet (by seq; `now` = arrival time in seconds
    feeds the RLS drift fit). get_tick(): pop the payload for the next
    playout slot, or None (=loss/underrun/stretch). Counters mirror oRTP
    stats (late ≈ outoftime, lost ≈ cum_packet_loss, discarded).
    """

    def __init__(self, params: Optional[JBParams] = None):
        self.p = params or JBParams()
        self.buf: Dict[int, RtpPacket] = {}
        self.next_seq: Optional[int] = None     # next seq to play
        self.late = 0
        self.lost = 0
        self.underruns = 0
        self.resyncs = 0
        self.discarded = 0
        self.stretched = 0                      # concealed growth ticks
        self._depth_target = self.p.nom_depth_ticks
        self._started = False
        self._fill_seen = 0
        self._slack = 0
        self._tick_count = 0
        # RLS drift fit over extended seq
        self._rls = _Rls()
        self._ext_base: Optional[int] = None
        self._ext_last = 0
        self._resid_max = 0.0

    # -- extended (unwrapped) sequence numbers ---------------------------
    def _ext_seq(self, seq: int) -> int:
        if self._ext_base is None:
            self._ext_base = seq
            self._ext_last = 0
            return 0
        last16 = (self._ext_base + self._ext_last) & 0xFFFF
        delta = (seq - last16) & 0xFFFF
        if delta >= 0x8000:
            delta -= 0x10000
        self._ext_last += delta
        return self._ext_last

    def put(self, pkt: RtpPacket, now: Optional[float] = None):
        if self.p.algorithm == "rls" and now is not None:
            x = float(self._ext_seq(pkt.seq))
            resid = self._rls.update(x, now)
            if resid > self._resid_max:
                self._resid_max = resid
        if self.next_seq is not None:
            behind = (self.next_seq - pkt.seq) & 0xFFFF
            if 0 < behind < 0x8000:
                self.late += 1          # too late to play (cf. outoftime)
                return
        self.buf[pkt.seq] = pkt
        if self.next_seq is None:
            self.next_seq = pkt.seq

    def depth(self) -> int:
        return len(self.buf)

    def _refresh_target(self):
        """RLS re-evaluation: positive residual envelope -> depth target."""
        packet_s = max(self._rls.m, 1e-4)       # fitted packet interval
        need = int(math.ceil(self._resid_max / packet_s)) + 1
        new_target = max(self.p.min_depth_ticks,
                         min(self.p.max_depth_ticks, need))
        if new_target > self._depth_target:
            self._slack += new_target - self._depth_target   # stretch
        self._depth_target = new_target
        self._resid_max *= 0.25                  # decay, don't forget spikes

    def get_tick(self) -> Optional[bytes]:
        """Pull payload for one tick; None means conceal this tick."""
        self._tick_count += 1
        if (self.p.adaptive and self.p.algorithm == "rls"
                and self._tick_count % self.p.refresh_ticks == 0):
            self._refresh_target()
        if self.next_seq is None:
            self.underruns += 1
            return None
        if not self._started:
            # prebuffer until target depth reached
            if len(self.buf) < self._depth_target:
                return None
            self._started = True
        if self._slack > 0:
            self._slack -= 1
            self.stretched += 1
            return None                          # playout stretch (growth)
        pkt = self.buf.pop(self.next_seq, None)
        if pkt is None:
            if not self.buf:
                self.underruns += 1
                return None
            # gap: declare the slot lost, move on (PLC conceals)
            self.lost += 1
            self.next_seq = (self.next_seq + 1) & 0xFFFF
            # resync if we've drifted far behind (e.g. after a burst loss)
            ahead = min(((s - self.next_seq) & 0xFFFF) for s in self.buf)
            if ahead > self.p.max_depth_ticks:
                self.next_seq = min(self.buf, key=lambda s: (s - self.next_seq) & 0xFFFF)
                self.resyncs += 1
            return None
        self.next_seq = (self.next_seq + 1) & 0xFFFF
        # over-full control: if persistently above target, drop one (latency)
        if self.p.adaptive and len(self.buf) > self._depth_target + 2:
            self._fill_seen += 1
            if self._fill_seen > 50:     # sustained over target
                drop = self.buf.pop(self.next_seq, None)
                if drop is not None:
                    self.next_seq = (self.next_seq + 1) & 0xFFFF
                    self.discarded += 1
                self._fill_seen = 0
        else:
            self._fill_seen = 0
        return pkt.payload

    def reset(self):
        """cf. jitter buffer reset on clock resync (msrtp.c recv)."""
        self.buf.clear()
        self.next_seq = None
        self._started = False
        self.resyncs += 1


def replay_capture(path: str, jb: JitterBuffer, payload_type=None,
                   tick_s: Optional[float] = None):
    """Replay a pcap/pcapng capture through a JitterBuffer in capture time
    (the reference's pcap_sender + receiver-stream harness,
    jitterbuffer_tester.c:86-122). Returns dict of counters."""
    from mediastreamer2_tpu_torch.io.pcap import read_capture
    pkts = []
    for cp in read_capture(path):
        try:
            p = RtpPacket.unpack(cp.udp_payload)
        except ValueError:
            continue
        if payload_type is not None and p.payload_type != payload_type:
            continue
        pkts.append((cp.ts, p))
    if not pkts:
        return {"recv": 0}
    if tick_s is None:
        # infer the packet interval from seq span over capture duration
        # (robust to bursty arrivals, unlike inter-arrival medians)
        span = (pkts[-1][1].seq - pkts[0][1].seq) & 0xFFFF
        if span:
            tick_s = (pkts[-1][0] - pkts[0][0]) / span
        else:
            tick_s = 0.02
    t = pkts[0][0]
    end = pkts[-1][0] + 10 * tick_s
    i = 0
    got = concealed = 0
    while t < end:
        while i < len(pkts) and pkts[i][0] <= t:
            jb.put(pkts[i][1], now=pkts[i][0])
            i += 1
        if jb.get_tick() is None:
            concealed += 1
        else:
            got += 1
        t += tick_s
    return {"recv": len(pkts), "played": got, "concealed": concealed,
            "late": jb.late, "lost": jb.lost, "underruns": jb.underruns,
            "discarded": jb.discarded, "stretched": jb.stretched,
            "depth_target": jb._depth_target}


class BatchEdgeJitterController:
    """Walks each leg's packet prefill of the native edge's jitter ring.

    The C ring is deliberately simple (fixed per-leg prefill, seq-keyed
    slots); adaptation stays here, applied through ``rx.set_prefill``. Per
    control pass it reads each leg's cumulative (lost, late) counters and
    moves the prefill

    * UP   by one packet after a pass with misses, up to ``max_prefill``;
    * DOWN by one after ``shrink_after`` consecutive clean passes, down to
      ``min_prefill``.

    ``set_prefill`` resyncs the leg (one refill gap), so shrinking is slow.
    """

    def __init__(self, rx, n_legs: int, min_prefill: int = 2,
                 max_prefill: int = 24, shrink_after: int = 10,
                 apply_initial: bool = True):
        """apply_initial=False when the ring is already primed at
        min_prefill: set_prefill always resyncs (one refill gap per leg),
        so re-applying an unchanged value costs N gaps for nothing."""
        self.rx = rx
        self.n = n_legs
        self.min_prefill = min_prefill
        self.max_prefill = max_prefill
        self.shrink_after = shrink_after
        self.prefill = [min_prefill] * n_legs
        self._last = [(0, 0) for _ in range(n_legs)]   # (lost, late)
        self._clean = [0] * n_legs
        if apply_initial:
            for i in range(n_legs):
                rx.set_prefill(i, min_prefill)

    def control(self) -> int:
        """Run one control pass; returns the number of legs adjusted."""
        changed = 0
        for i in range(self.n):
            st = self.rx.stats(i)
            lost, late = st["lost"], st["late"]
            d_lost = lost - self._last[i][0]
            d_late = late - self._last[i][1]
            self._last[i] = (lost, late)
            if d_lost + d_late > 0:
                self._clean[i] = 0
                if self.prefill[i] < self.max_prefill:
                    self.prefill[i] += 1
                    self.rx.set_prefill(i, self.prefill[i])
                    changed += 1
            else:
                self._clean[i] += 1
                if self._clean[i] >= self.shrink_after \
                        and self.prefill[i] > self.min_prefill:
                    self._clean[i] = 0
                    self.prefill[i] -= 1
                    self.rx.set_prefill(i, self.prefill[i])
                    changed += 1
        return changed
