"""Adaptive playout depth for the native batched RTP edge (port of
``BatchEdgeJitterController`` from ``mediastreamer2_tpu/net/jitter.py``;
the per-packet ``JitterBuffer`` there, which needs ``net.rtp``, is not on
the port's path yet)."""
from __future__ import annotations


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
