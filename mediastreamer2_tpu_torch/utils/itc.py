"""Inter-ticker communication (ITC): cross-graph hand-off (a copy of
``mediastreamer2_tpu/utils/itc.py``, numpy and a lock).

Reference: src/otherfilters/itc.c (itc_source/itc_sink connect graphs that
run on different tickers; used e.g. to feed a recorder graph from a call
graph). Here graphs exchange fixed-shape tick blocks at the host boundary,
so an ITC link is a small thread-safe ring that the producing ticker's
``push`` writes and the consuming ticker's ``pull`` reads (one tick of
slack absorbs scheduling skew, like the reference's queue). Blocks cross
as numpy arrays: a ``Ticker`` hands its ``io_push`` numpy already, and a
tensor (on the card too) is brought to the host first."""
from __future__ import annotations

import collections
import threading
from typing import Deque

import numpy as np
import torch


def _host(block) -> np.ndarray:
    if isinstance(block, torch.Tensor):
        return block.detach().cpu().numpy()
    return np.asarray(block)


class ItcBridge:
    """One directed cross-ticker channel for one ext_sink -> ext_source."""

    def __init__(self, shape, dtype=np.float32, depth: int = 4):
        self.shape = tuple(shape)
        self.dtype = dtype
        self._q: Deque[np.ndarray] = collections.deque(maxlen=depth)
        self._lock = threading.Lock()
        self.overruns = 0
        self.underruns = 0

    def push(self, block):
        block = _host(block)
        with self._lock:
            if len(self._q) == self._q.maxlen:
                self.overruns += 1
            self._q.append(block)

    def pull(self) -> np.ndarray:
        with self._lock:
            if self._q:
                return self._q.popleft()
            self.underruns += 1
            return np.zeros(self.shape, self.dtype)

    # convenience wiring for Ticker.set_io handlers
    def as_push_io(self, sink_name: str):
        def push(tick, ext_out):
            self.push(ext_out[sink_name])
        return push

    def as_pull_io(self, source_name: str):
        def pull(tick):
            return {source_name: self.pull()}
        return pull
