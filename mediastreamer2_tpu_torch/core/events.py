"""Host-side event queue — MSEventQueue equivalent (a copy of
``mediastreamer2_tpu/core/events.py``, numpy only).

Reference: src/base/eventqueue.c packs (filter, event-id, <=255B arg) into a
1024-slot mblk ring drained by ``ms_event_queue_pump`` on the app thread.
Here, device filters emit per-leg event *tensors* each step (e.g. VAD flags,
tone hits, EOF); the Ticker copies them host-side and this queue converts
nonzero entries into discrete events the app pumps.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Deque, Dict, Optional

import numpy as np

MAX_EVENTS = 1024  # parity with reference eventqueue.c:24-26


@dataclasses.dataclass(frozen=True)
class Event:
    source: str        # "node.event_name"
    leg: int           # which batch row fired
    value: Any
    tick: int


class EventQueue:
    def __init__(self, max_events: int = MAX_EVENTS):
        self._q: Deque[Event] = collections.deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._handlers: Dict[str, Callable[[Event], None]] = {}

    def post_tensor_events(self, events: Dict[str, Any], tick: int):
        """Convert per-leg event tensors into queued discrete events.

        An event fires for leg i when the tensor value is nonzero/True.
        """
        with self._lock:
            for name, arr in events.items():
                a = np.asarray(arr)
                if a.ndim == 0:
                    if a:
                        self._q.append(Event(name, -1, a.item(), tick))
                    continue
                flat = a.reshape(a.shape[0], -1)
                fired = np.any(flat != 0, axis=-1)
                for leg in np.nonzero(fired)[0]:
                    self._q.append(Event(name, int(leg), flat[leg] if flat.shape[1] > 1
                                         else flat[leg, 0].item(), tick))

    def set_handler(self, source: str, fn: Callable[[Event], None]):
        self._handlers[source] = fn

    def pump(self, max_n: Optional[int] = None) -> int:
        """cf. ms_event_queue_pump — run handlers on the app thread."""
        n = 0
        while self._q and (max_n is None or n < max_n):
            with self._lock:
                if not self._q:
                    break
                ev = self._q.popleft()
            h = self._handlers.get(ev.source)
            if h:
                h(ev)
            n += 1
        return n

    def drain(self):
        with self._lock:
            evs = list(self._q)
            self._q.clear()
        return evs

    def __len__(self):
        return len(self._q)
