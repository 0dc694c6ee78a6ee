"""Audio conferencing control plane (port of
``mediastreamer2_tpu/models/conference.py``; MSAudioConference parity).

The deployment-wide ``conf_mixer`` mixes every conference of the batch at
once; this class allocates legs to conferences, keeps the mixer's
``group_id`` / ``active`` params in sync, and reports active talkers and
levels from the device-computed energies. Adding or removing a member is a
params update: no graph surgery, no 50-member cap.

``_sync`` writes ``group_id`` and ``active`` as new tensors on the
ticker's device, on its stream (``Ticker.tensor``); membership from this
class is not a uniform contiguous layout, so the mixer takes its one-hot
[B, B] segment-sum branch. The level readers wait for the ticker's stream
before reading (``Ticker.host``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

ACTIVE_TALKER_DB = -30.0    # parity: audioconference.c:31


class AudioConferenceControl:
    """Manages conference membership over a conf_mixer node's params, for
    any Ticker whose graph holds a 'conf_mixer' node."""

    def __init__(self, ticker, mixer_node: str = "conf",
                 levels_node: Optional[str] = "levels"):
        self.ticker = ticker
        self.node = mixer_node
        self.levels_node = levels_node
        self.batch = ticker.graph.batch
        self.membership: List[Optional[int]] = [None] * self.batch
        self._free_group = 0
        self._sync()

    # -- reference API surface ------------------------------------------
    def new_conference(self) -> int:
        gid = self._free_group
        self._free_group += 1
        return gid

    def add_member(self, leg: int, conf_id: int):
        """cf. ms_audio_conference_add_member -- here a params update."""
        self.membership[leg] = conf_id
        self._sync()

    def remove_member(self, leg: int):
        self.membership[leg] = None
        self._sync()

    def mute_member(self, leg: int, muted: bool = True):
        p = self.ticker.params[self.node]
        active = self.ticker.host(p["active"]).copy()
        active[leg] = not muted
        p["active"] = self.ticker.tensor(active)

    def member_count(self, conf_id: int) -> int:
        return sum(1 for m in self.membership if m == conf_id)

    def _sync(self):
        group = np.zeros(self.batch, np.int32)
        active = np.zeros(self.batch, bool)
        # parked legs get unique groups beyond the used conference ids
        parked_gid = max([m for m in self.membership if m is not None], default=-1) + 1
        for leg, conf in enumerate(self.membership):
            if conf is None:
                group[leg] = parked_gid
                parked_gid = min(parked_gid + 1, self.batch - 1)
            else:
                group[leg] = conf
                active[leg] = True
        p = self.ticker.params[self.node]
        p["group_id"] = self.ticker.tensor(group, torch.int32)
        p["active"] = self.ticker.tensor(active)

    def _energy(self) -> Optional[np.ndarray]:
        st = self.ticker.state
        if self.levels_node and self.levels_node in st:
            return self.ticker.host(st[self.levels_node]["energy"])
        if "vol_send" in st:
            return self.ticker.host(st["vol_send"]["energy"])
        return None

    # -- active talker detection (cf. conference talker events) ----------
    def active_talkers(self, threshold_db: float = ACTIVE_TALKER_DB) -> Dict[int, List[int]]:
        """conf_id -> legs currently above threshold, from the
        audio_levels (or volume) node's energy."""
        e = self._energy()
        if e is None:
            return {}
        db = 10 * np.log10(e + 1e-12)
        out: Dict[int, List[int]] = {}
        for leg, conf in enumerate(self.membership):
            if conf is not None and db[leg] > threshold_db:
                out.setdefault(conf, []).append(leg)
        return out

    def participant_volume(self, leg: int) -> int:
        """ms_audio_conference_get_participant_volume: the member's level in
        dBov (0 loudest .. -127 silence)."""
        e = self._energy()
        if e is None:
            return -127
        return int(np.clip(10 * np.log10(float(e[leg]) + 1e-12), -127, 0))

    def csrc_levels_for(self, leg: int, ssrc_map: Optional[Dict[int, int]] = None,
                        top_n: int = 15) -> List:
        """RFC 6465 feed for a mixed output leg: the other members of
        ``leg``'s conference, loudest first, as (ssrc, dBov) pairs. ssrc_map
        maps leg index -> RTP ssrc (default: the leg index)."""
        conf = self.membership[leg]
        if conf is None:
            return []
        e = self._energy()
        if e is None:
            return []
        members = [(m, float(e[m])) for m, c in enumerate(self.membership)
                   if c == conf and m != leg]
        members.sort(key=lambda t: -t[1])
        out = []
        for m, energy in members[:top_n]:
            dbov = int(min(127, max(0, -10 * np.log10(energy + 1e-13))))
            out.append(((ssrc_map or {}).get(m, m), dbov))
        return out
