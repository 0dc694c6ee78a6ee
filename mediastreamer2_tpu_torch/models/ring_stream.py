"""RingStream: ring-tone playback (port of
``mediastreamer2_tpu/models/ring_stream.py``; the reference's
src/voip/ringstream.c, graph fileplayer->decoder->resampler->gendtmf->sndwrite).

Batched: N simultaneous ring streams (a PBX ringing many parties) share
one graph; per-leg loop and pause through the player's params.
``device=None`` runs on ``cuda`` (raising without a card); tests pass
``"cpu"``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from mediastreamer2_tpu_torch.core.block import Format
from mediastreamer2_tpu_torch.core.graph import GraphBuilder
from mediastreamer2_tpu_torch.core.ticker import Ticker


class RingStreamBatch:
    def __init__(self, factory, batch: int, signal: np.ndarray, rate: int,
                 out_rate: Optional[int] = None, loop: bool = True, device=None):
        g = GraphBuilder(factory, batch=batch)
        p = g.add("file_player", "play", fmt=Format(rate=rate), signal=signal)
        last = p
        if out_rate and out_rate != rate:
            rs = g.add("resample", "rs", out_rate=out_rate)
            g.link(last, 0, rs, 0)
            last = rs
        dg = g.add("dtmf_gen", "dtmf")          # parity: gendtmf in ring graph
        g.link(last, 0, dg, 0)
        g.link(dg, 0, g.add("ext_sink", "spk"), 0)
        self.graph = g.build()
        self.ticker = Ticker(self.graph, device=device, name=f"ring[{batch}]")
        with self.ticker.on_stream():
            self.ticker.params["play"]["loop"].fill_(bool(loop))
        self.ticker.sync()
        self.batch = batch

    def start(self, n_ticks: int = 10 ** 9):
        self.ticker.warm_up()
        self.ticker.start(n_ticks)

    def stop(self):
        self.ticker.stop()
