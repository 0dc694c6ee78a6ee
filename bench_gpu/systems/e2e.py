"""The port's e2e conference graph (``models/e2e_bench.build_e2e_graph``,
driven by ``e2e_tick``) as the system under test, without the network
edge: each tick the rx mu-law codes go up from pinned host memory, and the
tx codes are what comes back. The graph fixes its rates, tail and group
size in code; building checks them against the configuration's."""
from __future__ import annotations

import torch


class Port:
    readback = ("tx",)

    def __init__(self, cfg, legs: int, device):
        from mediastreamer2_tpu_torch import Factory
        from mediastreamer2_tpu_torch.models import e2e_bench
        fixed = {"codec_rate": 8000, "rate": e2e_bench.RATE, "mix_rate": e2e_bench.MIX_RATE,
                 "tail_ms": e2e_bench.TAIL_MS, "conf_size": e2e_bench.CONF_SIZE}
        differ = {k: (v, cfg[k]) for k, v in fixed.items() if cfg[k] != v}
        if differ:
            raise ValueError(f"the e2e graph fixes (program, configuration): {differ}")
        self._tick = e2e_bench.e2e_tick
        self.device = torch.device(device)
        self.cg, self.params = e2e_bench.build_e2e_graph(Factory(), legs, self.device)
        self.state = self.cg.init_state(self.device)

    def tick(self, ins):
        codes = ins["codes"].to(self.device, non_blocking=True)
        self.state, tx, _, out = self._tick(self.cg, self.state, self.params, codes, ins["mic"])
        return {"tx": tx, "out": out}
