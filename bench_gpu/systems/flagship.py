"""The port's flagship graph (``models/flagship.build_flagship``) as the
system under test: mic and speaker reference in on the device, the
mix-minus out, one ``CompiledGraph.step`` a tick."""
from __future__ import annotations


class Port:
    readback = ("out",)

    def __init__(self, cfg, legs: int, device):
        from mediastreamer2_tpu_torch import Factory
        from mediastreamer2_tpu_torch.models.flagship import build_flagship
        self.cg, self.params = build_flagship(
            Factory(), legs, device, rate=cfg["rate"], mix_rate=cfg["mix_rate"],
            conf_size=cfg["conf_size"], tail_ms=cfg["tail_ms"])
        self.state = self.cg.init_state(device)

    def tick(self, ins):
        self.state, out, _ = self.cg.step(self.state, self.params,
                                          {"mic": ins["mic"], "spk_ref": ins["spk_ref"]})
        return {"out": out["out"]}
