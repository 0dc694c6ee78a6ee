"""Host<->device boundary filters (port of ``mediastreamer2_tpu/ops/boundary.py``).

``ext_source`` / ``ext_sink`` carry tick tensors between the host and the
graph; ``CompiledGraph.step`` special-cases these two names.
"""
from __future__ import annotations

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter

register_filter(FilterDef(
    name="ext_source", ninputs=0, noutputs=1,
    out_formats=lambda ctx: (ctx.params["fmt"],),
))

register_filter(FilterDef(
    name="ext_sink", ninputs=1, noutputs=0,
    out_formats=lambda ctx: (),
))
