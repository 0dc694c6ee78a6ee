"""Filter descriptors (port of ``mediastreamer2_tpu/core/filter.py``).

A filter is a function over batched tick blocks of torch tensors:

    process(state, inputs, params, ctx) -> (state, outputs, events)

* ``state``  -- dict of per-leg tensors (leading dim = batch), carried by
  the compiled graph across ticks. Unlike the JAX package, a process may
  update state tensors in place (the echo canceller's taps and history do).
* ``inputs`` / ``outputs`` -- tuples of tick blocks ``[batch, samples]``.
* ``params`` -- dict of runtime-reconfigurable tensors (gains, enables).
* ``events`` -- dict name -> per-leg tensor.

``init(ctx, device)`` and ``runtime_params(ctx, device)`` take the device
the graph's tensors live on; key names match the JAX package's, so one
helper (``utils/convert.py``) converts a state tree in both directions.

The registry is the port's own: the JAX package's ``FILTER_REGISTRY`` is
module-global in a package the port cannot import.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

from mediastreamer2_tpu_torch.core.block import Format


@dataclasses.dataclass
class FilterCtx:
    """Build-time context handed to init/out_formats."""
    batch: int
    in_formats: Tuple[Format, ...]
    params: Dict[str, object]          # static (python-level) construction params
    name: str = ""                     # node instance name


@dataclasses.dataclass(frozen=True)
class FilterDef:
    """Descriptor registered into the factory (cf. MSFilterDesc)."""
    name: str
    ninputs: int
    noutputs: int
    # out_formats(ctx) -> tuple of Format, one per output pin
    out_formats: Callable[[FilterCtx], Tuple[Format, ...]]
    # init(ctx, device) -> state dict (batched leading dim) -- may be None
    init: Optional[Callable] = None
    # process(state, inputs, params, ctx) -> (state, outputs, events)
    process: Callable = None
    # runtime_params(ctx, device) -> dict name -> tensor
    runtime_params: Optional[Callable] = None
    interfaces: Tuple[str, ...] = ()

    def implements(self, interface: str) -> bool:
        return interface in self.interfaces


FILTER_REGISTRY: Dict[str, FilterDef] = {}


def register_filter(fdef: FilterDef) -> FilterDef:
    """Module-level registration; Factory snapshots this at construction."""
    if fdef.name in FILTER_REGISTRY:
        raise ValueError(f"duplicate filter name {fdef.name}")
    FILTER_REGISTRY[fdef.name] = fdef
    return fdef


def filter_def(name: str, ninputs: int, noutputs: int, *,
               interfaces: Sequence[str] = (), out_formats=None, init=None,
               runtime_params=None):
    """Decorator: the decorated function is the ``process`` callback."""
    def deco(process_fn):
        fdef = FilterDef(
            name=name, ninputs=ninputs, noutputs=noutputs,
            out_formats=out_formats or (lambda ctx: ctx.in_formats[:1] * max(noutputs, 0)),
            init=init, process=process_fn, runtime_params=runtime_params,
            interfaces=tuple(interfaces),
        )
        register_filter(fdef)
        return fdef
    return deco
