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


@dataclasses.dataclass(frozen=True)
class LegShard:
    """Where a graph built for one shard of the legs sits in the whole
    batch (``parallel/sharding.py``): its legs are the global rows
    ``[offset, offset + global_batch // world)``. ``group`` is the
    ``torch.distributed`` process group its cross-leg filters exchange rows
    over (None: the default group)."""
    offset: int
    global_batch: int
    world: int
    group: object = None

    @property
    def batch(self) -> int:
        return self.global_batch // self.world


@dataclasses.dataclass
class FilterCtx:
    """Build-time context handed to init/out_formats. ``batch`` is the legs
    this graph holds; with a ``shard`` it is one shard's, and a filter whose
    code path depends on the batch reads ``global_batch`` instead, so that
    every shard takes the branch the unsharded graph takes."""
    batch: int
    in_formats: Tuple[Format, ...]
    params: Dict[str, object]          # static (python-level) construction params
    name: str = ""                     # node instance name
    shard: Optional[LegShard] = None   # set by a sharded build

    @property
    def global_batch(self) -> int:
        return self.shard.global_batch if self.shard is not None else self.batch


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
    category: str = "other"            # MSFilterCategory: "encoder", "decoder", ...
    interfaces: Tuple[str, ...] = ()
    # encoder/decoder mime type for Factory.find_encoder / find_decoder
    enc_fmt: str = ""

    def implements(self, interface: str) -> bool:
        return interface in self.interfaces


FILTER_REGISTRY: Dict[str, FilterDef] = {}


def register_filter(fdef: FilterDef) -> FilterDef:
    """Module-level registration; Factory snapshots this at construction."""
    if fdef.name in FILTER_REGISTRY:
        raise ValueError(f"duplicate filter name {fdef.name}")
    FILTER_REGISTRY[fdef.name] = fdef
    return fdef


def filter_def(name: str, ninputs: int, noutputs: int, *, category: str = "other",
               interfaces: Sequence[str] = (), enc_fmt: str = "", out_formats=None,
               init=None, runtime_params=None):
    """Decorator: the decorated function is the ``process`` callback."""
    def deco(process_fn):
        fdef = FilterDef(
            name=name, ninputs=ninputs, noutputs=noutputs,
            out_formats=out_formats or (lambda ctx: ctx.in_formats[:1] * max(noutputs, 0)),
            init=init, process=process_fn, runtime_params=runtime_params,
            category=category, interfaces=tuple(interfaces), enc_fmt=enc_fmt,
        )
        register_filter(fdef)
        return fdef
    return deco
