"""Graph construction and execution (port of ``mediastreamer2_tpu/core/graph.py``).

The graph is a declarative DAG built once. ``build()`` resolves formats in
topological order, and ``step`` runs every node's ``process`` once per tick
for all legs, passing edge values as tensors.

Differences from the JAX package:

* ``step`` is **not pure**. Filters may update state tensors in place, as
  the echo canceller does for its taps and far-end history (the Pallas
  kernel aliased the same buffers). The state dict passed in therefore
  changes too: ``clone()`` a state before stepping it if the old one is
  still needed.
* ``run_scan`` is a Python loop of K steps that stacks its outputs; PyTorch
  runs eagerly, so there is nothing to fuse at this level.
* ``init_state`` / ``init_params`` take the device the tensors live on.
* ``profile_nodes`` is not ported yet.

``ext_source`` / ``ext_sink`` are special-cased by name, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from mediastreamer2_tpu_torch.core.block import Format, block_shape, block_dtype
from mediastreamer2_tpu_torch.core.filter import FilterCtx, FilterDef


@dataclasses.dataclass(frozen=True)
class Node:
    idx: int
    name: str
    fdef: FilterDef

    def __repr__(self):
        return f"<{self.name}:{self.fdef.name}>"


@dataclasses.dataclass(frozen=True)
class Link:
    src: int
    srcpin: int
    dst: int
    dstpin: int


class GraphBuilder:
    """Declarative graph description (cf. MSConnectionHelper, msfilter.h:532-577)."""

    def __init__(self, factory, batch: int):
        self.factory = factory
        self.batch = batch
        self.nodes: List[Node] = []
        self.links: List[Link] = []
        self.static_params: List[Dict[str, Any]] = []
        self._names: Dict[str, int] = {}

    def add(self, filter_name: str, name: Optional[str] = None, **static_params) -> Node:
        fdef = self.factory.lookup(filter_name)
        name = name or f"{filter_name}#{len(self.nodes)}"
        if name in self._names:
            raise ValueError(f"duplicate node name {name}")
        node = Node(len(self.nodes), name, fdef)
        self.nodes.append(node)
        self.static_params.append(dict(static_params))
        self._names[name] = node.idx
        return node

    def link(self, src: Node, srcpin: int, dst: Node, dstpin: int):
        """cf. ms_filter_link (reference: src/base/msfilter.c:120-165)."""
        if not (0 <= srcpin < src.fdef.noutputs):
            raise ValueError(f"{src}: no output pin {srcpin}")
        if not (0 <= dstpin < dst.fdef.ninputs):
            raise ValueError(f"{dst}: no input pin {dstpin}")
        for l in self.links:
            if l.dst == dst.idx and l.dstpin == dstpin:
                raise ValueError(f"{dst} input pin {dstpin} already linked")
            if l.src == src.idx and l.srcpin == srcpin:
                raise ValueError(f"{src} output pin {srcpin} already linked")
        self.links.append(Link(src.idx, srcpin, dst.idx, dstpin))

    def chain(self, *nodes: Node):
        """Link nodes serially pin0->pin0."""
        for a, b in zip(nodes, nodes[1:]):
            self.link(a, 0, b, 0)

    def build(self) -> "CompiledGraph":
        return CompiledGraph(self)


def _toposort(n_nodes: int, links: Sequence[Link]) -> List[int]:
    indeg = [0] * n_nodes
    succ: List[List[int]] = [[] for _ in range(n_nodes)]
    for l in links:
        indeg[l.dst] += 1
        succ[l.src].append(l.dst)
    ready = [i for i in range(n_nodes) if indeg[i] == 0]
    order: List[int] = []
    while ready:
        i = ready.pop()
        order.append(i)
        for j in succ[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                ready.append(j)
    if len(order) != n_nodes:
        raise ValueError("graph has a cycle — feedback must be carried in filter "
                         "state (like the reference's EC far-end reference buffer), "
                         "not graph edges")
    return order


class CompiledGraph:
    """Resolved formats + initial state + step function."""

    def __init__(self, gb: GraphBuilder):
        self.batch = gb.batch
        self.nodes = list(gb.nodes)
        self.links = list(gb.links)
        self.order = _toposort(len(self.nodes), self.links)
        self._in_link: Dict[Tuple[int, int], Link] = {(l.dst, l.dstpin): l for l in self.links}

        # -- format resolution
        self.out_formats: List[Tuple[Format, ...]] = [None] * len(self.nodes)
        self.ctxs: List[FilterCtx] = [None] * len(self.nodes)
        for i in self.order:
            node = self.nodes[i]
            in_fmts = []
            for pin in range(node.fdef.ninputs):
                l = self._in_link.get((i, pin))
                if l is None:
                    raise ValueError(f"{node} input pin {pin} unlinked")
                in_fmts.append(self.out_formats[l.src][l.srcpin])
            # multi-input nodes need matching tick geometry: a mismatch is a
            # build-time error telling the caller to insert a resampler
            pcm_fmts = [(p, f) for p, f in enumerate(in_fmts)
                        if f.kind == "pcm"]
            if len({f.samples_per_tick for _, f in pcm_fmts}) > 1:
                detail = ", ".join(
                    f"pin {p}: {f.rate} Hz x{f.channels}"
                    for p, f in pcm_fmts)
                raise ValueError(
                    f"{node}: input rates disagree ({detail}) — link a "
                    f"'resample' node in front of the slower/faster input "
                    f"(graphs are fixed-shape; there is no bufferizer to "
                    f"absorb unsynchronized inputs at run time)")
            ctx = FilterCtx(batch=gb.batch, in_formats=tuple(in_fmts),
                            params=gb.static_params[i], name=node.name)
            self.ctxs[i] = ctx
            fmts = tuple(node.fdef.out_formats(ctx))
            if len(fmts) != node.fdef.noutputs:
                raise ValueError(f"{node}: out_formats returned {len(fmts)} formats, "
                                 f"expected {node.fdef.noutputs}")
            self.out_formats[i] = fmts

        # -- ext boundary discovery
        self.ext_inputs: Dict[str, Tuple] = {}   # name -> (shape, dtype)
        self.ext_outputs: List[str] = []
        for i, node in enumerate(self.nodes):
            if node.fdef.name == "ext_source":
                fmt = self.out_formats[i][0]
                self.ext_inputs[node.name] = (block_shape(gb.batch, fmt),
                                              block_dtype(fmt))
            elif node.fdef.name == "ext_sink":
                self.ext_outputs.append(node.name)

    def init_state(self, device) -> Dict[str, Any]:
        device = torch.device(device)
        return {node.name: node.fdef.init(self.ctxs[i], device)
                for i, node in enumerate(self.nodes)
                if node.fdef.init is not None}

    def init_params(self, device) -> Dict[str, Any]:
        device = torch.device(device)
        return {node.name: node.fdef.runtime_params(self.ctxs[i], device)
                for i, node in enumerate(self.nodes)
                if node.fdef.runtime_params is not None}

    def step(self, state: Dict, params: Dict, ext_in: Optional[Dict] = None
             ) -> Tuple[Dict, Dict, Dict]:
        """One 10 ms tick for every leg. May update ``state``'s tensors in
        place (see the module docstring).

        Returns (new_state, ext_out, events).
        """
        ext_in = ext_in or {}
        edge_vals: Dict[Tuple[int, int], Any] = {}
        new_state = dict(state)
        ext_out: Dict[str, Any] = {}
        events: Dict[str, Any] = {}

        for i in self.order:
            node = self.nodes[i]
            ctx = self.ctxs[i]
            ins = tuple(edge_vals[(l.src, l.srcpin)]
                        for l in (self._in_link[(i, pin)] for pin in range(node.fdef.ninputs)))
            st = new_state.get(node.name)
            p = params.get(node.name, {})
            if node.fdef.name == "ext_source":
                if node.name not in ext_in:
                    raise KeyError(f"ext_source '{node.name}' needs an entry in ext_in "
                                   f"(have {sorted(ext_in)})")
                want = self.ext_inputs[node.name][0]
                got = tuple(ext_in[node.name].shape)
                if got != want:
                    raise ValueError(f"ext_source '{node.name}': input shape {got} "
                                     f"!= expected {want}")
                outs = (ext_in[node.name],)
                ev = {}
            elif node.fdef.name == "ext_sink":
                ext_out[node.name] = ins[0]
                outs = ()
                ev = {}
            else:
                st, outs, ev = node.fdef.process(st, ins, p, ctx)
            if node.fdef.init is not None:
                new_state[node.name] = st
            for pin, v in enumerate(outs):
                edge_vals[(i, pin)] = v
            for k, v in ev.items():
                events[f"{node.name}.{k}"] = v
        return new_state, ext_out, events

    def run_scan(self, state, params, ext_in_seq, length: Optional[int] = None):
        """K ticks in a loop. ext_in_seq: dict name -> [K, batch, samples].
        Returns (state, ext_out_seq, events_seq) with a leading K dim."""
        if length is None:
            length = next(iter(ext_in_seq.values())).shape[0] if ext_in_seq else 0
        outs: List[Dict] = []
        evs: List[Dict] = []
        for t in range(length):
            state, out, ev = self.step(state, params,
                                       {k: v[t] for k, v in ext_in_seq.items()})
            outs.append(out)
            evs.append(ev)
        stack = lambda seq: ({k: torch.stack([d[k] for d in seq]) for k in seq[0]}
                             if seq else {})
        return state, stack(outs), stack(evs)

    def describe(self) -> str:
        lines = [f"CompiledGraph batch={self.batch} nodes={len(self.nodes)}"]
        for i in self.order:
            node = self.nodes[i]
            fmts = ",".join(f"{f.kind}@{f.rate}x{f.channels}" for f in self.out_formats[i])
            outs = [f"{self.nodes[l.dst].name}:{l.dstpin}"
                    for l in self.links if l.src == i]
            lines.append(f"  {node.name} ({node.fdef.name}) -> [{fmts}] => {outs}")
        return "\n".join(lines)
