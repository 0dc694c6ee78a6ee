"""Leg sharding over processes (port of
``mediastreamer2_tpu/parallel/sharding.py``).

Call legs are pure data parallelism: each shard holds a contiguous block of
the batch, ``[rank * b, (rank + 1) * b)`` with ``b = batch // world``, and
runs the graph built for its ``b`` legs. The JAX package places global
arrays with ``NamedSharding`` and lets XLA add collectives wherever a
computation crosses legs. PyTorch has no such partitioner, so here a shard
is one process with its own device and its own rows, and every cross-leg
filter names its collective itself: ``conf_mixer`` (``ops/mixer.py``) is
the only one in the port's graphs. Collectives are ``all_reduce`` sums,
the one collective that both gloo (CUDA tensors included) and NCCL take.

Names follow the JAX module: ``LEGS_AXIS``, ``make_mesh``, ``leg_sharding``,
``shard_tree``, ``sharded_step``. Added here:

* ``LegMesh``: this process's rank, the world size, its device and its
  process group (``make_mesh`` returns it; JAX's ``Mesh`` holds devices);
* ``gather_tree``: a sharded tree's global value on every rank (JAX's
  global arrays give it for free);
* ``spawn_shards``: one process a shard, ``torch.multiprocessing`` spawn,
  ``file://`` rendezvous.

A third trap is on the card: under its default workspace cuBLAS picks a
product's algorithm (split-K or not) by its row count, so a 1,024-leg
shard's resampler products give every leg other bits than the 4,096-leg
graph's (``tools/batch_invariance.py``; the DFTs there are FFTs, whose
rows do not depend on the batch), and the AEC amplifies those bits past the
cross-backend quality bar on a few legs in 100 ticks. So every shard
process runs with no cuBLAS workspace (``CUBLAS_WORKSPACE_CONFIG=:0:0``,
set by ``spawn_shards`` before cuBLAS's first use): its products do not
depend on the batch, and a sharded run equals, bit for bit, the unsharded
graph run with the same setting (a one-rank ``spawn_shards`` world, or a
process started with it). On the CPU the products follow the thread
count instead, and a shard process runs one thread.

Two traps come from a shard seeing only its local shapes, where JAX
computes on global ones. A filter whose code path depends on the batch
reads ``FilterCtx.global_batch`` (the AEC's megakernel rule, the mixer's
uniform-group test). And the leg axis of a leaf is not always dim 0 (the
``mix2``-``mix4`` gains are ``[n, B]``): ``sharded_step`` derives each
leaf's axis by comparing the global graph's state and params shapes with
the local graph's, and keeps JAX's dim-0 rule only for trees no graph
describes.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mediastreamer2_tpu_torch.core.collective import exchange_rows
from mediastreamer2_tpu_torch.core.filter import LegShard

LEGS_AXIS = "legs"
CUBLAS_WORKSPACE = ":0:0"   # a shard's cuBLAS workspace: none, so no product depends on the batch
STARTUP_S = 30.0      # spawn_shards' allowance for a world's start-up, beyond its timeout
SPILL_BYTES = 1 << 20  # a result's numpy arrays this large travel through files, not the pipe


@dataclasses.dataclass(frozen=True)
class LegMesh:
    """One shard's view of the legs axis: this process's ``rank`` of
    ``world``, the ``device`` its legs live on and the process ``group``
    (None: the default group)."""
    rank: int
    world: int
    device: torch.device
    group: Any = None

    def shard(self, batch: int) -> LegShard:
        """This rank's ``LegShard`` of a ``batch``-leg graph."""
        local = local_batch(batch, self.world)
        return LegShard(offset=self.rank * local, global_batch=batch, world=self.world,
                        group=self.group)


def local_batch(batch: int, world: int) -> int:
    if batch % world:
        raise ValueError(f"{batch} legs do not split evenly over {world} shards")
    return batch // world


def make_mesh(n_devices: Optional[int] = None, devices=None, group=None) -> LegMesh:
    """This process's ``LegMesh``, inside a process group that already
    exists (``torch.distributed.init_process_group``; ``spawn_shards``
    makes one). ``n_devices``, when given, must equal the world size.
    ``devices``: the one device of every rank (``"cpu"``, as the tests
    pass); None means ``cuda:{rank % device_count}`` and raises without a
    card."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh runs inside a process group: call "
                           "torch.distributed.init_process_group first (or spawn_shards)")
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}) in a world of {world} processes")
    return LegMesh(rank=rank, world=world, device=rank_device(devices, rank), group=group)


def rank_device(devices, rank: int) -> torch.device:
    """``make_mesh``'s device for ``rank``: ``devices`` itself, or for
    None ``cuda:{rank % device_count}`` (raising without a card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices='cpu' to shard "
                               "on the CPU")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(devices)


def _leading_axis(x, batch: int) -> Optional[int]:
    return 0 if getattr(x, "ndim", 0) >= 1 and x.shape[0] == batch else None


def leg_sharding(mesh: LegMesh, batch: int) -> Callable:
    """Tree-mapper (JAX ``:30-40``): a tensor or numpy array whose leading
    dim equals ``batch`` becomes this rank's contiguous rows; everything
    else (matrices, scalars, counters) is replicated. Returns tensors on
    ``mesh.device``."""
    local = local_batch(batch, mesh.world)

    def spec_of(x):
        return _place(x, _leading_axis(x, batch), mesh, local)
    return spec_of


def _place(x, axis: Optional[int], mesh: LegMesh, local: int):
    """``x`` on ``mesh.device``, cut to this rank's ``local`` rows along
    ``axis`` unless it holds ``local`` rows there already (a tree sharded
    before); None replicates. A cut is copied, so a shard's in-place
    updates never reach the global tensor it came from."""
    t = torch.as_tensor(x) if isinstance(x, np.ndarray) else x
    if not isinstance(t, torch.Tensor):
        return t
    if axis is not None and t.shape[axis] != local:
        if t.shape[axis] != local * mesh.world:
            raise ValueError(f"leg axis {axis} of {tuple(t.shape)} holds neither "
                             f"{local} nor {local * mesh.world} legs")
        t = t.narrow(axis, mesh.rank * local, local).to(mesh.device).clone(
            memory_format=torch.contiguous_format)
        return t
    return t.to(mesh.device)


def _map(tree, axes, fn):
    if isinstance(tree, dict):
        return {k: _map(v, axes.get(k) if isinstance(axes, dict) else axes, fn)
                for k, v in tree.items()}
    return fn(tree, axes)


def shard_tree(tree: Any, mesh: LegMesh, batch: int, axes=None) -> Any:
    """Each leaf of a nested dict on ``mesh.device``, cut to this rank's
    rows: along its entry of ``axes`` (a tree of the same keys holding a
    leaf's leg axis or None), or by ``leg_sharding``'s dim-0 rule where
    ``axes`` is None."""
    local = local_batch(batch, mesh.world)
    if axes is None:
        spec = leg_sharding(mesh, batch)
        return _map(tree, None, lambda x, _: spec(x))
    return _map(tree, axes, lambda x, a: _place(x, a, mesh, local))


def leg_axes(global_tree, local_tree, batch: int, world: int):
    """The leg axis of every leaf, from its shape in the global graph's
    tree and in a shard's: the one axis where they differ (global
    ``world`` times local), or None where they agree (replicated)."""
    if isinstance(global_tree, dict):
        return {k: leg_axes(v, local_tree[k], batch, world) for k, v in global_tree.items()}
    g, l = tuple(global_tree.shape), tuple(local_tree.shape)
    diff = [i for i, (a, b) in enumerate(zip(g, l)) if a != b]
    if len(g) != len(l) or len(diff) > 1 or (diff and g[diff[0]] != world * l[diff[0]]):
        raise ValueError(f"cannot find the leg axis of a leaf shaped {g} globally and "
                         f"{l} in a shard of {batch // world} legs")
    return diff[0] if diff else None


# -- gathering ------------------------------------------------------------------
def gather_tree(tree: Any, mesh: LegMesh, batch: int) -> Any:
    """A sharded tree's global value on every rank (collective: every rank
    calls it with the same tree): a leaf whose leading dim holds this
    rank's share of ``batch`` legs is gathered, the rest returned as they
    are. Built from ``exchange_rows`` (an ``all_reduce`` over a zero-padded
    global buffer): PyTorch does not promise gloo's ``all_gather`` for CUDA
    tensors."""
    local = local_batch(batch, mesh.world)

    def gather(x, _):
        if not isinstance(x, torch.Tensor) or x.ndim == 0 or x.shape[0] != local:
            return x
        return exchange_rows(x.contiguous(), mesh.rank * local, batch, mesh.group)
    return _map(tree, None, gather)


# -- the sharded step ----------------------------------------------------------
def sharded_step(cg, mesh: LegMesh):
    """The global ``CompiledGraph`` ``cg`` built again at ``cg.batch //
    world`` legs for this rank (``CompiledGraph.for_shard``), every node's
    context carrying the shard. Returns ``run(state, params, ext_in)``: it
    cuts global trees to this rank's rows (leaves already cut pass through,
    so a run's returned state feeds the next) and steps the local graph,
    returning its local (state, ext_out, events).

    ``run.graph`` is the local graph; ``run.state_axes`` /
    ``run.param_axes`` / ``run.ext_axes`` the leg axis of every leaf, for
    ``shard_tree``; ``run.init_state()`` the global
    graph's initial state cut to this rank (made on the CPU, moved to the
    device)."""
    shard = mesh.shard(cg.batch)
    local = cg.for_shard(shard)
    meta = torch.device("meta")
    state_axes = leg_axes(cg.init_state(meta), local.init_state(meta), cg.batch, mesh.world)
    param_axes = leg_axes(cg.init_params(meta), local.init_params(meta), cg.batch, mesh.world)
    ext_axes = {name: leg_axes(torch.empty(shape, device=meta),
                               torch.empty(local.ext_inputs[name][0], device=meta),
                               cg.batch, mesh.world)
                for name, (shape, _) in cg.ext_inputs.items()}

    def run(state, params, ext_in=None):
        state = shard_tree(state, mesh, cg.batch, state_axes)
        params = shard_tree(params, mesh, cg.batch, param_axes)
        ext = {}
        for name, x in (ext_in or {}).items():
            axis = ext_axes[name] if name in ext_axes else _leading_axis(x, cg.batch)
            ext[name] = _place(x, axis, mesh, shard.batch)
        return local.step(state, params, ext)

    run.graph = local
    run.mesh = mesh
    run.shard = shard
    run.state_axes, run.param_axes, run.ext_axes = state_axes, param_axes, ext_axes
    run.init_state = lambda: shard_tree(cg.init_state("cpu"), mesh, cg.batch, state_axes)
    return run


# -- one process a shard -------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _Spilled:
    path: str


def _spill(tree, prefix: str):
    """``tree`` (dicts, lists, tuples) with each numpy array of
    ``SPILL_BYTES`` or more saved to a file ``prefix.N.npy`` and replaced
    by its path: the result pipe carried ~57 MB/s on the card's host
    (1.55 GB in 27 s), a file 1.5 GB in under a second."""
    count = itertools.count()

    def go(x):
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(go(v) for v in x)
        if isinstance(x, np.ndarray) and x.nbytes >= SPILL_BYTES:
            path = f"{prefix}.{next(count)}.npy"
            np.save(path, x)
            return _Spilled(path)
        return x
    return go(tree)


def _unspill(tree):
    """``_spill``'s tree with its arrays read back."""
    if isinstance(tree, dict):
        return {k: _unspill(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unspill(v) for v in tree)
    return np.load(tree.path) if isinstance(tree, _Spilled) else tree


def _shard_main(rank, world, backend, init_method, device, timeout_s, call_path, results,
                spill_prefix):
    """A shard process: join the group, run ``fn(mesh, *args)`` (pickled
    in the file ``call_path``), report."""
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE    # before cuBLAS's first use
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)      # the world shares the cores
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(make_mesh(world, devices=dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, _spill(out, spill_prefix)))
    except BaseException:               # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn_shards(fn: Callable, world: int, backend: str = "gloo",
                 init_file: Optional[str] = None, device=None, timeout_s: float = 60.0,
                 args: Sequence = ()) -> list:
    """Run ``fn(mesh, *args)`` in ``world`` new processes, one a shard, and
    return each rank's result (index = rank). ``fn`` and its result must be
    picklable: a module-level function of the port (a child imports the
    port, never a caller's test module), results as numpy or Python values
    (``fn``, ``args`` and large result arrays travel through files in a
    temporary directory).

    ``torch.multiprocessing`` with the spawn start method (the parent may
    hold a CUDA context); ``file://`` rendezvous on ``init_file``, a path
    that must not exist yet (None: a fresh temporary directory's); the
    group's collectives time out after ``timeout_s``. The parent waits
    ``timeout_s + STARTUP_S`` at most (start-up: an interpreter, torch and
    a CUDA context a rank): when a rank fails or dies, or the deadline
    passes, it kills every child and raises with the failed ranks'
    tracebacks. ``device``: as ``make_mesh``'s (None: the cards). Each
    child runs with no cuBLAS workspace and, on the CPU, one thread (the
    module's docstring says why). NCCL refuses two ranks on one card, so
    ``backend="nccl"`` with more ranks than cards raises before anything
    starts."""
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > cards:
            raise ValueError(f"backend='nccl' with {world} ranks on {cards} card(s): NCCL "
                             f"refuses two ranks on one card; use backend='gloo' to put "
                             f"several shards on one card")
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"backend='nccl' needs CUDA devices, not {device!r}")
    if init_file is not None and os.path.exists(init_file):
        raise ValueError(f"rendezvous file {init_file} exists: a new group needs a new file")
    tmpdir = tempfile.mkdtemp(prefix="ms2_shards_")
    init_method = "file://" + os.path.abspath(init_file or os.path.join(tmpdir, "rendezvous"))
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    # fn and args go through a file: a spawned child reads the rest of its
    # start-up message only after importing the parent's main module, so a
    # message larger than the pipe's buffer held the parent in start() and
    # started the ranks one by one (7 s apart on the card's host)
    call_path = os.path.join(tmpdir, "call.pkl")
    with open(call_path, "wb") as f:
        pickle.dump((fn, tuple(args)), f, protocol=pickle.HIGHEST_PROTOCOL)
    procs = [ctx.Process(target=_shard_main, daemon=True,
                         args=(rank, world, backend, init_method, device, timeout_s, call_path,
                               results, os.path.join(tmpdir, f"rank{rank}")))
             for rank in range(world)]
    limit = timeout_s + STARTUP_S
    deadline = time.monotonic() + limit
    got, failed = {}, {}
    try:
        for p in procs:
            p.start()
        while len(got) + len(failed) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                if failed:
                    break
                raise TimeoutError(f"spawn_shards: ranks {sorted(set(range(world)) - set(got))} "
                                   f"did not finish within {limit:.0f} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 0.2))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and r not in failed and p.exitcode is not None]
                if dead and results.empty():
                    time.sleep(0.5)             # a last report may still be in the pipe
                    if results.empty():
                        failed.update({r: f"exited with code {procs[r].exitcode} and no "
                                          f"report" for r in dead})
                continue
            if ok:
                got[rank] = _unspill(out)
            else:
                if not failed:                  # the others' reports, for a moment
                    deadline = min(deadline, time.monotonic() + 2.0)
                failed[rank] = out
        if failed:
            raise RuntimeError(f"spawn_shards: rank(s) {', '.join(map(str, failed))} of {world} "
                               f"({backend}) failed, in the order they reported:\n"
                               + "\n".join(f"--- rank {r} ---\n{tb}" for r, tb in failed.items()))
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5.0)
        results.close()
        shutil.rmtree(tmpdir, ignore_errors=True)
    return [got[r] for r in range(world)]
