"""Shard-side checks: functions a shard process runs (``spawn_shards``'s
``fn``) for the CPU tests and ``chip_smoke.py``'s phase 15. They live in
the package so that a shard imports the port and nothing else, and they
return numpy arrays and Python values, which the parent compares.

``run_jobs(mesh, jobs)`` runs several in one world (one start-up):
``jobs`` is a list of ``(name, kwargs)`` naming the functions below.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from mediastreamer2_tpu_torch.core import collective
from mediastreamer2_tpu_torch.core.block import Format
from mediastreamer2_tpu_torch.core.factory import Factory
from mediastreamer2_tpu_torch.core.graph import GraphBuilder
from mediastreamer2_tpu_torch.parallel import dryrun, sharding
from mediastreamer2_tpu_torch.utils.convert import from_jax

TAP_KEYS = ("Ws_r", "Ws_i", "Wm_r", "Wm_i")


def bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as a numpy integer array (bf16 as int16, f32 as
    int32), so that equality is bit equality, -0.0 and NaNs included."""
    dt = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return t.detach().contiguous().view(dt).cpu().numpy()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rows(mesh, a):
    """This rank's rows of a global [B, ...] array (or of the array stored
    in an ``.npy`` file, read by memory map)."""
    if isinstance(a, str):
        a = np.load(a, mmap_mode="r")
    b = a.shape[0] // mesh.world
    return np.array(a[mesh.rank * b:(mesh.rank + 1) * b])


def mixer_graph(batch, samples, k=0):
    """ext_source "x" -> conf_mixer (groups of ``k`` contiguous legs, or the
    segment sum over ``group_id`` where ``k`` is 0) -> ext_sink "out"."""
    g = GraphBuilder(Factory(), batch=batch)
    src = g.add("ext_source", "x", fmt=Format(rate=100 * samples))
    mix = g.add("conf_mixer", "conf", **({"uniform_group_size": k} if k else {}))
    g.chain(src, mix, g.add("ext_sink", "out"))
    return g.build()


def mixer(mesh, x, group_id=None, k=0):
    """The mixer alone on ``x`` [B, S], sharded, and unsharded on this rank
    from the same inputs: this rank's rows of both (as bits), the
    collectives of the call and their host ms."""
    dev = mesh.device
    B, S = x.shape
    cg = mixer_graph(B, S, k)
    params = cg.init_params(dev)
    if group_id is not None:
        params["conf"]["group_id"] = torch.as_tensor(group_id, dtype=torch.int32).to(dev)
    xt = torch.as_tensor(x).to(dev)
    ref = cg.step({}, params, {"x": xt})[1]["out"]
    run = sharding.sharded_step(cg, mesh)
    params = sharding.shard_tree(params, mesh, B, run.param_axes)
    xl = sharding.shard_tree({"x": xt}, mesh, B, run.ext_axes)
    collective.reset_collective_stats()
    out = run({}, params, xl)[1]["out"]
    _sync(dev)
    coll = collective.collective_stats()
    off = run.shard.offset
    return {"out": bits(out), "ref": bits(ref[off:off + run.shard.batch]),
            "collectives": coll["calls"],
            "collective_ms": 1e3 * coll["seconds"] / max(1, coll["calls"])}


def flagship(mesh, mic, far, ticks, group_id=None, params=None, taps=False, unsharded=False):
    """The flagship sharded over ``mesh`` for ``ticks`` ticks of this
    rank's rows of ``mic`` / ``far`` (global [B, ticks * 480] arrays or
    ``.npy`` paths); ``group_id`` as ``build_flagship``'s; ``params`` a
    JAX-side numpy params tree (``utils/convert``) to use instead of the
    port's; ``unsharded``: rank 0 runs the whole batch's graph instead (a
    reference run in the shards' process settings) and the other ranks
    return None. Returns this rank's output rows, the bf16 taps' bits with
    ``taps``, host ms a tick over ticks 1.. (ending in a synchronize), the
    kernels' launches and the collectives over the run (their host ms a
    tick over ticks 1..: the first exchange sets up), and the job's
    seconds with its set-up (reading the inputs, building the graph)."""
    from mediastreamer2_tpu_torch.models.flagship import build_flagship
    from mediastreamer2_tpu_torch.ops import kernels
    if unsharded and mesh.rank != 0:
        return None
    start = time.perf_counter()
    dev = mesh.device
    if unsharded:
        mic, far = (np.load(a, mmap_mode="r") if isinstance(a, str) else a for a in (mic, far))
        mic, far = np.array(mic), np.array(far)
        B = mic.shape[0]
    else:
        mic, far = _rows(mesh, mic), _rows(mesh, far)
        B = mic.shape[0] * mesh.world
    S = 480
    cg, pr = build_flagship(Factory(), B, dev, group_id=group_id)
    if params is not None:
        pr = from_jax(params, dev)
    if unsharded:
        run, state = cg.step, cg.init_state(dev)
    else:
        run = sharding.sharded_step(cg, mesh)
        state = run.init_state()
        pr = sharding.shard_tree(pr, mesh, B, run.param_axes)
    mic_t = torch.from_numpy(mic).to(dev)
    far_t = torch.from_numpy(far).to(dev)
    outs = []
    kernels.reset_launch_counts()
    collective.reset_collective_stats()
    t0, coll0 = time.perf_counter(), 0.0
    for t in range(ticks):
        if t == 1:
            _sync(dev)
            t0, coll0 = time.perf_counter(), collective.collective_stats()["seconds"]
        state, out, _ = run(state, pr, {"mic": mic_t[:, t * S:(t + 1) * S].contiguous(),
                                        "spk_ref": far_t[:, t * S:(t + 1) * S].contiguous()})
        outs.append(out["out"])
    _sync(dev)
    ms = 1e3 * (time.perf_counter() - t0) / max(1, ticks - 1)
    out = torch.cat(outs, dim=1)
    coll = collective.collective_stats()
    res = {"rank": mesh.rank, "out": out.cpu().numpy(), "ms_tick": ms,
           "finite": bool(torch.isfinite(out).all()),
           "launches": kernels.launch_counts(),
           "collectives": coll["calls"],
           "collective_ms_tick": 1e3 * (coll["seconds"] - coll0) / max(1, ticks - 1)}
    if taps:
        res["taps"] = {k: bits(state["ec"][k]) for k in TAP_KEYS}
    res["seconds"] = time.perf_counter() - start
    return res


def e2e(mesh, codes, mic, ticks):
    """The sharded e2e step (mu-law in, mu-law out) over ``ticks`` ticks of
    this rank's rows of ``codes`` [B, ticks * 80] and ``mic``
    [B, ticks * 480]; returns this rank's tx codes [b, ticks * 80]."""
    from mediastreamer2_tpu_torch.models.e2e_bench import build_e2e_graph
    from mediastreamer2_tpu_torch.ops.g711 import (float_to_pcm16, pcm16_to_float,
                                                   ulaw_decode, ulaw_encode)
    dev = mesh.device
    codes, mic = _rows(mesh, codes), _rows(mesh, mic)
    B = codes.shape[0] * mesh.world
    cg, params = build_e2e_graph(Factory(), B, dev)
    run = sharding.sharded_step(cg, mesh)
    state = run.init_state()
    params = sharding.shard_tree(params, mesh, B, run.param_axes)
    tx = []
    for t in range(ticks):
        c = torch.from_numpy(codes[:, t * 80:(t + 1) * 80].astype(np.int32)).to(dev)
        m = torch.from_numpy(np.ascontiguousarray(mic[:, t * 480:(t + 1) * 480])).to(dev)
        state, out, _ = run(state, params, {"rx": pcm16_to_float(ulaw_decode(c)), "mic": m})
        tx.append(ulaw_encode(float_to_pcm16(out["out"])).to(torch.uint8).cpu().numpy())
    return np.concatenate(tx, axis=1)


def dc_mix_minus(mesh, batch):
    """Dry-run stage 2's levels: (got, want) over the whole batch."""
    return dryrun.stage_dc_mix_minus(mesh, batch)


def modules(mesh):
    """Modules of JAX or of the JAX package this shard has loaded."""
    return dryrun.foreign_modules()


def environment(mesh):
    """The process settings ``spawn_shards`` gives a shard: its cuBLAS
    workspace setting and its thread count."""
    return {"CUBLAS_WORKSPACE_CONFIG": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
            "threads": torch.get_num_threads()}


def barrier(mesh):
    """Returns when every rank has reached it (one exchange)."""
    collective.sum_exact(torch.zeros(1, device=mesh.device), mesh.group)


def fail(mesh, rank):
    """Raises on ``rank``; the others wait in a collective for it."""
    if mesh.rank == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    collective.sum_exact(torch.zeros(1, device=mesh.device), mesh.group)


def skip_collective(mesh, rank, hold_s):
    """Every rank but ``rank`` enters a collective, which hangs until the
    group's timeout; ``rank`` holds back for ``hold_s`` seconds."""
    if mesh.rank == rank:
        time.sleep(hold_s)
    else:
        collective.sum_exact(torch.zeros(1, device=mesh.device), mesh.group)


JOBS = {f.__name__: f for f in (mixer, flagship, e2e, dc_mix_minus, modules, environment,
                                barrier, fail, skip_collective)}


def run_jobs(mesh, jobs):
    """Each ``(name, kwargs)`` of ``jobs`` in turn on this rank; returns
    their results in order."""
    return [JOBS[name](mesh, **kwargs) for name, kwargs in jobs]
