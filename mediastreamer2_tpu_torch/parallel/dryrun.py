"""The multi-shard dry run (port of ``dryrun_multichip`` in the JAX
package's ``__graft_entry__.py:36-131`` and ``_dryrun_edge_system``
``:134-207``).

    python -m mediastreamer2_tpu_torch.parallel.dryrun 4 [--device cpu]

``dryrun_multichip(n)`` runs ``n`` shards (``sharding.spawn_shards``, one
process each, gloo) of a ``max(2n, 8)``-leg batch, two legs a shard at
``n >= 4``, so every conference of four spans two shards and the mixer's
exchange runs. Every rank checks, on its device:

1. the sharded flagship equals the unsharded one after a tick (atol
   2e-5, gathered on every rank);
2. the cross-shard mix-minus on distinct per-leg DC levels: leg i hears
   its group's sum minus itself (rtol 0.05, after 4 ticks, AGC off);
3. a co-resident G.711 ``ulaw_enc -> ulaw_dec`` graph stepped interleaved
   with the flagship on the same shards stays within 0.02 of its input;
4. per-shard native RTP sockets with SRTP (``native.BatchRtpTx`` /
   ``BatchRtpRx``) feed the sharded e2e step (mu-law at the boundary) over
   localhost UDP for 4 ticks: the ring delivers exactly what the previous
   tick sent.

Departures from JAX: no ``XLA_FLAGS`` / ``jax.config`` handling (it made a
virtual CPU mesh; here a shard is a process and ``device`` picks where it
runs: None means the cards, ``"cpu"`` the CPU); stage 4 raises where the
edge does not build, rather than printing a skip; a rank waits for its
packets with a deadline (its ``recv`` counters) rather than a fixed 5 ms
sleep; the summary names the port's devices.
"""
from __future__ import annotations

import socket
import sys
import time

import numpy as np
import torch

from mediastreamer2_tpu_torch.core.block import Format
from mediastreamer2_tpu_torch.core.factory import Factory
from mediastreamer2_tpu_torch.core.graph import GraphBuilder
from mediastreamer2_tpu_torch.parallel.sharding import (gather_tree, shard_tree,
                                                        sharded_step, spawn_shards)

CONF_SIZE = 4
EDGE_TICKS = 4
EDGE_WAIT_S = 5.0          # a tick's packets must arrive within this


def foreign_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "mediastreamer2_tpu"))


def dryrun_batch(n_devices: int) -> int:
    return max(2 * n_devices, 8)


def _flagship(batch, device):
    from mediastreamer2_tpu_torch.models.flagship import build_flagship, example_inputs
    cg, params = build_flagship(Factory(), batch, device, conf_size=CONF_SIZE)
    ext = {k: torch.from_numpy(v).to(device) for k, v in example_inputs(batch).items()}
    return cg, params, ext


def stage_sharded_equals_unsharded(mesh, batch):
    """Stage 1: max abs difference of the gathered sharded output from
    the unsharded one (raises above 2e-5)."""
    cg, params, ext = _flagship(batch, mesh.device)
    _, ref, _ = cg.step(cg.init_state(mesh.device), params, ext)
    run = sharded_step(cg, mesh)
    _, out, _ = run(run.init_state(), params, ext)
    out = gather_tree(out, mesh, batch)["out"]
    err = float((out - ref["out"]).abs().max())
    if not err <= 2e-5:
        raise AssertionError(f"sharded flagship differs from unsharded by {err}")
    return tuple(out.shape), err


def stage_dc_mix_minus(mesh, batch, ticks=4):
    """Stage 2: [batch] steady-state levels each leg hears and what
    mix-minus wants (raises outside rtol 0.05)."""
    cg, params, _ = _flagship(batch, mesh.device)
    params["agc"]["agc_enabled"] = torch.zeros((batch,), dtype=torch.bool,
                                               device=mesh.device)
    dc = 0.01 * (1.0 + np.arange(batch, dtype=np.float32))
    ext = {"mic": np.broadcast_to(dc[:, None], (batch, 480)).copy(),
           "spk_ref": np.zeros((batch, 480), np.float32)}
    run = sharded_step(cg, mesh)
    st, out = run.init_state(), None
    for _ in range(ticks):                       # let the resampler settle on DC
        st, out, _ = run(st, params, ext)
    got = gather_tree(out, mesh, batch)["out"][:, -40:].mean(dim=1).cpu().numpy()
    want = np.repeat(dc.reshape(-1, CONF_SIZE).sum(axis=1), CONF_SIZE) - dc
    np.testing.assert_allclose(got, want, rtol=0.05)
    return got, want


def stage_co_resident(mesh, batch, ticks=3):
    """Stage 3: the co-resident G.711 graph's max error (raises >= 0.02)."""
    cg, params, ext = _flagship(batch, mesh.device)
    g2 = GraphBuilder(Factory(), batch=batch)
    src2 = g2.add("ext_source", "in8k", fmt=Format(rate=8000))
    g2.chain(src2, g2.add("ulaw_enc"), g2.add("ulaw_dec"), g2.add("ext_sink", "out8k"))
    cg2 = g2.build()
    run, run2 = sharded_step(cg, mesh), sharded_step(cg2, mesh)
    sig = (0.25 * np.sin(2 * np.pi * 440 / 8000 * np.arange(80))).astype(np.float32)
    ext2 = {"in8k": np.broadcast_to(sig, (batch, 80)).copy()}
    st, st2, out2 = run.init_state(), run2.init_state(), None
    pr2 = cg2.init_params(mesh.device)
    for _ in range(ticks):                       # interleaved multi-graph ticks
        st, _, _ = run(st, params, ext)
        st2, out2, _ = run2(st2, pr2, ext2)
    got = gather_tree(out2, mesh, batch)["out8k"].cpu().numpy()
    err = float(np.abs(got - sig).max())
    if not err < 0.02:
        raise AssertionError(f"co-resident G.711 class diverged: {err}")
    return err


def stage_edge(mesh, batch, ticks=EDGE_TICKS):
    """Stage 4: this rank's legs over its own SRTP sockets into the
    sharded e2e step; returns the packets it received."""
    from mediastreamer2_tpu_torch.models.e2e_bench import build_e2e_graph
    from mediastreamer2_tpu_torch.native import BatchRtpRx, BatchRtpTx
    from mediastreamer2_tpu_torch.ops.g711 import (float_to_pcm16, pcm16_to_float,
                                                   ulaw_decode, ulaw_encode)
    per, off = batch // mesh.world, mesh.rank * (batch // mesh.world)
    cg, params = build_e2e_graph(Factory(), batch, mesh.device)
    run = sharded_step(cg, mesh)
    state = run.init_state()
    params = shard_tree(params, mesh, batch, run.param_axes)
    key_rng = np.random.default_rng(42)          # every leg's keys; this rank takes its own
    keys = [(key_rng.bytes(16), key_rng.bytes(14)) for _ in range(batch)]
    mic = (0.1 * np.random.default_rng(7).standard_normal((batch, 480))).astype(np.float32)
    mic = torch.from_numpy(mic[off:off + per]).to(mesh.device)
    txs = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rxs = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx = rx = None
    try:
        txs.bind(("127.0.0.1", 0))
        rxs.bind(("127.0.0.1", 0))
        rxs.setblocking(False)
        port = rxs.getsockname()[1]
        tx, rx = BatchRtpTx(txs, per, 80), BatchRtpRx(per, 80, ring_depth=16)
        rx.add_socket(rxs)
        for i in range(per):
            tx.config(i, "127.0.0.1", port, ssrc=off + i, pt=0)
            rx.map_ssrc(off + i, i)
            rx.set_prefill(i, 0)
            tx.set_srtp(i, *keys[off + i])
            rx.set_srtp(i, *keys[off + i])
        cur = np.full((per, 80), 0xFF, np.uint8)
        prev_tx = None
        for tick in range(ticks):
            tx.send(cur, ts_inc=80)
            deadline = time.monotonic() + EDGE_WAIT_S
            while True:
                rx.poll()
                if all(rx.stats(i)["recv"] > tick for i in range(per)):
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"rank {mesh.rank}: localhost self-loop dropped "
                                         f"packets on tick {tick}")
                time.sleep(0.001)
            pay, fl = rx.read_tick()
            if not fl.all():
                raise AssertionError(f"rank {mesh.rank}: tick {tick} played a missing packet")
            if prev_tx is not None and not np.array_equal(pay, prev_tx):
                raise AssertionError(f"rank {mesh.rank}: the ring did not deliver what the "
                                     f"previous tick sent")
            dec = pcm16_to_float(ulaw_decode(torch.from_numpy(pay.astype(np.int32))
                                             .to(mesh.device)))
            state, out, _ = run(state, params, {"rx": dec, "mic": mic})
            prev_tx = ulaw_encode(float_to_pcm16(out["out"])).to(torch.uint8).cpu().numpy()
            cur = prev_tx
        recv = sum(rx.stats(i)["recv"] for i in range(per))
        if any(rx.auth_failures(i) for i in range(per)):
            raise AssertionError(f"rank {mesh.rank}: SRTP authentication failures")
    finally:
        for h in (tx, rx):
            if h is not None:
                h.close()
        txs.close()
        rxs.close()
    return recv


def dryrun_shard(mesh, batch):
    """The four stages on this rank; returns what it saw."""
    shape, err = stage_sharded_equals_unsharded(mesh, batch)
    stage_dc_mix_minus(mesh, batch)
    g711_err = stage_co_resident(mesh, batch)
    recv = stage_edge(mesh, batch)
    return {"rank": mesh.rank, "device": str(mesh.device), "out_shape": shape,
            "max_abs_err": err, "g711_err": g711_err, "edge_packets": recv,
            "foreign_modules": foreign_modules()}


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = 120.0) -> list:
    """Run the dry run on ``n_devices`` shards (``device``: None for the
    cards, ``"cpu"`` for the CPU); prints the JAX function's summary line
    and returns each rank's report. Raises if any stage fails on any rank."""
    batch = dryrun_batch(n_devices)
    reports = spawn_shards(dryrun_shard, n_devices, backend="gloo", device=device,
                           timeout_s=timeout_s, args=(batch,))
    devices = [r["device"] for r in reports]
    print(f"dryrun_multichip({n_devices}): ok (sharded==unsharded, "
          f"cross-shard mix-minus exact, co-resident 2-class fleet, "
          f"per-shard SRTP edge e2e), out shape {reports[0]['out_shape']}, "
          f"devices {devices[:4]}...", flush=True)
    return reports


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=None, help="cpu, or none for the cards")
    a = ap.parse_args()
    dryrun_multichip(a.n, device=a.device)
