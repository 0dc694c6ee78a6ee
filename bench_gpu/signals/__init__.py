"""The one traffic generator: a traffic file's ``signals`` made into rings
of ticks from the run's seed.

Every signal is a ring of ``ring_ticks`` ticks, ``[R, legs, samples]``,
which the window cycles through (tick t reads slot t % R). Each signal
names its ``kind``, a file ``signals/<kind>.py`` whose ``make(sig, made,
legs, R, randn, device)`` returns the ring; ``made`` holds the signals
made before it, in the order the traffic file lists them, and ``randn(*shape)``
draws from the one generator of the run, on its device. Sizes never depend
on the seed; only the values do.
"""
from __future__ import annotations

import torch

from bench_gpu import files


def make(traffic, legs: int, seed: int, device) -> dict:
    """{name: ring tensor}, made on ``device`` from one generator seeded
    with ``seed`` (a kind may keep its ring on the host, as ``ulaw``)."""
    device = torch.device(device)
    R = int(traffic["ring_ticks"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    out = {}
    for name, sig in traffic["signals"].items():
        kind = files.by_name("signals", sig["kind"], f"signal kind (signal {name})")
        out[name] = kind.make(sig, out, legs, R, randn, device)
    return out


def continuous(ring):
    """[R, B, S] -> [B, R*S]: each leg's time axis, circular across the
    ring's wrap."""
    R, B, S = ring.shape
    return ring.permute(1, 0, 2).reshape(B, R * S)


def ring(flat, R):
    """[B, R*S] -> [R, B, S], contiguous."""
    B = flat.shape[0]
    return flat.reshape(B, R, -1).permute(1, 0, 2).contiguous()
