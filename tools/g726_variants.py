#!/usr/bin/env python3
"""Versions of the G.726 kernels (csrc/adpcm_kernels.cu) side by side on the
card: the checkout's source built once per lane count (-DG726_LANES=n) and
any other versions given with
--source (an earlier commit's, say), each held bit for bit to the plain
versions at every rate (codes, samples and all 14 state leaves: B legs x 2
ticks of speech, and chip_smoke.py's ragged shapes), then both kernels
timed at B legs of one 80-sample tick at each rate as chip_smoke.py phase 2
times them (the stream spins, then one event pair around 50 launches, over
input sets that spill the L2).

    python3 tools/g726_variants.py [--legs 1024] [--lanes 4 8 16]
                                   [--source other_adpcm_kernels.cu ...] [--sass]

Needs one CUDA card and nvcc. A candidate that does not build or differs
from the plain versions is reported and left out of the timing.
Candidates are timed in turns, twice (in order, then in reverse), one line
per candidate, kernel and rate with the card's name and power limit.
--sass prints, from ``cuobjdump -sass`` of each built library
(tools/g722_variants.py's reader), each kernel's instruction count, its
loops, and the sample loop's (the largest loop holding no other)
instruction count and opcode mix. The chip copy has no
``.git``: put an earlier commit's source (``git show
REV:mediastreamer2_tpu_torch/csrc/adpcm_kernels.cu``) under the git-ignored
``scratch_tree/`` first.
"""
import argparse
import os
import sys
from pathlib import Path

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import chip_smoke  # noqa: E402
from g722_variants import sass_loops  # noqa: E402
from mediastreamer2_tpu_torch.ops import kernels  # noqa: E402
from mediastreamer2_tpu_torch.ops.g726 import g726_state  # noqa: E402

NAMES = ("g726_encode", "g726_decode")
FLAGS, SOURCES = kernels.NVCC_FLAGS, kernels.SOURCES
# each kernel at each rate, by its label, and a fragment of its mangled name
FRAGMENTS = {f"{name}@{kbps}": f"{name}_kernelILi{bits}E"
             for name in NAMES for bits, kbps in chip_smoke.G726_RATES.items()}


EMPTY_STUB = '\nextern "C" int ms2_adpcm_empty(int, int, void*) { return 1; }\n'


def with_empty_entry(source: Path) -> Path:
    """``source``, or a copy of it beside it with a stub of the empty
    kernel's entry point (``ms2_adpcm_empty``, which the loader binds) where
    an earlier version has none; the tools never call the stub."""
    text = Path(source).read_text()
    if "ms2_adpcm_empty" in text:
        return source
    stub = Path(source).with_name(f"{Path(source).stem}_stub{Path(source).suffix}")
    stub.write_text(text + EMPTY_STUB)
    return stub


def use(source, defines):
    """Build and load the kernels of ``source`` with ``-D`` ``defines``;
    returns the ADPCM library's path and nvcc's output."""
    kernels.NVCC_FLAGS = FLAGS + tuple(f"-D{d}" for d in defines)
    kernels.SOURCES = SOURCES[:2] + (with_empty_entry(source),)
    kernels._lib = None
    kernels._load()
    libs, log = kernels.build()
    return libs[2], log


def check(legs, dev):
    """Each kernel against its plain version at every rate, to the bit."""
    pcm = torch.from_numpy(chip_smoke.speech_fixture(legs, 2 * chip_smoke.S8, seed=6)).to(dev)
    ticks = [pcm[:, t * chip_smoke.S8:(t + 1) * chip_smoke.S8].contiguous() for t in range(2)]
    for bits in chip_smoke.G726_RATES:
        chip_smoke.g726_exact(kernels, ticks, bits, dev, f"{legs} legs")
    chip_smoke.g726_ragged_checks(kernels, dev)


def time_kernels(legs, dev):
    """{"g726_encode@32": ms, ...} at B = ``legs``, S = 80, as phase 2."""
    S8 = chip_smoke.S8
    pcm = torch.from_numpy(chip_smoke.speech_fixture(legs, 2 * S8, seed=2)).to(dev)
    out = {}
    for bits, kbps in chip_smoke.G726_RATES.items():
        st = g726_state(legs, dev)
        codes = kernels.g726_encode(pcm[:, :S8].contiguous(), st, bits)[0]
        x = pcm[:, S8:].contiguous()
        for name, inp in (("g726_encode", x), ("g726_decode", codes)):
            n_sets = chip_smoke.rotation(chip_smoke.adpcm_cost(legs, S8, name, bits)[0])
            sets = [(inp.clone(), chip_smoke._clone_tree(st)) for _ in range(n_sets)]
            fn = getattr(kernels, name)
            out[f"{name}@{kbps}"] = chip_smoke.device_ms(
                lambda i, fn=fn: fn(*sets[i % n_sets], bits))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legs", type=int, default=1024)
    ap.add_argument("--lanes", type=int, nargs="*", default=[4, 8, 16])
    ap.add_argument("--source", nargs="*", default=[],
                    help="other versions of csrc/adpcm_kernels.cu to time beside it")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("g726_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    cands = ([(SOURCES[2], (f"G726_LANES={n}",)) for n in args.lanes]
             + [(Path(p).resolve(), ()) for p in args.source])
    label = lambda src, d: " ".join((os.path.relpath(src, REPO), *d))  # noqa: E731
    good = []
    for src, d in cands:
        try:
            lib, log = use(src, d)
        except RuntimeError as e:
            print(f"{label(src, d)}: FAILED to build, left out: {e}", flush=True)
            continue
        regs = {k: chip_smoke.ptxas_usage(log, frag)["registers"] for k, frag in FRAGMENTS.items()}
        print(f"{label(src, d)}: registers {regs}", flush=True)
        if args.sass:
            for k, (total, loops, loop, mix) in sass_loops(lib, FRAGMENTS).items():
                print(f"{label(src, d)} {k} SASS: {total} instructions; loops (start, end, "
                      f"instructions) {[(hex(a), hex(b), c) for a, b, c in loops]}; sample loop "
                      f"{loop} instructions: {dict(mix.most_common())}", flush=True)
        try:
            check(args.legs, dev)
        except AssertionError as e:
            print(f"{label(src, d)}: FAILED, left out: {e}", flush=True)
            continue
        print(f"{label(src, d)}: bit-exact against the plain versions at every rate", flush=True)
        good.append((src, d))
    for src, d in good + good[::-1]:
        use(src, d)
        for k, ms in time_kernels(args.legs, dev).items():
            print(f"{label(src, d)} B={args.legs} {k}: {ms:.4f} ms per launch [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
