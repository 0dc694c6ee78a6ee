#!/usr/bin/env python3
"""Versions of the G.722 kernels (csrc/g722_kernels.cu) side by side on the
card: the checkout's source built once per lane count (-DG722_LANES=n) and
any other versions given with --source (an earlier commit's, say), each
held bit for bit to the plain versions (B legs x 2 ticks, and 33 legs x 7
slots), then both kernels timed at B legs of one 80-slot tick as
chip_smoke.py phase 2 times them (the stream spins, then one event pair
around 50 launches, over input sets that spill the L2).

    python3 tools/g722_variants.py [--legs 1024] [--lanes 16 8 32]
                                   [--source other_g722_kernels.cu ...] [--sass]

Needs one CUDA card and nvcc. Candidates are timed in turns, twice (in
order, then in reverse), one line per candidate and kernel with the card's
name and power limit. --sass prints, from ``cuobjdump -sass`` of each
built library, each kernel's instruction count, its loops, and the slot
loop's (the largest loop holding no other) instruction count and opcode
mix.
"""
import argparse
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from mediastreamer2_tpu_torch.ops import kernels  # noqa: E402
from mediastreamer2_tpu_torch.ops.g722 import g722_state  # noqa: E402

NAMES = ("g722_encode", "g722_decode")
FLAGS, SOURCES = kernels.NVCC_FLAGS, kernels.SOURCES


def use(source, lanes):
    """Build and load the kernels of ``source`` (lanes: a -DG722_LANES value
    or None); returns the G.722 library's path and nvcc's output."""
    kernels.NVCC_FLAGS = FLAGS + ((f"-DG722_LANES={lanes}",) if lanes else ())
    kernels.SOURCES = SOURCES[:1] + (source,) + SOURCES[2:]
    kernels._lib = None
    kernels._load()
    libs, log = kernels.build()
    return libs[1], log


def check(legs, dev):
    """Each kernel against its plain version: outputs and every state leaf."""
    g = torch.Generator(device=dev).manual_seed(3)
    for B, slots in ((legs, chip_smoke.G722_SLOTS), (33, 7)):
        chip_smoke._g722_run(kernels, "g722_encode", [torch.randint(
            -32768, 32768, (B, 2 * slots), generator=g, device=dev, dtype=torch.int32)
            for _ in range(2)], dev)
        chip_smoke._g722_run(kernels, "g722_decode", [torch.randint(
            0, 256, (B, slots), generator=g, device=dev, dtype=torch.int32)
            for _ in range(2)], dev)


def time_kernels(legs, dev):
    g = torch.Generator(device=dev).manual_seed(1)
    make = {"g722_encode": lambda: torch.randint(-32768, 32768, (legs, 2 * chip_smoke.G722_SLOTS),
                                                 generator=g, device=dev, dtype=torch.int32),
            "g722_decode": lambda: torch.randint(0, 256, (legs, chip_smoke.G722_SLOTS),
                                                 generator=g, device=dev, dtype=torch.int32)}
    out = {}
    for name in NAMES:
        n_sets = chip_smoke.rotation(chip_smoke.g722_cost(legs, name)[0])
        sets = [(make[name](), g722_state(legs, dev)) for _ in range(n_sets)]
        fn = getattr(kernels, name)
        out[name] = chip_smoke.device_ms(lambda i: fn(*sets[i % n_sets]))
    return out


def sass_loops(lib: Path) -> dict:
    """{kernel: (instructions, loops [(start, end, instructions)], slot loop's
    opcode Counter)} from ``cuobjdump -sass``; a loop is a backward branch's
    span, the slot loop the largest one that holds no other."""
    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            hit = [n for n in NAMES if f"{n}_kernel" in m[1]]
            name = hit[0] if hit else None
            if name:
                funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name and m:
            ins = re.sub(r"^@!?U?P\w+\s+", "", m[2].strip())
            funcs[name].append((int(m[1], 16), ins))
    out = {}
    for name, code in funcs.items():
        count = lambda a, b: sum(1 for addr, ins in code  # noqa: E731
                                 if a <= addr <= b and not ins.startswith("NOP"))
        loops = []
        for addr, ins in code:
            t = re.findall(r"0x[0-9a-f]+", ins)
            if ins.startswith("BRA") and t and int(t[-1], 16) <= addr:
                loops.append((int(t[-1], 16), addr))
        inner = [lp for lp in loops if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                                               for o in loops)]
        slot = max(inner, key=lambda lp: count(*lp)) if inner else None
        mix = Counter(ins.split()[0].split(".")[0] for addr, ins in code
                      if slot and slot[0] <= addr <= slot[1] and not ins.startswith("NOP"))
        out[name] = (count(0, 1 << 40), [(a, b, count(a, b)) for a, b in loops], slot and
                     count(*slot), mix)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legs", type=int, default=1024)
    ap.add_argument("--lanes", type=int, nargs="+", default=[16, 8, 32])
    ap.add_argument("--source", nargs="*", default=[],
                    help="other versions of csrc/g722_kernels.cu to time beside it")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("g722_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    cands = ([(SOURCES[1], n) for n in args.lanes]
             + [(Path(p).resolve(), None) for p in args.source])
    label = lambda src, n: (f"{os.path.relpath(src, REPO)}"  # noqa: E731
                            + (f" G722_LANES={n}" if n else ""))
    for src, n in cands:
        lib, log = use(src, n)
        check(args.legs, dev)
        regs = {name: chip_smoke.ptxas_usage(log, f"{name}_kernel") for name in NAMES}
        print(f"{label(src, n)}: bit-exact against the plain versions; ptxas {regs}", flush=True)
        if args.sass:
            for name, (total, loops, slot, mix) in sass_loops(lib).items():
                print(f"{label(src, n)} {name} SASS: {total} instructions; loops (start, end, "
                      f"instructions) {[(hex(a), hex(b), c) for a, b, c in loops]}; slot loop "
                      f"{slot} instructions: {dict(mix.most_common())}", flush=True)
    for src, n in cands + cands[::-1]:
        use(src, n)
        for name, ms in time_kernels(args.legs, dev).items():
            print(f"{label(src, n)} B={args.legs} {name}: {ms:.4f} ms per launch [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
