#!/usr/bin/env python3
"""Versions of the DVI4 kernels (csrc/adpcm_kernels.cu) side by side on the
card: the checkout's source built once per set of defines (-DDVI4_LANES=8
or 32, the encoder's lanes a leg) and any other versions given with --source (an
earlier commit's, say), each held bit for bit to the plain versions
(output, pred and index after every tick: B legs x 2 ticks of speech, and
chip_smoke.py's ragged shapes and clamp fixtures), then both kernels timed
at B legs of one 80-sample tick as chip_smoke.py phase 2 times them (the
stream spins, then one event pair around 50 launches, over input sets that
spill the L2), after the launch floor (an empty kernel).

    python3 tools/dvi4_variants.py [--legs 1024]
        [--builds "" DVI4_LANES=8 DVI4_LANES=32]
        [--source other_adpcm_kernels.cu ...] [--sass]

Needs one CUDA card and nvcc. A build is a comma-separated list of defines
("" builds the source as it stands). A candidate that does not build or
differs from the plain versions is reported and left out of the timing.
Candidates are timed in turns, twice (in order, then in reverse), one line
per candidate and kernel with the card's name and power limit. --sass
prints, from ``cuobjdump -sass`` of each built library
(tools/g722_variants.py's reader), each kernel's instruction count, its
loops, and the innermost loop's instruction count and opcode mix (the
decoder's chunk loop; the encoder's loop over the samples of a partial
chunk, the whole chunk's being unrolled). The chip copy has no ``.git``:
put an earlier commit's source (``git show
REV:mediastreamer2_tpu_torch/csrc/adpcm_kernels.cu``) under the git-ignored
``scratch_tree/`` first (``g726_variants.use`` gives a source without the
empty kernel's entry point a stub of it, which the tool never calls).
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
from g726_variants import use  # noqa: E402
from mediastreamer2_tpu_torch.ops import kernels  # noqa: E402

NAMES = ("dvi4_encode", "dvi4_decode")
SOURCE = kernels.SOURCES[2]
FRAGMENTS = {name: f"{name}_kernel" for name in NAMES}


def check(legs, dev):
    """Both kernels against their plain versions, to the bit."""
    S8 = chip_smoke.S8
    pcm = torch.from_numpy(chip_smoke.speech_fixture(legs, 2 * S8, seed=6)).to(dev)
    codes = chip_smoke.dvi4_run(kernels, "dvi4_encode", [
        pcm[:, t * S8:(t + 1) * S8].contiguous() for t in range(2)], dev, f"{legs} legs")[0]
    chip_smoke.dvi4_run(kernels, "dvi4_decode", codes, dev, f"{legs} legs")
    chip_smoke.dvi4_checks(kernels, dev, legs)


def time_kernels(legs, dev):
    """{"dvi4_encode": ms, "dvi4_decode": ms} at B = ``legs``, S = 80, as
    phase 2."""
    S8 = chip_smoke.S8
    pcm = torch.from_numpy(chip_smoke.speech_fixture(legs, 2 * S8, seed=2)).to(dev)
    zeros = lambda: torch.zeros((legs,), dtype=torch.int32, device=dev)   # noqa: E731
    st = (zeros(), zeros())
    codes = kernels.dvi4_encode(pcm[:, :S8].contiguous(), *st)[0]
    x = pcm[:, S8:].contiguous()
    out = {}
    for name, inp in (("dvi4_encode", x), ("dvi4_decode", codes)):
        n_sets = chip_smoke.rotation(chip_smoke.adpcm_cost(legs, S8, name)[0])
        sets = [(inp.clone(), *(s.clone() for s in st)) for _ in range(n_sets)]
        fn = getattr(kernels, name)
        out[name] = chip_smoke.device_ms(lambda i, fn=fn: fn(*sets[i % n_sets]))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legs", type=int, default=1024)
    ap.add_argument("--builds", nargs="*", default=["", "DVI4_LANES=8", "DVI4_LANES=32"])
    ap.add_argument("--source", nargs="*", default=[],
                    help="other versions of csrc/adpcm_kernels.cu to time beside it")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dvi4_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    cands = ([(SOURCE, tuple(d for d in b.split(",") if d)) for b in args.builds]
             + [(Path(p).resolve(), ()) for p in args.source])
    label = lambda src, d: " ".join((os.path.relpath(src, REPO), *d))  # noqa: E731
    good = []
    for src, d in cands:
        try:
            lib, log = use(src, d)
        except RuntimeError as e:
            print(f"{label(src, d)}: FAILED to build, left out: {e}", flush=True)
            continue
        regs = {k: chip_smoke.ptxas_usage(log, frag) for k, frag in FRAGMENTS.items()}
        print(f"{label(src, d)}: registers and spills {regs}", flush=True)
        if args.sass:
            for k, (total, loops, loop, mix) in sass_loops(lib, FRAGMENTS).items():
                print(f"{label(src, d)} {k} SASS: {total} instructions; loops (start, end, "
                      f"instructions) {[(hex(a), hex(b), c) for a, b, c in loops]}; innermost "
                      f"loop {loop} instructions: {dict(mix.most_common())}", flush=True)
        try:
            check(args.legs, dev)
        except AssertionError as e:
            print(f"{label(src, d)}: FAILED, left out: {e}", flush=True)
            continue
        print(f"{label(src, d)}: bit-exact against the plain versions", flush=True)
        good.append((src, d))
    use(SOURCE, ())
    chip_smoke.launch_floor(kernels, dev, card, args.legs)
    for src, d in good + good[::-1]:
        use(src, d)
        for k, ms in time_kernels(args.legs, dev).items():
            print(f"{label(src, d)} B={args.legs} {k}: {ms:.4f} ms per launch [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
