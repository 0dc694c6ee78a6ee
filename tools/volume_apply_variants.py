#!/usr/bin/env python3
"""Versions of the fused_volume, mdf_apply and mdf_update_fused kernels
(csrc/ms2_kernels.cu) side by side on the card: the checkout's source and
any other versions given with --source (an earlier commit's, say), each
held to the plain versions (fused_volume to rtol 1e-5 / atol 1e-6, the
other two bit for bit: mdf_apply's four sums and shifted history,
mdf_update_fused's Ws and Wm at cpos 0, 3 and 7) and, bit for bit, to
itself on four row slices of the batch (mdf_update_fused's with their
lin0), at the shapes below and at chip_smoke.py's unaligned shapes
(``ragged_checks``); then the kernels timed at those shapes as
chip_smoke.py phase 2 times them (the stream spins, then one event pair
around 50 launches, over input sets that spill the L2), after the launch
floor (an empty kernel), each line with its bound and share of it.

    python3 tools/volume_apply_variants.py [--source other_ms2_kernels.cu ...] [--only NAME ...]

Shapes: fused_volume x [4096, 480], [1024, 80], [1024, 160] f32 (the
flagship, the session, the wideband call); mdf_apply 4096 x 8 x 481 with
bf16 and with f32 shadow taps, 1024 x 8 x 81 and 1024 x 8 x 161 with bf16;
mdf_update_fused at those three shapes with bf16 and with f32 shadow taps,
each on the ordinary mix (no flag set, a real tick's) and on phase 2's 30%
mix (chip_smoke.update_flags), whose bound counts only the bytes its legs
need (chip_smoke.update_mix). ``--only`` keeps the cases whose label
starts with one of the names.

Needs one CUDA card and nvcc. A candidate that does not build or differs
is reported and left out of the timing. Candidates are timed in turns,
twice (in order, then in reverse), one line per candidate, kernel and
shape with the card's name and power limit. The chip copy has no
``.git``: put an earlier commit's source (``git show
REV:mediastreamer2_tpu_torch/csrc/ms2_kernels.cu``) under the git-ignored
``scratch_tree/`` first.
"""
import argparse
import os
import re
import sys
from pathlib import Path

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from mediastreamer2_tpu_torch.ops import kernels  # noqa: E402

SOURCES = kernels.SOURCES
VOLUME_SHAPES = ((4096, 480), (1024, 80), (1024, 160))                 # (B, S)
APPLY_SHAPES = ((4096, 8, 481, torch.bfloat16), (4096, 8, 481, torch.float32),
                (1024, 8, 81, torch.bfloat16), (1024, 8, 161, torch.bfloat16))
UPDATE_SHAPES = ((1024, 8, 81), (1024, 8, 161), (4096, 8, 481))
KERNELS = ("fused_volume", "mdf_apply", "mdf_update_fused")


def use(source):
    """Build and load the kernels with ``source`` in place of
    csrc/ms2_kernels.cu; returns nvcc's output."""
    kernels.SOURCES = (Path(source),) + SOURCES[1:]
    kernels._lib = None
    kernels._load()
    return kernels.build()[1]


def registers(log):
    """{entry function: "registers, spill bytes"} of the two kernels, from
    nvcc's ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m[1] if any(k in m[1] for k in KERNELS) else None
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name] = f"spills {m[1]} + {m[2]} bytes"
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name] = f"{m[1]} registers, " + out.get(name, "")
            name = None
    return out


def cases(rnd):
    """[(label, check, make_args, fn, cost)]: each kernel at each shape (and
    mdf_update_fused in each mode and mix)."""
    out = []
    for B, S in VOLUME_SHAPES:
        out.append((f"fused_volume x [{B}, {S}]",
                    lambda args: chip_smoke.check_volume(kernels, "fused_volume", args),
                    lambda B=B, S=S: chip_smoke.volume_args(rnd, B, S), kernels.fused_volume,
                    chip_smoke.fused_volume_cost(B, S)))
    for B, P, F, sdt in APPLY_SHAPES:
        name = f"mdf_apply {'bf16' if sdt == torch.bfloat16 else 'f32'} Ws {B} x {P} x {F}"
        out.append((name, lambda args, name=name: chip_smoke.check_apply(kernels, name, args),
                    lambda B=B, P=P, F=F, sdt=sdt: chip_smoke.apply_args(rnd, B, P, F, sdt),
                    kernels.mdf_apply,
                    chip_smoke.mdf_apply_cost(B, P, F, torch.finfo(sdt).bits // 8)))
    srk = torch.tensor(123456789, dtype=torch.int64, device=rnd(1).device)
    cposes = [torch.tensor(c, dtype=torch.int32, device=srk.device) for c in (0, 3, 7)]
    for B, P, F in UPDATE_SHAPES:
        mixes = {mix: chip_smoke.update_flags(rnd, B, mix) for mix in chip_smoke.UPDATE_MIXES}
        for sdt in (torch.bfloat16, torch.float32):
            for mix, flags in mixes.items():
                name = (f"mdf_update_fused {'bf16' if sdt == torch.bfloat16 else 'f32'} Ws "
                        f"{B} x {P} x {F} {mix}")

                def check(args, name=name, flags=flags):
                    for cpos in cposes:
                        chip_smoke.check_update(kernels, f"{name} cpos={int(cpos)}", cpos, args,
                                                flags, srk)
                upd, wm_read, wm_write = chip_smoke.update_mix(*flags, sdt == torch.bfloat16)
                out.append((name, check,
                            lambda B=B, P=P, F=F, sdt=sdt: chip_smoke.update_args(rnd, B, P, F,
                                                                                  sdt),
                            lambda *a, flags=flags: kernels.mdf_update_fused(cposes[1], *a,
                                                                             *flags, srk),
                            chip_smoke.mdf_update_fused_cost(B, P, F, torch.finfo(sdt).bits // 8,
                                                             wm_read, wm_write, upd)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", nargs="*", default=[],
                    help="other versions of csrc/ms2_kernels.cu to time beside it")
    ap.add_argument("--only", nargs="*", default=list(KERNELS),
                    help="the kernels (label prefixes) to check and time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("volume_apply_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, s=1.0: s * torch.randn(shape, generator=g, device=dev)  # noqa: E731
    todo = [c for c in cases(rnd) if c[0].startswith(tuple(args.only))]
    label = lambda src: os.path.relpath(src, REPO)  # noqa: E731
    good = []
    for src in [SOURCES[0]] + [Path(p).resolve() for p in args.source]:
        try:
            log = use(src)
        except RuntimeError as e:
            print(f"{label(src)}: FAILED to build, left out: {e}", flush=True)
            continue
        print(f"{label(src)}: {registers(log)}", flush=True)
        try:
            for name, check, make_args, _, _ in todo:
                check(make_args())
            name = "the unaligned shapes"
            chip_smoke.ragged_checks(kernels, card, rnd)
            torch.cuda.synchronize()
        except (AssertionError, RuntimeError) as e:
            print(f"{label(src)}: FAILED at {name}, left out: {e}", flush=True)
            continue
        print(f"{label(src)}: matches the plain versions (fused_volume rtol 1e-5, atol 1e-6; "
              f"mdf_apply and mdf_update_fused bit-exact) and itself on 4 row slices, bit for "
              f"bit", flush=True)
        good.append(src)
    use(SOURCES[0])
    chip_smoke.launch_floor(kernels, dev, card, 1024)
    for src in good + good[::-1]:
        use(src)
        for name, _, make_args, fn, cost in todo:
            sets = [make_args() for _ in range(chip_smoke.rotation(cost[0]))]
            ms = chip_smoke.device_ms(lambda i: fn(*sets[i % len(sets)]))
            bound_ms, by = chip_smoke.bound(cost)
            print(f"{label(src)} {name}: {ms:.4f} ms per launch, bound {bound_ms:.4f} ms "
                  f"({by}), {100 * bound_ms / ms:.0f}% of bound [{card}]", flush=True)
            del sets
    kernels.SOURCES = SOURCES


if __name__ == "__main__":
    main()
