#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mediastreamer2_tpu_torch) on one
NVIDIA GPU: builds its kernels and its native RTP edge from source, checks
each kernel against its plain PyTorch version on the card, drives the
flagship conference leg, the end-to-end G.711 leg over localhost UDP (in
clear and with SRTP), the session layer, the secured wideband call
(G.722, SRTP, RTCP and QoS) and the gateway transcoder (G.711 <-> G.726-32,
the DVI4 and G.726 codec chains, Baudot TTY), and compares the port on the
card with the port on the CPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, g++ and nvidia-smi; imports nothing of JAX.
Phases, in order (any failure raises and the script exits non-zero):

1. card, versions, build times (one nvcc per kernel source and g++ for the
   edge, started together), the G.722 and G.726 kernels' registers and
   spill bytes from nvcc's ``-Xptxas -v`` report (a spill fails the run),
   the edge's
   AES path (``native.hw_crypto``) and which system codec and crypto
   libraries the machine has (printed only);
2. each kernel against its plain version, at the flagship's shapes
   (fused_volume; mdf_apply with bf16 and with f32 shadow taps;
   mdf_update at cpos 0, 3, 7; mdf_update_fused, f32 and bf16 shadow)
   at the session's (B = 1,024, S = 80, F = 81: the three kernels of
   its path) and the wideband call's (B = 1,024, S = 160, F = 161), and
   g722_encode / g722_decode bit-exact (codes or samples and every state
   leaf after every tick): the ITU vectors as one 1,600-slot tick on one
   leg and on 1,024 (even legs equal to the vectors' codes and samples),
   three ticks of random input and three of speech at B = 1,024, and
   ragged shapes (1, 33 and 1,000 legs x 1, 7 and 160 slots, two ticks
   each); each kernel with its device time per
   launch (the stream spins while the host enqueues, then one event pair
   around 50 launches, over input sets that spill the L2), its bound
   (bytes over 3.35 TB/s or operations over 67 TFLOP/s, the larger; for
   G.722 the serial chain of its 80 code slots instead of the throughput)
   and its share of the bound; dvi4_encode / dvi4_decode (bit-exact) and
   g726_encode / g726_decode at 16, 24, 32 and 40 kbit/s at B = 1,024 over
   three ticks of speech, bit-exact (codes, decoded samples and every state
   leaf; the codes that differ are counted and printed) and at every rate
   on ragged shapes (1, 33, 77 and 1,000 legs x 1, 7, 80 and 200 samples,
   two ticks each; DVI4 at 77 legs x 200 samples), each beside its
   serial-chain and bytes bounds;
3. the flagship at 4,096 legs (1,024 four-party conferences) for 100
   ticks of echo-coupled input: fused_volume, mdf_apply and
   mdf_update_fused launched once per tick and mdf_update never, all
   outputs finite, the AEC's shadow filter converged (Es < 0.5 * Dn) on
   >= 90% of legs; ms/tick;
4. the flagship on the CPU (plain versions) against the card (kernels) on
   the cross-backend fixture (256 legs, 100 ticks), held to the bar of
   tools/tpu_correctness.py: audio_diff >= 0.999 on legs 0, 37, 74, ...
   (the all-legs minimum is printed too), rms error <= 5e-3, and per-leg
   energy gap <= 1.5 dB;
5. the e2e leg (models/e2e_bench.py) in the AEC's megakernel mode
   (PALLAS_MDF=1): 1,024 legs paced over localhost UDP for 300 measured
   ticks inside paused_gc, with mdf_apply, mdf_update and fused_volume
   launched once per tick and mdf_update_fused never, finite graph
   outputs and state, loss < 0.02 and fidelity >= 0.9; the same with
   AES_CM_128_HMAC_SHA1_80 on every leg (srtp=True; no authentication
   failure); then 4,096 legs unpaced for 100 ticks, printed with no bar;
6. the e2e graph without the network in megakernel mode, the CPU against
   the card, 256 legs x 100 ticks fed the same mu-law codes, held to the
   bar of phase 4;
7. the session layer (AudioStreamBatch, Ticker, AudioConferenceControl):
   echo-cancelling (AEC + AGC) mu-law clients against a conference
   server, legs 4k..4k+3 in conference k, leg 4k talking. 7a: 1,024 +
   1,024 legs over the batch edge, 150 alternating do_ticks: fused_volume
   3 (the clients' two volumes, the server's receive volume: a conference
   stream has no send volume), mdf_apply 1 and mdf_update_fused 1
   launches per tick pair and mdf_update none, finite outputs and state, each leg's edge recv >=
   ticks/2, active_talkers names each talker and no listener; 7b: 64 +
   64 legs over LoopbackPair, each ticker start()ed paced on its own
   thread (late ticks and load printed, no bar); 7a and 7b hold each
   sampled listener's recording to audio_diff > 0.85 against its
   talker's speech as sent (the talker's codes on the wire; the talker's
   own AGC shapes it) and > 0.7 against its mic, and the talker's own
   recording to < 5% of a listener's energy (mix-minus); 7b, whose late
   tickers make the jitter buffers underrun or discard mid-run, holds the
   first two tick by tick along the path each listener's packets took
   (logged sequence numbers: each stretch between events at its own
   delay, the concealed ticks left out, at least half the ticks played)
   and prints each listener's line;
   7c: 8 + 8 legs
   on the CPU against the card, the listeners' recordings held to the
   bar of phase 4;
8. the secured wideband call: phase 7's clients and server with G.722 at
   16 kHz (AEC P = 8, F = 161). 8a: 1,024 + 1,024 legs over the batch
   edge with AES_CM_128_HMAC_SHA1_80 on every leg (keys from a seeded
   generator), 150 alternating do_ticks: launches per tick pair
   g722_encode 2, g722_decode 2, fused_volume 3, mdf_apply 1,
   mdf_update_fused 1, every leg >= ticks/2 packets, no authentication
   failure and no replay drop, phase 7a's listener, mix-minus and talker
   bars (the speech as sent decoded from the wire codes by the plain
   G.722 decode; from tick 40 on, after G.722's start transient), finite
   outputs and state; 8b: 64 + 64 legs over
   LoopbackPair with per-leg SRTP keyed by SDES, RTCP every 0.5 s, a
   quality indicator and a bitrate controller on every leg, alternating
   do_ticks with iterate() every 10 ticks for >= 3 s: every leg saw a
   remote report and has an RTT, every quality indicator >= 4.5, one leg
   given a wrong receive key receives nothing, the listener bars; 8c: 8 +
   8 legs of 8b's configuration on the CPU against the card, the bar of
   phase 4 on the listeners' recordings over 60 ticks;
9. the gateway transcoder. 9a: file_player -> X_enc -> X_dec ->
   file_recorder through a free-running Ticker at 1,024 legs x 100 ticks of
   speech for dvi4 and each G.726 rate: exactly one encode and one decode
   launch a tick and no other kernel, finite state, audio_diff of legs 0,
   37, ... against the signal above CHAIN_BARS at shift 0; 9b: four
   batches of 1,024 legs (mu-law talkers, TranscodeBatch ulaw -> g726_32,
   TranscodeBatch g726_32 -> ulaw, mu-law listeners) over a LoopbackPair
   per leg and hop, 150 rounds of do_tick in turn: launches a round
   g726_encode 1, g726_decode 1, fused_volume 4, the sampled listeners'
   recordings above 0.85 against the speech sent from round 40 on (the
   G.726 decoders play a transient on the jitter buffers' empty first
   ticks), every listener at least half of its packets, finite state; 9c:
   8 legs of 9b's gateway with Baudot on talkers and listeners, every
   talker typing "SOS 911", on the CPU against the card: the listeners'
   recordings to phase 4's audio_diff and energy bars and an rms error of
   2e-2 (the two G.726 codings differ by the codec's quantisation noise:
   CROSS_GATEWAY_RMS), and the text read exactly on both.

Each phase prints the seconds elapsed when it ends. The last two lines of
standard output are the kernels' JSON and the result's JSON; the card's
name and power limit come before them.
"""
import contextlib
import ctypes.util
import json
import math
import os
import re
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "mediastreamer2_tpu_torch/csrc/ms2_kernels.cu"
G722_SOURCE = "mediastreamer2_tpu_torch/csrc/g722_kernels.cu"
ADPCM_SOURCE = "mediastreamer2_tpu_torch/csrc/adpcm_kernels.cu"
REPLACES = {  # the TPU kernel (or lax.scan) each CUDA kernel replaces
    "fused_volume": "mediastreamer2_tpu/ops/pallas_kernels.py:56",
    "mdf_apply": "mediastreamer2_tpu/ops/pallas_kernels.py:133",
    "mdf_update": "mediastreamer2_tpu/ops/pallas_kernels.py:178",
    "mdf_update_fused": "mediastreamer2_tpu/ops/pallas_kernels.py:278",
    "g722_encode": "mediastreamer2_tpu/ops/g722.py:213",
    "g722_decode": "mediastreamer2_tpu/ops/g722.py:221",
    "dvi4_encode": "mediastreamer2_tpu/ops/adpcm.py:78",
    "dvi4_decode": "mediastreamer2_tpu/ops/adpcm.py:84",
    "g726_encode": "mediastreamer2_tpu/ops/g726.py:172",
    "g726_decode": "mediastreamer2_tpu/ops/g726.py:180",
}
SOURCES = {"g722": G722_SOURCE, "dvi4": ADPCM_SOURCE, "g726": ADPCM_SOURCE}   # by name prefix
SYSTEM_LIBRARIES = ("opus", "gsm", "avcodec", "ssl", "crypto")
# kernels whose registers phase 1 prints and whose spills fail it, by a
# fragment of the mangled name (G.726 at 40 kbit/s: the most thresholds
# and candidates a lane)
SPILL_CHECKED = {"g722_encode": "g722_encode_kernel", "g722_decode": "g722_decode_kernel",
                 "g726_encode (40 kbit/s)": "g726_encode_kernelILi5E",
                 "g726_decode (40 kbit/s)": "g726_decode_kernelILi5E"}
LEGS = 4096
TICKS = 100
CROSS_LEGS = 256
CROSS_TICKS = 100
E2E_LEGS = 1024
E2E_TICKS = 300
E2E_BIG_LEGS = 4096
E2E_BIG_TICKS = 100
SESSION_LEGS = 1024           # phase 7a: clients and server, each
SESSION_TICKS = 150
PACED_LEGS = 64               # phase 7b
PACED_TICKS = 300
PACED_PLAYED_MIN = 0.5        # 7b: share of a listener's ticks its talker's packets reach
CROSS_SESSION_LEGS = 8        # phase 7c
CROSS_SESSION_TICKS = 150
WIDE_LEGS = 1024              # phase 8a: clients and server, each
WIDE_TICKS = 150
SECURE_LEGS = 64              # phase 8b
SECURE_MIN_S = 3.0            # 8b's least wall time: several RTCP intervals
SECURE_MIN_TICKS = 150
SECURE_MAX_TICKS = 600
RTCP_INTERVAL_S = 0.5
CROSS_WIDE_LEGS = 8           # phase 8c
CROSS_WIDE_TICKS = 60
CHAIN_LEGS = 1024             # phase 9a: each codec chain
CHAIN_TICKS = 100
# 9a's audio_diff floors on legs 0, 37, 74, ...: 0.90 as the JAX package's
# fixture test holds dvi4 and g726_32 to; the two low rates from the same
# graph on the CPU, which read 0.9948 (16 kbit/s) and 0.9958 (24 kbit/s) at
# least over these legs and signals
CHAIN_BARS = {"dvi4": 0.90, "g726_16": 0.98, "g726_24": 0.98, "g726_32": 0.90, "g726_40": 0.90}
GATEWAY_LEGS = 1024           # phase 9b: each of the four batches
GATEWAY_ROUNDS = 150
GATEWAY_SETTLE = 40           # the listener bar starts here
CROSS_GATEWAY_LEGS = 8        # phase 9c
CROSS_GATEWAY_ROUNDS = 240
# 9c's bar: phase 4's audio_diff (>= 0.999) and energy gap (<= 1.5 dB), and
# an rms error of 2e-2 in place of 5e-3. The two backends' FSK differs in
# the last float32 bits (the generator's phase is a cumsum, summed in
# another order on the card), a mu-law code flips where a sample sits on a
# decision level, and from there the two G.726-32 encoders code
# near-equal signals with different codes: the listeners' recordings then
# differ by the codec's own quantisation noise (~30 dB under the 0.4 tone:
# ~1.3e-2 rms for two independent codings; 6.4e-3 was measured), with
# bursts where the tone / transition detector fires on one side only.
CROSS_GATEWAY_RMS = 2e-2
TTY_TEXT = "SOS 911"
P, F, S = 8, 481, 480         # the flagship's AEC at 48 kHz
SP, SF, S8 = 8, 81, 80        # the session's AEC at 8 kHz
WF, S16 = 161, 160            # the wideband call's AEC at 16 kHz


def ptxas_usage(log: str, fragment: str) -> dict:
    """Registers and spill bytes of the kernel whose mangled name holds
    ``fragment``, from nvcc's ``-Xptxas -v`` output: {"registers",
    "spill_stores", "spill_loads"}; raises if the log has no such kernel."""
    usage, current = {}, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = fragment in line
        elif current and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                         line)):
            usage["spill_stores"], usage["spill_loads"] = int(m[1]), int(m[2])
        elif current and (m := re.search(r"Used (\d+) registers", line)):
            usage["registers"] = int(m[1])
            current = False
    if set(usage) != {"registers", "spill_stores", "spill_loads"}:
        raise AssertionError(f"no -Xptxas -v report of {fragment} in the build log")
    return usage


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def device_ms(fn, n: int = 50) -> float:
    """Device time of one call of ``fn(i)``, without the host's wrapper
    cost: after 3 warm-up calls, the host's enqueue time for ``n`` calls is
    measured; then the stream spins (``torch.cuda._sleep``) for longer than
    that before one event pair around ``n`` calls, so the device runs them
    back to back; the pair's time over ``n``. ``i`` counts the calls, for
    callers that rotate through input sets."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2.0e9) + 1_000_000)   # >= 2x at <= 2 GHz
    a.record()
    for i in range(n):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


# -- bounds: the least time the card could take for a kernel's work -----------
# Each input byte read once, each output byte written once; operations
# over the float32 rate outside the tensor cores (none of the four has a
# matrix product). H100 SXM at 700 W: 3.35 TB/s, 67 TFLOP/s float32.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
L2_BYTES = 50e6


def fused_volume_cost(B, S):
    """(bytes, operations): x read, y written ([B, S] f32), four [B] f32
    in, energy and mean out; ~10 operations a sample."""
    return 4 * B * S * 2 + 4 * B * (4 + 2), 10 * B * S


def mdf_apply_cost(B, P, F, ws_bytes):
    """Wm (bf16) and Ws read over P partitions; the history Xh (bf16)
    shifted in place: partitions 0..P-2 read (the last one drops out, the
    new block takes partition 0), all P written; the new block Xr/Xi in and
    Ym/Ys out ([B, F] f32); two complex multiply-adds per (leg, partition,
    bin) and filter."""
    return (B * F * (P * (2 * 2 + 2 * ws_bytes) + (P - 1) * 2 * 2 + P * 2 * 2)
            + 4 * B * F * (2 + 4),
            16 * B * P * F)


def mdf_update_cost(B, P, F):
    """Ws (f32) and Wm (bf16) read and written, Xh read; Er, Ei,
    inv_norm, gc_r, gc_i in ([B, F] f32); mu, promote, reseed ([B] f32)
    and cpos in."""
    return (B * P * F * (2 * 4 * 2 + 2 * 2 * 2 + 2 * 2) + 4 * B * F * 5 + 4 * B * 3 + 4,
            28 * B * P * F)


def mdf_update_fused_cost(B, P, F, ws_bytes, wm_read_legs=0, wm_write_legs=0):
    """Ws read and written, Xh read; Wm read only on the legs that reseed
    (and are not hard-reset) and written only on the legs promoted, as the
    data of the call needs; the [B, F] f32 operands and the [B] flags, mu,
    cpos and srk in."""
    return (B * P * F * (2 * ws_bytes * 2 + 2 * 2) + P * F * 2 * 2 * (wm_read_legs + wm_write_legs)
            + 4 * B * F * 5 + B * (4 + 3) + 4 + 8,
            40 * B * P * F)


# G.722: a leg's 80 code slots run one after another, whatever the
# mapping (csrc/g722_kernels.cu gives a leg 16 lanes of a warp): each
# slot's predictor needs the previous slot's. The least time is then the
# slots' chain of dependent integer operations, counted from the work and
# not from the mapping, so that the share stays comparable across designs
# (hand-counted: the longest path through one slot, each add, shift,
# compare, select, multiply or table load one step, sums as binary trees):
# encode 42 (the lower band: the quantizer needs the prediction s, el ->
# wd -> 29 thresholds summed -> ilow -> dlow -> block 4 -> s), decode 27
# (the codes arrive from the wire, so the chain runs det -> dlowt -> block
# 4 -> s). Each step waits for its operand: at least 4 cycles of a
# dependent integer operation, at the H100's 1.98 GHz boost clock.
G722_SLOTS = 80
G722_CHAIN_OPS = {"g722_encode": 42, "g722_decode": 27}
G722_STATE_INTS = 80          # two bands of 28 int32, the 24-sample QMF line
DEP_OP_CYCLES = 4
SM_CLOCK_HZ = 1.98e9


def g722_cost(B, name):
    """(bytes, dependent operations of one leg's serial chain): pcm [B, 160]
    and codes [B, 80] int32, one in and one out, and the codec state read
    and written; the chain is 80 slots of G722_CHAIN_OPS."""
    return (B * (4 * 2 * G722_SLOTS + 4 * G722_SLOTS + 2 * 4 * G722_STATE_INTS),
            G722_SLOTS * G722_CHAIN_OPS[name])


def chain_bound(nbytes, cycles):
    """(bound ms, what bounds it, bytes bound ms, chain bound ms): a serial
    chain of ``cycles`` at 1.98 GHz against the bytes over 3.35 TB/s."""
    t_bytes, t_chain = nbytes / HBM_BYTES_PER_S, cycles / SM_CLOCK_HZ
    return (1e3 * max(t_bytes, t_chain), "bytes" if t_bytes >= t_chain else "operations",
            1e3 * t_bytes, 1e3 * t_chain)


def g722_bound(cost):
    """``chain_bound`` of a (bytes, dependent operations) pair, each
    operation DEP_OP_CYCLES."""
    return chain_bound(cost[0], cost[1] * DEP_OP_CYCLES)


# DVI4 and G.726 (csrc/adpcm_kernels.cu): one thread per leg runs the tick's
# samples one after another, as G.722. The chains, hand-counted from the
# kernels as the longest loop from one sample's state to the next's, each
# add, multiply, compare, select, min, max or table load one step of
# DEP_OP_CYCLES, sums as binary trees:
# - dvi4_encode 15: pred -> diff -> abs -> three compare / subtract-select
#   rounds against step, step/2, step/4 -> vpdiff -> pred +- vpdiff ->
#   clamp; dvi4_decode 4: the codes come from the wire, so only index ->
#   step load -> add -> clamp (and pred -> +- -> clamp beside it) carries;
# - g726_encode 37 steps plus the threshold count's (1 compare and a tree
#   over 1, 3, 7 or 15 thresholds: 1, 3, 4, 5), one log2f and one exp2f:
#   se -> d -> |d| -> log2f -> dln -> count -> code -> mag -> dqln load ->
#   dql -> exp2f -> dq -> p0 -> sign -> a2's update and clamp -> a1's
#   clamp against a2 -> a1*sr1 -> se;
# - g726_decode 16 steps and one exp2f: the codes come from the wire, so
#   the loop is y -> dql -> exp2f -> dq -> |dq| > threshold (the
#   transition detector) -> ap -> al -> y.
# log2f and exp2f are the accurate library functions: assumed 26 cycles
# each on the chain (an operand-range step, the MUFU.LG2 / MUFU.EX2 special
# function at ~18 cycles, a rescale step). G.726 has no true division:
# every divisor is a power of two, which compiles to a multiply.
DVI4_CHAIN_OPS = {"dvi4_encode": 15, "dvi4_decode": 4}
G726_RATES = {2: 16, 3: 24, 4: 32, 5: 40}         # bits a sample -> kbit/s
G726_ENCODE_OPS = {2: 38, 3: 40, 4: 41, 5: 42}
G726_DECODE_OPS = 16
SPECIAL_FN_CYCLES = 26
DVI4_STATE_INTS = 2
G726_STATE_FLOATS = 24


def adpcm_cost(B, S, name, bits=None):
    """(bytes, cycles of one leg's serial chain) of a DVI4 or G.726 kernel:
    samples [B, S] and codes [B, S], 4 bytes each, one in and one out, and
    the codec state read and written; the chain is S samples of the counts
    above."""
    if name in DVI4_CHAIN_OPS:
        words, cycles = DVI4_STATE_INTS, DVI4_CHAIN_OPS[name] * DEP_OP_CYCLES
    elif name == "g726_encode":
        words = G726_STATE_FLOATS
        cycles = G726_ENCODE_OPS[bits] * DEP_OP_CYCLES + 2 * SPECIAL_FN_CYCLES
    else:
        words, cycles = G726_STATE_FLOATS, G726_DECODE_OPS * DEP_OP_CYCLES + SPECIAL_FN_CYCLES
    return B * (2 * 4 * S + 2 * 4 * words), S * cycles


def bound(cost):
    """(bound ms, what bounds it) of a (bytes, operations) pair."""
    nbytes, ops = cost
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rotation(nbytes) -> int:
    """Input sets to cycle through so that back-to-back launches read
    device memory and not the 50 MB L2 (a real tick runs other work
    between two launches): enough sets for 2.5x the L2."""
    return max(1, min(64, math.ceil(2.5 * L2_BYTES / nbytes)))


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _require_equal(name, got, want):
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs err {_max_err(got, want)})")


def _timed(entry, cost, make_args, kernel_fn, plain_fn):
    """Device times of the kernel and its plain version on ``rotation``
    fresh input sets from ``make_args()``, beside the bound."""
    sets = [make_args() for _ in range(rotation(cost[0]))]
    entry["ms"] = device_ms(lambda i: kernel_fn(*sets[i % len(sets)]))
    entry["plain_ms"] = device_ms(lambda i: plain_fn(*sets[i % len(sets)]), n=10)
    entry["bound_ms"], entry["bound_by"] = bound(cost)
    entry["bytes"] = cost[0]
    return entry


def kernel_checks(kernels, dev, card, B, S, P, F, full=True):
    """Phase 2 at one set of shapes: each kernel against its plain version
    on the card, timed (device time, ``device_ms``) beside its bound.
    ``full`` adds the f32-shadow modes and mdf_update (the flagship's and
    the e2e leg's); the session's path runs the bf16-shadow kernels only."""
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, s=1.0: s * torch.randn(shape, generator=g, device=dev)
    legs = lambda: torch.rand((B,), generator=g, device=dev) < 0.3
    results = {}

    # fused_volume: [B, S] f32; sums run in another order (rtol 1e-5)
    def vol_args():
        return (rnd(B, S, s=0.5), rnd(B).abs() + 0.1, rnd(B).abs() + 0.1, rnd(B, s=0.05),
                (torch.rand((B,), generator=g, device=dev) < 0.5).float())
    vargs = vol_args()
    got = kernels.fused_volume(*vargs)
    want = kernels.fused_volume_reference(*vargs)
    err = 0.0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        err = max(err, _max_err(a, b))
    results["fused_volume"] = _timed(
        {"max_abs_err": err, "tolerance": "rtol 1e-5, atol 1e-6"}, fused_volume_cost(B, S),
        vol_args, kernels.fused_volume, kernels.fused_volume_reference)

    # mdf_apply: [B, P, F], bit-exact (no FMA contraction); shadow taps bf16
    # (the default) and f32 (the megakernel and f32-shadow modes)
    modes = [("mdf_apply (f32 Ws)", torch.float32)] if full else []
    for name, sdt in modes + [("mdf_apply", torch.bfloat16)]:
        def apply_args():
            return ([rnd(B, P, F, s=0.1).to(torch.bfloat16) for _ in range(2)]
                    + [rnd(B, P, F, s=0.1).to(sdt) for _ in range(2)]
                    + [rnd(B, P, F).to(torch.bfloat16) for _ in range(2)]
                    + [rnd(B, F) for _ in range(2)])
        args = apply_args()
        a_k = [t.clone() for t in args]
        got = kernels.mdf_apply(*a_k)
        want = kernels.mdf_apply_reference(*args)
        for i, (a, b) in enumerate(zip(got + tuple(a_k[4:6]), want + tuple(args[4:6]))):
            _require_equal(f"{name} output {i}", a, b)
        results[name] = _timed(
            {"max_abs_err": 0.0, "tolerance": "bit-exact"},
            mdf_apply_cost(B, P, F, torch.finfo(sdt).bits // 8), apply_args,
            kernels.mdf_apply, kernels.mdf_apply_reference)

    # mdf_update_fused: the f32 shadow mode at cpos 3, then the bf16 shadow
    # (default, timed) at cpos 0, 3, 7; 30% of legs promoted, reseeded or
    # hard-reset
    hist = [rnd(B, P, F).to(torch.bfloat16) for _ in range(2)]
    spec = [rnd(B, F, s=0.3), rnd(B, F, s=0.3), rnd(B, F).abs(),
            rnd(B, F, s=0.05), rnd(B, F, s=0.05)]
    mu = rnd(B).abs() * 0.6
    flags = [legs(), legs(), legs()]
    flags[0] &= ~flags[2]
    srk = torch.tensor(123456789, dtype=torch.int64, device=dev)
    cases = ((3, torch.float32),) if full else ()
    for cpos_v, sdt in cases + ((0, torch.bfloat16), (3, torch.bfloat16), (7, torch.bfloat16)):
        cpos = torch.tensor(cpos_v, dtype=torch.int32, device=dev)
        ws = [rnd(B, P, F, s=0.1).to(torch.bfloat16).to(sdt) for _ in range(2)]
        wm = [rnd(B, P, F, s=0.1).to(torch.bfloat16) for _ in range(2)]
        st_k = [t.clone() for t in ws + wm]
        st_p = [t.clone() for t in ws + wm]
        kernels.mdf_update_fused(cpos, *st_k, *hist, *spec, mu, *flags, srk)
        kernels.mdf_update_fused_reference(cpos, *st_p, *hist, *spec, mu, *flags, srk)
        for name, a, b in zip(("Ws_r", "Ws_i", "Wm_r", "Wm_i"), st_k, st_p):
            _require_equal(f"mdf_update_fused {name} cpos={cpos_v} {sdt}", a, b)

    def fused_args():
        return ([rnd(B, P, F, s=0.1).to(torch.bfloat16) for _ in range(6)]
                + [t.clone() for t in spec])
    wm_read = int((flags[1] & ~flags[2]).sum())
    results["mdf_update_fused"] = _timed(
        {"max_abs_err": 0.0, "tolerance": "bit-exact"},
        mdf_update_fused_cost(B, P, F, 2, wm_read, int(flags[0].sum())), fused_args,
        lambda *a: kernels.mdf_update_fused(cpos, *a, mu, *flags, srk),
        lambda *a: kernels.mdf_update_fused_reference(cpos, *a, mu, *flags, srk))
    if full:
        # mdf_update: f32 Ws, bf16 Wm [B, P, F], bit-exact at cpos 0, 3, 7;
        # promote and reseed 0/1 floats on 30% of legs each, never both
        pr_f, rs_f = flags[0].float(), (flags[1] & ~flags[0]).float()
        for cpos_v in (0, 3, 7):
            cpos = torch.tensor(cpos_v, dtype=torch.int32, device=dev)
            ws = [rnd(B, P, F, s=0.1) for _ in range(2)]
            wm = [rnd(B, P, F, s=0.1).to(torch.bfloat16) for _ in range(2)]
            st_k = [t.clone() for t in ws + wm]
            st_p = [t.clone() for t in ws + wm]
            kernels.mdf_update(cpos, *st_k, *hist, *spec, mu, pr_f, rs_f)
            kernels.mdf_update_reference(cpos, *st_p, *hist, *spec, mu, pr_f, rs_f)
            for name, a, b in zip(("Ws_r", "Ws_i", "Wm_r", "Wm_i"), st_k, st_p):
                _require_equal(f"mdf_update {name} cpos={cpos_v}", a, b)

        def update_args():
            return ([rnd(B, P, F, s=0.1) for _ in range(2)]
                    + [rnd(B, P, F, s=0.1).to(torch.bfloat16) for _ in range(4)]
                    + [t.clone() for t in spec])
        results["mdf_update"] = _timed(
            {"max_abs_err": 0.0, "tolerance": "bit-exact"}, mdf_update_cost(B, P, F),
            update_args, lambda *a: kernels.mdf_update(cpos, *a, mu, pr_f, rs_f),
            lambda *a: kernels.mdf_update_reference(cpos, *a, mu, pr_f, rs_f))
    for name, r in results.items():
        print(f"kernel {name} [B={B} S={S} P={P} F={F}]: matches plain ({r['tolerance']}, "
              f"max abs err {r['max_abs_err']}); device {r['ms']:.4f} ms per launch, bound "
              f"{r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.1f} MB, {r['bound_by']}), "
              f"{100 * r['bound_ms'] / r['ms']:.0f}% of bound; plain {r['plain_ms']:.4f} ms "
              f"[{card}]", flush=True)
    return results


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


G722_VECTORS = "tests/data/g722_vectors.npz"   # the ITU vectors: pcm, code, dec
G722_RAGGED = ((1, 33, 1000), (1, 7, 160))    # legs x code slots a tick, 2 ticks each


def _g722_run(kernels, name, blocks, dev):
    """Ticks ``blocks`` (int32 [B, n] each) through a G.722 kernel and its
    plain version, each from a fresh state carried across the ticks: the
    outputs and every state leaf bit for bit after each tick. Returns the
    plain outputs and both final states."""
    from mediastreamer2_tpu_torch.ops.g722 import g722_state
    kfn, pfn = getattr(kernels, name), getattr(kernels, f"{name}_reference")
    B = blocks[0].shape[0]
    st_k, st_p = g722_state(B, dev), g722_state(B, dev)
    outs = []
    for t, x in enumerate(blocks):
        got, want = kfn(x, st_k)[0], pfn(x, st_p)[0]
        _require_equal(f"{name} [B={B}, {x.shape[1]}] tick {t}", got, want)
        for i, (a, b) in enumerate(zip(kernels.g722_state_leaves(st_k),
                                       kernels.g722_state_leaves(st_p))):
            _require_equal(f"{name} [B={B}, {x.shape[1]}] state leaf {i} after tick {t}", a, b)
        outs.append(want)
    return outs, st_k, st_p


def g722_checks(kernels, dev, card, B):
    """Phase 2 for G.722, each kernel bit for bit against its plain version
    on the card (outputs and every state leaf after every tick): the ITU
    vectors (3,200 samples as one tick of 1,600 slots) on one leg and on B
    legs (even legs the vectors, equal to their codes and decoded samples;
    odd legs speech), three ticks of random samples or codes and three of
    speech (decoded from the plain encoder's codes) at B legs, and ragged
    shapes (G722_RAGGED, two ticks each). Then each kernel is timed beside
    its bounds (the serial chain and the bytes)."""
    vec = np.load(os.path.join(REPO, G722_VECTORS))
    n = vec["pcm"].shape[0]
    speech = speech_fixture(B, n, seed=5)
    for legs in (1, B):
        pcm = np.where((np.arange(legs) % 2 == 0)[:, None], vec["pcm"][None], speech[:legs])
        (enc,), _, _ = _g722_run(kernels, "g722_encode",
                                 [torch.from_numpy(pcm.astype(np.int32)).to(dev)], dev)
        if not (enc[0::2].cpu() == torch.from_numpy(vec["code"].astype(np.int32))).all():
            raise AssertionError(f"g722_encode [B={legs}]: the ITU vector's codes differ")
        c = np.where((np.arange(legs) % 2 == 0)[:, None], vec["code"][None], enc.cpu().numpy())
        (pcm_out,), _, _ = _g722_run(kernels, "g722_decode",
                                     [torch.from_numpy(c.astype(np.int32)).to(dev)], dev)
        if not (pcm_out[0::2].cpu() == torch.from_numpy(vec["dec"].astype(np.int32))).all():
            raise AssertionError(f"g722_decode [B={legs}]: the ITU vector's samples differ")
    print(f"g722 ITU vectors ({n} samples, one tick of {n // 2} slots) on 1 and {B} legs: "
          f"codes and decoded samples equal to the vectors, kernels equal to plain", flush=True)

    g = torch.Generator(device=dev).manual_seed(1)
    pcm = lambda: torch.randint(-32768, 32768, (B, S16), generator=g, device=dev,  # noqa: E731
                                dtype=torch.int32)
    codes = lambda: torch.randint(0, 256, (B, G722_SLOTS), generator=g, device=dev,  # noqa: E731
                                  dtype=torch.int32)
    speech = torch.from_numpy(speech_fixture(B, S16 * 3, seed=4)).to(dev)
    speech_codes, _, _ = _g722_run(
        kernels, "g722_encode",
        [speech[:, t * S16:(t + 1) * S16].contiguous() for t in range(3)], dev)
    _g722_run(kernels, "g722_decode", speech_codes, dev)
    for legs in G722_RAGGED[0]:
        for slots in G722_RAGGED[1]:
            _g722_run(kernels, "g722_encode", [torch.randint(
                -32768, 32768, (legs, 2 * slots), generator=g, device=dev, dtype=torch.int32)
                for _ in range(2)], dev)
            _g722_run(kernels, "g722_decode", [torch.randint(
                0, 256, (legs, slots), generator=g, device=dev, dtype=torch.int32)
                for _ in range(2)], dev)
    print(f"g722 speech ({B} legs, 3 ticks) and ragged shapes (legs {G722_RAGGED[0]} x slots "
          f"{G722_RAGGED[1]}, 2 ticks): kernels equal to plain", flush=True)

    results = {}
    for name, make in (("g722_encode", pcm), ("g722_decode", codes)):
        kfn, pfn = getattr(kernels, name), getattr(kernels, f"{name}_reference")
        _, st_k, _ = _g722_run(kernels, name, [make() for _ in range(3)], dev)
        cost = g722_cost(B, name)
        sets = [(make(), _clone_tree(st_k)) for _ in range(rotation(cost[0]))]
        r = {"max_abs_err": 0.0, "tolerance": "bit-exact",
             "ms": device_ms(lambda i: kfn(*sets[i % len(sets)])),
             "plain_ms": device_ms(lambda i: pfn(*sets[i % len(sets)]), n=3), "bytes": cost[0]}
        r["bound_ms"], r["bound_by"], r["bound_bytes_ms"], r["bound_chain_ms"] = g722_bound(cost)
        results[name] = r
        print(f"kernel {name} [B={B}, 80 slots]: matches plain (bit-exact: output and every "
              f"state leaf, 3 ticks); device {r['ms']:.4f} ms per launch, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}: serial chain "
              f"{G722_SLOTS} x {G722_CHAIN_OPS[name]} ops = {r['bound_chain_ms']:.4f} ms, "
              f"bytes {r['bytes'] / 1e6:.2f} MB = {r['bound_bytes_ms']:.4f} ms), "
              f"{100 * r['bound_ms'] / r['ms']:.0f}% of bound; plain {r['plain_ms']:.4f} ms "
              f"[{card}]", flush=True)
    return results


# G.726 on the card, kernel against plain version (float32 through log2f and
# exp2f, in the same association order, no contracted multiply-add): to the
# bit. No code may differ, and neither may a decoded sample or any of the 14
# state leaves (the measurement this check prints, PERF.md §5, has found no
# difference since the kernels were written).
G726_CODES_DIFFERING_MAX = 0
G726_PCM_ATOL = 0.0
G726_STATE_RTOL = 0.0
ADPCM_CHECK_TICKS = 3
# legs x samples a tick, two ticks each, at every rate: warps partly past B
# and ticks that are not a multiple of the lanes a leg
G726_RAGGED = ((1, 33, 77, 1000), (1, 7, 80, 200))


def speech_fixture(legs, n, seed=0) -> np.ndarray:
    """int32 [legs, n] at 8 kHz: two tones and filtered noise (the fixture
    of the G.726 tests), the first tone, the level and the noise varied
    per leg."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 8000
    tone = rng.uniform(200.0, 1800.0, (legs, 1))
    level = rng.uniform(0.05, 1.5, (legs, 1))
    noise = rng.standard_normal((legs, n + 5))
    noise = sum(noise[:, k:k + n] for k in range(6)) / 6
    sig = 7000 * np.sin(2 * np.pi * tone * t) + 2500 * np.sin(2 * np.pi * 1100 * t) + 800 * noise
    return np.clip(sig * level, -32000, 32000).astype(np.int32)


def g726_compare(kernels, blocks, bits, dev):
    """Run ``blocks`` (int32 [B, S] ticks of samples) through the G.726
    kernels and their plain versions on ``dev``, the state carried. Returns
    ``measured`` = (codes that differ between the encoders, the decoders'
    largest sample difference when both are fed the plain encoder's codes,
    the largest state difference of the encoders and of the decoders, each
    leaf's over its largest magnitude), the codes' largest difference, the
    plain codes per tick, and the kernels' final encoder and decoder
    states."""
    from mediastreamer2_tpu_torch.ops.g726 import g726_state
    B = blocks[0].shape[0]

    def state_err(a, b):
        return max(float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp(min=1e-3))
                   for k in kernels.G726_KEYS)

    ek, ep, dk, dp = (g726_state(B, dev) for _ in range(4))
    differing, pcm_err, e_err, d_err, code_err, codes = 0, 0.0, 0.0, 0.0, 0.0, []
    for x in blocks:
        got = kernels.g726_encode(x, ek, bits)[0]
        want = kernels.g726_encode_reference(x, ep, bits)[0]
        differing += int((got != want).sum())
        code_err = max(code_err, _max_err(got, want))
        e_err = max(e_err, state_err(ek, ep))
        codes.append(want)
        pcm_err = max(pcm_err, _max_err(kernels.g726_decode(want, dk, bits)[0],
                                        kernels.g726_decode_reference(want, dp, bits)[0]))
        d_err = max(d_err, state_err(dk, dp))
    return (differing, pcm_err, e_err, d_err), code_err, codes, ek, dk


def g726_bar_met(differing, pcm_err, e_err, d_err) -> bool:
    return (differing <= G726_CODES_DIFFERING_MAX and pcm_err <= G726_PCM_ATOL
            and max(e_err, d_err) <= G726_STATE_RTOL)


def g726_exact(kernels, blocks, bits, dev, what):
    """``g726_compare`` of ``blocks`` at ``bits``, held to the bar."""
    measured = g726_compare(kernels, blocks, bits, dev)[0]
    if not g726_bar_met(*measured):
        raise AssertionError(f"g726 at {G726_RATES[bits]} kbit/s, {what}: codes differing, "
                             f"sample and state errors {measured}")


def g726_ragged_checks(kernels, dev):
    """Every rate on every G726_RAGGED shape, two ticks of speech each, the
    state carried: the kernels equal to their plain versions."""
    for legs in G726_RAGGED[0]:
        for n in G726_RAGGED[1]:
            x = torch.from_numpy(speech_fixture(legs, 2 * n, seed=legs + n)).to(dev)
            blocks = [x[:, :n].contiguous(), x[:, n:].contiguous()]
            for bits in G726_RATES:
                g726_exact(kernels, blocks, bits, dev, f"{legs} legs x {n} samples")


def _adpcm_row(name, label, B, bits, kfn, pfn, make_set, err, tolerance, card, what):
    """Time one DVI4 / G.726 kernel and its plain version over input sets
    that spill the L2, beside its bounds; print the row."""
    cost = adpcm_cost(B, S8, name, bits)
    sets = [make_set() for _ in range(rotation(cost[0]))]
    r = {"max_abs_err": err, "tolerance": tolerance,
         "ms": device_ms(lambda i: kfn(*sets[i % len(sets)])),
         "plain_ms": device_ms(lambda i: pfn(*sets[i % len(sets)]), n=3), "bytes": cost[0]}
    r["bound_ms"], r["bound_by"], r["bound_bytes_ms"], r["bound_chain_ms"] = chain_bound(*cost)
    print(f"kernel {label} [B={B}, {S8} samples]: {what}; device {r['ms']:.4f} ms per launch, "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: serial chain {cost[1]} cycles = "
          f"{r['bound_chain_ms']:.4f} ms, bytes {r['bytes'] / 1e6:.2f} MB = "
          f"{r['bound_bytes_ms']:.4f} ms), {100 * r['bound_ms'] / r['ms']:.0f}% of bound; plain "
          f"{r['plain_ms']:.4f} ms [{card}]", flush=True)
    return r


def adpcm_checks(kernels, dev, card, B):
    """Phase 2 for DVI4 and G.726 at B legs, ADPCM_CHECK_TICKS ticks of the
    speech fixture with the state carried, each kernel against its plain
    version on the card. DVI4: codes, samples and both state leaves bit for
    bit. G.726, per rate: the codes that differ are counted, the decoder
    (fed the plain encoder's codes) and every state leaf are held to the
    bar above. Then each is timed beside its bounds. Returns the rows:
    dvi4_encode, dvi4_decode, and g726_encode / g726_decode keyed
    ``"g726_encode@32"`` by kbit/s."""
    ticks = ADPCM_CHECK_TICKS
    pcm = torch.from_numpy(speech_fixture(B, S8 * ticks, seed=2)).to(dev)
    tick = lambda a, t: a[:, t * S8:(t + 1) * S8].contiguous()          # noqa: E731
    zeros = lambda: torch.zeros((B,), dtype=torch.int32, device=dev)    # noqa: E731
    results = {}

    # DVI4: bit-exact
    codes = []
    ks, ps = (zeros(), zeros()), (zeros(), zeros())
    for t in range(ticks):
        got, want = kernels.dvi4_encode(tick(pcm, t), *ks)[0], \
            kernels.dvi4_encode_reference(tick(pcm, t), *ps)[0]
        _require_equal(f"dvi4_encode tick {t}", got, want)
        for name, a, b in zip(("pred", "index"), ks, ps):
            _require_equal(f"dvi4_encode {name} after tick {t}", a, b)
        codes.append(want)
    enc_state = ks
    ks, ps = (zeros(), zeros()), (zeros(), zeros())
    for t in range(ticks):
        _require_equal(f"dvi4_decode tick {t}", kernels.dvi4_decode(codes[t], *ks)[0],
                       kernels.dvi4_decode_reference(codes[t], *ps)[0])
        for name, a, b in zip(("pred", "index"), ks, ps):
            _require_equal(f"dvi4_decode {name} after tick {t}", a, b)
    what = f"matches plain (bit-exact: output, pred and index, {ticks} ticks)"
    results["dvi4_encode"] = _adpcm_row(
        "dvi4_encode", "dvi4_encode", B, None, kernels.dvi4_encode,
        kernels.dvi4_encode_reference,
        lambda: (tick(pcm, ticks - 1), *(s.clone() for s in enc_state)), 0.0, "bit-exact",
        card, what)
    results["dvi4_decode"] = _adpcm_row(
        "dvi4_decode", "dvi4_decode", B, None, kernels.dvi4_decode,
        kernels.dvi4_decode_reference,
        lambda: (codes[-1], *(s.clone() for s in ks)), 0.0, "bit-exact", card, what)

    # a ragged block and a tick longer than 80 samples (77 legs x 200
    # samples, one tick): DVI4 bit for bit; G.726 at every rate on
    # G726_RAGGED's shapes
    rb, rs = 77, 200
    x = torch.from_numpy(speech_fixture(rb, rs, seed=3)).to(dev)
    zr = lambda: torch.zeros((rb,), dtype=torch.int32, device=dev)      # noqa: E731
    c = kernels.dvi4_encode_reference(x, zr(), zr())[0]
    _require_equal("dvi4_encode ragged", kernels.dvi4_encode(x, zr(), zr())[0], c)
    _require_equal("dvi4_decode ragged", kernels.dvi4_decode(c, zr(), zr())[0],
                   kernels.dvi4_decode_reference(c, zr(), zr())[0])
    g726_ragged_checks(kernels, dev)
    print(f"g726 ragged shapes (legs {G726_RAGGED[0]} x samples {G726_RAGGED[1]}, 2 ticks, "
          f"every rate): kernels equal to plain in codes, samples and every state leaf",
          flush=True)

    # G.726 at each rate: measure, then hold to the bar
    for bits, kbps in G726_RATES.items():
        measured, code_err, codes, ek, dk = g726_compare(
            kernels, [tick(pcm, t) for t in range(ticks)], bits, dev)
        differing, pcm_err, e_err, d_err = measured
        total = B * S8 * ticks
        what = (f"against plain over {ticks} ticks of speech: codes differing {differing} of "
                f"{total} (bar {G726_CODES_DIFFERING_MAX}), decoded samples max abs err "
                f"{pcm_err:.3e} (bar {G726_PCM_ATOL}), state max rel err encoder {e_err:.3e} "
                f"decoder {d_err:.3e} (bar {G726_STATE_RTOL})")
        if not g726_bar_met(*measured):
            raise AssertionError(f"g726 at {kbps} kbit/s {what}")
        tol = "bit-exact: codes, samples and every state leaf"
        results[f"g726_encode@{kbps}"] = _adpcm_row(
            "g726_encode", f"g726_encode ({kbps} kbit/s)", B, bits,
            lambda x, st, bits=bits: kernels.g726_encode(x, st, bits),
            lambda x, st, bits=bits: kernels.g726_encode_reference(x, st, bits),
            lambda: (tick(pcm, ticks - 1), _clone_tree(ek)), code_err, tol,
            card, what)
        results[f"g726_decode@{kbps}"] = _adpcm_row(
            "g726_decode", f"g726_decode ({kbps} kbit/s)", B, bits,
            lambda x, st, bits=bits: kernels.g726_decode(x, st, bits),
            lambda x, st, bits=bits: kernels.g726_decode_reference(x, st, bits),
            lambda: (codes[-1], _clone_tree(dk)), pcm_err, tol, card, what)
    return results


def _device_ticks(a: np.ndarray, ticks: int, dev) -> torch.Tensor:
    """[legs, ticks*S] numpy -> [ticks, legs, S] contiguous on ``dev``."""
    legs = a.shape[0]
    return torch.from_numpy(a).to(dev).view(legs, ticks, S).permute(1, 0, 2).contiguous()


def run_flagship(legs, ticks, dev, mic, far):
    """Drive the flagship graph for ``ticks`` ticks. Returns (state,
    output [legs, ticks*samples] on ``dev``, all-finite flag, host seconds
    per tick over ticks 1.. (the first tick, which pays one-time set-up,
    is left out))."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.models.flagship import build_flagship
    cg, params = build_flagship(Factory(), legs, dev)
    state = cg.init_state(dev)
    mic_t, far_t = _device_ticks(mic, ticks, dev), _device_ticks(far, ticks, dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    outs = []
    for t in range(ticks):
        if t == 1:
            sync()
            t0 = time.perf_counter()
        state, out, _ = cg.step(state, params, {"mic": mic_t[t], "spk_ref": far_t[t]})
        finite &= torch.isfinite(out["out"]).all()
        outs.append(out["out"])
    sync()
    per_tick = (time.perf_counter() - t0) / (ticks - 1)
    return state, torch.cat(outs, dim=1), bool(finite), per_tick


@contextlib.contextmanager
def environ(**env):
    """Set environment variables for the block, restore them after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _require_counts(path, launches, want):
    """Every kernel's launches equal ``want``'s (0 where it names none)."""
    want = {k: want.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{path}: kernel launches {launches}, expected {want}")


def run_e2e(kernels, dev, card, legs, ticks, paced, srtp=False):
    """Phase 5: the e2e bench in megakernel mode (``srtp``: every leg
    protected on the edge); returns (result, the launches of its run, the
    ticks it dispatched)."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.core.rtgc import paused_gc
    from mediastreamer2_tpu_torch.models.e2e_bench import (WARMUP_TICKS,
                                                           E2EConferenceBench)
    b = E2EConferenceBench(Factory(), legs, dev, srtp=srtp)
    try:
        b.warm()                    # first launches outside the counted run
        t0 = b._t
        kernels.reset_launch_counts()
        with paused_gc():
            res = b.run(ticks + WARMUP_TICKS, paced=paced, trace=True)
        launches = kernels.launch_counts()
        dispatched = b._t - t0
        ws_dtype = str(b.state["ec"]["Ws_r"].dtype).replace("torch.", "")
        state_finite = all(bool(torch.isfinite(v).all()) for entry in b.state.values()
                           for v in entry.values() if v.is_floating_point())
    finally:
        b.close()
    ph = " ".join(f"{k} {v:.3f}" for k, v in res.phases_ms.items() if not k.endswith("_max"))
    print(f"e2e {'paced' if paced else 'unpaced'}{' SRTP' if srtp else ''}: {legs} legs x "
          f"{res.ticks} measured ticks "
          f"({dispatched} dispatched), K=1 D=2, megakernel AEC (Ws {ws_dtype}), "
          f"{res.ms_per_tick:.3f} ms/tick, late ticks {res.late_ticks}, loss "
          f"{res.loss_rate:.5f}, fidelity {res.fidelity:.5f}, mouth-to-ear "
          f"{res.mouth_to_ear_ms:.0f} ms, edge threads {b.edge_threads}, UDP GSO {b.gso}, "
          f"out finite {res.out_finite}, state finite {state_finite}, launches {launches}, "
          f"SRTP auth failures {res.auth_failures}; "
          f"host ms/tick by phase: {ph} [{card}]", flush=True)
    want = {"fused_volume": dispatched, "mdf_apply": dispatched,
            "mdf_update": dispatched, "mdf_update_fused": 0}
    _require_counts(f"e2e {legs} legs", launches, want)
    if ws_dtype != "float32":
        raise AssertionError(f"megakernel mode needs an f32 shadow, got {ws_dtype}")
    if not (res.out_finite and state_finite):
        raise AssertionError("e2e graph output or state holds non-finite values")
    if res.auth_failures:
        raise AssertionError(f"e2e SRTP: {res.auth_failures} authentication failures")
    return res, launches, dispatched


def e2e_cross(dev, legs, ticks):
    """Phase 6: the e2e graph on the CPU and on the card, megakernel mode,
    fed the same mu-law codes. Returns (outputs cpu, outputs card, both
    finite, cpu ms/tick)."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.models.e2e_bench import (build_e2e_graph, e2e_tick,
                                                           echo_coupled_codes)
    codes, mic = echo_coupled_codes(legs, ticks, seed=9)
    outs, finite, cpu_tick = [], True, 0.0
    for d in (torch.device("cpu"), dev):
        cg, params = build_e2e_graph(Factory(), legs, d)
        state = cg.init_state(d)
        codes_d, mic_d = torch.from_numpy(codes).to(d), torch.from_numpy(mic).to(d)
        out = []
        t0 = time.perf_counter()
        for t in range(ticks):
            state, _, _, o = e2e_tick(cg, state, params, codes_d[:, t * 80:(t + 1) * 80],
                                      mic_d[:, t * S:(t + 1) * S].contiguous())
            out.append(o)
        out = torch.cat(out, dim=1).cpu()
        if d.type == "cpu":
            cpu_tick = (time.perf_counter() - t0) / ticks
        finite &= bool(torch.isfinite(out).all()) and state["ec"]["Ws_r"].dtype == torch.float32
        outs.append(out.numpy())
    return outs[0], outs[1], finite, cpu_tick


# -- phase 7: the session layer ----------------------------------------------
def _tree_finite(tree):
    return all(_tree_finite(v) if isinstance(v, dict) else
               (not v.is_floating_point() or bool(torch.isfinite(v).all()))
               for v in tree.values())


class Session:
    """Echo-cancelling clients (AEC + AGC) against a conference server, both
    ``AudioStreamBatch`` on ``dev``, G.711 mu-law at 8 kHz or G.722 at
    16 kHz: legs 4k..4k+3 form conference k (``AudioConferenceControl``),
    leg 4k talks. The clients' push is tapped for the talkers' sent codes
    and for finite speakers."""

    def __init__(self, dev, legs, ticks, seed=3, codec="ulaw", rate=8000):
        """G.722 is stateful: its decoders start on the jitter buffers'
        empty ticks (code 0, as in the JAX package) and play a loud
        transient until the first packets have re-synchronised their
        predictors (~10 ticks), which the clients' echo cancellers and
        AGC then take ~30 more ticks to shed; ``settle`` = 40 ticks are left
        out of the bars (``bars``) and of the talker samples."""
        from mediastreamer2_tpu_torch import Factory, tick_samples
        from mediastreamer2_tpu_torch.models.audio_stream import (AudioStreamBatch,
                                                                  AudioStreamFeatures)
        from mediastreamer2_tpu_torch.models.conference import AudioConferenceControl
        from mediastreamer2_tpu_torch.utils.signals import make_speechlike
        self.legs, self.ticks, self.codec, self.rate = legs, ticks, codec, rate
        self.S = tick_samples(rate)
        self.settle = 40 if codec == "g722" else 0
        n = self.S * (ticks + 60)
        self.mic = np.zeros((legs, n), np.float32)
        for k in range(legs // 4):
            self.mic[4 * k] = make_speechlike(n, rate, seed=seed + k)
        f = Factory()
        self.clients = AudioStreamBatch(
            f, legs, codec=codec, rate=rate, mic_signal=self.mic, record_ticks=ticks + 60,
            device=dev, features=AudioStreamFeatures(echo_canceller=True, agc=True))
        self.server = AudioStreamBatch(f, legs, codec=codec, rate=rate, conference=True,
                                       device=dev)
        self.ctl = AudioConferenceControl(self.server.ticker)
        for leg in range(legs):
            self.ctl.add_member(leg, leg // 4)
        self.sent, self.finite = [], [True]
        for s, keep in ((self.clients, True), (self.server, False)):
            s.ticker.realtime = False
            self._tap(s, keep)

    def _tap(self, stream, keep):
        push = stream.ticker._io_push

        def tapped(tick, out):
            if keep:
                self.sent.append(out["rtp_tx"][::4].copy())
            self.finite[0] &= bool(np.isfinite(out["spk"]).all())
            push(tick, out)
        stream.ticker.set_io(pull=stream.ticker._io_pull, push=tapped)

    def loopback(self):
        from mediastreamer2_tpu_torch.net.rtp import LoopbackPair
        for leg in range(self.legs):
            pair = LoopbackPair()
            self.clients.set_transport(leg, pair.endpoint(0))
            self.server.set_transport(leg, pair.endpoint(1))

    def alternate(self, ticks, sample_every=0, iterate_every=0):
        """``ticks`` rounds of clients.do_tick() then server.do_tick();
        returns host ms per round and the active talkers sampled every
        ``sample_every`` rounds. ``iterate_every``: each side's iterate()
        once in that many rounds, the server's half a period after the
        clients' (so each side's report answers the other's latest SR)."""
        samples = []
        t0 = time.perf_counter()
        for t in range(ticks):
            self.clients.ticker.do_tick()
            self.server.ticker.do_tick()
            if sample_every and t % sample_every == sample_every - 1 and t >= self.settle:
                samples.append(self.ctl.active_talkers())
            if iterate_every and t % iterate_every == iterate_every // 2 - 1:
                self.clients.iterate()
            if iterate_every and t % iterate_every == iterate_every - 1:
                self.server.iterate()
        return 1e3 * (time.perf_counter() - t0) / ticks, samples

    def state_finite(self):
        for s in (self.clients, self.server):
            s.ticker.sync()
        return all(_tree_finite(entry) for s in (self.clients, self.server)
                   for entry in s.ticker.state.values() if entry)

    def said(self, conferences):
        """Each sampled talker's speech as sent: its wire codes decoded by
        the plain codec on the CPU ([len(conferences), ticks * S])."""
        sent = np.stack(self.sent)[:self.ticks][:, conferences]       # [ticks, n, 80]
        codes = torch.from_numpy(np.ascontiguousarray(
            sent.transpose(1, 0, 2).reshape(len(conferences), -1).astype(np.int32)))
        from mediastreamer2_tpu_torch.ops.g711 import pcm16_to_float, ulaw_decode
        if self.codec == "g722":
            from mediastreamer2_tpu_torch.ops.g722 import g722_state
            from mediastreamer2_tpu_torch.ops.kernels import g722_decode_reference
            pcm, _ = g722_decode_reference(codes, g722_state(len(conferences)))
        else:
            pcm = ulaw_decode(codes)
        return pcm16_to_float(pcm).numpy()

    def bars(self, conf_step, skip=()):
        """Every ``conf_step``-th conference: each listener's recording
        against its talker's speech as sent (the talker's codes on the
        wire, decoded: the talker's own AEC and AGC shape it) and as
        spoken (its mic signal), and the talker's own energy against its
        listeners' (mix-minus). Legs in ``skip`` are left out. With a
        ``settle`` window, a listener's recording from that tick on is held
        to the part of the speech it plays, found by the lag over the whole
        signals. Each listener's audio_diff against the speech sent and its
        lag are kept in ``self.leg_sims`` (leg -> (audio_diff, lag))."""
        from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff
        n = self.S * self.ticks
        start = self.S * self.settle

        def sim(ref, rec):
            got, lag = audio_diff(ref, rec)
            if not start:
                return got, lag
            lag = max(0, min(lag, start))
            return audio_diff(ref[start - lag:n - lag], rec[start:])[0], lag

        rec = self.clients.get_recording()[:, :n]
        confs = list(range(0, self.legs // 4, conf_step))
        said = self.said(confs)
        sim_sent, sim_mic, ratio = [], [], []
        self.leg_sims = {}
        for j, k in enumerate(confs):
            e_talker = float((rec[4 * k, start:] ** 2).mean())
            for leg in range(4 * k + 1, 4 * k + 4):
                if leg in skip:
                    continue
                got, lag = sim(said[j], rec[leg])
                sim_sent.append(got)
                self.leg_sims[leg] = (got, lag)
                sim_mic.append(sim(self.mic[4 * k, :n], rec[leg])[0])
                ratio.append(e_talker / (float((rec[leg, start:] ** 2).mean()) + 1e-20))
        return min(sim_sent), min(sim_mic), max(ratio), rec

    def heard(self):
        """{listener leg: int [ticks]}: for each tick of the listener's
        recording, the tick of its talker's speech that it played, followed
        through the listener's jitter buffer (the server's packet played),
        the server's mix and the talker's jitter buffer on the server (the
        talker's packet mixed); -1 where either buffer concealed the tick.
        Needs ``Playout`` on both streams (``self.playout``) from the first
        tick."""
        clients, server = self.playout
        out = {}
        for k in range(self.legs // 4):
            talker = clients.ticks_by_seq(4 * k)
            for leg in range(4 * k + 1, 4 * k + 4):
                mixed = server.ticks_by_seq(leg)
                got = np.full(self.ticks, -1)
                for t in range(self.ticks):
                    u = mixed.get(clients.played[t][leg])
                    v = talker.get(server.played[u][4 * k]) if u in server.played else None
                    got[t] = -1 if v is None else v
                out[leg] = got
        return out

    def check(self, conf_step, skip=()):
        """(bars met, a line that states them)."""
        sim_sent, sim_mic, ratio, _ = self.bars(conf_step, skip)
        ok = sim_sent > 0.85 and sim_mic > 0.7 and ratio < 0.05 and self.finite[0]
        return ok, (f"listeners vs talkers (every {conf_step}th conference): audio_diff min "
                    f"{sim_sent:.4f} against the speech sent, {sim_mic:.4f} against the "
                    f"mic; talker/listener energy max {ratio:.2e}; outputs finite "
                    f"{self.finite[0]}, bars met {ok}")


class Playout:
    """One stream's RTP sequence numbers by tick and leg: ``sent[tick]``
    the packet each leg sent that tick, ``played[tick]`` the packet each
    leg's jitter buffer played (None: the tick was concealed). Installed
    around the ticker's pull and push and each leg's jitter buffer's
    ``get_tick``, which the stream's pull calls once a leg."""

    def __init__(self, stream):
        self.sent, self.played = {}, {}
        sessions = stream.sessions
        now = [None] * len(sessions)
        for i, sess in enumerate(sessions):
            jb = sess.jitter_buffer

            def get_tick(i=i, jb=jb, get=jb.get_tick):
                seq, payload = jb.next_seq, get()
                now[i] = None if payload is None else seq
                return payload
            jb.get_tick = get_tick
        pull, push = stream.ticker._io_pull, stream.ticker._io_push

        def pulled(tick):
            now[:] = [None] * len(now)
            ext_in = pull(tick)
            self.played[tick] = list(now)
            return ext_in

        def pushed(tick, out):
            self.sent[tick] = [sess.seq for sess in sessions]    # this tick's packets
            push(tick, out)
        stream.ticker.set_io(pull=pulled, push=pushed)

    def ticks_by_seq(self, leg):
        """{sequence number: the tick that sent it} for ``leg``."""
        return {seqs[leg]: t for t, seqs in self.sent.items()}


def mapped_sim(ref, rec, S, heard):
    """The normalized correlation of ``rec``'s ticks with the ticks of
    ``ref`` they played (``heard[t]``, -1 for none), and the share of
    rec's ticks compared."""
    t = np.flatnonzero((heard >= 0) & (heard < len(ref) // S))
    a = rec[:len(heard) * S].astype(np.float64).reshape(-1, S)[t]
    b = ref[:len(ref) // S * S].astype(np.float64).reshape(-1, S)[heard[t]]
    den = np.sqrt((a * a).sum() * (b * b).sum())
    return (float((a * b).sum() / den) if den > 0 else 0.0), len(t) / max(len(heard), 1)


def session_launches(codec, ticks):
    """The kernel launches of ``ticks`` session tick pairs (clients then
    server): fused_volume 3 a pair (the clients' vol_send and vol_recv, the
    server's vol_recv: a conference=True stream has no send volume, in the
    JAX package too), the clients' AEC once (mdf_apply, mdf_update_fused),
    and with G.722 each side's encode and decode once; no other."""
    want = {"fused_volume": 3 * ticks, "mdf_apply": ticks, "mdf_update_fused": ticks}
    if codec == "g722":
        want.update(g722_encode=2 * ticks, g722_decode=2 * ticks)
    return want


def session_edge(kernels, dev, card, legs, ticks, phase="7a", codec="ulaw", rate=8000,
                 srtp=False):
    """Phases 7a and 8a: the session pair at full width over localhost UDP
    through the native batched edge (UDP GSO only where the kernel takes
    it); ``srtp``: AES_CM_128_HMAC_SHA1_80 on every leg, keys from a seeded
    generator. Returns the launches of the counted run."""
    from mediastreamer2_tpu_torch import native
    sess = Session(dev, legs, ticks, codec=codec, rate=rate)
    socks = []
    for _ in range(2):
        sk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sk.bind(("127.0.0.1", 0))
        sk.setblocking(False)
        for opt in (socket.SO_RCVBUF, socket.SO_SNDBUF):
            with contextlib.suppress(OSError):
                sk.setsockopt(socket.SOL_SOCKET, opt, 1 << 24)
        socks.append(sk)
    srv, cli = socks
    keys = None
    if srtp:
        rng = np.random.default_rng(8)
        keys = [(rng.bytes(16), rng.bytes(14)) for _ in range(legs)]
    try:
        sess.clients.enable_batch_edge(rx_sock=cli, tx_sock=cli, remote=srv.getsockname(),
                                       ssrc_base=0x6000, srtp_keys=keys)
        sess.server.enable_batch_edge(rx_sock=srv, tx_sock=srv, remote=cli.getsockname(),
                                      ssrc_base=0x6000, srtp_keys=keys)
        sess.clients.ticker.warm_up()
        sess.server.ticker.warm_up()
        kernels.reset_launch_counts()
        ms, samples = sess.alternate(ticks, sample_every=10)
        launches = kernels.launch_counts()
        sides = (sess.server, sess.clients)
        recv = [min(s._edge_rx.stats(i)["recv"] for i in range(legs)) for s in sides]
        auth = sum(s._edge_rx.auth_failures(i) for s in sides for i in range(legs))
        replay = sum(s._edge_rx.replay_drops(i) for s in sides for i in range(legs))
    finally:
        srv.close()
        cli.close()
    ph = {f"{who} {k}": v / ticks for who, s in (("clients", sess.clients),
                                                 ("server", sess.server))
          for k, v in s.ticker.phase_ms.items() if not k.endswith("_max")}
    ok, line = sess.check(conf_step=4)
    named = {k: set() for k in range(legs // 4)}
    stray = set()
    for sample in samples:
        for conf, who in sample.items():
            named[conf].update(who)
            stray.update(leg for leg in who if leg % 4)
    missing = [k for k, who in named.items() if 4 * k not in who]
    state_finite = sess.state_finite()
    what = (f"{codec} at {rate // 1000} kHz" + (", AES_CM_128_HMAC_SHA1_80 on every leg "
                                                f"(edge AES-NI {native.hw_crypto()})"
                                                if srtp else ""))
    print(f"session {phase}: {legs} + {legs} legs (AEC+AGC clients, conference server, "
          f"{legs // 4} four-party conferences, {what}) x {ticks} ticks over the batch edge, "
          f"UDP GSO {sess.server.gso}: {ms:.3f} ms per tick pair (host clock); host ms/tick by "
          f"phase: " + " ".join(f"{k} {v:.3f}" for k, v in ph.items())
          + f"; launches {launches}; edge recv min server {recv[0]} clients {recv[1]}, SRTP "
          f"auth failures {auth}, replay drops {replay}; {line}; state finite "
          f"{state_finite}; conferences whose talker was never named {len(missing)}, "
          f"listeners named {len(stray)} [{card}]", flush=True)
    _require_counts(f"session {phase}", launches, session_launches(codec, ticks))
    if min(recv) < ticks // 2:
        raise AssertionError(f"session {phase}: a leg received only {min(recv)} packets")
    if auth or replay:
        raise AssertionError(f"session {phase}: {auth} SRTP authentication failures, "
                             f"{replay} replay drops")
    if missing or stray or not (state_finite and ok):
        raise AssertionError(f"session {phase}: talkers not named in conferences {missing[:8]}, "
                             f"listeners named {sorted(stray)[:8]}, state finite "
                             f"{state_finite}, bars met {ok}")
    return launches


def session_paced(dev, card, legs, ticks):
    """Phase 7b: the session pair over LoopbackPair (the per-leg RtpSession
    path), both tickers warmed, then start()ed paced on their own threads:
    the clients for ``ticks`` ticks, the server until 20 ticks after them.
    Both tickers run late (their host time exceeds a tick), so the jitter
    buffers' fill drifts and they underrun or discard mid-run, as the JAX
    package's do: each such event conceals a tick or skips one, and moves
    the playout's delay by a tick, which one audio_diff lag over the whole
    run cannot follow. So each listener's recording is held to its
    talker's speech tick by tick along the path its packets took
    (``Playout``, ``Session.heard``): every stretch between events at its
    own delay, the concealed ticks left out. The fixed-lag audio_diff is
    printed beside it. Returns the Session."""
    sess = Session(dev, legs, ticks, seed=40)
    sess.loopback()
    sess.playout = (Playout(sess.clients), Playout(sess.server))
    for s in (sess.server, sess.clients):
        s.ticker.realtime = True
        s.ticker.warm_up()
    sess.server.ticker.start()
    sess.clients.ticker.start(ticks)
    sess.clients.ticker._run_thread.join(timeout=30 + ticks * 0.05)
    alive = sess.clients.ticker._run_thread.is_alive()
    time.sleep(0.2)
    for s in (sess.clients, sess.server):
        s.stop()
    if alive:
        raise AssertionError("session 7b: the paced clients did not finish")
    st = [(s.ticker.stats.ticks, s.ticker.stats.late_ticks, s.ticker.get_average_load(),
           s.ticker.stats.mean_step_ms) for s in (sess.clients, sess.server)]
    fixed_sent, fixed_mic, ratio, rec = sess.bars(conf_step=1)
    said = sess.said(list(range(legs // 4)))
    sess.heard_sims = {}
    for leg, heard in sess.heard().items():
        sent, played = mapped_sim(said[leg // 4], rec[leg], sess.S, heard)
        mic = mapped_sim(sess.mic[leg - leg % 4], rec[leg], sess.S, heard)[0]
        sess.heard_sims[leg] = (sent, mic, played)
    sent, mic, played = (min(v[i] for v in sess.heard_sims.values()) for i in range(3))
    ok = (sent > 0.85 and mic > 0.7 and played >= PACED_PLAYED_MIN and ratio < 0.05
          and sess.finite[0])

    def jb(stream, leg):
        b = stream.sessions[leg].jitter_buffer
        return (f"{b.underruns}/{b.resyncs}/{b.lost}/{b.discarded}/{b.stretched}")
    legs_line = "; ".join(
        f"{leg} {got:.4f} lag {lag} along the path {sess.heard_sims[leg][0]:.4f} / "
        f"{sess.heard_sims[leg][1]:.4f} played {sess.heard_sims[leg][2]:.3f} jb "
        f"{jb(sess.clients, leg)} talker jb {jb(sess.server, leg - leg % 4)}"
        for leg, (got, lag) in sess.leg_sims.items())
    line = (f"listeners along their packets' path: min {sent:.4f} against the speech sent "
            f"(bar 0.85), {mic:.4f} against the mic (bar 0.7), ticks played from the "
            f"talker's packets min {played:.3f} (bar {PACED_PLAYED_MIN}); at one fixed lag: "
            f"audio_diff min {fixed_sent:.4f} against the speech sent, {fixed_mic:.4f} "
            f"against the mic; talker/listener energy max {ratio:.2e}; outputs finite "
            f"{sess.finite[0]}, bars met {ok}")
    print(f"session 7b: {legs} + {legs} legs x {ticks} ticks paced over LoopbackPair, "
          + ", ".join(f"{who} {n} ticks, late {late}, load {load:.3f}, mean {mean:.3f} ms"
                      for who, (n, late, load, mean) in zip(("clients", "server"), st))
          + "; host ms/tick by phase: " + " ".join(
              f"{who} {k} {v / s.ticker.stats.ticks:.3f}"
              for who, s in (("clients", sess.clients), ("server", sess.server))
              for k, v in s.ticker.phase_ms.items() if not k.endswith("_max"))
          + f"; {line}; every listener: leg, audio_diff against the speech sent at one lag, "
          f"that lag, against the speech sent / the mic along its packets' path, the share "
          f"of its ticks played from its talker's packets, its jitter buffer's and its "
          f"talker's (on the server) underruns/resyncs/lost/discarded/stretched: "
          f"{legs_line} [{card}]", flush=True)
    if not ok:
        raise AssertionError("session 7b: bars not met")
    return sess


def session_cross(dev, legs, ticks):
    """Phase 7c: the same session on the CPU (plain versions) and on the
    card (kernels), over LoopbackPair with alternating do_tick; returns
    the clients' recordings of the listeners, CPU then card."""
    recs = []
    for d in (torch.device("cpu"), dev):
        sess = Session(d, legs, ticks, seed=70)
        sess.loopback()
        sess.alternate(ticks)
        ok, line = sess.check(conf_step=1)
        if not ok:
            raise AssertionError(f"session 7c on {d.type}: {line}")
        rec = sess.clients.get_recording()[:, :S8 * ticks]
        recs.append(rec[[leg for leg in range(legs) if leg % 4]])
    return recs


# -- phase 8: the secured wideband call ---------------------------------------
def secure_session(dev, legs, max_ticks, wrong_key_leg=None, seed=90):
    """Phase 8b's configuration: the G.722 session pair over LoopbackPair
    with per-leg SRTP keyed by SDES (each side generates its key line, the
    other parses it), RTCP every RTCP_INTERVAL_S, and on every leg a
    quality indicator (counting the reports it was fed) and a bitrate
    controller (whose ptime ladder drives ``set_ptime``). The clients'
    ``wrong_key_leg`` gets a receive key that is not the server's.
    Returns (session, {(side, leg): quality indicator})."""
    from mediastreamer2_tpu_torch.models import qos
    from mediastreamer2_tpu_torch.net.srtp import sdes_generate, sdes_parse

    class Indicator(qos.QualityIndicator):
        reports = 0

        def update(self, stats):
            self.reports += 1
            return super().update(stats)

    sess = Session(dev, legs, max_ticks, seed=seed, codec="g722", rate=16000)
    sess.loopback()
    for leg in range(legs):
        offer, kc, sc = sdes_generate()
        answer, ks, ss = sdes_generate()
        _, rkc, rsc = sdes_parse("1 " + offer)           # the server reads the offer
        _, rks, rss = sdes_parse("1 " + answer)          # the clients read the answer
        if leg == wrong_key_leg:
            rks = bytes(16)
        sess.clients.enable_srtp(leg, kc, sc, rks, rss)
        sess.server.enable_srtp(leg, ks, ss, rkc, rsc)
    qis = {}
    for side, stream in (("clients", sess.clients), ("server", sess.server)):
        stream.enable_rtcp(interval_s=RTCP_INTERVAL_S)
        for leg in range(legs):
            qis[(side, leg)] = qi = Indicator()
            stream.attach_quality_indicator(leg, qi)
            stream.attach_bitrate_controller(leg, qos.BitrateController(
                qos.SimpleQosAnalyzer(), qos.AudioBitrateDriver(
                    lambda bps: None, lambda ms, st=stream, leg=leg: st.set_ptime(leg, ms))))
    for stream in (sess.clients, sess.server):
        stream.ticker.warm_up()
    return sess, qis


def session_secure(dev, card, legs):
    """Phase 8b: 8b's configuration, alternating do_ticks with iterate()
    every 10 rounds until SECURE_MIN_S of wall time and SECURE_MIN_TICKS
    rounds have passed."""
    wrong = 5                                             # a listener of conference 1
    sess, qis = secure_session(dev, legs, SECURE_MAX_TICKS, wrong_key_leg=wrong)
    t0, ran, ms = time.perf_counter(), 0, []
    while ran < SECURE_MIN_TICKS or time.perf_counter() - t0 < SECURE_MIN_S:
        ms.append(sess.alternate(10, iterate_every=10)[0])
        ran += 10
        if ran >= SECURE_MAX_TICKS:
            raise AssertionError(f"session 8b: {ran} rounds in {time.perf_counter() - t0:.1f} s")
    wall = time.perf_counter() - t0
    sess.ticks = ran
    ok, line = sess.check(conf_step=1, skip=(wrong,))
    legs_ok = [(side, leg) for side in ("clients", "server") for leg in range(legs)
               if leg != wrong]
    unreported = [k for k in legs_ok if qis[k].reports == 0]
    stream = {"clients": sess.clients, "server": sess.server}
    rtts = {k: stream[k[0]].sessions[k[1]].rtcp.last_rtt_ms for k in legs_ok}
    no_rtt = [k for k, v in rtts.items() if v is None]
    rating = min(qis[k].rating for k in legs_ok)
    bad = sess.clients.sessions[wrong]
    auth = sum(s.sessions[leg].transport.auth_failures for s in stream.values()
               for leg in range(legs) if leg != wrong)
    known = sorted(v for v in rtts.values() if v is not None)
    print(f"session 8b: {legs} + {legs} legs, G.722 at 16 kHz, per-leg SRTP (SDES), RTCP every "
          f"{RTCP_INTERVAL_S} s, quality indicator and bitrate controller on every leg, "
          f"{ran} rounds in {wall:.2f} s ({sum(ms) / len(ms):.3f} ms per tick pair, host "
          f"clock), iterate() every 10: legs without a remote report {len(unreported)}, "
          f"without an RTT {len(no_rtt)}, RTT ms min/median/max "
          + (f"{known[0]:.3f}/{known[len(known) // 2]:.3f}/{known[-1]:.3f}" if known else "-")
          + f", quality indicator min {rating:.3f}, SRTP auth failures {auth} (the wrong-key "
          f"leg: received {bad.stats.recv_packets} packets, auth failures "
          f"{bad.transport.auth_failures}); {line} [{card}]", flush=True)
    if unreported or no_rtt or rating < 4.5 or auth:
        raise AssertionError(f"session 8b: unreported {unreported[:4]}, no RTT {no_rtt[:4]}, "
                             f"quality indicator min {rating}, auth failures {auth}")
    if bad.stats.recv_packets or not bad.transport.auth_failures:
        raise AssertionError("session 8b: the leg with the wrong key received media")
    if not ok:
        raise AssertionError("session 8b: listener bars not met")


def session_secure_cross(dev, legs, ticks):
    """Phase 8c: 8b's configuration on the CPU (plain versions) and on the
    card (kernels), ``ticks`` rounds each; returns the clients'
    recordings of the listeners, CPU then card. (8b holds the listener
    bars of this configuration on the card; 8c holds the two backends to
    each other.)"""
    recs = []
    for d in (torch.device("cpu"), dev):
        sess, _ = secure_session(d, legs, ticks, seed=110)
        sess.alternate(ticks, iterate_every=10)
        rec = sess.clients.get_recording()[:, :sess.S * ticks]
        recs.append(rec[[leg for leg in range(legs) if leg % 4]])
    return recs


# -- phase 9: the gateway transcoder ------------------------------------------
def speech_legs(legs, n, seed):
    """float32 [legs, n]: each leg its own speech-like signal at 8 kHz."""
    from mediastreamer2_tpu_torch.utils.signals import make_speechlike
    return np.stack([make_speechlike(n, 8000, seed=seed + leg) for leg in range(legs)])


def codec_chain(kernels, dev, card, codec, sig, ticks):
    """Phase 9a, one codec: file_player -> enc -> dec -> file_recorder
    through a free-running Ticker, every leg playing its row of ``sig``.
    Returns the launches of the run."""
    from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder
    from mediastreamer2_tpu_torch.core.ticker import Ticker
    from mediastreamer2_tpu_torch.ops.fileio import recorder_get_audio
    from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff
    legs = sig.shape[0]
    g = GraphBuilder(Factory(), batch=legs)
    p = g.add("file_player", "play", fmt=Format(rate=8000), signal=sig)
    g.chain(p, g.add(f"{codec}_enc", "enc"), g.add(f"{codec}_dec", "dec"),
            g.add("file_recorder", "rec", max_ticks=ticks))
    tk = Ticker(g.build(), device=dev, name=f"chain[{codec}]", realtime=False)
    tk.warm_up()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tk.run(ticks)
    tk.sync()
    ms = 1e3 * (time.perf_counter() - t0) / ticks
    launches = kernels.launch_counts()
    rec = recorder_get_audio(tk.state["rec"], ticks, S8)
    sims = [audio_diff(sig[leg, :ticks * S8], rec[leg]) for leg in range(0, legs, 37)]
    sim, shifts = min(s for s, _ in sims), {k for _, k in sims}
    finite = all(_tree_finite(entry) for entry in tk.state.values() if entry)
    kind = codec.split("_")[0]
    print(f"chain 9a {codec}: {legs} legs x {ticks} ticks, file_player -> {codec}_enc -> "
          f"{codec}_dec -> file_recorder through Ticker: {ms:.3f} ms/tick (host clock), "
          f"launches {launches}, audio_diff min {sim:.4f} over legs 0, 37, ... (bar "
          f"{CHAIN_BARS[codec]}), shifts {sorted(shifts)}, state finite {finite} [{card}]",
          flush=True)
    _require_counts(f"chain {codec}", launches, {f"{kind}_encode": ticks, f"{kind}_decode": ticks})
    if not (sim > CHAIN_BARS[codec] and shifts == {0} and finite
            and bool(np.isfinite(rec).all())):
        raise AssertionError(f"chain {codec}: audio_diff {sim}, shifts {shifts}, finite {finite}")
    return launches


class Gateway:
    """Phase 9b's path: mu-law talkers -> TranscodeBatch(ulaw -> g726_32) ->
    TranscodeBatch(g726_32 -> ulaw) -> mu-law listeners, ``legs`` legs in
    each of the four batches on ``dev``, every hop a LoopbackPair per leg
    (the per-leg RtpSession path: TranscodeBatch has no batch edge, in the
    JAX package neither). The listeners only receive. ``tty`` builds
    talkers and listeners with the Baudot feature and a silent mic, and
    every talker types ``tty``."""

    def __init__(self, dev, legs, rounds, seed, tty=None):
        from mediastreamer2_tpu_torch import Factory, TranscodeBatch
        from mediastreamer2_tpu_torch.models.audio_stream import (AudioStreamBatch,
                                                                  AudioStreamFeatures)
        from mediastreamer2_tpu_torch.net.rtp import LoopbackPair
        self.legs, self.rounds = legs, rounds
        n = S8 * rounds
        self.mic = (np.zeros((legs, n), np.float32) if tty else speech_legs(legs, n, seed))
        f = Factory()
        feats = AudioStreamFeatures(baudot=bool(tty))
        self.talkers = AudioStreamBatch(f, legs, codec="ulaw", mic_signal=self.mic,
                                        features=feats, device=dev)
        self.up = TranscodeBatch(f, legs, codec_in="ulaw", rate_in=8000,
                                 codec_out="g726_32", rate_out=8000, device=dev)
        self.down = TranscodeBatch(f, legs, codec_in="g726_32", rate_in=8000,
                                   codec_out="ulaw", rate_out=8000, device=dev)
        self.listeners = AudioStreamBatch(f, legs, codec="ulaw", record_ticks=rounds,
                                          features=feats, device=dev)
        self.batches = (self.talkers, self.up, self.down, self.listeners)
        for leg in range(legs):
            a, m, b = LoopbackPair(), LoopbackPair(), LoopbackPair()
            self.talkers.set_transport(leg, a.endpoint(0))
            self.up.set_transports(leg, rx=a.endpoint(1), tx=m.endpoint(0))
            self.down.set_transports(leg, rx=m.endpoint(1), tx=b.endpoint(0))
            self.listeners.set_transport(leg, b.endpoint(1))
            self.listeners.set_direction(leg, "recvonly")
            if tty:
                self.talkers.send_baudot_string(leg, tty)
        self.sent = []                       # the sampled talkers' codes on the wire
        push = self.talkers.ticker._io_push

        def tapped(tick, out):
            self.sent.append(out["rtp_tx"][::37].copy())
            push(tick, out)
        self.talkers.ticker.set_io(pull=self.talkers.ticker._io_pull, push=tapped)
        for s in self.batches:
            s.ticker.realtime = False
            s.ticker.warm_up()

    def run(self):
        """``rounds`` rounds of one do_tick of each batch in turn (the
        listeners pump their events each round); host ms per round."""
        t0 = time.perf_counter()
        for _ in range(self.rounds):
            for s in self.batches:
                s.ticker.do_tick()
            if self.talkers.features.baudot:
                self.listeners.iterate()
        for s in self.batches:
            s.ticker.sync()
        return 1e3 * (time.perf_counter() - t0) / self.rounds

    def heard(self, settle):
        """The sampled listeners' recordings (legs 0, 37, ...) against their
        talkers' speech as sent (the wire codes decoded), from round
        ``settle`` on, aligned by the lag over the whole signals: the least
        audio_diff, and the lags."""
        from mediastreamer2_tpu_torch.ops.g711 import pcm16_to_float, ulaw_decode
        from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff
        n, start = S8 * self.rounds, S8 * settle
        rec = self.listeners.get_recording()[::37, :n]
        sent = np.stack(self.sent)[:self.rounds]                       # [rounds, k, 80]
        said = pcm16_to_float(ulaw_decode(torch.from_numpy(np.ascontiguousarray(
            sent.transpose(1, 0, 2).reshape(rec.shape[0], -1).astype(np.int32))))).numpy()
        sims, lags = [], []
        for ref, got in zip(said, rec):
            lag = max(0, min(audio_diff(ref, got)[1], start))
            sims.append(audio_diff(ref[start - lag:n - lag], got[start:])[0])
            lags.append(lag)
        return min(sims), sorted(set(lags))

    def state_finite(self):
        return all(_tree_finite(entry) for s in self.batches
                   for entry in s.ticker.state.values() if entry)


def gateway_launches(rounds):
    """The kernel launches of ``rounds`` gateway rounds: the two G.726
    launches (the transcoders' encode and decode) and the four volumes of
    the talkers and the listeners (each stream's vol_send and vol_recv)."""
    return {"g726_encode": rounds, "g726_decode": rounds, "fused_volume": 4 * rounds}


def gateway_full(kernels, dev, card, legs, rounds):
    """Phase 9b. Returns the launches of the counted run."""
    t0 = time.perf_counter()
    gw = Gateway(dev, legs, rounds, seed=200)
    setup_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    ms = gw.run()
    launches = kernels.launch_counts()
    sim, lags = gw.heard(GATEWAY_SETTLE)
    recv = min(s.stats.recv_packets for s in gw.listeners.sessions)
    finite = gw.state_finite()
    ph = " ".join(f"{who} {k} {v / rounds:.3f}" for who, s in (("up", gw.up), ("down", gw.down))
                  for k, v in s.ticker.phase_ms.items() if not k.endswith("_max"))
    print(f"gateway 9b: 4 x {legs} legs (mu-law talkers -> ulaw->g726_32 -> g726_32->ulaw -> "
          f"mu-law listeners, a LoopbackPair per leg and hop) x {rounds} rounds: {ms:.3f} ms "
          f"per round (host clock; set-up {setup_s:.1f} s); transcoders' host ms/tick by "
          f"phase: {ph}; launches {launches}; listeners vs the speech sent from round "
          f"{GATEWAY_SETTLE} on (legs 0, 37, ...): audio_diff min {sim:.4f} (bar 0.85), lags "
          f"{lags} samples; packets received min {recv} of {rounds}; state finite {finite} "
          f"[{card}]", flush=True)
    _require_counts("gateway 9b", launches, gateway_launches(rounds))
    if not (sim > 0.85 and recv >= rounds // 2 and finite):
        raise AssertionError(f"gateway 9b: audio_diff {sim}, received {recv}, finite {finite}")
    return launches


def gateway_cross(dev, legs, rounds):
    """Phase 9c: the gateway with Baudot on talkers and listeners, every
    talker typing TTY_TEXT, on the CPU (plain versions) and on the card
    (kernels); returns the listeners' recordings, CPU then card, and the
    texts read on each."""
    recs, texts = [], []
    for d in (torch.device("cpu"), dev):
        gw = Gateway(d, legs, rounds, seed=300, tty=TTY_TEXT)
        gw.run()
        recs.append(gw.listeners.get_recording()[:, :S8 * rounds])
        texts.append([gw.listeners.get_baudot_text(leg) for leg in range(legs)])
    return recs, texts


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false); this script runs only on the card")
    sys.path.insert(0, REPO)
    from mediastreamer2_tpu_torch import native
    from mediastreamer2_tpu_torch.models.flagship import echo_coupled_inputs
    from mediastreamer2_tpu_torch.ops import kernels
    from mediastreamer2_tpu_torch.utils.audiodiff import quality_bar

    dev = torch.device("cuda", 0)
    card = card_line()
    start = time.perf_counter()

    def phase_done(n):
        print(f"phase {n} done at {time.perf_counter() - start:.1f} s", flush=True)

    # phase 1: environment and build
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:     # nvcc (one per source) and g++ side by side
        k_build = pool.submit(kernels.build)
        e_build = pool.submit(native.build)
        libs, log = k_build.result()
        edge = e_build.result()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          + ", ".join(os.path.relpath(p, REPO) for p in (*libs, edge)), flush=True)
    if log.strip():
        print(log.strip(), flush=True)
    for name, fragment in SPILL_CHECKED.items():
        u = ptxas_usage(log, fragment)
        print(f"{name}: {u['registers']} registers, spill stores {u['spill_stores']} bytes, "
              f"spill loads {u['spill_loads']} bytes", flush=True)
        if u["spill_stores"] or u["spill_loads"]:
            raise AssertionError(f"{name} spills registers: {u}")
    print(f"edge AES: {'AES-NI/SHA-NI/PCLMUL' if native.hw_crypto() else 'libcrypto EVP'} "
          f"(hw_crypto {native.hw_crypto()})", flush=True)
    # which system libraries the host codecs would load (ctypes, as the JAX
    # package's ops/host_codecs.py and ops/h264.py look them up)
    print("system libraries: " + ", ".join(f"{name} {ctypes.util.find_library(name)}"
                                           for name in SYSTEM_LIBRARIES), flush=True)

    phase_done(1)

    # phase 2: kernels against their plain versions on the card, at the
    # flagship's, the session's and the wideband call's shapes; G.722
    results = kernel_checks(kernels, dev, card, LEGS, S, P, F)
    session_results = kernel_checks(kernels, dev, card, SESSION_LEGS, S8, SP, SF, full=False)
    wide_results = kernel_checks(kernels, dev, card, WIDE_LEGS, S16, SP, WF, full=False)
    results.update(g722_checks(kernels, dev, card, WIDE_LEGS))
    adpcm_results = adpcm_checks(kernels, dev, card, GATEWAY_LEGS)

    phase_done(2)

    # phase 3: the flagship at 4,096 legs, counted launches
    mic, far = echo_coupled_inputs(LEGS, TICKS, seed=11)
    kernels.reset_launch_counts()
    state, out, finite, per_tick = run_flagship(LEGS, TICKS, dev, mic, far)
    launches = kernels.launch_counts()
    del mic, far
    ec = state["ec"]
    conv = float((ec["Es"] < 0.5 * ec["Dn"]).float().mean())
    tap_mb = sum(ec[k].numel() * ec[k].element_size()
                 for k in ("Wm_r", "Wm_i", "Ws_r", "Ws_i", "Xh_r", "Xh_i")) / 1e6
    print(f"flagship: {LEGS} legs x {TICKS} ticks, {1e3 * per_tick:.3f} ms/tick "
          f"(host clock, ticks 1..{TICKS - 1}), AEC taps+history {tap_mb:.1f} MB, "
          f"launches {launches}, finite {finite}, shadow converged on "
          f"{100 * conv:.1f}% of legs, out {tuple(out.shape)} [{card}]", flush=True)
    _require_counts("flagship", launches, {"fused_volume": TICKS, "mdf_apply": TICKS,
                                           "mdf_update": 0, "mdf_update_fused": TICKS})
    if not finite:
        raise AssertionError("flagship output holds non-finite values")
    if tuple(out.shape) != (LEGS, TICKS * 160):
        raise AssertionError(f"flagship output shape {tuple(out.shape)}")
    if conv < 0.9:
        raise AssertionError(f"shadow filter converged on only {100 * conv:.1f}% of legs")
    del state, out

    phase_done(3)

    # phase 4: the port on the CPU against the port on the card
    mic, far = echo_coupled_inputs(CROSS_LEGS, CROSS_TICKS, seed=7)
    _, out_cpu, fin_cpu, cpu_tick = run_flagship(CROSS_LEGS, CROSS_TICKS,
                                              torch.device("cpu"), mic, far)
    _, out_gpu, fin_gpu, _ = run_flagship(CROSS_LEGS, CROSS_TICKS, dev, mic, far)
    bar = quality_bar(out_cpu.numpy(), out_gpu.cpu().numpy())
    print(f"cpu vs gpu: {CROSS_LEGS} legs x {CROSS_TICKS} ticks, "
          f"audio_diff_min {bar['audio_diff_min']:.6f} (legs 0, 37, ...; all legs "
          f"{bar['audio_diff_min_all_legs']:.6f}, {bar['legs_below_0.999']} below "
          f"0.999), rms_err {bar['rms_err']:.3e}, max_abs_err {bar['max_abs_err']:.3e}, "
          f"energy_gap_db_max {bar['energy_gap_db_max']:.4f}, pass {bar['pass']} "
          f"(cpu {1e3 * cpu_tick:.1f} ms/tick)", flush=True)
    if not (bar["pass"] and fin_cpu and fin_gpu):
        raise AssertionError(f"cpu vs gpu quality bar failed: {bar}")

    phase_done(4)

    # phase 5: the e2e leg over localhost UDP, megakernel AEC
    with environ(PALLAS_MDF="1"):
        res, e2e_launches, e2e_ticks = run_e2e(kernels, dev, card, E2E_LEGS, E2E_TICKS,
                                               paced=True)
        if not (res.loss_rate < 0.02 and res.fidelity >= 0.9):
            raise AssertionError(f"e2e bar failed: {res}")
        res, srtp_launches, srtp_ticks = run_e2e(kernels, dev, card, E2E_LEGS, E2E_TICKS,
                                                 paced=True, srtp=True)
        if not (res.loss_rate < 0.02 and res.fidelity >= 0.9):
            raise AssertionError(f"e2e SRTP bar failed: {res}")
        _, big_launches, big_ticks = run_e2e(kernels, dev, card, E2E_BIG_LEGS,
                                             E2E_BIG_TICKS, paced=False)

    phase_done(5)

    # phase 6: the e2e graph without the network, the CPU against the card
    with environ(PALLAS_MDF="1"):
        out_cpu, out_gpu, fin, cpu_tick = e2e_cross(dev, CROSS_LEGS, CROSS_TICKS)
    bar = quality_bar(out_cpu, out_gpu)
    print(f"e2e cpu vs gpu: {CROSS_LEGS} legs x {CROSS_TICKS} ticks, megakernel AEC, "
          f"audio_diff_min {bar['audio_diff_min']:.6f} (legs 0, 37, ...; all legs "
          f"{bar['audio_diff_min_all_legs']:.6f}, {bar['legs_below_0.999']} below "
          f"0.999), rms_err {bar['rms_err']:.3e}, max_abs_err {bar['max_abs_err']:.3e}, "
          f"energy_gap_db_max {bar['energy_gap_db_max']:.4f}, pass {bar['pass']} "
          f"(cpu {1e3 * cpu_tick:.1f} ms/tick)", flush=True)
    if not (bar["pass"] and fin):
        raise AssertionError(f"e2e cpu vs gpu quality bar failed: {bar}")

    phase_done(6)

    # phase 7: the session layer (AudioStreamBatch, Ticker, conference
    # control): 7a full width over the batch edge, 7b paced threads over
    # loopback RTP, 7c the CPU against the card
    session_launches = session_edge(kernels, dev, card, SESSION_LEGS, SESSION_TICKS)
    session_paced(dev, card, PACED_LEGS, PACED_TICKS)
    rec_cpu, rec_gpu = session_cross(dev, CROSS_SESSION_LEGS, CROSS_SESSION_TICKS)
    bar = quality_bar(rec_cpu, rec_gpu, leg_step=1)
    print(f"session cpu vs gpu: {CROSS_SESSION_LEGS} + {CROSS_SESSION_LEGS} legs x "
          f"{CROSS_SESSION_TICKS} ticks over LoopbackPair, the clients' recordings of "
          f"every listener: audio_diff_min {bar['audio_diff_min']:.6f}, rms_err "
          f"{bar['rms_err']:.3e}, max_abs_err {bar['max_abs_err']:.3e}, energy_gap_db_max "
          f"{bar['energy_gap_db_max']:.4f}, pass {bar['pass']}", flush=True)
    if not bar["pass"]:
        raise AssertionError(f"session cpu vs gpu quality bar failed: {bar}")

    phase_done(7)

    # phase 8: the secured wideband call: 8a full width over the batch edge
    # with SRTP on every leg, 8b per-leg SRTP + RTCP + QoS, 8c CPU vs card
    wide_launches = session_edge(kernels, dev, card, WIDE_LEGS, WIDE_TICKS, phase="8a",
                                 codec="g722", rate=16000, srtp=True)
    phase_done("8a")
    session_secure(dev, card, SECURE_LEGS)
    phase_done("8b")
    rec_cpu, rec_gpu = session_secure_cross(dev, CROSS_WIDE_LEGS, CROSS_WIDE_TICKS)
    bar = quality_bar(rec_cpu, rec_gpu, leg_step=1)
    print(f"session 8c: {CROSS_WIDE_LEGS} + {CROSS_WIDE_LEGS} legs x {CROSS_WIDE_TICKS} ticks, "
          f"G.722 with per-leg SRTP and RTCP over LoopbackPair, the CPU against the card, the "
          f"clients' recordings of every listener: audio_diff_min {bar['audio_diff_min']:.6f}, "
          f"rms_err {bar['rms_err']:.3e}, max_abs_err {bar['max_abs_err']:.3e}, "
          f"energy_gap_db_max {bar['energy_gap_db_max']:.4f}, pass {bar['pass']}", flush=True)
    if not bar["pass"]:
        raise AssertionError(f"session 8c cpu vs gpu quality bar failed: {bar}")

    phase_done(8)

    # phase 9: the gateway transcoder: 9a the five codec chains at full
    # width, 9b the G.711 <-> G.726-32 gateway, 9c its TTY legs CPU vs card
    sig = speech_legs(CHAIN_LEGS, S8 * CHAIN_TICKS, seed=100)
    chain_launches = {codec: codec_chain(kernels, dev, card, codec, sig, CHAIN_TICKS)
                      for codec in CHAIN_BARS}
    del sig
    phase_done("9a")
    gw_launches = gateway_full(kernels, dev, card, GATEWAY_LEGS, GATEWAY_ROUNDS)
    phase_done("9b")
    (rec_cpu, rec_gpu), texts = gateway_cross(dev, CROSS_GATEWAY_LEGS, CROSS_GATEWAY_ROUNDS)
    bar = quality_bar(rec_cpu, rec_gpu, leg_step=1)
    print(f"gateway 9c: 4 x {CROSS_GATEWAY_LEGS} legs x {CROSS_GATEWAY_ROUNDS} rounds, every "
          f"talker typing {TTY_TEXT!r} as Baudot FSK through G.711 and G.726-32, the CPU "
          f"against the card, the listeners' recordings: audio_diff_min "
          f"{bar['audio_diff_min']:.6f}, rms_err {bar['rms_err']:.3e}, max_abs_err "
          f"{bar['max_abs_err']:.3e}, energy_gap_db_max {bar['energy_gap_db_max']:.4f} (bars: "
          f"audio_diff >= 0.999, rms_err <= {CROSS_GATEWAY_RMS}, energy gap <= 1.5 dB); text "
          f"read on the CPU {sorted(set(texts[0]))}, on the card "
          f"{sorted(set(texts[1]))}", flush=True)
    if not (bar["audio_diff_min"] >= 0.999 and bar["energy_gap_db_max"] <= 1.5
            and bar["rms_err"] <= CROSS_GATEWAY_RMS):
        raise AssertionError(f"gateway 9c cpu vs gpu bar failed: {bar}")
    if any(t != TTY_TEXT for side in texts for t in side):
        raise AssertionError(f"gateway 9c: Baudot text read {texts}, expected {TTY_TEXT!r}")

    phase_done(9)

    # launches over the main-path runs that were counted: the flagship, the
    # three e2e runs, the session and the wideband call at full width
    runs = {"flagship": (launches, TICKS),
            "e2e": ({k: e2e_launches[k] + srtp_launches[k] + big_launches[k] for k in launches},
                    e2e_ticks + srtp_ticks + big_ticks),
            "session": (session_launches, SESSION_TICKS),
            "wideband": (wide_launches, WIDE_TICKS),
            "gateway": (gw_launches, GATEWAY_ROUNDS)}
    runs.update({f"chain_{codec}": (c, CHAIN_TICKS) for codec, c in chain_launches.items()})
    total = {k: sum(c[k] for c, _ in runs.values()) for k in launches}
    entries = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    results.update({k: v for k, v in adpcm_results.items() if "@" not in k})
    for name in ("g726_encode", "g726_decode"):      # the gateway's rate leads the entry
        results[name] = adpcm_results[f"{name}@32"]
    for name in REPLACES:
        r = results[name]
        entry = {"name": name, "route": "cuda",
                 "source": SOURCES.get(name.split("_")[0], KERNEL_SOURCE),
                 "replaces": REPLACES[name], "launches": total[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                 "launches_per_tick": {path: c[name] / n for path, (c, n) in runs.items()}}
        if "bound_chain_ms" in r:
            entry.update(bound_bytes_ms=r["bound_bytes_ms"], bound_chain_ms=r["bound_chain_ms"])
        if name.startswith("g726"):
            entry["rates_kbps"] = {kbps: {k: adpcm_results[f"{name}@{kbps}"][k] for k in keys}
                                   for kbps in G726_RATES.values()}
        for label, res_at in (("session_shapes", session_results),
                              ("wideband_shapes", wide_results)):
            if name in res_at:
                entry[label] = {k: res_at[name][k] for k in keys}
        entries.append(entry)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
