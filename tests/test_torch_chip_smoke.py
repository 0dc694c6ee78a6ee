"""The bound arithmetic of ``chip_smoke.py`` (phase 2) on the CPU: the bytes
each kernel must move at the flagship's shapes (B = 4096, S = 480,
P = 8, F = 481), the G.722 kernels' bytes and serial chain at B = 1,024,
the DVI4 and G.726 kernels' the same, against the figures worked out by
hand from the kernels' operands; the launches phases 8a and 9b expect a
tick pair or round; and the loops that ``REPLACES`` names."""
import importlib.util
import os

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, P, F = 4096, 480, 8, 481
MB = 1e6


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)              # defines only; main() needs a card
    return mod


def test_bytes_at_the_flagship_shapes(smoke):
    cells = B * P * F                         # one [B, P, F] tensor's elements
    # fused_volume: x in, y out [B, S] f32 (15.8 MB)
    assert smoke.fused_volume_cost(B, S)[0] / MB == pytest.approx(15.8, abs=0.05)
    # mdf_apply, bf16 Ws: Wm and Ws read, Xh read over partitions 0..P-2
    # (the last drops out of the shift) and written over all P (bf16),
    # 6 [B, F] f32
    assert smoke.mdf_apply_cost(B, P, F, 2)[0] / MB == pytest.approx(291.6, abs=0.05)
    assert (smoke.mdf_apply_cost(B, P, F, 2)[0]
            == 2 * 2 * (2 * cells + (P - 1) * B * F + cells) + 4 * B * F * 6)
    # the same with an f32 Ws: + 4 bytes a cell
    assert (smoke.mdf_apply_cost(B, P, F, 4)[0] - smoke.mdf_apply_cost(B, P, F, 2)[0]
            == 2 * 2 * cells)
    assert smoke.mdf_apply_cost(B, P, F, 4)[0] / MB == pytest.approx(354.6, abs=0.05)
    # at the session's shapes (B = 1024, F = 81)
    assert smoke.mdf_apply_cost(1024, P, 81, 2)[0] / MB == pytest.approx(12.28, abs=0.005)
    # mdf_update: Ws f32 read and written, Wm bf16 read and written, Xh
    # read: 28 bytes a cell (441 MB), plus its five [B, F] f32 operands
    # (Er, Ei, inv_norm, gc_r, gc_i: 39.4 MB), which the 441 MB leaves out
    nbytes = smoke.mdf_update_cost(B, P, F)[0]
    assert 28 * cells / MB == pytest.approx(441.3, abs=0.1)
    assert (nbytes - 28 * cells) / MB == pytest.approx(39.4, abs=0.1)
    # mdf_update_fused, bf16 Ws: 228 MB without Wm traffic; Wm read or
    # written on half the legs: 261 MB
    assert smoke.mdf_update_fused_cost(B, P, F, 2)[0] / MB == pytest.approx(228.6, abs=0.5)
    assert (smoke.mdf_update_fused_cost(B, P, F, 2, B // 4, B // 4)[0] / MB
            == pytest.approx(260.1, abs=0.5))


def test_bound_takes_the_larger_time(smoke):
    ms, by = smoke.bound((3.35e9, 1))
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = smoke.bound((1, 67e9))
    assert ms == pytest.approx(1.0) and by == "operations"
    # the flagship's mdf_apply: 291.6 MB over 3.35 TB/s
    assert smoke.bound(smoke.mdf_apply_cost(B, P, F, 2))[0] == pytest.approx(0.0870, abs=1e-4)


def test_rotation_spills_the_l2(smoke):
    assert smoke.rotation(300 * MB) == 1
    n = smoke.rotation(smoke.mdf_apply_cost(1024, 8, 81, 2)[0])
    assert n * smoke.mdf_apply_cost(1024, 8, 81, 2)[0] > 2 * smoke.L2_BYTES


def test_g722_bounds(smoke):
    """G.722 at B = 1,024: pcm [B, 160] and codes [B, 80] int32, one in and
    one out, and the 80-int32 codec state (two bands of 28, the 24-sample
    QMF line) read and written: 1,600 bytes a leg, 1.64 MB, 0.49 us at
    3.35 TB/s. The serial chain: 80 slots of 42 (encode) or 27 (decode)
    dependent operations at 4 cycles and 1.98 GHz: 6.79 and 4.36 us, the
    larger bound each time."""
    for name, ops in (("g722_encode", 42), ("g722_decode", 27)):
        nbytes, chain = smoke.g722_cost(1024, name)
        assert nbytes == 1024 * (160 * 4 + 80 * 4 + 2 * (2 * 28 + 24) * 4) == 1024 * 1600
        assert chain == 80 * ops
        ms, by, bytes_ms, chain_ms = smoke.g722_bound((nbytes, chain))
        assert bytes_ms == pytest.approx(1024 * 1600 / 3.35e12 * 1e3)
        assert chain_ms == pytest.approx(80 * ops * 4 / 1.98e9 * 1e3)
        assert (ms, by) == (chain_ms, "operations")
    assert smoke.g722_bound(smoke.g722_cost(1024, "g722_encode"))[0] == pytest.approx(
        0.00679, abs=1e-5)
    assert smoke.g722_bound(smoke.g722_cost(1024, "g722_decode"))[0] == pytest.approx(
        0.00436, abs=1e-5)


def test_phase_8a_launches_a_tick_pair(smoke):
    """The wideband pair: g722_encode and g722_decode twice (clients and
    server), fused_volume 3, mdf_apply 1, mdf_update_fused 1, mdf_update
    none; the G.711 pair of 7a the same without G.722."""
    assert smoke.session_launches("g722", 1) == {
        "fused_volume": 3, "mdf_apply": 1, "mdf_update_fused": 1,
        "g722_encode": 2, "g722_decode": 2}
    assert smoke.session_launches("ulaw", 200) == {
        "fused_volume": 600, "mdf_apply": 200, "mdf_update_fused": 200}
    launches = {"fused_volume": 3, "mdf_apply": 1, "mdf_update": 0, "mdf_update_fused": 1,
                "g722_encode": 2, "g722_decode": 2}
    smoke._require_counts("8a", launches, smoke.session_launches("g722", 1))
    with pytest.raises(AssertionError, match="mdf_update"):
        smoke._require_counts("8a", dict(launches, mdf_update=1),
                              smoke.session_launches("g722", 1))


def test_dvi4_and_g726_bounds(smoke):
    """DVI4 and G.726 at B = 1,024, S = 80: samples and codes [B, 80] of 4
    bytes, one in and one out, and the state read and written (2 int32, or
    24 float32: b[6], dq[6] and twelve scalars): 656 and 832 bytes a leg,
    0.67 and 0.85 MB. The serial chains: DVI4 15 (encode) and 4 (decode)
    steps a sample at 4 cycles; G.726 encode 38, 40, 41, 42 steps by rate
    plus a log2f and an exp2f at 26 cycles each, decode 16 steps plus an
    exp2f; at 1.98 GHz, the larger bound each time."""
    nbytes, cycles = smoke.adpcm_cost(1024, 80, "dvi4_encode")
    assert (nbytes, cycles) == (1024 * (2 * 320 + 2 * 2 * 4), 80 * 15 * 4) == (1024 * 656, 4800)
    assert smoke.adpcm_cost(1024, 80, "dvi4_decode") == (1024 * 656, 80 * 4 * 4)
    for bits, steps in ((2, 38), (3, 40), (4, 41), (5, 42)):
        assert smoke.adpcm_cost(1024, 80, "g726_encode", bits) == (
            1024 * (2 * 320 + 2 * 24 * 4), 80 * (steps * 4 + 2 * 26))
        assert smoke.adpcm_cost(1024, 80, "g726_decode", bits) == (1024 * 832, 80 * (16 * 4 + 26))
    ms, by, bytes_ms, chain_ms = smoke.chain_bound(*smoke.adpcm_cost(1024, 80, "g726_encode", 4))
    assert bytes_ms == pytest.approx(1024 * 832 / 3.35e12 * 1e3)
    assert chain_ms == pytest.approx(80 * 216 / 1.98e9 * 1e3) == pytest.approx(0.00873, abs=1e-5)
    assert (ms, by) == (chain_ms, "operations")
    assert smoke.chain_bound(*smoke.adpcm_cost(1024, 80, "dvi4_encode"))[0] == pytest.approx(
        0.00242, abs=1e-5)
    assert smoke.chain_bound(*smoke.adpcm_cost(1024, 80, "g726_decode", 4))[0] == pytest.approx(
        0.00364, abs=1e-5)
    # the chain helper is G.722's too
    assert smoke.g722_bound((10, 5)) == smoke.chain_bound(10, 5 * smoke.DEP_OP_CYCLES)
    assert smoke.chain_bound(3.35e9, 1)[1] == "bytes"


def test_replaces_names_the_loop_each_kernel_replaces(smoke):
    """Every kernel has its entry, and each file:line is the ``def`` (or
    the Pallas wrapper) of that name in the JAX package."""
    assert list(smoke.REPLACES) == [
        "fused_volume", "mdf_apply", "mdf_update", "mdf_update_fused", "g722_encode",
        "g722_decode", "dvi4_encode", "dvi4_decode", "g726_encode", "g726_decode"]
    jax_name = {"dvi4_encode": "adpcm_encode", "dvi4_decode": "adpcm_decode"}
    for name, where in smoke.REPLACES.items():
        path, line = where.rsplit(":", 1)
        with open(os.path.join(REPO, path)) as f:
            text = f.readlines()[int(line) - 1]
        assert text.startswith(f"def {jax_name.get(name, name)}("), (name, where, text)
    for name in smoke.REPLACES:
        source = smoke.SOURCES.get(name.split("_")[0], smoke.KERNEL_SOURCE)
        assert os.path.exists(os.path.join(REPO, source)), source
    assert smoke.SOURCES["dvi4"] == smoke.SOURCES["g726"] == smoke.ADPCM_SOURCE


def test_phase_9_launches_and_fixture(smoke):
    """A gateway round: the transcoders' G.726 encode and decode once, the
    talkers' and listeners' four volumes; nothing else. The speech fixture
    is int32 in the int16 range and repeats from its seed."""
    assert smoke.gateway_launches(150) == {"g726_encode": 150, "g726_decode": 150,
                                           "fused_volume": 600}
    launches = dict.fromkeys(smoke.REPLACES, 0)
    launches.update(g726_encode=1, g726_decode=1, fused_volume=4)
    smoke._require_counts("9b", launches, smoke.gateway_launches(1))
    with pytest.raises(AssertionError, match="g726_decode"):
        smoke._require_counts("9b", dict(launches, g726_decode=2), smoke.gateway_launches(1))
    x = smoke.speech_fixture(5, 240, seed=2)
    assert x.shape == (5, 240) and x.dtype.name == "int32" and abs(x).max() <= 32000
    assert (x == smoke.speech_fixture(5, 240, seed=2)).all()
    assert len({int(abs(row).max()) for row in x}) == 5          # the level varies per leg
    assert set(smoke.CHAIN_BARS) == {"dvi4", "g726_16", "g726_24", "g726_32", "g726_40"}
    assert smoke.g726_bar_met(0, 0.0, 0.0, 0.0) and not smoke.g726_bar_met(1, 0.0, 0.0, 0.0)
    assert not smoke.g726_bar_met(0, 0.06, 0.0, 0.0)


_PTXAS_LOG = """ptxas info    : 0 bytes gmem, 416 bytes cmem[3]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118g722_decode_kernelEPKiPiNS_8BandPtrsES3_S2_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118g722_decode_kernelEPKiPiNS_8BandPtrsES3_S2_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 94 registers, 17216 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118g722_encode_kernelEPKiPiNS_8BandPtrsES3_S2_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118g722_encode_kernelEPKiPiNS_8BandPtrsES3_S2_ii
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 96 registers, 32576 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_usage_reads_registers_and_spills(smoke):
    """Phase 1 reads each G.722 kernel's registers and spill bytes from
    nvcc's -Xptxas -v report, and fails on a kernel the report lacks."""
    assert smoke.ptxas_usage(_PTXAS_LOG, "g722_decode_kernel") == {
        "registers": 94, "spill_stores": 0, "spill_loads": 0}
    assert smoke.ptxas_usage(_PTXAS_LOG, "g722_encode_kernel") == {
        "registers": 96, "spill_stores": 12, "spill_loads": 16}
    with pytest.raises(AssertionError, match="mdf_apply"):
        smoke.ptxas_usage(_PTXAS_LOG, "mdf_apply_kernel")


def test_g722_run_compares_every_tick_and_leaf(smoke):
    """Phase 2's G.722 check on the CPU, where the wrappers run the plain
    versions: equal runs pass and return the plain outputs; a kernel whose
    output or state differs on a later tick fails there."""
    import types

    import torch

    from mediastreamer2_tpu_torch.ops import kernels
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(0)
    blocks = [torch.randint(-32768, 32768, (3, 14), generator=g, dtype=torch.int32)
              for _ in range(2)]
    outs, st_k, st_p = smoke._g722_run(kernels, "g722_encode", blocks, cpu)
    assert [tuple(o.shape) for o in outs] == [(3, 7), (3, 7)]
    assert all(torch.equal(a, b) for a, b in zip(kernels.g722_state_leaves(st_k),
                                                 kernels.g722_state_leaves(st_p)))

    calls = []

    def off_by_one_code(x, st):                 # wrong from the second tick on
        calls.append(1)
        codes, st = kernels.g722_encode_reference(x, st)
        return codes + (len(calls) > 1), st

    def bad_state(x, st):
        codes, st = kernels.g722_encode_reference(x, st)
        st["hi"]["det"][1] += 1
        return codes, st
    for fn, what in ((off_by_one_code, "tick 1"), (bad_state, "state leaf 19 after tick 0")):
        fake = types.SimpleNamespace(g722_encode=fn,
                                     g722_encode_reference=kernels.g722_encode_reference,
                                     g722_state_leaves=kernels.g722_state_leaves)
        with pytest.raises(AssertionError, match=what):
            smoke._g722_run(fake, "g722_encode", blocks, cpu)


_SASS = """\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_118g722_encode_kernelEPKiPiNS_8BandPtrsES3_S2_ii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   IMAD R2, R0, 0x4, RZ ;
        /*0030*/                   LDS R3, [R2] ;
        /*0040*/                   VOTE.ANY R4, PT, P0 ;
        /*0050*/                   POPC R5, R4 ;
        /*0060*/              @!P0 BRA 0x20 ;
        /*0070*/                   IADD3 R6, R5, 0x1, RZ ;
        /*0080*/                   BRA 0x70 ;
        /*0090*/               @P1 BRA 0x0 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   NOP ;
\t\tFunction : _ZN12_GLOBAL__N_118mdf_apply_kernelEv
        /*0000*/                   BRA 0x0 ;
"""


def test_g722_variants_reads_the_slot_loop(monkeypatch):
    """tools/g722_variants.py --sass: a loop is a backward branch's span,
    the slot loop the largest loop that holds no other (here 0x20..0x60,
    inside the loop 0x0..0x90), counted without NOPs; other kernels are
    skipped."""
    import subprocess
    import types
    spec = importlib.util.spec_from_file_location(
        "g722_variants", os.path.join(REPO, "tools", "g722_variants.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(tool.kernels, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: types.SimpleNamespace(stdout=_SASS))
    total, loops, slot, mix = tool.sass_loops("lib.so")["g722_encode"]
    assert total == 11
    assert loops == [(0x20, 0x60, 5), (0x70, 0x80, 2), (0x0, 0x90, 10)]
    assert slot == 5
    assert mix == {"IMAD": 1, "LDS": 1, "VOTE": 1, "POPC": 1, "BRA": 1}
    assert set(tool.sass_loops("lib.so")) == {"g722_encode"}


def test_g726_bar_is_exact_and_ragged_shapes_cover_partial_warps(smoke):
    """Phase 2 holds G.726 to the bit: no code, decoded sample or state
    leaf may differ. Its ragged shapes reach a warp partly past B (1, 33,
    77 legs, at two legs a warp) and ticks that are not a
    multiple of the lanes a leg (1, 7, 200 samples), at every rate; on the
    CPU (the wrappers run the plain versions) they pass, and a kernel whose
    state differs in the last bit fails."""
    import types

    import torch

    from mediastreamer2_tpu_torch.ops import kernels
    assert (smoke.G726_CODES_DIFFERING_MAX, smoke.G726_PCM_ATOL, smoke.G726_STATE_RTOL) == (
        0, 0.0, 0.0)
    assert smoke.g726_bar_met(0, 0.0, 0.0, 0.0)
    assert not smoke.g726_bar_met(0, 1e-9, 0.0, 0.0)
    assert not smoke.g726_bar_met(0, 0.0, 0.0, 1e-9)
    assert smoke.G726_RAGGED == ((1, 33, 77, 1000), (1, 7, 80, 200))
    legs, samples = smoke.G726_RAGGED
    assert any(n % 32 for n in legs) and any(n % 16 for n in samples) and min(samples) == 1
    cpu = torch.device("cpu")
    smoke.G726_RAGGED, keep = ((1, 3), (1, 7)), smoke.G726_RAGGED
    try:
        smoke.g726_ragged_checks(kernels, cpu)
    finally:
        smoke.G726_RAGGED = keep

    def ulp_off(x, st, bits):
        codes, st = kernels.g726_encode_reference(x, st, bits)
        st["yl"].copy_(torch.nextafter(st["yl"], torch.full_like(st["yl"], 1e9)))
        return codes, st
    fake = types.SimpleNamespace(**{k: getattr(kernels, k) for k in (
        "G726_KEYS", "g726_encode_reference", "g726_decode", "g726_decode_reference")},
        g726_encode=ulp_off)
    x = torch.from_numpy(smoke.speech_fixture(3, 7, seed=1))
    with pytest.raises(AssertionError, match="24 kbit/s, 3 legs"):
        smoke.g726_exact(fake, [x], 3, cpu, "3 legs")


_G726_SASS = """\tcode for sm_90a
\t\tFunction : _ZN49_GLOBAL__N__561919b3_16_adpcm_kernels_cu_c1cd648d18g726_encode_kernelILi5EEEvPKiPiNS_8G726PtrsEii
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   MUFU.LG2 R3, R2 ;
        /*0020*/                   VOTE.ANY R4, PT, P0 ;
        /*0030*/                   SHFL.IDX PT, R5, R4, R0, 0x1f ;
        /*0040*/              @!P0 BRA 0x10 ;
        /*0050*/                   EXIT ;
\t\tFunction : _ZN49_GLOBAL__N__561919b3_16_adpcm_kernels_cu_c1cd648d18g726_encode_kernelILi2EEEvPKiPiNS_8G726PtrsEii
        /*0000*/                   LDG.E R1, desc[UR4][R2.64] ;
        /*0010*/                   MUFU.EX2 R3, R2 ;
        /*0020*/               @P0 BRA 0x0 ;
\t\tFunction : _ZN49_GLOBAL__N__561919b3_16_adpcm_kernels_cu_c1cd648d18dvi4_encode_kernelEPKiPiS1_S1_ii
        /*0000*/                   BRA 0x0 ;
"""


def test_g726_variants_reads_each_rates_sample_loop(monkeypatch):
    """tools/g726_variants.py --sass: g722_variants' reader, with each
    G.726 kernel told apart by its rate (the template argument in the
    mangled name); DVI4's kernels are skipped."""
    import subprocess
    import types
    spec = importlib.util.spec_from_file_location(
        "g726_variants", os.path.join(REPO, "tools", "g726_variants.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.FRAGMENTS["g726_encode@40"] == "g726_encode_kernelILi5E"
    assert tool.FRAGMENTS["g726_decode@16"] == "g726_decode_kernelILi2E"
    monkeypatch.setattr(tool.kernels, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=_G726_SASS))
    got = tool.sass_loops("lib.so", tool.FRAGMENTS)
    assert set(got) == {"g726_encode@40", "g726_encode@16"}
    total, loops, loop, mix = got["g726_encode@40"]
    assert (total, loops, loop) == (6, [(0x10, 0x40, 4)], 4)
    assert mix == {"MUFU": 1, "VOTE": 1, "SHFL": 1, "BRA": 1}
    assert got["g726_encode@16"][2:] == (3, {"LDG": 1, "MUFU": 1, "BRA": 1})


def test_playout_logs_the_packets_each_jitter_buffer_plays(smoke):
    """Phase 7b's instrumentation on the port's JitterBuffer: per tick, the
    sequence number each leg sends (read at push) and the one its buffer
    plays (None when it conceals: an underrun, after which it plays a tick
    later), across the 16-bit wrap; the stream's own pull and push still
    run."""
    import types

    from mediastreamer2_tpu_torch.net.jitter import JBParams, JitterBuffer
    from mediastreamer2_tpu_torch.net.rtp import RtpPacket
    jb = JitterBuffer(JBParams(nom_depth_ticks=1, adaptive=False))
    sess = types.SimpleNamespace(jitter_buffer=jb, seq=65533)
    ticker = types.SimpleNamespace(set_io=lambda pull, push: ticker.__dict__.update(
        _io_pull=pull, _io_push=push))
    got, pushed = [], []
    ticker.set_io(lambda tick: got.append(jb.get_tick()), lambda tick, out: pushed.append(tick))
    log = smoke.Playout(types.SimpleNamespace(sessions=[sess], ticker=ticker))
    late = None
    for tick in range(12):
        pkt = RtpPacket(0, sess.seq, 80 * tick, 1, bytes([tick]) * 80)
        if tick == 7:
            late = pkt                                 # arrives a tick late: an underrun
        else:
            jb.put(pkt)
            if late is not None:
                jb.put(late)
                late = None
        ticker._io_pull(tick)
        ticker._io_push(tick, {})
        sess.seq = (sess.seq + 1) & 0xFFFF
    seqs = [(65533 + t) & 0xFFFF for t in range(12)]
    assert pushed == list(range(12)) and [log.sent[t][0] for t in range(12)] == seqs
    played = [log.played[t][0] for t in range(12)]
    assert [None if p is None else seqs[p[0]] for p in got] == played
    assert played == seqs[:7] + [None] + seqs[7:11] and jb.underruns == 1
    assert log.ticks_by_seq(0)[1] == 4


def test_heard_follows_each_listener_through_the_server_mix(smoke):
    """Session.heard and mapped_sim on a logged conference (talker 0,
    listeners 1-3): the talker's buffer on the server underruns at server
    tick 100 (one tick concealed, the talker a tick later from there), a
    listener's buffer discards at tick 200 (a tick earlier from there).
    Each listener's ticks map to the talker's ticks they played, -1 where
    concealed; the recording matches the speech along that map though no
    lag over the whole run does, and another talker's speech does not."""
    import types

    import numpy as np

    from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff
    from mediastreamer2_tpu_torch.utils.signals import make_speechlike
    S, n = 80, 300
    log = lambda sent, played: types.SimpleNamespace(                  # noqa: E731
        sent=sent, played=played, ticks_by_seq=lambda leg: smoke.Playout.ticks_by_seq(
            types.SimpleNamespace(sent=sent), leg))
    client_sent = {t: [1000 + t, 0, 0, 0] for t in range(n)}
    server_played = {u: [None if u == 100 or u < 3 else 1000 + u - (3 if u < 100 else 4),
                         None, None, None] for u in range(n + 20)}
    server_sent = {u: [0] + [2000 + u] * 3 for u in range(n + 20)}
    client_played = {t: [None] + [None if t < 4 else 2000 + t - (4 if t < 200 else 3)] * 3
                     for t in range(n)}
    fake = types.SimpleNamespace(legs=4, ticks=n, playout=(log(client_sent, client_played),
                                                           log(server_sent, server_played)))
    heard = smoke.Session.heard(fake)
    assert set(heard) == {1, 2, 3}
    h = heard[1]
    assert (h[50], h[104], h[150], h[250]) == (43, -1, 142, 243) and (h[:7] == -1).all()
    ref = make_speechlike(n * S, 8000, seed=3)
    noise = np.random.default_rng(0).uniform(-0.3, 0.3, n * S).astype(np.float32)
    rec = np.concatenate([ref[v * S:(v + 1) * S] if v >= 0 else noise[t * S:(t + 1) * S]
                          for t, v in enumerate(h)])
    sim, played = smoke.mapped_sim(ref, rec, S, h)
    assert sim > 0.999 and played == (h >= 0).mean() and 0.9 < played < 1
    assert audio_diff(ref, rec)[0] < 0.9
    # the fixture's talkers share one pitch track and differ in their
    # envelope's phase: this one's is far from seed 3's
    assert smoke.mapped_sim(make_speechlike(n * S, 8000, seed=6), rec, S, h)[0] < 0.5
    assert smoke.mapped_sim(ref, rec, S, np.where(h >= 0, h + 1, -1))[0] < 0.5
