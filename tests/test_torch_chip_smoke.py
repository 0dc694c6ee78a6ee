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
