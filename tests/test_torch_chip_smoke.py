"""The bound arithmetic of ``chip_smoke.py`` (phase 2) on the CPU: the bytes
each kernel must move at the flagship's shapes (B = 4096, S = 480,
P = 8, F = 481), the G.722 kernels' bytes and serial chain at B = 1,024,
the DVI4 and G.726 kernels' the same (and dvi4_decode's scan depth),
against the figures worked out by hand from the kernels' operands; the
DVI4 clamp fixtures; the launches phases 8a and 9b expect a tick pair or
round; the loops that ``REPLACES`` names; and the harness of the later
phases on the CPU at tiny sizes (10, 11 and the video call's phase 12,
which catches no failure, through phase 15's leg sharding over two gloo
ranks, whose bars must fail a perturbed shard, to phase 16's programs:
16a's two runs, one as ``python -m``, each side's launches counted
apart, 16c's counted call leg); and the kernels JSON line's entries,
``sharded`` and the programs' runs included."""
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


def test_mdf_update_fused_bytes_follow_the_mix(smoke):
    """The bytes that mdf_update_fused's data needs (``update_mix``,
    ``mdf_update_fused_cost``). The ordinary mix (no flag) at the session's
    shape, bf16 Ws: Ws read and written and Xh read, 12 bytes an element,
    and five f32 operands, 20 bytes a bin: 14.5 bytes an element, 9.63 MB,
    0.0029 ms. A hand-built mix of eight legs, leg b the bits of b (hard
    reset 1, reseed 2, promote 4): with a bf16 shadow legs 0 and 4 update,
    legs 2 and 6 read Wm, legs 4 to 7 write it; with an f32 shadow the
    promoted legs update too (0, 4, 5, 6, 7)."""
    import torch
    P, F = 8, 81
    ordinary = [torch.zeros(1024, dtype=torch.bool) for _ in range(3)]
    assert smoke.update_mix(*ordinary) == (1024, 0, 0)
    nbytes, ops = smoke.mdf_update_fused_cost(1024, P, F, 2, 0, 0, update_legs=1024)
    assert nbytes == 1024 * P * F * 12 + 1024 * F * 20 + 1024 * 7 + 12 == 9_628_684
    assert nbytes - 1024 * 7 - 12 == 1024 * P * F * 14.5
    assert smoke.bound((nbytes, ops)) == (pytest.approx(0.002874, abs=1e-6), "bytes")
    assert smoke.mdf_update_fused_cost(1024, P, F, 2) == (nbytes, ops)
    flags = smoke.update_flags(lambda *shape, s=1.0: torch.zeros(shape), 8, "every kind")
    assert [[int(f[b]) for f in flags] for b in (0, 3, 6)] == [[0, 0, 0], [0, 1, 1], [1, 1, 0]]
    assert smoke.update_mix(*flags) == (2, 2, 4)
    assert smoke.update_mix(*flags, bf16_shadow=False) == (5, 2, 4)
    assert smoke.mdf_update_fused_cost(8, P, F, 2, 2, 4, update_legs=2)[0] == (
        8 * P * F * 2 * 2 + 2 * (P * F * (2 * 2 + 2 * 2) + 4 * F * 5)
        + P * F * 2 * 2 * (2 + 4) + 8 * 7 + 12)
    assert smoke.mdf_update_fused_cost(8, P, F, 4, 2, 4, update_legs=5)[0] == (
        8 * P * F * 2 * 4 + 5 * (P * F * (2 * 4 + 2 * 2) + 4 * F * 5)
        + P * F * 2 * 2 * (2 + 4) + 8 * 7 + 12)
    # the 30% mix's quiet legs read nothing: fewer bytes than the ordinary mix
    g = torch.Generator().manual_seed(0)
    mix = smoke.update_flags(lambda *shape, s=1.0: s * torch.randn(shape, generator=g), 1024,
                             "30% mix")
    upd, wm_read, wm_write = smoke.update_mix(*mix)
    assert 0.35 < upd / 1024 < 0.65 and not (mix[0] & mix[2]).any()
    assert smoke.mdf_update_fused_cost(1024, P, F, 2, wm_read, wm_write, upd)[0] < nbytes


def test_update_check_holds_the_plain_version_and_fails_a_faulty_kernel(smoke):
    """Phase 2's check of mdf_update_fused (``check_update``) on the CPU,
    the plain version in both places: bit for bit, and on four row slices,
    each with its own lin0, in both modes; it fails a kernel that rounds
    every slice from index 0 (lin0 dropped) and one that writes Wm on a leg
    that is not promoted."""
    import types

    import torch

    from mediastreamer2_tpu_torch.ops import kernels
    g = torch.Generator().manual_seed(1)
    rnd = lambda *shape, s=1.0: s * torch.randn(shape, generator=g)  # noqa: E731
    B, P, F = 16, 8, 81
    srk = torch.tensor(42, dtype=torch.int64)
    cpos = torch.tensor(3, dtype=torch.int32)
    flags = smoke.update_flags(rnd, B, "every kind")
    for sdt in (torch.bfloat16, torch.float32):
        smoke.check_update(kernels, f"plain {sdt}", cpos, smoke.update_args(rnd, B, P, F, sdt),
                           flags, srk)

    def no_lin0(*a, lin0=0):
        return kernels.mdf_update_fused_reference(*a)

    def promotes_all(cpos, *a, lin0=0):
        a = list(a)
        a[12] = torch.ones_like(a[12])
        return kernels.mdf_update_fused_reference(cpos, *a, lin0=lin0)
    for fault, match in ((no_lin0, "row slices"), (promotes_all, "Wm_r")):
        fake = types.SimpleNamespace(mdf_update_fused=fault,
                                     mdf_update_fused_reference=kernels.mdf_update_fused_reference)
        with pytest.raises(AssertionError, match=match):
            smoke.check_update(fake, "faulty", cpos,
                               smoke.update_args(rnd, B, P, F, torch.bfloat16), flags, srk)


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
    0.67 and 0.85 MB. The serial chains: DVI4 13 (encode: the three
    rounds' compares and selects, the subtracts beside them) and 4
    (decode) steps a sample at 4 cycles; G.726 encode 38, 40, 41, 42 steps
    by rate plus a log2f and an exp2f at 26 cycles each, decode 16 steps
    plus an exp2f; at 1.98 GHz, the larger bound each time."""
    nbytes, cycles = smoke.adpcm_cost(1024, 80, "dvi4_encode")
    assert (nbytes, cycles) == (1024 * (2 * 320 + 2 * 2 * 4), 80 * 13 * 4) == (1024 * 656, 4160)
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
        0.00210, abs=1e-5)
    assert smoke.chain_bound(*smoke.adpcm_cost(1024, 80, "g726_decode", 4))[0] == pytest.approx(
        0.00364, abs=1e-5)
    # the chain helper is G.722's too
    assert smoke.g722_bound((10, 5)) == smoke.chain_bound(10, 5 * smoke.DEP_OP_CYCLES)
    assert smoke.chain_bound(3.35e9, 1)[1] == "bytes"
    # every kernel but dvi4_decode keeps its serial chain in adpcm_bound
    for name, bits in (("dvi4_encode", None), ("g726_encode", 4), ("g726_decode", 2)):
        assert smoke.adpcm_bound(1024, 80, name, bits) == (
            *smoke.chain_bound(*smoke.adpcm_cost(1024, 80, name, bits)), "serial chain")


def test_dvi4_decode_bound_is_the_shorter_of_chain_and_scan_depth(smoke):
    """dvi4_decode's bound is max(bytes, min(serial chain, scan depth)). The
    scan depth is the function's: one scan over all S samples, the table
    load, two scans of ceil(log2 S) levels of 5 steps and 14 steps between
    and after them, 4 cycles a step: at 80 samples 7 levels, 85 steps, 340
    cycles (0.000172 ms), under the bytes' 0.000201 ms, so the bytes bound
    it. The kernel's layout, chunks of a warp's 32 lanes scanned one after
    another (chunk 0's index scan, 26 steps, then 15 steps and a pred scan
    of 25 a chunk), is longer: 584 cycles at 80 samples; 784 at 16 lanes.
    A one-sample tick's scan (15 steps) is longer than its 4-step chain, so
    the chain bounds it; no sample, no time."""
    assert (smoke.DVI4_DECODE_LANES, smoke.SCAN_LEVEL_OPS, smoke.DVI4_SAMPLE_OPS,
            smoke.DVI4_CHUNK_OPS) == (32, 5, 14, 15)
    assert smoke.dvi4_scan_cycles(80) == 4 * (1 + 2 * 5 * 7 + 14) == 340
    assert smoke.dvi4_scan_cycles(32) == 4 * (1 + 50 + 14)
    assert smoke.dvi4_scan_cycles(33) == smoke.dvi4_scan_cycles(64) == 4 * (1 + 60 + 14)
    assert smoke.dvi4_scan_cycles(1) == 4 * 15 and smoke.dvi4_scan_cycles(2) == 4 * 25
    assert smoke.dvi4_scan_cycles(80, lanes=32) == 4 * (26 + 3 * 40) == 584
    assert smoke.dvi4_scan_cycles(80, lanes=16) == 4 * (21 + 5 * 35) == 784
    assert smoke.dvi4_scan_cycles(32, 32) == 4 * (26 + 40)
    assert smoke.dvi4_scan_cycles(33, 32) == 4 * 106
    assert smoke.dvi4_scan_cycles(0) == smoke.dvi4_scan_cycles(0, 32) == 0
    ms, by, bytes_ms, depth_ms, depth = smoke.adpcm_bound(1024, 80, "dvi4_decode")
    assert depth == "scan depth" and by == "bytes"
    assert depth_ms == pytest.approx(340 / 1.98e9 * 1e3) == pytest.approx(0.000172, abs=1e-6)
    assert bytes_ms == pytest.approx(1024 * 656 / 3.35e12 * 1e3) == pytest.approx(0.000201,
                                                                                  abs=1e-6)
    assert depth_ms < bytes_ms == ms
    # a few legs: the depth bounds it
    assert smoke.adpcm_bound(8, 80, "dvi4_decode")[:2] == (pytest.approx(340 / 1.98e6),
                                                           "operations")
    assert smoke.adpcm_bound(1024, 1, "dvi4_decode")[3:] == (
        pytest.approx(16 / 1.98e9 * 1e3), "serial chain")
    # a large enough block is bound by its bytes, whichever depth is shorter
    assert smoke.adpcm_bound(1 << 20, 80, "dvi4_decode")[1] == "bytes"


def test_dvi4_clamp_fixtures(smoke):
    """The fixtures of phase 2's DVI4 clamp check: random codes 0..15 from a
    seed, and a full-scale square wave (a half period of 1 + leg % 40
    samples) over the first half, then silence; int32, repeatable. On 8 legs
    x 240 samples from the zero state each reaches every clamp, which
    dvi4_clamp_hits counts where the sum passes its limit; a quiet signal
    reaches none of the pred clamps, and phase 2's check fails on it."""
    import torch

    from mediastreamer2_tpu_torch.ops import kernels
    codes = smoke.dvi4_clamp_codes(8, 240, seed=7)
    assert codes.dtype.name == "int32" and codes.min() == 0 and codes.max() == 15
    assert (codes == smoke.dvi4_clamp_codes(8, 240, seed=7)).all()
    sq = smoke.dvi4_square_fixture(3, 8)
    assert sq.dtype.name == "int32"
    assert sq.tolist() == [[32767, -32768, 32767, -32768, 0, 0, 0, 0],
                           [32767, 32767, -32768, -32768, 0, 0, 0, 0],
                           [32767, 32767, 32767, -32768, 0, 0, 0, 0]]
    zeros = torch.zeros(8, dtype=torch.int32)
    enc = kernels.dvi4_encode_reference(torch.from_numpy(smoke.dvi4_square_fixture(8, 240)),
                                        zeros.clone(), zeros.clone())[0]
    for c in (enc, torch.from_numpy(codes)):
        hits = smoke.dvi4_clamp_hits(c, zeros, zeros)
        assert list(hits) == ["pred -32768", "pred 32767", "index 0", "index 88"]
        assert min(hits.values()) > 0, hits
    quiet = kernels.dvi4_encode_reference(
        torch.from_numpy(smoke.speech_fixture(8, 240, seed=1) // 8), zeros.clone(),
        zeros.clone())[0]
    hits = smoke.dvi4_clamp_hits(quiet, zeros, zeros)
    assert hits["pred -32768"] == hits["pred 32767"] == 0
    # one step by hand: from pred 32000, index 88, code 7 adds 61,436
    hits = smoke.dvi4_clamp_hits(torch.tensor([[7]], dtype=torch.int32),
                                 torch.tensor([32000], dtype=torch.int32),
                                 torch.tensor([88], dtype=torch.int32))
    assert hits == {"pred -32768": 0, "pred 32767": 1, "index 0": 0, "index 88": 1}
    # sums that land on a limit without passing it reach no clamp: 28,672 +
    # 4,095 (index 88, code 0) is 32,767; index 80 + 8 (code 7) is 88
    hits = smoke.dvi4_clamp_hits(torch.tensor([[0], [7]], dtype=torch.int32),
                                 torch.tensor([28672, 0], dtype=torch.int32),
                                 torch.tensor([88, 80], dtype=torch.int32))
    assert hits == dict.fromkeys(smoke.DVI4_CLAMPS, 0)


def test_dvi4_checks_run_every_shape_and_fixture(smoke, monkeypatch):
    """Phase 2's DVI4 check on the CPU, where the wrappers run the plain
    versions: every ragged shape, the 77 x 200 block, the empty tick, the
    block of no legs and both fixtures pass and the hits come back; a
    kernel that is a sample off fails it, and so does one that moves the
    state on an empty tick."""
    import types

    import torch

    from mediastreamer2_tpu_torch.ops import kernels
    cpu = torch.device("cpu")
    monkeypatch.setattr(smoke, "G726_RAGGED", ((1, 3), (1, 7, 33)))
    hits = smoke.dvi4_checks(kernels, cpu, 8)
    assert set(hits) == {"encoder", "decoder"} and all(min(h.values()) > 0 for h in hits.values())

    def one_off(codes, pred, index):
        pcm, pred, index = kernels.dvi4_decode_reference(codes, pred, index)
        pcm[-1, -1] += 1
        return pcm, pred, index
    fake = types.SimpleNamespace(**{k: getattr(kernels, k) for k in (
        "dvi4_encode", "dvi4_encode_reference", "dvi4_decode_reference")},
        dvi4_decode=one_off)
    with pytest.raises(AssertionError, match="dvi4_decode 1 legs x 1 samples tick 0"):
        smoke.dvi4_checks(fake, cpu, 8)

    # one that moves the state on a tick of no samples, as its plain version
    # does here, is caught by the empty tick's own check
    def moves_on_empty(pcm, pred, index):
        if pcm.shape[1] == 0:
            index += 1
        return kernels.dvi4_encode_reference(pcm, pred, index)
    fake = types.SimpleNamespace(**{k: getattr(kernels, k) for k in (
        "dvi4_decode", "dvi4_decode_reference")}, dvi4_encode=moves_on_empty,
        dvi4_encode_reference=moves_on_empty)
    with pytest.raises(AssertionError, match="index after an empty tick 1"):
        smoke.dvi4_checks(fake, cpu, 8)


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


def test_variant_tools_build_earlier_sources_with_an_empty_entry(tmp_path):
    """tools/g726_variants.use (which tools/dvi4_variants.py and
    tools/adpcm_block_size.py build through) gives a source that predates the
    empty kernel's entry point a copy with a stub of it, so that the loader
    binds every entry; the checkout's source is built as it is.
    tools/dvi4_variants.py reads both DVI4 kernels' SASS by name."""
    spec = importlib.util.spec_from_file_location(
        "dvi4_variants", os.path.join(REPO, "tools", "dvi4_variants.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.FRAGMENTS == {"dvi4_encode": "dvi4_encode_kernel",
                              "dvi4_decode": "dvi4_decode_kernel"}
    import g726_variants
    old = tmp_path / "old_adpcm_kernels.cu"
    old.write_text('extern "C" int ms2_dvi4_encode() { return 0; }\n')
    stub = g726_variants.with_empty_entry(old)
    assert stub == tmp_path / "old_adpcm_kernels_stub.cu"
    assert stub.read_text() == old.read_text() + g726_variants.EMPTY_STUB
    assert "ms2_adpcm_empty(int, int, void*)" in g726_variants.EMPTY_STUB
    assert g726_variants.with_empty_entry(tool.SOURCE) == tool.SOURCE


def test_phase_10_captures_replay_and_files_on_the_cpu(smoke, tmp_path):
    """Phase 10's harness at 8 legs x 60 ticks on the CPU (plain versions):
    the speech of every leg is make_speechlike's; the captures hold each
    leg's G.722 codes as RTP (its SSRC, consecutive sequence numbers and
    timestamps, the lossy legs' missing and late packets); the replay
    takes every packet into the stream's batch edge, the clean legs play
    every one and record their speech as encoded, the lossy legs count
    their lost and late packets; settled_sims is audio_diff of each leg's
    settled window; 10b's files, player, controls and recorder pass on two
    of the recordings."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)              # one core, as the other workers' tests
    try:
        _phase_10_on_the_cpu(smoke, tmp_path)
    finally:
        torch.set_num_threads(threads)


def _phase_10_on_the_cpu(smoke, tmp_path):
    import numpy as np
    import torch
    from mediastreamer2_tpu_torch.io.pcap import PcapRtpPlayer
    from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff
    from mediastreamer2_tpu_torch.utils.signals import make_speechlike
    cpu, legs, ticks = torch.device("cpu"), 8, 60
    speech = smoke.speech_legs(130, 400, seed=7, rate=16000)   # two chunks of legs
    for leg in (0, 1, 128, 129):
        assert (speech[leg] == make_speechlike(400, 16000, seed=7 + leg)).all()
    caps = smoke.g722_captures(cpu, legs, ticks, seed=500, directory=str(tmp_path))
    assert caps.codes.shape == (legs, ticks * 80) and len(caps.lossy) == 2
    per = smoke.S16 // 2
    for leg in range(legs):
        pkts = PcapRtpPlayer(caps.paths[leg], payload_type=9).packets
        assert len(pkts) == caps.packets[leg]
        assert {p.ssrc for _, p in pkts} == {smoke.CAPTURE_SSRC + leg}
        seqs = [(p.seq - pkts[0][1].seq) & 0xFFFF for _, p in pkts]
        for (t, p), k in zip(pkts, seqs):
            assert p.payload == caps.codes[leg, k * per:(k + 1) * per].tobytes()
            assert (p.timestamp - pkts[0][1].timestamp) & 0xFFFFFFFF == per * k
        late = sum(t > k * smoke.TICK_S + 0.2 for (t, _), k in zip(pkts, seqs))
        if leg in caps.lossy:
            assert len(pkts) == ticks - 1 and late == smoke.CAPTURE_LATE
        else:
            assert seqs == list(range(ticks)) and late == 0
    res = smoke.replay_captures(cpu, caps, legs, ticks)
    assert (res.sent == caps.packets).all() and (res.recv == res.sent).all() and res.waits == 0
    clean = [leg for leg in range(legs) if leg not in caps.lossy]
    assert (res.lost[clean] == 0).all() and (res.late[clean] == 0).all()
    assert (res.concealed[clean] == 4).all()                      # the edge's prefill
    assert (res.late[caps.lossy] == smoke.CAPTURE_LATE).all()
    assert (res.lost[caps.lossy] >= 1 + smoke.CAPTURE_LATE).all()
    assert res.finite and res.state_finite and res.rec.shape == (legs, ticks * smoke.S16)
    said = smoke.decode_captures(cpu, caps.codes, ticks)
    start = smoke.S16 * smoke.CAPTURE_SETTLE
    sims, lags = smoke.settled_sims(said, res.rec, start, cpu)
    assert (sims[clean] > 0.999).all() and (lags == 4 * smoke.S16).all()
    for leg in range(legs):
        want = audio_diff(said[leg, start - lags[leg]:ticks * smoke.S16 - lags[leg]],
                          res.rec[leg, start:])[0]
        assert abs(sims[leg] - want) < 1e-9
    assert smoke.capture_launches(300) == {"g722_encode": 300, "g722_decode": 300,
                                           "fused_volume": 600}
    smoke.recorded_files(cpu, "cpu", res.rec, [0, caps.lossy[0]], str(tmp_path))


def test_phase_11a_setup_and_negotiated_keys_on_the_cpu(smoke):
    """Phase 11a's harness at 8 calls on the CPU: every call set up (4 by
    DTLS-SRTP, 4 by ZRTP) passes the setup bars, every answer leads with
    G722/8000 PT 9; the session pair's batch edges take each leg's
    negotiated keys and suite, one direction each, and 20 tick pairs run
    with every leg received and no authentication failure or replay drop;
    a leg whose client was given another call's keys fails
    authentication, alone; refused calls end security_failed."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _phase_11a_on_the_cpu(smoke)
    finally:
        torch.set_num_threads(threads)


def _phase_11a_on_the_cpu(smoke):
    import torch
    cpu, n, ticks = torch.device("cpu"), 8, 20
    smoke.raise_nofile(64)
    calls = smoke.open_calls(n, dtls_calls=n // 2)
    try:
        st = smoke.drive_setup(calls, 30.0)
        smoke.check_setup(calls)
        assert st.ice is not None and st.ice[1] <= st.rounds
        assert sum(s.check_list.checks_sent for pair in calls.pairs for s in pair) >= 2 * n
        assert [c.srtp_suite for c, _ in calls.pairs] == \
            ["AEAD_AES_128_GCM"] * 4 + ["AES_CM_128_HMAC_SHA1_80"] * 4
        assert "calls a second" in smoke.setup_line(calls, st)
        client, server = calls.pairs[5]
        client.srtp_keys = calls.pairs[6][0].srtp_keys       # a leg keyed wrong
        sess = smoke.Session(cpu, n, ticks, codec="g722", rate=16000)
        srv, cli = smoke.batch_edge(sess, calls=calls)
        try:
            for s in (sess.clients, sess.server):
                s.ticker.warm_up()
            sess.alternate(ticks)
            sides = (sess.server, sess.clients)
            recv = [[s.edge_rx.stats(i)["recv"] for i in range(n)] for s in sides]
            auth = [[s.edge_rx.auth_failures(i) for i in range(n)] for s in sides]
            replay = sum(s.edge_rx.replay_drops(i) for s in sides for i in range(n))
        finally:
            srv.close()
            cli.close()
        assert replay == 0
        assert min(recv[0][i] for i in range(n) if i != 5) >= ticks - 2
        assert min(recv[1][i] for i in range(n) if i != 5) >= ticks - 2
        # leg 5's client sends and receives on call 6's keys: the server
        # refuses what it sends, and the client what it is sent
        assert auth[0][5] > 0 and auth[1][5] > 0
        assert sum(auth[0]) == auth[0][5] and sum(auth[1]) == auth[1][5]
    finally:
        smoke.close_calls(calls)
    smoke.refused_calls(2, "cpu")


def test_phase_11b_one_socket_calls_on_the_cpu(smoke):
    """Phase 11b's harness at 2 + 2 legs x 60 ticks on the CPU: one call
    by DTLS-SRTP, one by ZRTP over trickle ICE; each leg's transport is its
    call's media_transport(), every CallSetup iterated after every round:
    each leg has a remote report and an RTT, no authentication failure,
    only RTP and RTCP reach the jitter buffers while the demux sorts STUN,
    DTLS and ZRTP away, and the listener hears its talker from tick 40 on."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _phase_11b_on_the_cpu(smoke)
    finally:
        torch.set_num_threads(threads)


def _phase_11b_on_the_cpu(smoke):
    import torch
    cpu, legs, ticks = torch.device("cpu"), 2, 60
    sess, qis, calls, st, leaked = smoke.one_socket_session(cpu, legs, ticks)
    try:
        assert calls.trickle == {1} and calls.pairs[1][0].zrtp is not None
        assert calls.pairs[0][0].dtls is not None

        def between():
            for pair in calls.pairs:
                for setup in pair:
                    setup.iterate()
        sess.alternate(ticks, iterate_every=10, between=between)
        rep = smoke.secure_report(sess, qis)
        demuxed = {k: sum(s.demuxed[k] for pair in calls.pairs for s in pair)
                   for k in ("stun", "dtls", "zrtp", "media")}
        ok, line = sess.check(conf_step=1)
    finally:
        smoke.close_calls(calls)
    assert not rep.unreported and not rep.no_rtt and rep.auth == 0, rep.line
    assert leaked[0] == 0
    assert demuxed["stun"] > 0 and demuxed["dtls"] > 0 and demuxed["zrtp"] > 0
    assert demuxed["media"] >= 2 * legs * ticks          # RTP both ways, and RTCP
    assert ok, line


PHASE_12 = ("video_formats", "video_tick_bytes", "video_stream", "video_split",
            "video_pixel_path", "video_e2e_run", "video_e2e", "video_codec_refusals",
            "video_call", "video_cross")


def test_phase_12_video_on_the_cpu(smoke, monkeypatch):
    """Phase 12's functions at B = 2, 5 ticks on the CPU (a 64x48 mire sent
    at 32x24): 12a's bars hold and no hand kernel launches, 12b's bench
    passes unpaced and recovers from the burst, the codec legs are made
    where the libraries are and raise naming them where they are not,
    12c's CPU-vs-CPU run agrees; and a failed bar raises out of the
    phase."""
    import torch
    from mediastreamer2_tpu_torch.models import video_e2e_bench
    from mediastreamer2_tpu_torch.ops import av1, h264, kernels, vp8
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = smoke.video_pixel_path(kernels, "cpu", "cpu", 2, 5, cam=(64, 48),
                                          out=(32, 24))
        assert set(launches) == set(smoke.REPLACES) | set(smoke.EC_KERNELS)
        assert not any(launches.values())
        smoke.video_e2e("cpu", "cpu", 2, seconds=1.0, warmup=0.3, size=(32, 24), paced=False)
        smoke.video_cross("cpu", "cpu", 2, 5, cam=(64, 48), out=(32, 24))
        smoke.video_codec_refusals("cpu", "cpu")
        for module, attr in ((vp8, "_vpx"), (h264, "_av"), (h264, "_CTX_OFF"), (av1, "_aom")):
            monkeypatch.setattr(module, attr, None)
        monkeypatch.setattr(smoke.ctypes.util, "find_library", lambda name: None)
        smoke.video_codec_refusals("cpu", "cpu")
        monkeypatch.setattr(video_e2e_bench.VideoE2EResult, "passes", lambda self: False)
        with pytest.raises(AssertionError, match="video 12b"):
            smoke.video_e2e("cpu", "cpu", 1, seconds=0.2, warmup=0.1, size=(32, 24),
                            paced=False)
    finally:
        torch.set_num_threads(threads)
    # 12a's bytes: a VGA f32 frame written and read, the QVGA f32 frame three
    # times, two u8 blocks, the rx luma; 118 MB each way over PCIe at 1,024 legs
    nbytes, pcie = smoke.video_tick_bytes(1024, (640, 480), (320, 240))
    assert pcie == 1024 * 115_200
    assert nbytes == 2 * 4 * 1024 * 460_800 + 3 * 4 * pcie + 2 * pcie + 4 * 1024 * 76_800
    assert nbytes / 1e6 == pytest.approx(5741.0, abs=0.1)


def test_phase_12_catches_nothing(smoke):
    """No phase-12 function handles an exception: a failure anywhere in it
    ends the run. The one handler is ``refusal``'s, which returns the
    message of the RuntimeError an expected refusal raises."""
    import ast
    import inspect
    for name in PHASE_12:
        tree = ast.parse(inspect.getsource(getattr(smoke, name)))
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)], name
    tree = ast.parse(inspect.getsource(smoke.refusal))
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    assert [ast.unparse(h.type) for h in handlers] == ["RuntimeError"]
    main = inspect.getsource(smoke.main)
    block = main[main.index("# phase 12"):main.index("phase_done(12)")]
    assert "try:" not in block and "except" not in block
    for call in ("video_pixel_path(", "video_e2e(", "video_codec_refusals(", "video_cross("):
        assert call in block


PHASE_13 = ("sfu_mics", "sfu_speakers", "Sfu", "audio_sfu", "sfu_cross", "pump_session",
            "video_router_fec", "text_streams", "upnp_mapping")


def test_phase_13_speakers_and_microphones(smoke):
    """13a's design: every microphone carries the room noise; members 0, 1,
    2 speak before the switch at their levels, member 2 stops and member 3
    starts at it; the designed speaker sets hold outside the settle
    windows."""
    import numpy as np
    mic = smoke.sfu_mics(2, 100, seed=5)
    assert mic.shape == (16, 100 * 160) and mic.dtype == np.float32
    cut = smoke.SFU_SWITCH * 160
    db = lambda x: 10 * np.log10((x.astype(np.float64) ** 2).mean())
    for c in range(2):
        m = mic[8 * c:8 * c + 8]
        for k in range(4, 8):
            assert abs(db(m[k]) - smoke.SFU_ROOM_DBFS) < 0.5
        assert db(m[0]) > db(m[1]) > db(m[2, :cut]) > smoke.SFU_ROOM_DBFS + 20
        assert abs(db(m[2, cut:]) - smoke.SFU_ROOM_DBFS) < 0.5      # member 2 stopped
        assert abs(db(m[3, :cut]) - smoke.SFU_ROOM_DBFS) < 0.5      # member 3 not yet
        assert db(m[3, cut:]) > smoke.SFU_ROOM_DBFS + 25
    assert np.abs(mic).max() < 1.0                                  # nothing clips
    assert smoke.sfu_speakers(5) is None and smoke.sfu_speakers(55) is None
    assert smoke.sfu_speakers(10) == smoke.sfu_speakers(49) == {0, 1, 2}
    assert smoke.sfu_speakers(smoke.SFU_SWITCH + smoke.SFU_SETTLE) == {0, 1, 3}


def test_phase_13a_audio_sfu_on_the_cpu(smoke, capsys):
    """13a at one conference of 8 x 100 ticks on the CPU: the routes hold
    the design and the levels, payloads equal, nothing missing or stray,
    the pumps drop nothing; the drains read the same datagrams both ways;
    profile_nodes times the decoder and the levels. Then a router that
    forwards a quiet member fails the phase."""
    import numpy as np
    import torch
    from mediastreamer2_tpu_torch.net import router
    from mediastreamer2_tpu_torch.ops import kernels
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches, ranks, energies = smoke.audio_sfu(kernels, "cpu", "cpu", 1, 100)
        out = capsys.readouterr().out
        assert "routes off the levels 0" in out and "pumps dropped 0, truncated 0" in out
        assert "profile_nodes (server graph, ms a call): dec" in out
        assert energies.shape == (100, 8) and np.isfinite(energies).all()
        assert sorted(ranks[:3]) == [0, 1, 3]            # after the switch
        assert not any(launches.values())                # plain versions on the CPU
        sfu = smoke.Sfu("cpu", 1, 12)
        try:
            sfu.run()
            assert sfu.route_failures() == [] and sfu.level_failures() == []
            assert [sorted(h) for h in sfu.routed[11]] == [
                [1, 2], [0, 2], [0, 1], [0, 1, 2], [0, 1, 2], [0, 1, 2], [0, 1, 2], [0, 1, 2]]
            pkt = sfu.sent[11]
            assert (pkt != smoke.G722_SILENCE).any()
        finally:
            sfu.close()
    finally:
        torch.set_num_threads(threads)
    route = router.AudioPacketRouter.route

    def louder_quiet(self, from_idx, pkt):     # a router that forwards member 7 too
        if from_idx % 8 == 7:
            self.top_n = 8
            n = route(self, from_idx, pkt)
            self.top_n = 3
            return n
        return route(self, from_idx, pkt)
    router.AudioPacketRouter.route = louder_quiet
    try:
        with pytest.raises(AssertionError, match="sfu 13a: routes off the design"):
            smoke.audio_sfu(kernels, "cpu", "cpu", 1, 15)
    finally:
        router.AudioPacketRouter.route = route


def test_phase_13b_to_13e_on_the_cpu(smoke, capsys):
    """13b's session over UDP on one pump at 4 + 4 legs x 60 ticks: remote
    reports, RTTs, no auth failure, the listener bars; 13c's router and
    FEC bars; 13d's text (4 pairs) and UPnP; 13e's CPU-vs-CPU run."""
    import torch
    from mediastreamer2_tpu_torch.native import NativeIoPump
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    pump = NativeIoPump()
    try:
        sess, qis = smoke.secure_session("cpu", 4, 60, seed=150,
                                         connect=lambda s: s.udp(pump))
        try:
            sess.alternate(60, iterate_every=10)
            rep = smoke.secure_report(sess, qis)
            ok, line = sess.check(conf_step=1)
            assert all(pump.dropped(t.sock) == 0 for t in sess.udp_transports)
            assert all(t.last_recv_ns for t in sess.udp_transports)
        finally:
            for t in sess.udp_transports:
                t.close()
        assert not rep.unreported and not rep.no_rtt and rep.auth == 0, rep.line
        assert ok, line
        lost, residual = smoke.video_router_fec("cpu", [2, 5, 0, 7], seconds=4.0)
        assert lost > 0 and residual < lost
        wrong = smoke.text_streams("cpu", pairs=4, chars=120)
        assert wrong == {"every 7th lost": [], "burst of 3": []}
        smoke.upnp_mapping("cpu")
        smoke.sfu_cross("cpu", "cpu", ticks=20)
        out = capsys.readouterr().out
        assert "key-frame requests [2, 5]" in out and "U+FFFD read 4" in out
    finally:
        pump.close()
        torch.set_num_threads(threads)


def test_phase_13_catches_nothing(smoke):
    """No phase-13 function handles an exception: a failure anywhere in it
    ends the run. ``Sfu.__init__`` closes what it opened and re-raises, and
    ``Sfu.drain_compare``'s Python loop ends a socket's drain on
    BlockingIOError."""
    import ast
    with open(smoke.__file__) as f:
        defs = {n.name: n for n in ast.parse(f.read()).body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    for name in PHASE_13:
        for n in ast.walk(defs[name]):
            if isinstance(n, ast.ExceptHandler):
                assert name == "Sfu", name
                assert (isinstance(n.body[-1], ast.Raise)
                        or ast.unparse(n.type) == "BlockingIOError"), ast.unparse(n)


PHASE_14 = ("quirk_features", "fleet_sizes", "fleet_launches", "fleet_bars", "fleet_run",
            "host_codec_bar", "host_codec_pair", "host_codec_legs", "mire_frames",
            "device_gating")


def test_phase_14_counts_and_sizes(smoke, monkeypatch):
    """14a's members follow phase 1's libraries; the launches a fleet run
    must show: once a tick of each e2e member for the three kernels of the
    megakernel leg, the Opus member's receive volume a tick and at its
    warm-up; 14d's features come from the quirk DB."""
    monkeypatch.setattr(smoke.ctypes.util, "find_library", lambda name: None)
    assert smoke.fleet_sizes() == (1024, 256, 0, 0)
    monkeypatch.setattr(smoke.ctypes.util, "find_library", lambda name: f"lib{name}.so")
    assert smoke.fleet_sizes() == (1024, 256, 32, 2)
    assert smoke.fleet_launches({"flagship": 800, "srtp": 800}) == {
        "fused_volume": 1600, "mdf_apply": 1600, "mdf_update": 1600}
    assert smoke.fleet_launches({"flagship": 10}, opus_ticks=7)["fused_volume"] == 18
    ft = smoke.quirk_features()
    assert (ft.echo_canceller, ft.agc, ft.ec_delay_ms) == (True, True, 120)
    assert ft.mic_eq_gains and ft.spk_eq_gains == smoke.QUIRK_SPK_EQ
    assert smoke.HOST_CODEC_BARS["g729"] == pytest.approx(
        (10 ** 0.6 / (1 + 10 ** 0.6)) ** 0.5, abs=5e-4)


def test_phase_14ab_fleet_on_the_cpu(smoke, capsys, monkeypatch):
    """14a and 14b at 8 + 4 e2e legs for 1 s on the CPU (Opus and VP8 left
    out): each prints the summary, passes() and the loop's trace and meets
    the correctness bars. Then a fleet whose flagship member drops half its
    legs' packets fails 14a."""
    import torch
    from mediastreamer2_tpu_torch import native
    from mediastreamer2_tpu_torch.ops import kernels
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for mode in ("loop", "threads"):
            res, launches, ticks = smoke.fleet_run(kernels, "cpu", "cpu", mode, seconds=1.0,
                                                   sizes=(8, 4, 0, 0))
            assert ticks >= 100 and not any(launches.values())
            assert res.srtp.auth_failures == 0 and not res.errors
        out = capsys.readouterr().out
        assert "fleet 14a (loop)" in out and "loop trace" in out and "passes()" in out
        assert "fleet 14b (threads)" in out
        read_tick = native.BatchRtpRx.read_tick

        def lossy(self):
            pay, fl = read_tick(self)
            if self.n_legs == 8:                        # the flagship member's edge
                fl = fl.copy()
                fl[::2] = 0
            return pay, fl
        monkeypatch.setattr(native.BatchRtpRx, "read_tick", lossy)
        with pytest.raises(AssertionError, match="fleet 14a: flagship: .*loss 0.5"):
            smoke.fleet_run(kernels, "cpu", "cpu", "loop", seconds=0.5, sizes=(8, 4, 0, 0))
    finally:
        torch.set_num_threads(threads)


def test_phase_14c_host_codecs_on_the_cpu(smoke, capsys, monkeypatch):
    """14c at 2 + 2 legs on the CPU: each codec whose library this machine
    has runs above its bar, the others raise naming theirs before a graph;
    mpeg4-generic is offered iff AAC is available. With every library
    hidden from find_library, all six must raise, and a stream that builds
    its graph before raising fails the phase."""
    import torch
    from mediastreamer2_tpu_torch.models import audio_stream
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lines = smoke.host_codec_legs("cpu", "cpu", legs=2, ticks=100)
        assert set(lines) == {c for c, *_ in smoke.HOST_CODEC_LIBS}
        out = capsys.readouterr().out
        assert "offers mpeg4-generic" in out
        from mediastreamer2_tpu_torch.ops import aac, host_codecs
        for mod, attr in ((host_codecs, "_opus"), (host_codecs, "_gsm"),
                          (host_codecs, "_speex"), (aac, "_av")):
            monkeypatch.setattr(mod, attr, None)
        monkeypatch.setattr(aac, "_aac_ok", False)
        monkeypatch.setattr(smoke.ctypes.util, "find_library", lambda name: None)
        lines = smoke.host_codec_legs("cpu", "cpu", legs=2, ticks=10)
        assert all("raised" in line and "before the raise 0" in line for line in lines.values())
        make = audio_stream.AudioStreamBatch._make_host_codecs

        def late(self, batch):                  # a stream that builds first, raises after
            audio_stream.GraphBuilder(None, batch=batch)
            return make(self, batch)
        monkeypatch.setattr(audio_stream.AudioStreamBatch, "_make_host_codecs", late)
        monkeypatch.setattr(audio_stream, "GraphBuilder", lambda *a, **k: None)
        with pytest.raises(AssertionError, match="host codecs 14c"):
            smoke.host_codec_legs("cpu", "cpu", legs=2, ticks=10)
    finally:
        torch.set_num_threads(threads)


def test_phase_14de_quirk_session_on_the_cpu(smoke, capsys, monkeypatch):
    """14d at 8 + 8 legs x 100 ticks on the CPU over the batch edge: the
    quirk nodes are in the graph, the card plays spk times the output gain
    and the listener bars hold; 14e's CPU-vs-CPU run agrees. Then a card
    that ignores its output gain fails 14d."""
    import torch
    from mediastreamer2_tpu_torch.core import devices
    from mediastreamer2_tpu_torch.ops import kernels
    from mediastreamer2_tpu_torch.utils.audiodiff import quality_bar
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        smoke.session_edge(kernels, "cpu", "cpu", 8, 100, phase="14d", sound_card=True)
        out = capsys.readouterr().out
        assert "nodes ['mic_eq', 'ec_delay', 'ec', 'spk_eq']" in out
        assert "played blocks equal to spk x the output gain: True" in out
        cpu, other = smoke.session_cross("cpu", 4, 60, sound_card=True)
        assert quality_bar(cpu, other, leg_step=1)["pass"]
        monkeypatch.setattr(devices.SndCard, "push",
                            lambda self, tick, block: self._push_raw(tick, block))
        with pytest.raises(AssertionError, match="session 14d: the sound card"):
            smoke.session_edge(kernels, "cpu", "cpu", 8, 60, phase="14d", sound_card=True)
    finally:
        torch.set_num_threads(threads)


def test_phase_14f_device_gating_on_the_cpu(smoke, capsys, monkeypatch):
    """14f on the CPU against itself: the gates print and the mire agrees;
    a detector that registers a card without its library fails it, and so
    do mire frames two codes apart."""
    smoke.device_gating("cpu", "cpu")
    assert "the mire's (5, 4, 360, 320) frames" in capsys.readouterr().out
    from mediastreamer2_tpu_torch.core import alsa, devices
    if not alsa.alsa_available():
        monkeypatch.setattr(alsa, "detect_alsa_cards",
                            lambda mgr: mgr.add_card(devices.SndCard("alsa:default", "alsa", 3)))
        with pytest.raises(AssertionError, match="alsa: registered True"):
            smoke.device_gating("cpu", "cpu")
        monkeypatch.undo()
    frames = smoke.mire_frames

    def shifted(dev, *a):
        f = frames(dev, *a)
        return f if str(dev) == "cpu" and not isinstance(dev, str) else f // 2
    monkeypatch.setattr(smoke, "mire_frames", shifted)
    with pytest.raises(AssertionError, match="mire frames"):
        smoke.device_gating("cpu", "cpu")


def test_phase_14_catches_nothing(smoke):
    """No phase-14 function handles an exception (``refusal`` is the one
    handler, as in phase 12), and main runs 14a to 14f in order."""
    import ast
    import inspect
    for name in PHASE_14:
        tree = ast.parse(inspect.getsource(getattr(smoke, name)))
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)], name
    main = inspect.getsource(smoke.main)
    block = main[main.index("# phase 14"):main.index("phase_done(14)")]
    assert "except" not in block
    order = [block.index(f'phase_done("14{x}")') for x in "abcde"]
    assert order == sorted(order) and "device_gating(" in block


def test_phase_15_on_the_cpu(smoke, capsys):
    """Phase 15 at 8 legs over two gloo ranks on the CPU (15d, which needs
    a card, left out): the mixer bit-equal on each rank, 15a and 15b and
    their taps bit-equal to the unsharded run, the dry run, the offset
    update; the launches each rank counted come back (0 here: the plain
    versions launch nothing) with the ticks x ranks they cover."""
    import torch
    from mediastreamer2_tpu_torch.ops import kernels
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # as the shards: the CPU's products follow it
    try:
        launches, n = smoke.phase15(kernels, torch.device("cpu"), "cpu", legs=8, ticks=3,
                                    world=2, conferences=2, nccl_legs=8, offset_rows=(2, 4))
    finally:
        torch.set_num_threads(threads)
    assert n == 2 * 3 * 2
    assert set(launches) == set(smoke.REPLACES) | set(smoke.EC_KERNELS)
    assert not any(launches.values())
    out = capsys.readouterr().out
    for line in ("15a rank 1: 4 legs x 3 ticks", "15b rank 1: 4 legs x 3 ticks",
                 "collectives 3 (", "15b mixer rank 1: bit-equal True",
                 "15a: 2 shards against the unsharded 8-leg run",
                 "legs bit-equal 8 of 8", "15e taps after 15b: Ws_r, Ws_i, Wm_r, Wm_i of 8 of 8",
                 "dryrun_multichip(2): ok", "15c rank 1 on cpu", "15d: left out",
                 "with lin0 = 7696: bit-equal to the full call's rows True, to its plain "
                 "twin True"):
        assert line in out, line


def _shard_reports(ref, ticks, launches=0, collectives=1):
    from mediastreamer2_tpu_torch.ops import kernels
    counts = {k: 0 for k in kernels.launch_counts()}
    counts.update(fused_volume=launches, mdf_apply=launches, mdf_update_fused=launches)
    half = ref.shape[0] // 2
    return [{"rank": i, "out": ref[i * half:(i + 1) * half].copy(), "ms_tick": 1.0,
             "collectives": collectives * ticks, "collective_ms_tick": 0.1,
             "launches": dict(counts), "finite": True, "seconds": 1.0} for i in range(2)]


def test_phase_15_bars_fail_on_a_perturbed_shard(smoke):
    """15a / 15b's bars take a shard that equals the unsharded run and fail
    one that is a float32 step off on one sample, one that lost half
    its level (phase 4's bar), one with a launch too many and one that
    skipped its exchange; the mixer's bar fails an unequal rank; the taps'
    report counts a leg one bf16 step off."""
    import numpy as np
    ticks = 10
    ref = (0.1 * np.random.default_rng(1).standard_normal((4, 160 * ticks))).astype(np.float32)
    smoke.shard_bars("15b", ref, _shard_reports(ref, ticks), ticks, 1, "cpu")
    reports = _shard_reports(ref, ticks)
    reports[1]["out"][0, 5] = np.nextafter(reports[1]["out"][0, 5], np.float32(1))
    with pytest.raises(AssertionError, match="15b: 1 legs differ"):
        smoke.shard_bars("15b", ref, reports, ticks, 1, "cpu")
    reports = _shard_reports(ref, ticks)
    reports[1]["out"][1] *= 0.5
    with pytest.raises(AssertionError, match="quality bar failed"):
        smoke.shard_bars("15b", ref, reports, ticks, 1, "cpu")
    with pytest.raises(AssertionError, match="15a rank 0: kernel launches"):
        smoke.shard_bars("15a", ref, _shard_reports(ref, ticks, launches=ticks), ticks, 0, "cpu")
    with pytest.raises(AssertionError, match="0 collectives in 10 ticks, expected 1"):
        smoke.shard_bars("15b", ref, _shard_reports(ref, ticks, collectives=0), ticks, 1, "cpu")
    same = np.arange(6, dtype=np.int32)
    smoke.mixer_bars("15b", [{"rank": 0, "out": same, "ref": same.copy(), "collectives": 1.0,
                              "collective_ms": 0.1}], "cpu")
    with pytest.raises(AssertionError, match="the sharded mixer differs"):
        smoke.mixer_bars("15b", [{"rank": 0, "out": same, "ref": same + 1, "collectives": 1.0,
                                  "collective_ms": 0.1}], "cpu")
    taps = {k: np.random.default_rng(2).integers(-2 ** 15, 2 ** 15, (4, 2, 3), dtype=np.int16)
            for k in ("Ws_r", "Ws_i", "Wm_r", "Wm_i")}
    shards = [{"taps": {k: v[:2].copy() for k, v in taps.items()}},
              {"taps": {k: v[2:].copy() for k, v in taps.items()}}]
    assert smoke.tap_report(taps, shards, 4) == (4, 0)
    shards[1]["taps"]["Ws_i"][0, 1, 2] ^= 1                 # one bf16 step off
    assert smoke.tap_report(taps, shards, 4) == (3, 1)


def test_bf16_steps_count_across_zero(smoke):
    import numpy as np
    import torch
    bits = lambda *v: torch.tensor(v, dtype=torch.bfloat16).view(torch.int16).numpy()
    one_up = np.nextafter(np.float32(1.0), np.float32(2.0))          # rounds to 1.0 in bf16
    assert smoke.bf16_steps(bits(1.0, -1.0, 0.0), bits(1.0, -1.0, -0.0)).tolist() == [0, 0, 0]
    assert smoke.bf16_steps(bits(1.0), bits(1.0078125)).tolist() == [1]   # one bf16 ulp at 1
    assert smoke.bf16_steps(bits(-1.0), bits(-1.0078125)).tolist() == [1]
    assert smoke.bf16_steps(bits(float(one_up)), bits(1.0)).tolist() == [0]
    tiny = 9.183549615799121e-41                                        # the least bf16 subnormal
    assert smoke.bf16_steps(bits(tiny), bits(-tiny)).tolist() == [2]


def test_kernels_line_carries_the_sharded_run(smoke):
    """Every kernel's entry in the kernels JSON line has all the keys the
    contract names and a ``sharded`` launches a tick (a tick of a rank):
    1 for the flagship's three kernels, 0 for the rest."""
    meas = dict(max_abs_err=0.0, ms=1.0, plain_ms=2.0, bound_ms=0.5, bound_by="bytes")
    results = {name: dict(meas) for name in smoke.REPLACES if not name.startswith(("dvi4", "g726"))}
    adpcm = {f"{n}@{kbps}": dict(meas) for n in ("g726_encode", "g726_decode")
             for kbps in smoke.G726_RATES.values()}
    adpcm.update({n: dict(meas) for n in ("dvi4_encode", "dvi4_decode")})
    ticks = 2 * smoke.SHARD_TICKS * smoke.SHARD_WORLD + smoke.SHARD_TICKS
    flagship = ("fused_volume", "mdf_apply", "mdf_update_fused")

    def counts(n):
        c = dict.fromkeys(smoke.REPLACES, 0)
        c.update(dict.fromkeys(flagship, n))
        return c
    runs = {"flagship": (counts(100), 100), "sharded": (counts(ticks), ticks)}
    entries = smoke.kernel_entries(results, adpcm, {}, {}, runs)
    assert [e["name"] for e in entries] == list(smoke.REPLACES)
    contract = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for e in entries:
        assert contract <= set(e)
        per_tick = e["launches_per_tick"]
        if e["name"] in flagship:
            assert per_tick == {"flagship": 1.0, "sharded": 1.0}
            assert e["launches"] == 100 + ticks
        else:
            assert per_tick == {"flagship": 0.0, "sharded": 0.0} and e["launches"] == 0


# -- phase 16: the programs around the package, on the CPU at tiny sizes ------
def test_phase_16a_conference_example_on_the_cpu(smoke, capsys):
    """16a at 8 legs: the example's server on a thread for 2 s, the clients
    following its ticks for 150 ticks; the bars hold (listeners above 0.85
    against the speech sent, mix-minus) and each side's launches come back
    (0 on the CPU) with its own ticks."""
    import torch
    from mediastreamer2_tpu_torch.ops import kernels
    runs = smoke.conference_example(kernels, torch.device("cpu"), "cpu", legs=8, seconds=2,
                                    client_ticks=150)
    assert set(runs) == {"conference_server", "conference_clients"}
    assert runs["conference_server"][1] == 200 and runs["conference_clients"][1] == 150
    assert not any(v for launches, _ in runs.values() for v in launches.values())
    out = capsys.readouterr().out
    assert "16a conference example: 8 legs in groups of 4" in out
    assert "the server 200 ticks paced (2 s)" in out and "bars met True" in out


def test_phase_16a_conference_example_as_python_m_on_the_cpu(smoke, capsys):
    """16a from a fresh interpreter at 8 legs: ``python -m`` the example for
    2 s, the native edge as its clients for 150 ticks; it exits 0, prints
    its statistics, and the bars hold."""
    import torch
    res = smoke.conference_example_process(torch.device("cpu"), "cpu", legs=8, seconds=2,
                                           client_ticks=150)
    assert res["ticks"] == 200 and res["recv_min"] >= 75 and res["leg0"]["recv"] >= 75
    assert res["listeners_min"] > 0.85 and res["energy_ratio_max"] < 0.05
    assert "16a conference example from a fresh interpreter (python -m): 8 legs" in \
        capsys.readouterr().out


def test_split_counts_gives_each_section_its_launches(smoke):
    """Launches between one mark and the next belong to the first mark's
    owner, those before the first mark to ``first_owner``, those after
    the last to the last mark's owner."""
    c = lambda n: {"fused_volume": n, "mdf_apply": n // 2}
    marks = [("server", c(2)), ("clients", c(3)), ("server", c(7)), ("clients", c(8))]
    side = smoke.split_counts(marks, c(12), "server")
    assert side["server"] == {"fused_volume": 2 + 1 + 1, "mdf_apply": 1 + 0 + 1}
    assert side["clients"] == {"fused_volume": 4 + 4, "mdf_apply": 2 + 2}


def test_phase_16c_call_in_this_process_on_the_cpu(smoke, capsys):
    """16c's counted leg: ``mediastream call --ec --agc`` for 1 s in this
    process exits 0; on the CPU no kernel launches."""
    import torch
    from mediastreamer2_tpu_torch.ops import kernels
    launches, ticks = smoke.cli_call(kernels, torch.device("cpu"), "cpu")
    assert ticks == 100 and not any(launches.values())
    assert "16c mediastream call in this process (--ec --agc, B = 1): 100 ticks, exit 0" in \
        capsys.readouterr().out


def test_start_together_releases_the_processes_at_once(smoke):
    """Two processes that reach their ready line 1.5 s apart, each with
    0.3 s of work after it (the call's warm-up), are held there and go on
    within 0.5 s of each other; each one's output comes back whole."""
    import sys
    code = ("import sys, time; time.sleep(float(sys.argv[1])); print('ready'); "
            "time.sleep(0.3); print(time.time())")
    cmds = [[sys.executable, "-c", code, d] for d in ("0", "1.5")]
    procs, lines, readers = smoke.start_together(cmds, "ready", 60)
    for p, r in zip(procs, readers):
        assert p.wait(30) == 0
        r.join(10)
    after = [float(ln[1]) for ln in lines]
    assert [ln[0] for ln in lines] == ["ready\n", "ready\n"]
    assert abs(after[0] - after[1]) < 0.5, after


def test_phase_16a_fails_a_server_that_mixes_no_one(smoke, monkeypatch):
    """A conference server whose legs each sit alone (group_id = leg) sends
    every listener silence: 16a's listener bar fails."""
    import torch
    from mediastreamer2_tpu_torch.examples import conference_server
    from mediastreamer2_tpu_torch.ops import kernels
    monkeypatch.setattr(conference_server.torch, "div", lambda a, b, rounding_mode: a)
    with pytest.raises(AssertionError, match="16a: bars not met"):
        smoke.conference_example(kernels, torch.device("cpu"), "cpu", legs=8, seconds=2,
                                 client_ticks=120)


def test_phase_16b_and_16d_on_the_cpu(smoke, capsys):
    """16b's bench at 4 legs for a second; 16d's gateway at 4 legs for a
    second: every packet back, the listeners above 0.85 from tick 40."""
    import torch
    from mediastreamer2_tpu_torch.ops import kernels
    cpu = torch.device("cpu")
    launches, ticks = smoke.cli_bench(kernels, cpu, "cpu", legs=4, seconds=1)
    assert ticks == 100 and not any(launches.values())
    launches, ticks = smoke.gateway_example(kernels, cpu, "cpu", legs=4, seconds=1)
    assert ticks == 100 and not any(launches.values())
    out = capsys.readouterr().out
    assert "16b mediastream bench: 4 legs x 100 ticks, exit 0" in out
    assert "packets received a leg min 100 of 100, missing 0, pump drops 0" in out


def test_phase_16e_to_16g_on_the_cpu(smoke, capsys, tmp_path):
    """16e (the IVR at 2 legs, the secured call both ways), 16f (every
    other subcommand; record x.mkv writes where libopus is found and
    raises naming it where it is not) and 16g (CPU against CPU: equal)."""
    import torch
    cpu = torch.device("cpu")
    assert smoke.ivr_and_secure_calls(cpu, "cpu", legs=2) == {"ivr": 0, "dtls": 0, "zrtp": 0}
    checks = smoke.other_subcommands(cpu, "cpu", str(tmp_path))
    assert all(checks.values()) and len(checks) == 13
    sims, rms = smoke.programs_cross(cpu, "cpu", legs=2)
    assert sims.min() == pytest.approx(1.0) and rms == 0.0
    assert "16g programs, the CPU against the card: ivr_server at 2 legs" in capsys.readouterr().out


def test_phase_16f_record_mkv_refusal_without_libopus(smoke, monkeypatch, tmp_path):
    """On a machine without libopus (the card's) 16f holds the refusal."""
    import torch
    from mediastreamer2_tpu_torch.ops import host_codecs
    monkeypatch.setattr(host_codecs, "opus_available", lambda: False)
    checks = smoke.other_subcommands(torch.device("cpu"), "cpu", str(tmp_path))
    assert checks["record .mkv raises"] and "record .mkv" not in checks


def test_phase_16_fixtures(smoke, tmp_path):
    """The capture holds the sequence numbers across the wrap, the swapped
    pair and the gap; the MKV fixtures' frames come back through
    ``mkv_received`` from packets made as mkvstream makes them; the ports
    found bind; ``device_args`` is empty for the card."""
    import socket
    import torch
    from mediastreamer2_tpu_torch.io.pcap import PcapRtpPlayer
    from mediastreamer2_tpu_torch.net.h26x import packetize
    from mediastreamer2_tpu_torch.net.rtp import RtpPacket
    from mediastreamer2_tpu_torch.ops.vp8 import vp8_payload_pack
    codes = smoke.pcap_fixture(str(tmp_path / "c.pcap"))
    seqs = [p.seq for _, p in PcapRtpPlayer(str(tmp_path / "c.pcap")).packets]
    a = smoke.PCAP_SWAPPED
    assert len(seqs) == smoke.PCAP_PACKETS - 1 and codes.shape == (smoke.PCAP_PACKETS, 80)
    assert seqs[a] == (65500 + a + 1) & 0xFFFF and seqs[a + 1] == (65500 + a) & 0xFFFF
    assert (65500 + smoke.PCAP_MISSING) & 0xFFFF not in seqs and 0 in seqs
    for codec in ("vp8", "h264"):
        want, params = smoke.mkv_fixture(str(tmp_path / f"{codec}.mkv"), codec)
        assert len(want) == smoke.MKV_FRAMES and sum(k for k, _ in want) == 2
        datagrams, seq = [], 0
        for k, (key, data) in enumerate(want):
            if codec == "vp8":
                pays = vp8_payload_pack([data[i:i + 1400] for i in range(0, len(data), 1400)])
            else:
                pays = packetize((params if key else []) + data, mtu=1400)
            for j, p in enumerate(pays):
                datagrams.append(RtpPacket(payload_type=102, seq=seq, timestamp=k, ssrc=1,
                                           payload=p, marker=j == len(pays) - 1).pack())
                seq += 1
        got = smoke.mkv_received(datagrams[::-1], codec)      # order restored by seq
        assert got == ([d for _, d in want] if codec == "vp8"
                       else [(params if key else []) + n for key, n in want])
    base = smoke.free_ports(4, host="127.0.0.1")
    assert 2000 <= base and base + 4 <= 16000
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", base + 3))
    assert smoke.device_args(torch.device("cpu")) == ["--device", "cpu"]
    assert smoke.device_args(torch.device("cuda", 0)) == []


def test_kernels_line_carries_the_program_runs(smoke):
    """The conference example's server and its clients, the CLI's bench, its
    call leg and the gateway example are counted runs of the kernels line:
    their launches a tick per kernel, each over its own ticks."""
    meas = dict(max_abs_err=0.0, ms=1.0, plain_ms=2.0, bound_ms=0.5, bound_by="bytes")
    results = {name: dict(meas) for name in smoke.REPLACES if not name.startswith(("dvi4", "g726"))}
    adpcm = {f"{n}@{kbps}": dict(meas) for n in ("g726_encode", "g726_decode")
             for kbps in smoke.G726_RATES.values()}
    adpcm.update({n: dict(meas) for n in ("dvi4_encode", "dvi4_decode")})
    zero = dict.fromkeys(smoke.REPLACES, 0)
    runs = {"conference_server": ({**zero, "fused_volume": 402}, 400),
            "conference_clients": ({**zero, "fused_volume": 2 * 340, "mdf_apply": 340,
                                    "mdf_update_fused": 340}, 340),
            "cli_bench": ({**zero, "fused_volume": 800}, 200),
            "cli_call": ({**zero, "fused_volume": 300, "mdf_apply": 100,
                          "mdf_update_fused": 100}, 100),
            "gateway_example": ({**zero, "g722_encode": 201}, 200)}
    entries = {e["name"]: e for e in smoke.kernel_entries(results, adpcm, {}, {}, runs)}
    assert entries["mdf_apply"]["launches_per_tick"]["conference_clients"] == 1.0
    assert entries["mdf_apply"]["launches_per_tick"]["conference_server"] == 0.0
    assert entries["fused_volume"]["launches_per_tick"]["conference_server"] == 402 / 400
    assert entries["mdf_update_fused"]["launches_per_tick"]["cli_call"] == 1.0
    assert entries["g722_encode"]["launches_per_tick"]["gateway_example"] == 201 / 200
    assert entries["fused_volume"]["launches"] == 402 + 2 * 340 + 800 + 300
    assert entries["g722_decode"]["launches"] == 0


def test_flagship_makes_phase_3s_dft_calls(smoke):
    """Phase 3's count of the echo canceller's DFTs: the flagship makes
    ``FLAGSHIP_DFTS`` a tick, here all products (the CPU's path); the bar
    that wants FFTs (the card's) fails them."""
    import torch
    from mediastreamer2_tpu_torch.models.flagship import echo_coupled_inputs
    from mediastreamer2_tpu_torch.ops import rfft
    ticks = 3
    mic, far = echo_coupled_inputs(8, ticks, seed=7)
    before = dict(rfft.calls)
    smoke.run_flagship(8, ticks, torch.device("cpu"), mic, far)
    dfts = {k: v - before[k] for k, v in rfft.calls.items()}
    what = "DFT calls by path"
    smoke._require_counts("flagship", dfts, {"product": smoke.FLAGSHIP_DFTS * ticks}, what)
    with pytest.raises(AssertionError, match="flagship: DFT calls by path"):
        smoke._require_counts("flagship", dfts, {"fft": smoke.FLAGSHIP_DFTS * ticks}, what)


def test_ec_kernels_are_wanted_with_mdf_apply(smoke):
    """The launch bars want each kernel of ``EC_KERNELS`` as many times an
    echo-canceller tick as it names (5, 4, 1, 1), over mdf_apply's ticks,
    without a phase naming them; a layout pass too few fails; a phase that
    names one holds its own number."""
    assert {k: n for k, (_, n) in smoke.EC_KERNELS.items()} == {
        "spectrum_planes": 5, "planes_spectrum": 4, "suppress_gain": 1, "aec_decide": 1}
    launches = dict.fromkeys([*smoke.REPLACES, *smoke.EC_KERNELS], 0)
    launches.update(fused_volume=6, mdf_apply=2, mdf_update_fused=2, spectrum_planes=10,
                    planes_spectrum=8, suppress_gain=2, aec_decide=2)
    want = {"fused_volume": 6, "mdf_apply": 2, "mdf_update_fused": 2}
    smoke._require_counts("8a", launches, want)
    with pytest.raises(AssertionError, match="spectrum_planes"):
        smoke._require_counts("8a", dict(launches, spectrum_planes=9), want)
    smoke._require_counts("8a", dict(launches, suppress_gain=0), dict(want, suppress_gain=0))
    idle = dict.fromkeys(launches, 0)
    smoke._require_counts("9b", dict(idle, g726_encode=1), {"g726_encode": 1})
    with pytest.raises(AssertionError, match="planes_spectrum"):
        smoke._require_counts("9b", dict(idle, planes_spectrum=1), {})


def test_kernels_line_carries_the_ec_kernels(smoke):
    """Each kernel of ``EC_KERNELS`` has an entry in the kernels JSON line
    with the contract's keys, the port's operations it replaces (a file of
    the port), its measurements at the three shapes and its launches a
    tick of each counted run."""
    meas = dict(max_abs_err=0.0, ms=1.0, plain_ms=2.0, bound_ms=0.5, bound_by="bytes")
    results = {name: dict(meas) for name in smoke.EC_KERNELS}
    zero = dict.fromkeys([*smoke.REPLACES, *smoke.EC_KERNELS], 0)
    runs = {"flagship": ({**zero, "spectrum_planes": 500, "planes_spectrum": 400,
                          "suppress_gain": 100, "aec_decide": 100}, 100),
            "gateway": (zero, 50)}
    entries = smoke.ec_kernel_entries(results, results, results, runs)
    assert [e["name"] for e in entries] == list(smoke.EC_KERNELS)
    contract = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms", "session_shapes",
                "wideband_shapes"}
    for e in entries:
        assert contract <= set(e) and e["source"] == smoke.KERNEL_SOURCE
        assert os.path.exists(os.path.join(REPO, e["replaces"].split(":")[0]))
        assert e["launches_per_tick"] == {"flagship": smoke.EC_KERNELS[e["name"]][1],
                                          "gateway": 0.0}
    assert [e["launches"] for e in entries] == [500, 400, 100, 100]
