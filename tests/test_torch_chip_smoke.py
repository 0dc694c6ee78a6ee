"""The bound arithmetic of ``chip_smoke.py`` (phase 2) on the CPU: the bytes
each kernel must move at the flagship's shapes (B = 4096, S = 480,
P = 8, F = 481), the G.722 kernels' bytes and serial chain at B = 1,024,
against the figures worked out by hand from the kernels' operands; and
the launches phase 8a expects a tick pair."""
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
