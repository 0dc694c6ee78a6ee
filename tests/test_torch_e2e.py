"""The port's end-to-end G.711 conference leg on the CPU: the e2e graph
against the JAX package's (default and megakernel AEC), the bench over
real localhost UDP (unpaced), and the port's copy of the native RTP edge."""
import socket
import time

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each, so that parallel test workers running
# real-time paced tests are not crowded by idle OpenMP threads
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mediastreamer2_tpu.models.e2e_bench import build_e2e_graph as jax_build  # noqa: E402
from mediastreamer2_tpu.ops import g711 as jg  # noqa: E402
from mediastreamer2_tpu_torch import Factory  # noqa: E402
from mediastreamer2_tpu_torch.models.e2e_bench import (  # noqa: E402
    DEPTH, WARMUP_TICKS, E2EConferenceBench, build_e2e_graph, e2e_tick,
    echo_coupled_codes)
from mediastreamer2_tpu_torch.native import BatchRtpRx, BatchRtpTx  # noqa: E402
from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff, quality_bar  # noqa: E402

B, TICKS, S8, S48 = 8, 60, 80, 480


@pytest.mark.parametrize("env", [{}, {"PALLAS_MDF": "1"}], ids=["default", "megakernel"])
def test_e2e_graph_matches_jax(factory, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    codes, mic = echo_coupled_codes(B, TICKS, seed=5)
    jcg, jpr = jax_build(factory, B)
    tcg, tpr = build_e2e_graph(Factory(), B, "cpu")
    jst, tst = jcg.init_state(), tcg.init_state("cpu")
    # both packages made the same shadow storage under this environment
    assert set(tst["ec"]) == set(jst["ec"])
    assert (tst["ec"]["Ws_r"].dtype == torch.float32) == ("PALLAS_MDF" in env)
    step = jax.jit(jcg.step)
    jo, to = [], []
    for t in range(TICKS):
        c = codes[:, t * S8:(t + 1) * S8]
        m = np.ascontiguousarray(mic[:, t * S48:(t + 1) * S48])
        jst, o, _ = step(jst, jpr, {"rx": jg.pcm16_to_float(jg.ulaw_decode(jnp.asarray(c))),
                                    "mic": m})
        jo.append(np.asarray(o["out"]))
        tst, tx, _, out = e2e_tick(tcg, tst, tpr, torch.from_numpy(c), torch.from_numpy(m))
        to.append(out.numpy())
        assert tx.dtype == torch.uint8 and tx.shape == (B, S8)
    jout, tout = np.concatenate(jo, 1), np.concatenate(to, 1)
    assert np.isfinite(tout).all()
    # the quality bar of tests/test_torch_flagship.py, on every leg
    bar = quality_bar(jout, tout, leg_step=1)
    assert bar["pass"], bar
    for i in range(B):
        assert audio_diff(jout[i], tout[i])[0] >= 0.999, i


@pytest.mark.parametrize("gso", [True, False], ids=["gso", "sendmmsg"])
def test_e2e_bench_selfloop_traffic_and_fidelity(monkeypatch, gso):
    """tests/test_e2e_bench.py's self-loop at K=1, D=2, unpaced, with the
    tx edge's GSO path and with the sendmmsg path that kernels without
    UDP_SEGMENT get."""
    from mediastreamer2_tpu_torch import native
    if gso and not native.udp_gso_supported():
        pytest.skip("this host's kernel refuses UDP_SEGMENT (UDP GSO)")
    if not gso:
        monkeypatch.setattr(native, "udp_gso_supported", lambda: False)
    b = E2EConferenceBench(Factory(), n_legs=16, device="cpu")
    assert b.gso == gso
    try:
        res = b.run(n_ticks=40, paced=False, trace=True)
        assert res.loss_rate < 0.05, res
        assert res.fidelity > 0.9, res
        assert res.ticks == 40 - WARMUP_TICKS
        assert res.out_finite
        assert res.mouth_to_ear_ms == (DEPTH + 1 + b.prefill) * 10.0
        assert set(res.phases_ms) >= {"edge_tx", "edge_rx", "submit", "pop", "dispatch"}
        assert res.late_ticks == 0
        assert b._t == 40                     # one tick dispatched per run tick
    finally:
        b.close()


def test_e2e_bench_flags_nonfinite_output():
    """A NaN in the graph's output is reported, though the probe legs'
    received audio, decoded from mu-law codes, stays finite."""
    b = E2EConferenceBench(Factory(), n_legs=8, device="cpu")
    try:
        b._mic0[0, 0] = float("nan")
        res = b.run(n_ticks=WARMUP_TICKS + 4, paced=False)
        assert not res.out_finite
        assert all(np.isfinite(p).all() for p in b._recv_probe)
    finally:
        b.close()


def test_e2e_bench_megakernel_state(monkeypatch):
    """Under PALLAS_MDF=1 the bench's AEC carries an f32 shadow and no srk."""
    monkeypatch.setenv("PALLAS_MDF", "1")
    b = E2EConferenceBench(Factory(), n_legs=8, device="cpu")
    try:
        ec = b.state["ec"]
        assert ec["Ws_r"].dtype == torch.float32 and "srk" not in ec
        b.warm()
        assert not ec["Wm_r"].float().abs().any()   # warm leaves the state as it was
    finally:
        b.close()


def test_e2e_bench_srtp_raises():
    """srtp=True with a suite the edge does not know raises before a leg
    is sent (the run with SRTP: test_e2e_bench_srtp_runs)."""
    with pytest.raises(KeyError, match="AES_CM_64"):
        E2EConferenceBench(Factory(), n_legs=4, device="cpu", srtp=True,
                           srtp_suite="AES_CM_64_HMAC_SHA1_80")


def test_e2e_bench_srtp_runs():
    """The self-looped bench with SRTP on every leg, unpaced: no loss after
    the warmup, no authentication failure, the probe legs' audio back."""
    b = E2EConferenceBench(Factory(), n_legs=8, device="cpu", srtp=True)
    try:
        res = b.run(n_ticks=WARMUP_TICKS + 20, paced=False)
    finally:
        b.close()
    assert res.srtp and res.auth_failures == 0
    assert res.loss_rate == 0.0 and res.fidelity > 0.9 and res.out_finite


# --- the port's copy of the native edge (tests/test_rtp_edge.py's cases) ----
PSZ = 80


def _mk_pair(n_legs, prefill=2):
    tx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx_sock.bind(("127.0.0.1", 0))
    rx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx_sock.bind(("127.0.0.1", 0))
    rx_sock.setblocking(False)
    port = rx_sock.getsockname()[1]
    tx = BatchRtpTx(tx_sock, n_legs, PSZ)
    rx = BatchRtpRx(n_legs, PSZ, ring_depth=64)
    rx.add_socket(rx_sock)
    for i in range(n_legs):
        ssrc = 0x1000 + i
        tx.config(i, "127.0.0.1", port, ssrc, seq0=100 + i, ts0=0, pt=0)
        rx.map_ssrc(ssrc, i)
        rx.set_prefill(i, prefill)
    return tx, rx, tx_sock, rx_sock


def test_native_edge_roundtrip_ordered():
    n, ticks = 32, 20
    tx, rx, s1, s2 = _mk_pair(n, prefill=1)
    rng = np.random.default_rng(0)
    sent = []
    try:
        for t in range(ticks):
            pay = rng.integers(0, 255, (n, PSZ), dtype=np.uint8)
            sent.append(pay.copy())
            assert tx.send(pay, ts_inc=PSZ) == n
            time.sleep(0.002)
            rx.poll()
            out, flags = rx.read_tick()
            if t >= 1:                       # prefill=1 -> one tick warmup
                assert flags.all(), f"tick {t} missing legs"
                np.testing.assert_array_equal(out, sent[t - 1])
        st = rx.stats(0)
        assert st["recv"] == ticks and st["got"] == ticks - 1
    finally:
        s1.close(); s2.close(); tx.close(); rx.close()


def test_native_edge_loss_flags_missing():
    tx, rx, s1, s2 = _mk_pair(2, prefill=1)
    port = s2.getsockname()[1]
    raw = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def pkt(ssrc, seq, fill):
        hdr = bytes([0x80, 0, seq >> 8, seq & 0xFF]) + \
            (seq * PSZ).to_bytes(4, "big") + ssrc.to_bytes(4, "big")
        return hdr + bytes([fill]) * PSZ

    try:
        for seq in (10, 11, 13):             # 12 lost
            raw.sendto(pkt(0x1000, seq, seq & 0xFF), ("127.0.0.1", port))
        time.sleep(0.01)
        rx.poll()
        rx.read_tick()                        # warmup tick
        flags_seen = []
        for _ in range(4):
            out, flags = rx.read_tick()
            flags_seen.append(int(flags[0]))
        # 10 ok, 11 ok, 12 missing -> flag 0, 13 ok
        assert flags_seen == [1, 1, 0, 1]
    finally:
        raw.close(); s1.close(); s2.close(); tx.close(); rx.close()


def test_native_edge_srtp_raises():
    """A suite or key the edge cannot take raises: no leg goes out in
    plaintext by mistake."""
    tx, rx, s1, s2 = _mk_pair(1)
    try:
        for edge in (tx, rx):
            with pytest.raises(ValueError, match="16-byte key"):
                edge.set_srtp(0, b"\x00" * 15, b"\x00" * 14)
            with pytest.raises(ValueError, match="unknown SRTP suite"):
                edge.set_srtp(0, b"\x00" * 16, b"\x00" * 14, "NULL_HMAC_SHA1_80")
    finally:
        s1.close(); s2.close(); tx.close(); rx.close()


@pytest.mark.parametrize("k_block", [1, 2, 8, 16])
def test_prefill_and_added_latency_match_jax(k_block):
    """The bench's latency arithmetic is the JAX package's, name for name."""
    from mediastreamer2_tpu.models.e2e_bench import E2EConferenceBench as JaxBench
    assert E2EConferenceBench.prefill_for(k_block) == JaxBench.prefill_for(k_block)
    for depth in range(4):
        assert (E2EConferenceBench.added_latency_ms(k_block, depth)
                == JaxBench.added_latency_ms(k_block, depth))


def test_prefill_at_the_ports_block_is_its_prefill():
    """The port runs K = 1: its jitter ring primes PREFILL ticks, and its
    mouth-to-ear figure is added_latency_ms(1, DEPTH)."""
    from mediastreamer2_tpu_torch.models.e2e_bench import PREFILL
    assert E2EConferenceBench.K == 1
    assert E2EConferenceBench.prefill_for(E2EConferenceBench.K) == PREFILL == 3
    assert E2EConferenceBench.added_latency_ms(1, DEPTH) == (DEPTH + 1 + PREFILL) * 10.0


@pytest.mark.parametrize("ms,ok", [(9.99, True), (10.0, True), (10.01, False)])
def test_realtime_ok_matches_jax(ms, ok):
    from mediastreamer2_tpu.models.e2e_bench import E2EResult as JaxResult
    from mediastreamer2_tpu_torch.models.e2e_bench import E2EResult
    common = dict(n_legs=4, ticks=10, ms_per_tick=ms, late_ticks=0, loss_rate=0.0,
                  fidelity=1.0, mouth_to_ear_ms=60.0)
    assert E2EResult(out_finite=True, **common).realtime_ok is ok
    assert JaxResult(k_block=1, pipeline_depth=DEPTH, **common).realtime_ok is ok


def test_rtp_edge_hw_crypto_is_hw_crypto():
    """The JAX package's name for the edge's AES path, on the port's edge
    (not on a build of JAX's, whose shared name races across workers)."""
    from mediastreamer2_tpu_torch import native
    assert native.rtp_edge_hw_crypto() is native.hw_crypto()
    assert isinstance(native.rtp_edge_hw_crypto(), bool)
