"""The port's Ticker and event queue (``core/ticker.py``, ``core/events.py``)
on the CPU: ports of the Ticker tests of ``tests/test_core.py``, both
packages' Tickers driving one graph at pipeline depths 0 and 2, and
``save_state`` blobs that cross between the packages."""
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each, so that parallel test workers running
# real-time paced tests are not crowded by idle OpenMP threads
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mediastreamer2_tpu.core.block import Format as JFormat  # noqa: E402
from mediastreamer2_tpu.core.graph import GraphBuilder as JGraphBuilder  # noqa: E402
from mediastreamer2_tpu.core.ticker import Ticker as JTicker  # noqa: E402
from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder, tick_samples  # noqa: E402
from mediastreamer2_tpu_torch.core.events import EventQueue  # noqa: E402
from mediastreamer2_tpu_torch.core.ticker import (FleetTicker, Ticker,  # noqa: E402
                                                  TickerSynchronizer)

S8 = tick_samples(8000)


@pytest.fixture(scope="module")
def tfactory():
    return Factory()


def test_event_queue():
    q = EventQueue()
    q.post_tensor_events({"player.eof": np.array([False, True, False, True])}, tick=7)
    assert len(q) == 2
    got = []
    q.set_handler("player.eof", lambda ev: got.append((ev.leg, ev.tick)))
    assert q.pump() == 2
    assert got == [(1, 7), (3, 7)]


def test_file_player_eof_and_loop(factory, tfactory):
    """Both packages' players on one signal: the same samples and the same
    ``eof`` events; leg 0 stops at the end, leg 1 loops."""
    B = 2
    sig = np.ones(S8 * 2, np.float32) * 0.25      # 2 ticks of signal
    got = {}
    for name, gb_cls, fmt, fac in (("jax", JGraphBuilder, JFormat, factory),
                                   ("torch", GraphBuilder, Format, tfactory)):
        g = gb_cls(fac, batch=B)
        g.chain(g.add("file_player", "play", fmt=fmt(rate=8000), signal=sig),
                g.add("ext_sink", "out"))
        cg = g.build()
        if name == "jax":
            st, params = cg.init_state(), cg.init_params()
            params["play"]["loop"] = jnp.array([False, True])
        else:
            st, params = cg.init_state("cpu"), cg.init_params("cpu")
            params["play"]["loop"] = torch.tensor([False, True])
        outs, eofs = [], []
        for _ in range(4):
            st, out, ev = cg.step(st, params, {})
            outs.append(np.asarray(out["out"]))
            eofs.append(np.asarray(ev["play.eof"]))
        got[name] = (np.stack(outs), np.stack(eofs))
    outs, eofs = got["torch"]
    assert eofs[0].tolist() == [False, False]
    assert eofs[1].tolist() == [True, True]
    assert np.all(outs[2][0] == 0.0)              # leg 0 silent after its end
    assert np.all(outs[2][1] == 0.25)             # leg 1 looped
    np.testing.assert_array_equal(outs, got["jax"][0])
    np.testing.assert_array_equal(eofs, got["jax"][1])


def _passthrough(factory, B=2):
    g = GraphBuilder(factory, batch=B)
    g.chain(g.add("ext_source", "in", fmt=Format(rate=8000)), g.add("ext_sink", "out"))
    return g.build()


def test_ticker_runs_and_measures(tfactory):
    tk = Ticker(_passthrough(tfactory), "cpu", realtime=False)
    tk.warm_up()
    tk.run(10)
    assert tk.stats.ticks == 10
    assert tk.time_ms == 100
    assert tk.stats.mean_step_ms > 0
    assert tk.get_average_load() > 0


def test_ticker_runs_on_the_card_unless_told_cpu(tfactory, monkeypatch):
    """``device=None`` means the card: without one the Ticker raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Ticker(_passthrough(tfactory))
    assert Ticker(_passthrough(tfactory), "cpu").device == torch.device("cpu")


def test_ticker_synchronizer():
    ts = TickerSynchronizer(alpha=0.5)
    # device consuming at exactly 8 kHz with a constant 5 ms offset
    for i in range(1, 50):
        skew = ts.update(nb_samples=i * 80, rate=8000, host_time_ms=i * 10 + 5)
    assert abs(skew - 5.0) < 0.5
    assert abs(ts.drift_ms(50 * 80, 8000, 50 * 10 + 5)) < 0.5


@pytest.mark.parametrize("async_publish", [False, True], ids=["inline", "async"])
def test_ticker_pipelined_outputs_complete(tfactory, async_publish):
    """pipeline_depth > 0: outputs arrive ``depth`` ticks late but complete
    and in order; drain() flushes the tail (the publish worker too)."""
    ticks = 12
    sig = np.arange(S8 * ticks, dtype=np.float32) / (S8 * ticks)
    g = GraphBuilder(tfactory, batch=2)
    g.chain(g.add("file_player", "play", fmt=Format(rate=8000), signal=sig),
            g.add("ext_sink", "out"))
    tk = Ticker(g.build(), "cpu", realtime=False, pipeline_depth=3)
    tk.async_publish = async_publish
    got = []
    tk.set_io(push=lambda t, out: got.append((t, out["out"][0].copy())))
    tk.warm_up()
    tk.run(ticks)
    assert [t for t, _ in got] == list(range(ticks))
    np.testing.assert_allclose(np.concatenate([o for _, o in got]), sig, atol=1e-6)


def test_fleet_ticker_heterogeneous_graphs(tfactory):
    """Two different graphs (batch and rate) under one FleetTicker beat:
    both deliver complete output streams; stride runs a member every Nth
    tick."""
    ticks = 12
    sig_a = np.arange(S8 * ticks, dtype=np.float32) / (S8 * ticks)
    ga = GraphBuilder(tfactory, batch=2)
    ga.chain(ga.add("file_player", "play", fmt=Format(rate=8000), signal=sig_a),
             ga.add("ulaw_enc"), ga.add("ulaw_dec"), ga.add("ext_sink", "out"))
    S16 = tick_samples(16000)
    gb = GraphBuilder(tfactory, batch=3)
    gb.chain(gb.add("file_player", "play", fmt=Format(rate=16000),
                    signal=0.5 * np.ones(S16 * ticks, np.float32)),
             gb.add("ext_sink", "out"))
    ta = Ticker(ga.build(), "cpu", name="a", realtime=False)
    tb = Ticker(gb.build(), "cpu", name="b", realtime=False, pipeline_depth=2)
    got_a, got_b = {}, {}
    ta.set_io(push=lambda t, o: got_a.update({t: o["out"][0].copy()}))
    tb.set_io(push=lambda t, o: got_b.update({t: o["out"][0].copy()}))
    fleet = FleetTicker(realtime=False)
    fleet.add(ta)
    fleet.add(tb, stride=2)
    fleet.warm_up()
    fleet.run(ticks)
    assert fleet.stats.ticks == ticks
    assert ta.stats.ticks == ticks
    assert tb.stats.ticks == ticks // 2
    flat = np.concatenate([got_a[t] for t in range(ticks)])
    assert np.corrcoef(flat, sig_a)[0, 1] > 0.999
    assert sorted(got_b) == list(range(ticks // 2))
    assert all(np.allclose(v, 0.5, atol=1e-6) for v in got_b.values())


def _vad_graph(gb_cls, fmt_cls, factory, B):
    g = gb_cls(factory, batch=B)
    g.chain(g.add("ext_source", "in", fmt=fmt_cls(rate=8000)), g.add("volume", "v"),
            g.add("vad_dtx", "vad"), g.add("ext_sink", "out"))
    return g.build()


@pytest.mark.parametrize("depth", [0, 2])
def test_tickers_match_jax(factory, tfactory, depth):
    """One graph (volume with AGC on some legs, then VAD) under both
    packages' Tickers on the same inputs: the same outputs, in the same
    order, and the same tensor events in the event queue."""
    B, ticks = 4, 24
    rng = np.random.default_rng(depth)
    level = np.where(rng.uniform(size=(ticks, B, 1)) < 0.3, 0.002, 0.4)
    xs = (rng.uniform(-1, 1, (ticks, B, S8)) * level).astype(np.float32)
    agc = np.array([True, False, True, False])
    runs = {}
    for name in ("jax", "torch"):
        if name == "jax":
            tk = JTicker(_vad_graph(JGraphBuilder, JFormat, factory, B), realtime=False,
                         pipeline_depth=depth)
            tk.params["v"]["agc_enabled"] = jnp.asarray(agc)
        else:
            tk = Ticker(_vad_graph(GraphBuilder, Format, tfactory, B), "cpu",
                        realtime=False, pipeline_depth=depth)
            tk.params["v"]["agc_enabled"].copy_(torch.from_numpy(agc))
        outs = []
        tk.set_io(pull=lambda t: {"in": xs[t]},
                  push=lambda t, o: outs.append((t, np.asarray(o["out"]).copy())))
        tk.warm_up()
        tk.run(ticks)
        events = sorted((ev.source, ev.leg, ev.tick) for ev in tk.event_queue.drain())
        runs[name] = (outs, events)
    (j_outs, j_ev), (t_outs, t_ev) = runs["jax"], runs["torch"]
    assert [t for t, _ in t_outs] == [t for t, _ in j_outs] == list(range(ticks))
    np.testing.assert_allclose(np.stack([o for _, o in t_outs]),
                               np.stack([o for _, o in j_outs]), rtol=1e-5, atol=1e-6)
    assert t_ev == j_ev
    assert any(src == "vad.silence_start" for src, _, _ in t_ev)


def _ec_graph(gb_cls, fmt_cls, factory, B, mic, far):
    """The echo canceller fed by two players, then a volume: float, bf16,
    int32 and uint32 state leaves."""
    g = gb_cls(factory, batch=B)
    fmt = fmt_cls(rate=8000)
    ec = g.add("echo_canceller", "ec")
    g.link(g.add("file_player", "mic", fmt=fmt, signal=mic), 0, ec, 0)
    g.link(g.add("file_player", "far", fmt=fmt, signal=far), 0, ec, 1)
    g.chain(ec, g.add("volume", "v"), g.add("ext_sink", "out"))
    return g.build()


def test_save_state_crosses_packages(factory, tfactory):
    """A blob saved by either package's Ticker loads in the other's (and in
    a fresh Ticker of the port), and the next tick's outputs match: keys
    ``node::leaf``, bf16 leaves as f32 under ``::bf16``, the AEC's ``srk``
    as uint32."""
    B, ticks = 2, 12
    rng = np.random.default_rng(4)
    far = (0.3 * rng.standard_normal((B, S8 * (ticks + 2)))).astype(np.float32)
    mic = (0.5 * far + 0.01 * rng.standard_normal(far.shape)).astype(np.float32)

    def jax_ticker():
        return JTicker(_ec_graph(JGraphBuilder, JFormat, factory, B, mic, far),
                       realtime=False)

    def torch_ticker():
        return Ticker(_ec_graph(GraphBuilder, Format, tfactory, B, mic, far), "cpu",
                      realtime=False)

    def next_out(tk):
        return np.asarray(tk.do_tick()["out"])

    for src_cls, dst_cls in ((jax_ticker, torch_ticker), (torch_ticker, jax_ticker),
                             (torch_ticker, torch_ticker)):
        src = src_cls()
        src.run(ticks)
        blob = src.save_state()
        dst = dst_cls()
        dst.load_state(blob)                      # applied at the next tick
        want, got = next_out(src), next_out(dst)
        assert np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    data = np.load(__import__("io").BytesIO(blob))
    assert "ec::Wm_r::bf16" in data.files and data["ec::srk"].dtype == np.uint32


def test_dispatch_lock_serves_in_arrival_order():
    from mediastreamer2_tpu_torch.core.ticker import _FifoLock
    lock, order, threads = _FifoLock(), [], []

    def take(i):
        with lock:
            order.append(i)
    with lock:
        for i in range(4):
            threads.append(threading.Thread(target=take, args=(i,)))
            threads[-1].start()
            deadline = time.monotonic() + 10
            while lock._asked < i + 2 and time.monotonic() < deadline:
                time.sleep(0.001)            # thread i holds ticket i + 1
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert order == [0, 1, 2, 3]


def test_tickers_on_threads_take_turns(tfactory):
    """Four tickers started on their own threads (more threads than this
    test's one torch thread), with a short switch interval: each delivers
    every tick, in order, with the right samples."""
    ticks = 40
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        runs = []
        for k in range(4):
            sig = (np.arange(S8 * ticks, dtype=np.float32) + k) / (2 * S8 * ticks)
            g = GraphBuilder(tfactory, batch=2)
            g.chain(g.add("file_player", "play", fmt=Format(rate=8000), signal=sig),
                    g.add("volume", "v"), g.add("ext_sink", "out"))
            tk = Ticker(g.build(), "cpu", name=f"t{k}", realtime=False,
                        pipeline_depth=k % 2)
            got = []
            tk.set_io(push=lambda t, o, got=got: got.append((t, o["out"][0].copy())))
            runs.append((tk, sig, got))
        for tk, _, _ in runs:
            tk.start(ticks)
        for tk, _, _ in runs:
            tk._run_thread.join(timeout=60)
            assert not tk._run_thread.is_alive()
    finally:
        sys.setswitchinterval(old)
    for tk, sig, got in runs:
        assert [t for t, _ in got] == list(range(ticks))
        np.testing.assert_allclose(np.concatenate([o for _, o in got]), sig, atol=1e-6)
        assert tk.phase_ms["queue"] >= 0
