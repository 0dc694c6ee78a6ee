"""The rest of the port's ``core/worker.py`` (``Task``, ``WorkerThread``,
``discover_mtu``) as ``tests/test_worker.py`` holds the JAX package's, its
echo-limiter wiring on the port's stream, and the port's ``net/netsim.py``
against the JAX package's: the same packets through simulators with the
same parameters and seed come out with the same delivery times, losses and
drops."""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mediastreamer2_tpu.net import netsim as jnetsim  # noqa: E402
from mediastreamer2_tpu_torch.core.worker import WorkerThread, discover_mtu  # noqa: E402
from mediastreamer2_tpu_torch.net import netsim as tnetsim  # noqa: E402


def test_worker_runs_tasks():
    w = WorkerThread()
    try:
        t1 = w.add_task(lambda: 41 + 1)
        assert t1.wait(2.0) and t1.result == 42
        t2 = w.add_task(lambda: 1 / 0)
        assert t2.wait(2.0) and isinstance(t2.error, ZeroDivisionError)
        order = []
        tasks = [w.add_task(lambda i=i: order.append(i)) for i in range(20)]
        assert all(t.wait(2.0) for t in tasks) and order == list(range(20))
    finally:
        w.destroy()
    assert not w._thread.is_alive()


def test_worker_repeated_and_cancel():
    w = WorkerThread()
    try:
        hits = []
        t = w.add_repeated_task(lambda: hits.append(1), interval_s=0.02)
        deadline = time.monotonic() + 5.0
        while len(hits) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        t.cancel()
        n = len(hits)
        assert n >= 3 and t.done.is_set()
        time.sleep(0.08)
        assert len(hits) <= n + 1                  # no further runs after cancel
    finally:
        w.destroy()


def test_worker_tasks_from_many_threads():
    """Eight threads add tasks at once (a short switch interval): every task
    runs exactly once."""
    import sys
    w = WorkerThread()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ran = []

        def add(k):
            for i in range(50):
                w.add_task(lambda k=k, i=i: ran.append((k, i)))
        threads = [threading.Thread(target=add, args=(k,)) for k in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=5.0)
            assert not th.is_alive()
        last = w.add_task(lambda: None)
        assert last.wait(5.0)
        assert sorted(ran) == [(k, i) for k in range(8) for i in range(50)]
    finally:
        sys.setswitchinterval(old)
        w.destroy()


def test_discover_mtu_loopback():
    assert discover_mtu("127.0.0.1") >= 1500


def test_echo_limiter_wiring():
    """The remote talks loudly and the local side's echo limiter is on: the
    peer energy reaches the send volume and ducks its gain."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.core.block import tick_samples
    from mediastreamer2_tpu_torch.models.audio_stream import AudioStreamBatch
    from mediastreamer2_tpu_torch.net.rtp import LoopbackPair
    from mediastreamer2_tpu_torch.utils.signals import make_speechlike
    S = tick_samples(8000)
    sig = make_speechlike(S * 120, 8000, seed=3)
    remote = AudioStreamBatch(Factory(), 1, mic_signal=sig, device="cpu")
    local = AudioStreamBatch(Factory(), 1, record_ticks=120, device="cpu")
    pair = LoopbackPair()
    remote.set_transport(0, pair.endpoint(0))
    local.set_transport(0, pair.endpoint(1))
    local.ticker.params["vol_send"]["ea_enabled"].fill_(True)
    for s in (local, remote):
        s.ticker.warm_up()
        s.ticker.realtime = False
    for _ in range(100):
        remote.ticker.do_tick()
        local.ticker.do_tick()
    local.ticker.sync()
    assert float(local.ticker.params["vol_send"]["peer_energy"][0]) > 1e-6
    assert float(local.ticker.state["vol_send"]["gain"][0]) < 0.5


@pytest.mark.parametrize("params", [
    dict(loss_rate=10.0, seed=5),
    dict(loss_rate=20.0, consecutive_loss_probability=0.6, seed=9),
    dict(latency_ms=20, jitter_strength_ms=30.0, seed=4),
    dict(max_bandwidth_bps=64000.0, max_buffer_size_bytes=2000, latency_ms=5, seed=1),
    dict(enabled=False, loss_rate=50.0),
], ids=["loss", "bursts", "jitter", "bandwidth", "disabled"])
def test_netsim_equals_jax(params):
    j = jnetsim.NetworkSimulator(jnetsim.NetSimParams(**params))
    t = tnetsim.NetworkSimulator(tnetsim.NetSimParams(**params))
    assert dataclasses.asdict(t.p) == dataclasses.asdict(j.p)
    rng = np.random.default_rng(2)
    now, got_j, got_t = 100.0, [], []
    for i in range(400):
        now += 0.01 * float(rng.random())
        data = bytes(int(rng.integers(20, 200)))
        got_j.append(j.shape(now, data))
        got_t.append(t.shape(now, data))
    assert got_t == got_j
    delivered = sum(bool(g) for g in got_t)
    if params.get("enabled", True) and (params.get("loss_rate") or params.get("max_bandwidth_bps")):
        assert delivered < 400                  # the simulator did drop packets
