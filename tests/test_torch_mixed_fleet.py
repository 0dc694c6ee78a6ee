"""The port's mixed fleet (``models/mixed_fleet.py``), ``E2EStepper``
(``models/e2e_bench.py``) and ``core/worker.priority_pool`` on the CPU:
the two ``_TickerStepper`` unit tests of ``tests/test_mixed_fleet.py``, its
co-resident fleet (16 flagship + 8 SRTP e2e legs, Opus and VP8 members
where their libraries are, 2 s) in both modes with the JAX test's bars,
the stepper driven unpaced against ``run()``'s oracles (two benches on
one pair of workers: a buffer of one landing in the other fails the
fidelity oracle), the verdict's bars, and what the paced loop must put
back on every exit path (switch interval, GC, the thread's niceness)."""
import gc
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mediastreamer2_tpu.core import worker as j_worker  # noqa: E402
from mediastreamer2_tpu_torch import Factory  # noqa: E402
from mediastreamer2_tpu_torch import native  # noqa: E402
from mediastreamer2_tpu_torch.core import worker as t_worker  # noqa: E402
from mediastreamer2_tpu_torch.models import mixed_fleet as mf  # noqa: E402
from mediastreamer2_tpu_torch.models.e2e_bench import (E2EConferenceBench, E2EResult,  # noqa: E402
                                                       E2EStepper)
from mediastreamer2_tpu_torch.ops import host_codecs as t_hc  # noqa: E402
from mediastreamer2_tpu_torch.ops import vp8 as t_vp8  # noqa: E402

needs_edge = pytest.mark.skipif(not native.rtp_edge_available(), reason="g++ build failed")


class _StubFut:
    def __init__(self, err=None):
        self._done = False
        self._err = err

    def done(self):
        return self._done

    def result(self):
        if self._err:
            raise self._err


class _StubWorker:
    def __init__(self):
        self.futs = []

    def submit(self, fn):
        f = _StubFut()
        self.futs.append(f)
        return f


class _StubTicker:
    realtime = True

    def do_tick(self):
        pass


def test_ticker_stepper_backlog_bound():
    """A dispatch worker that falls behind caps the stepper's queue at
    MAX_BACKLOG (further edges are skipped) and it resumes as soon as a
    slot frees."""
    tk, w = _StubTicker(), _StubWorker()
    st = mf._TickerStepper(tk, w)
    assert tk.realtime is False          # the fleet loop owns pacing
    for _ in range(st.MAX_BACKLOG):
        assert st._submit_tick()
    assert not st._submit_tick()
    assert len(w.futs) == st.MAX_BACKLOG
    w.futs[0]._done = True
    assert st._submit_tick()


def test_ticker_stepper_propagates_worker_errors():
    """A do_tick failure on the dispatch worker is raised again on the
    fleet loop instead of vanishing."""
    st = mf._TickerStepper(_StubTicker(), _StubWorker())
    st._pending.append(_StubFut(err=RuntimeError("boom")))
    st._pending[0]._done = True
    with pytest.raises(RuntimeError, match="boom"):
        st._submit_tick()


@needs_edge
@pytest.mark.parametrize("mode", ["loop", "threads"])
def test_mixed_fleet_coresident(mode):
    """tests/test_mixed_fleet.py::test_mixed_fleet_coresident on the port:
    flagship and SRTP e2e legs, Opus conference legs and VP8 streams at
    once, each class's traffic and fidelity oracles held (the deadline is
    the CPU's, printed by ``passes()``, not barred)."""
    n_opus = 2 if t_hc.opus_available() else 0
    n_video = 2 if t_vp8.vp8_available() else 0
    fleet = mf.MixedFleetBench(Factory, n_flagship=16, n_srtp=8, n_opus=n_opus,
                               n_video=n_video, k_block=4, depth=1, opus_depth=0,
                               video_depth=0, device="cpu")
    try:
        res = fleet.run(seconds=2.0, mode=mode)
    finally:
        fleet.close()
    assert not res.errors, res.errors
    assert res.flagship is not None and res.flagship.fidelity > 0.9, res.summary()
    assert res.srtp is not None and res.srtp.fidelity > 0.9, res.summary()
    assert res.flagship.loss_rate < 0.02 and res.srtp.loss_rate < 0.02, res.summary()
    assert res.srtp.auth_failures == 0 and res.srtp.srtp and not res.flagship.srtp
    if n_opus:
        assert res.opus["delivery"] >= 0.9, res.summary()
    if n_video:
        assert res.video.fps_received_min > 0, res.summary()
    assert isinstance(res.passes(), bool)
    assert res.summary()["flagship"]["legs"] == 16
    if mode == "loop":
        assert set(res.trace["per_member_ms_mean"]) == {"flagship", "srtp"} | (
            {"opus"} if n_opus else set()) | ({"video"} if n_video else set())
    else:
        assert res.trace is None


@needs_edge
def test_e2e_stepper_unpaced_matches_run():
    """Two benches (the SRTP one keyed from seed 7) stepped in turn on one
    uploader and one reader, unpaced: each result has ``run()``'s shape and
    oracles (no loss, fidelity 1 on its own audio, every output finite,
    no SRTP failure), as many timed ticks as ``run()`` would time, and the
    mouth-to-ear of its depth."""
    benches = [E2EConferenceBench(Factory(), 8, "cpu", pipeline_depth=1),
               E2EConferenceBench(Factory(), 4, "cpu", srtp=True, seed=7, pipeline_depth=2)]
    up = t_worker.priority_pool(1, "t-up", nice=-5)
    rd = t_worker.normal_priority_pool(1, "t-rd")
    try:
        steppers = [E2EStepper(b, up, rd, 40) for b in benches]
        assert [s.warmup_blocks for s in steppers] == [1 + 2 + 3, 2 + 2 + 3]
        alive = [True, True]
        while any(alive):
            for i, st in enumerate(steppers):
                if alive[i]:
                    alive[i] = st.tick()
        results = [st.finish() for st in steppers]
    finally:
        up.shutdown(wait=True)
        rd.shutdown(wait=True)
        for b in benches:
            b.close()
    for b, st, r in zip(benches, steppers, results):
        assert isinstance(r, E2EResult) and r.n_legs == b.n
        assert r.ticks == 40 - b.default_warmup_blocks()
        assert r.loss_rate == 0.0 and r.fidelity > 0.99 and r.out_finite
        assert r.auth_failures == 0 and r.srtp == b.srtp and r.late_ticks == 0
        assert r.mouth_to_ear_ms == (b.D + 1 + b.prefill) * 10.0
        assert st.worker_trace()["worker_ms_mean"] > 0
    # the two benches' mics differ (seeds 0 and 7): a tick's buffer landing
    # in the other bench would be heard as another leg's audio
    assert not np.allclose(benches[0]._sent_probe[-1][:4], benches[1]._sent_probe[-1][:4])


def _e2e(**kw):
    base = dict(n_legs=4, ticks=100, ms_per_tick=9.0, late_ticks=1, loss_rate=0.0,
                fidelity=1.0, mouth_to_ear_ms=60.0, out_finite=True)
    return E2EResult(**{**base, **kw})


@pytest.mark.parametrize("what,passes", [
    ({}, True),
    ({"flagship": _e2e(loss_rate=0.05)}, False),           # a member that drops packets
    ({"srtp": _e2e(srtp=True, auth_failures=1)}, False),
    ({"flagship": _e2e(ms_per_tick=12.0)}, False),
    ({"flagship": _e2e(late_ticks=3)}, False),
    ({"opus": {"legs": 2, "ticks": 100, "late_ticks": 0, "delivery": 0.9}}, False),
    ({"errors": {"srtp": "RuntimeError: x"}}, False),
])
def test_fleet_verdict(what, passes):
    """``passes()`` holds each class to its own bench's bars: deadline,
    late ticks (<= ticks / 50), loss < 0.02, fidelity >= 0.9, SRTP
    authentication, Opus delivery >= 0.95, no member error."""
    kw = dict(seconds=1.0, flagship=_e2e(), srtp=_e2e(srtp=True), opus=None, video=None,
              errors={})
    kw.update(what)
    res = mf.MixedFleetResult(**kw)
    assert res.passes() is passes and res.summary()["passes"] is passes


def test_priority_pool_sets_the_nice_level_or_degrades(monkeypatch):
    """The pool's worker runs at the asked niceness, as the JAX package's
    does, where the process may take it; where it may not, the worker runs
    at its inherited level and nothing is raised."""
    def nice_of(pool):
        return pool.submit(lambda: os.getpriority(os.PRIO_PROCESS,
                                                  threading.get_native_id())).result()
    want = 3                               # raising the nice level needs no privilege
    for mod in (j_worker, t_worker):
        pool = mod.priority_pool(1, "t-nice", nice=want)
        try:
            assert nice_of(pool) == want
        finally:
            pool.shutdown(wait=True)

    def refuse(*a):
        raise PermissionError("no CAP_SYS_NICE")
    monkeypatch.setattr(os, "setpriority", refuse)
    pool = t_worker.priority_pool(1, "t-refused", nice=-5)
    try:
        assert pool.submit(lambda: 7).result() == 7
        assert nice_of(pool) == os.getpriority(os.PRIO_PROCESS, threading.get_native_id())
    finally:
        pool.shutdown(wait=True)
    assert mf._elevate_paced_thread() is None          # degrades, never raises


@needs_edge
def test_loop_restores_its_process_state_on_error(monkeypatch):
    """The paced loop sets the switch interval to 1 ms, pauses the GC and
    elevates its thread; an error inside the loop puts all three back."""
    tid = threading.get_native_id()
    before = (sys.getswitchinterval(), gc.isenabled(), os.getpriority(os.PRIO_PROCESS, tid))
    seen = {}

    def boom(self, steppers, errors):
        seen["inside"] = (sys.getswitchinterval(), gc.isenabled())
        raise RuntimeError("loop failed")
    monkeypatch.setattr(mf.MixedFleetBench, "_paced_loop", boom)
    fleet = mf.MixedFleetBench(Factory, n_flagship=4, n_srtp=0, n_opus=0, n_video=0,
                               device="cpu")
    try:
        with pytest.raises(RuntimeError, match="loop failed"):
            fleet.run(seconds=0.2, mode="loop")
    finally:
        fleet.close()
    assert seen["inside"] == (0.001, False)
    assert (sys.getswitchinterval(), gc.isenabled(),
            os.getpriority(os.PRIO_PROCESS, tid)) == before
