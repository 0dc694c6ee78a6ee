"""The port's video e2e bench (``mediastreamer2_tpu_torch/models/
video_e2e_bench.py``) on the CPU over real localhost UDP, unpaced: the
loss-recovery cases of the JAX ``tests/test_video_e2e_bench.py`` (the
product detects a burst, sends FIR, the sender answers with a keyframe,
decoding resumes), with VP8 where libvpx is present and with the dummy
codec, and an unpaced run of the phase-12b shape at a small size. The
paced JAX case is left out: a paced trial's bar measures the host it
runs on, and the card's run (``chip_smoke.py`` phase 12b) holds it."""
import pytest

from mediastreamer2_tpu_torch import Factory
from mediastreamer2_tpu_torch.models.video_e2e_bench import VideoE2EBench
from mediastreamer2_tpu_torch.ops.vp8 import vp8_available


def _codec_or_skip(codec):
    if codec == "vp8" and not vp8_available():
        pytest.skip("libvpx missing")


@pytest.mark.parametrize("codec", ["vp8", None])
def test_video_e2e_loss_recovery(codec):
    _codec_or_skip(codec)
    b = VideoE2EBench(Factory(), 2, codec=codec, width=128, height=96, fps=15.0, device="cpu")
    try:
        b.run(seconds=0.8, paced=False)          # converge first
        assert b.run_loss_recovery(seconds=1.0)
    finally:
        b.close()


@pytest.mark.parametrize("codec", ["vp8", None])
def test_video_e2e_loss_recovery_bench_config(codec):
    """frame_tick=True (one tick a frame interval) with pipeline_depth=2 and
    the async publish worker, whose stream clock must scale with the
    interval for the FIR limiter to reopen in time."""
    _codec_or_skip(codec)
    b = VideoE2EBench(Factory(), 2, codec=codec, width=128, height=96, fps=15.0,
                      pipeline_depth=2, frame_tick=True, device="cpu")
    try:
        assert b.vs.ticker.async_publish and b.vs.ticker.interval_ms == pytest.approx(1000 / 15)
        b.run(seconds=1.0, paced=False)
        assert b.run_loss_recovery(seconds=1.0)
    finally:
        b.close()


def test_video_e2e_unpaced_dummy_codec_delivers_every_frame():
    """Two legs of the dummy codec at 64x48, 15 fps, unpaced: every frame
    sent after the warm-up arrives (self-loop), the luma carries the mire,
    and the result's fields are consistent."""
    b = VideoE2EBench(Factory(), 2, codec=None, width=64, height=48, fps=15.0, device="cpu")
    try:
        sent0 = [s.frames_sent for s in b.vs.stats]
        res = b.run(seconds=1.0, paced=False, warmup_seconds=0.3)
        assert res.n_streams == 2 and res.ticks == 100 and res.luma_ok
        assert res.fps_nominal == 15.0 and res.fps_received_min > 0
        sent = [s.frames_sent - s0 for s, s0 in zip(b.vs.stats, sent0)]
        assert min(sent) == 19 and all(s.frames_received >= f for s, f in zip(b.vs.stats, sent))
        assert all(s.fir_sent == 0 for s in b.vs.stats)
    finally:
        b.close()
