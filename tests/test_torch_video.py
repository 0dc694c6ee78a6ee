"""The port's pixel path (``mediastreamer2_tpu_torch/ops/video.py``) against
the JAX package's ``ops/video.py`` on the CPU, every function and filter to
1e-5 on the same seeded inputs: the YUV layouts, color conversion, the
three scalings (antialiased down, as ``jax.image.resize(..., "linear")``),
rotations with mirror, the self-view composite, the pix-stride copies, the
mire over five ticks, pix_conv / size_conv / video_transform /
analyse_display through a graph; and the ticker's ``step_fn`` /
``warmup_ext`` hooks and ``StreamRegulator``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mediastreamer2_tpu.core.block import Format as JFormat
from mediastreamer2_tpu.core.factory import Factory as JFactory
from mediastreamer2_tpu.core.graph import GraphBuilder as JGraphBuilder
from mediastreamer2_tpu.core.worker import StreamRegulator as JStreamRegulator
from mediastreamer2_tpu.ops import video as jv

from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder
from mediastreamer2_tpu_torch.core.ticker import Ticker
from mediastreamer2_tpu_torch.core.worker import StreamRegulator
from mediastreamer2_tpu_torch.ops import video as tv

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _frame(B, w, h, seed):
    return np.random.default_rng(seed).random((B, h * 3 // 2, w)).astype(np.float32)


@pytest.mark.parametrize("w,h,ow,oh", [(640, 480, 320, 240), (320, 240, 176, 144),
                                       (176, 144, 352, 288), (64, 48, 64, 48)])
def test_scale_yuv420_equal_jax(w, h, ow, oh):
    f = _frame(2, w, h, seed=w)
    _close(tv.scale_yuv420(torch.from_numpy(f), w, h, ow, oh), jv.scale_yuv420(f, w, h, ow, oh))


def test_split_join_and_biplanar_equal_jax():
    f = _frame(3, 32, 24, seed=1)
    for a, b in zip(tv.split_yuv420(torch.from_numpy(f), 32, 24), jv.split_yuv420(f, 32, 24)):
        _close(a, b, 0)
    y, u, v = (torch.from_numpy(np.asarray(p)) for p in jv.split_yuv420(f, 32, 24))
    _close(tv.join_yuv420(y, u, v), f, 0)
    for nv21 in (False, True):
        ty, tuv = tv.i420_to_nv12(y, u, v, nv21=nv21)
        jy, juv = jv.i420_to_nv12(jnp.asarray(y.numpy()), jnp.asarray(u.numpy()),
                                  jnp.asarray(v.numpy()), nv21=nv21)
        _close(tuv, juv, 0)
        for a, b in zip(tv.nv12_to_i420(ty, tuv, nv21=nv21), jv.nv12_to_i420(jy, juv, nv21=nv21)):
            _close(a, b, 0)
        for deg, ow, oh in ((0, 0, 0), (90, 0, 0), (180, 16, 12), (270, 12, 16)):
            _close(tv.nv12_to_yuv420_frame(ty, tuv, deg, ow, oh, nv21=nv21),
                   jv.nv12_to_yuv420_frame(jy, juv, deg, ow, oh, nv21=nv21))


def test_color_conversion_equal_jax():
    rng = np.random.default_rng(2)
    rgb = rng.random((2, 48, 64, 3)).astype(np.float32)
    _close(tv.rgb_to_yuv420(torch.from_numpy(rgb)), jv.rgb_to_yuv420(rgb))
    f = _frame(2, 64, 48, seed=3)
    _close(tv.yuv420_to_rgb(torch.from_numpy(f), 64, 48), jv.yuv420_to_rgb(f, 64, 48))


@pytest.mark.parametrize("degrees", [0, 90, 180, 270])
def test_rotation_and_mirror_equal_jax(degrees):
    w, h = 64, 48
    f = _frame(2, w, h, seed=degrees)
    got = tv.rotate_yuv420(torch.from_numpy(f), w, h, degrees)
    want = jv.rotate_yuv420(f, w, h, degrees)
    _close(got, want, 0)
    ow, oh = (h, w) if degrees % 180 == 90 else (w, h)
    _close(tv.mirror_yuv420(got, ow, oh), jv.mirror_yuv420(want, ow, oh), 0)


@pytest.mark.parametrize("corner", ["bottom_right", "bottom_left", "top_right", "top_left"])
def test_compose_selfview_equal_jax(corner):
    main, pip = _frame(2, 64, 48, seed=4), _frame(2, 64, 48, seed=5)
    for scale, margin in ((0.25, 8), (0.5, 30)):          # 30: the inset clamps at the edge
        _close(tv.compose_selfview(torch.from_numpy(main), torch.from_numpy(pip), corner,
                                   scale, margin),
               jv.compose_selfview(jnp.asarray(main), jnp.asarray(pip), corner, scale, margin))


def test_pix_stride_copies_equal_jax():
    rng = np.random.default_rng(6)
    w, h = 16, 12
    y = rng.integers(0, 256, (h, w), np.uint8)
    uv = rng.integers(0, 256, (h // 2, w), np.uint8)      # NV12: interleaved chroma
    src_planes = [y, uv, uv[:, 1:]]
    outs = []
    for mod in (tv, jv):
        dst = [np.zeros((h, w), np.uint8), np.zeros((h // 2, w // 2), np.uint8),
               np.zeros((h // 2, w // 2), np.uint8)]
        mod.yuv_copy_with_pix_strides(src_planes, [w, w, w], [1, 2, 2], (4, 2, 8, 6),
                                      dst, [w, w // 2, w // 2], [1, 1, 1], (2, 4, 8, 6))
        one = np.zeros(h * w, np.uint8)
        mod.plane_copy_with_strides(y, w, 1, (0, 0, w // 2, h), one, w, 2, (0, 0, 0, 0))
        outs.append(dst + [one])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert outs[0][0].any() and outs[0][1].any()


def _graphs(build):
    """(port CompiledGraph, JAX CompiledGraph) from one builder function."""
    tg = GraphBuilder(Factory(), batch=3)
    jg = JGraphBuilder(JFactory(), batch=3)
    build(tg, Format)
    build(jg, JFormat)
    return tg.build(), jg.build()


def _run_both(build, ticks, ext=lambda t: {}):
    tcg, jcg = _graphs(build)
    ts, tp = tcg.init_state("cpu"), tcg.init_params("cpu")
    js, jp = jcg.init_state(), jcg.init_params()
    got = []
    for t in range(ticks):
        e = ext(t)
        ts, tout, tev = tcg.step(ts, tp, {k: torch.from_numpy(v) for k, v in e.items()})
        js, jout, jev = jcg.step(js, jp, e)
        got.append((tout, jout, tev, jev))
    return got, ts, js


def test_mire_five_ticks_equal_jax():
    def build(g, Fmt):
        m = g.add("mire", "cam", fmt=Fmt(kind="yuv420", width=64, height=48, fps=25.0))
        g.link(m, 0, g.add("ext_sink", "out"), 0)
    got, ts, js = _run_both(build, 5)
    for t, (tout, jout, _, _) in enumerate(got):
        _close(tout["out"], jout["out"])
    _close(ts["cam"]["frame_idx"], js["cam"]["frame_idx"], 0)
    assert int(ts["cam"]["frame_idx"][0]) == 5
    assert np.abs(got[4][0]["out"].numpy() - got[0][0]["out"].numpy()).max() > 0.05


def test_mire_at_vga_on_moved_legs_equal_jax():
    """The separable chroma at the full VGA width, legs at frame indices far
    apart (the sine and cosine arguments over whole periods)."""
    from mediastreamer2_tpu.core.filter import FilterCtx as JCtx
    from mediastreamer2_tpu_torch.core.filter import FilterCtx
    idx = np.array([0, 37, 1000], np.int32)
    jst, tst = {"frame_idx": jnp.asarray(idx)}, {"frame_idx": torch.from_numpy(idx)}
    jc = JCtx(3, (), {"fmt": JFormat(kind="yuv420", width=640, height=480)})
    tc = FilterCtx(3, (), {"fmt": Format(kind="yuv420", width=640, height=480)})
    for _ in range(2):
        jst, (jf,), _ = jv._mire_process(jst, (), {}, jc)
        tst, (tf,), _ = tv._mire_process(tst, (), {}, tc)
        _close(tf, jf)


def test_pixconv_sizeconv_transform_analyse_equal_jax():
    """mire -> pix_conv rgb -> size_conv (rgb) -> pix_conv yuv420 ->
    video_transform (90, mirror) -> tee -> size_conv (yuv) -> out, and
    analyse_display on the yuv and on the rgb branch (frame_mean)."""
    def build(g, Fmt):
        m = g.add("mire", "cam", fmt=Fmt(kind="yuv420", width=64, height=48, fps=25.0))
        rgb = g.add("pix_conv", "to_rgb", to="rgb")
        t1 = g.add("tee", "t1")
        small = g.add("size_conv", "small_rgb", out_w=32, out_h=24)
        yuv = g.add("pix_conv", "to_yuv", to="yuv420")
        rot = g.add("video_transform", "rot", degrees=90, mirror=True)
        t2 = g.add("tee", "t2")
        sc = g.add("size_conv", "sc", out_w=16, out_h=20)
        g.chain(m, rgb, t1)
        g.link(t1, 0, small, 0)
        g.chain(small, yuv, rot, t2)
        g.link(t2, 0, sc, 0)
        g.link(sc, 0, g.add("ext_sink", "out"), 0)
        g.link(t2, 1, g.add("ext_sink", "rot_out"), 0)
        g.link(t2, 2, g.add("analyse_display", "ana_yuv"), 0)
        g.link(t1, 1, g.add("analyse_display", "ana_rgb"), 0)
        g.link(t1, 2, g.add("ext_sink", "rgb_out"), 0)
    got, _, _ = _run_both(build, 3)
    for tout, jout, tev, jev in got:
        for k in ("out", "rot_out", "rgb_out"):
            _close(tout[k], jout[k])
        assert tuple(tout["rot_out"].shape) == (3, 32 * 3 // 2, 24)
        for k in ("ana_yuv.frame_mean", "ana_rgb.frame_mean"):
            _close(tev[k], jev[k])
            assert 0.0 < float(tev[k][0]) < 1.0


def test_ticker_step_fn_and_warmup_ext():
    """``step_fn`` replaces ``graph.step`` and gets the inputs uncast (u8
    here); ``warmup_ext`` is what ``warm_up`` feeds, and the warm-up leaves
    the state as it was."""
    g = GraphBuilder(Factory(), batch=2)
    fmt = Format(kind="yuv420", width=8, height=6)
    g.chain(g.add("ext_source", "rx", fmt=fmt), g.add("analyse_display", "ana"))
    g.link(g.add("mire", "cam", fmt=fmt), 0, g.add("ext_sink", "tx"), 0)
    cg = g.build()
    seen = []

    def step_fn(state, params, ext):
        seen.append(ext["rx"].dtype)
        ext = {"rx": ext["rx"].to(torch.float32) / 255.0}
        return cg.step(state, params, ext)
    tk = Ticker(cg, device="cpu", realtime=False, step_fn=step_fn)
    tk.warmup_ext = {"rx": np.full((2, 9, 8), 51, np.uint8)}
    tk.warm_up()
    assert seen == [torch.uint8] and int(tk.state["cam"]["frame_idx"][0]) == 0
    means = []
    tk.event_queue.set_handler("ana.frame_mean", lambda ev: means.append(ev.value))
    tk.set_io(pull=lambda t: {"rx": np.full((2, 9, 8), 102, np.uint8)})
    tk.do_tick()
    tk.event_queue.pump()
    assert seen == [torch.uint8] * 2 and int(tk.state["cam"]["frame_idx"][0]) == 1
    assert means == pytest.approx([0.4, 0.4])
    # without a step_fn the inputs are cast to the graph's block dtypes
    plain = Ticker(cg, device="cpu", realtime=False)
    plain.set_io(pull=lambda t: {"rx": np.full((2, 9, 8), 0.25, np.float64)})
    plain.do_tick()
    assert plain.warmup_ext is None


def test_stream_regulator_equal_jax():
    regs = StreamRegulator(clock_rate=90000), JStreamRegulator(clock_rate=90000)
    for reg in regs:
        for k in range(5):
            reg.push(k * 3000, f"f{k}")                  # 30 fps timestamps
    for now in (0.0, 0.034, 0.100, 0.200, 0.3):
        got, want = (r.pop_due(now) for r in regs)
        assert got == want
    assert regs[0].pop_due(0.3) == []
    regs[0].push(0, "g")
    regs[0].reset()
    assert regs[0].pop_due(1.0) == []
    r = StreamRegulator(clock_rate=1000)
    for k in range(3):
        r.push(100 + 40 * k, k)
    assert r.pop_due(5.0) == [0] and r.pop_due(5.039) == [] and r.pop_due(5.08) == [1, 2]
