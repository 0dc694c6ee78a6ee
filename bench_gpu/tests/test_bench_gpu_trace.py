"""The metric arithmetic on a recorded profile: a small Chrome trace with
known durations, reduced by ``trace.Trace`` and read by the per-layer
readers."""
import json
import types

import pytest
import torch

from bench_gpu import costs, files, harness
from bench_gpu.reference import graphs
from bench_gpu.trace import Trace, kernel_base, kind

CFG = {"system": "flagship", "rate": 48000, "mix_rate": 16000, "conf_size": 4,
       "tail_ms": 80, "env": {}}
LEGS = 1024


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.fixture
def recorded(tmp_path):
    """Two ticks: host spans at 0 and 100 us, each launching (at +1 to +4
    us) a cuBLAS product, a PyTorch kernel, mdf_apply and a copy, which run
    from +10 to +60 us; the device idles from 60 to 110 us while the host
    is in ``aten::mm``, and from 0 to 10 us inside the first tick's span."""
    ev = []
    for k, base in enumerate((0.0, 100.0)):
        ev.append(_x("bench.tick", "user_annotation", base, 90.0))
        ev.append(_x("aten::mm", "cpu_op", base + 50.0, 45.0))
        for j in range(4):
            ev.append(_x("cudaLaunchKernel", "cuda_runtime", base + 1.0 + j, 0.5, 10 * k + j))
        ev.append(_x("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>(x)",
                     "kernel", base + 10.0, 20.0, 10 * k))
        ev.append(_x("void at::native::vectorized_elementwise_kernel<4, add>(int)", "kernel",
                     base + 30.0, 10.0, 10 * k + 1))
        ev.append(_x("void mdf_apply_kernel<__nv_bfloat16>(a, b)", "kernel", base + 40.0, 15.0,
                     10 * k + 2))
        ev.append(_x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", base + 55.0, 5.0, 10 * k + 3))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace.from_chrome(path, 2)


def _ctx(tr, **kw):
    return types.SimpleNamespace(cfg=CFG, legs=LEGS, trace=tr, probes={}, **kw)


def _read(name, ctx):
    return files.by_name("metrics", name, "per-layer metric").read(ctx)


def test_window_busy_and_gaps(recorded):
    assert recorded.window_us() == (0.0, 160.0)
    assert recorded.busy_s() == pytest.approx(2 * 50e-6)
    assert recorded.window_s() == pytest.approx(160e-6)
    gaps = recorded.idle_gaps()
    assert gaps[0] == ["bench.tick/aten::mm", pytest.approx(50e-6)]   # 60 -> 110 us
    assert sum(s for _, s in gaps) == pytest.approx(60e-6)


def test_kinds_and_per_tick_readers(recorded):
    assert kernel_base("void at::native::foo<4>(int)") == "at::native::foo"
    assert kind("void at::native::(anonymous namespace)::cat<2>(x)") == "pytorch"
    assert kind("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x32x8") == "cublas"
    # a kernel the program does not have today is hand-written too
    assert kind("void fused_resample_kernel<4>(float const*)") == "hand"
    assert recorded.kernel_us("cublas") == 40.0
    assert recorded.kernel_us("pytorch") == 20.0
    assert recorded.kernel_us("hand") == 30.0
    ctx = _ctx(recorded)
    assert _read("gemm_ms_per_tick", ctx) == pytest.approx(0.020)
    assert _read("pointwise_ms_per_tick", ctx) == pytest.approx(0.010)
    assert _read("hand_kernels_ms_per_tick", ctx) == pytest.approx(0.015)
    assert _read("launches_per_tick", ctx) == 3.0
    assert _read("device_idle_pct.unpaced", ctx) == pytest.approx(100 * (1 - 100 / 160))
    # the ticks' spans are [0, 60] and [100, 160]: 20 of their 120 us idle
    assert recorded.tick_spans() == [(0.0, 60.0), (100.0, 160.0)]
    assert _read("device_idle_pct.paced", ctx) == pytest.approx(100 * 20 / 120)


def test_a_trace_without_correlations_reads_no_tick_idle(tmp_path):
    ev = [_x("bench.tick", "user_annotation", 0.0, 10.0),
          _x("void at::native::k(x)", "kernel", 1.0, 5.0)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = Trace.from_chrome(path, 1)
    assert tr.tick_spans() == [] and _read("device_idle_pct.paced", _ctx(tr)) is None
    assert _read("hand_kernels_ms_per_tick", _ctx(tr)) is None


def test_kernel_shares(recorded):
    P, F, ws = graphs.aec_shape(CFG)
    want = 100 * costs.mdf_apply_cost(LEGS, P, F, ws) / costs.HBM_BYTES_PER_S / 15e-6
    assert _read("mdf_apply_pct", _ctx(recorded)) == pytest.approx(want)
    # a reader whose kernel did not run reports nothing, never 0
    assert _read("fused_volume_pct", _ctx(recorded)) is None
    assert _read("mdf_update_pct", _ctx(recorded)) is None


def test_update_fused_share_counts_the_flags(tmp_path):
    ev = [_x("bench.tick", "user_annotation", 0.0, 10.0),
          _x("void mdf_update_fused_kernel<true, __nv_bfloat16>(x)", "kernel", 1.0, 20.0)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = Trace.from_chrome(path, 1)
    flags = torch.zeros(LEGS, dtype=torch.bool)
    reseed = flags.clone()
    reseed[:100] = True
    ctx = _ctx(tr)
    ctx.probes["mdf_update_fused"] = [(flags, reseed, flags)]
    P, F, ws = graphs.aec_shape(CFG)
    nbytes = costs.mdf_update_fused_cost(LEGS, P, F, ws, 100, 0, LEGS - 100)
    want = 100 * nbytes / costs.HBM_BYTES_PER_S / 20e-6
    assert _read("mdf_update_fused_pct", ctx) == pytest.approx(want)
    # calls that the probe did not see: the metric reads nothing
    ctx.probes["mdf_update_fused"] = ctx.probes["mdf_update_fused"] * 2
    assert _read("mdf_update_fused_pct", ctx) is None


def test_step_bytes_and_host_readers():
    ctx = _ctx(None, state_bytes=1000, io_bytes=500, tick_s=1e-6, dispatch_ms=4.5)
    assert _read("step_bytes_pct", ctx) == pytest.approx(100 * 2500 / costs.HBM_BYTES_PER_S / 1e-6)
    assert _read("dispatch_ms", ctx) == 4.5


def test_percentile():
    assert harness.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == pytest.approx(4.8)
    assert harness.percentile(list(range(101)), 95) == 95
