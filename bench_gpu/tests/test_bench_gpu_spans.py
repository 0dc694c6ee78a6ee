"""The span readers on a recorded profile: a small Chrome trace with the
program's nested ``ms2.*`` spans, launches and device rows of known
durations, joined by ``spans`` and read by the four readers that use it."""
import json

import pytest

from bench_gpu import files, spans
from bench_gpu.trace import Trace


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _ticks(base_times=(0.0, 200.0)):
    """Two ticks. In each (times from its start, us): ``bench.tick`` 0-150,
    ``ms2.step`` 5-100 holding ``ms2.node/ec`` 10-70 (``ms2.aec/update``
    30-40, ``ms2.aec/suppress`` 50-70) and ``ms2.node/conf`` 75-95; a
    read-back copy launched at 120 outside the step. Launches and their
    device rows (start-end on the device):

    * 12: a kernel, 20-30, in ec outside any stage (10 us)
    * 32: ``mdf_update_fused``, 35-45, in update (10 us)
    * 34: a memset, 45-47, in update (2 us)
    * 55: a product, 50-80, in suppress (30 us)
    * 60: an event record, no device work
    * 80: a kernel, 90-94, in conf (4 us)
    * 120: the read-back copy, 140-146
    """
    ev = []
    for k, base in enumerate(base_times):
        c = 100 * k
        ev += [_x("bench.tick", "user_annotation", base, 150.0),
               _x("ms2.step", "user_annotation", base + 5, 95.0),
               _x("ms2.node/ec", "user_annotation", base + 10, 60.0),
               _x("ms2.aec/update", "user_annotation", base + 30, 10.0),
               _x("ms2.aec/suppress", "user_annotation", base + 50, 20.0),
               _x("ms2.node/conf", "user_annotation", base + 75, 20.0)]
        for t, corr in ((12, 1), (32, 2), (34, 3), (55, 4), (60, 5), (80, 6), (120, 7)):
            ev.append(_x("cudaLaunchKernel", "cuda_runtime", base + t, 0.5, c + corr))
        ev += [_x("void at::native::k(x)", "kernel", base + 20, 10.0, c + 1),
               _x("void mdf_update_fused_kernel<true>(x)", "kernel", base + 35, 10.0, c + 2),
               _x("Memset (Device)", "gpu_memset", base + 45, 2.0, c + 3),
               _x("sm80_xmma_gemm_f32f32", "kernel", base + 50, 30.0, c + 4),
               _x("void at::native::m(x)", "kernel", base + 90, 4.0, c + 6),
               _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", base + 140, 6.0, c + 7)]
    return ev


def _trace(tmp_path, ev, ticks=2):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace.from_chrome(path, ticks)


class Ctx:
    def __init__(self, trace):
        self.trace = trace


def _read(name, trace):
    return files.by_name("metrics", name, "per-layer metric").read(Ctx(trace))


def test_readers_read_the_known_numbers(tmp_path):
    tr = _trace(tmp_path, _ticks())
    assert spans.device_us_in(tr, "ms2.step") == pytest.approx(2 * 56.0)
    assert _read("ec_ms_per_tick", tr) == pytest.approx(0.052)
    assert _read("aec_update_ms_per_tick", tr) == pytest.approx(0.012)
    assert _read("aec_suppress_ms_per_tick", tr) == pytest.approx(0.030)
    # each tick's span is 0-146; the device idles 0-20, 30-35, 47-50, 80-90
    # and 94-140 of it (84 us), the host in the step over 5-100 (39 us of it)
    assert tr.tick_spans() == [(0.0, 146.0), (200.0, 346.0)]
    assert _read("step_idle_pct.paced", tr) == pytest.approx(100 * 39 / 146)
    assert _read("device_idle_pct.paced", tr) == pytest.approx(100 * 84 / 146)


def test_a_launch_that_matches_no_row_or_two_reads_nothing(tmp_path):
    ev = _ticks()
    # a second row that ends with the update kernel: the launch matches two
    ev.append(_x("void at::native::other(x)", "kernel", 41.0, 4.0))
    tr = _trace(tmp_path, ev)
    assert _read("aec_update_ms_per_tick", tr) is None
    assert _read("ec_ms_per_tick", tr) is None
    # the suppress stage's launches each match one row
    assert _read("aec_suppress_ms_per_tick", tr) == pytest.approx(0.030)
    tr = _trace(tmp_path, _ticks())
    tr.device_end[4] = 81.0        # no row ends there
    assert _read("aec_suppress_ms_per_tick", tr) is None
    assert _read("aec_update_ms_per_tick", tr) == pytest.approx(0.012)


def test_a_trace_without_the_programs_spans_reads_nothing(tmp_path):
    ev = [e for e in _ticks() if not e["name"].startswith("ms2.")]
    tr = _trace(tmp_path, ev)
    for name in ("ec_ms_per_tick", "aec_update_ms_per_tick", "aec_suppress_ms_per_tick",
                 "step_idle_pct.paced"):
        assert _read(name, tr) is None, name
    assert _read("device_idle_pct.paced", tr) == pytest.approx(100 * 84 / 146)


def test_union_and_overlap():
    assert spans.union([(5, 7), (0, 2), (1, 3)]) == [[0, 3], [5, 7]]
    assert spans.overlap_us([[0, 3], [5, 7]], [[2, 6]]) == 2.0
    assert spans.overlap_us([[0, 1]], [[1, 2]]) == 0.0
