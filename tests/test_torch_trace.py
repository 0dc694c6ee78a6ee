"""The port's profiler spans (``core/trace.py``) on the CPU: the graph step,
each node, the echo canceller's five stages and the e2e program's codec
ends nest as documented and cover the work; the ticker's and the e2e
loop's phases appear; with no profiler recording no span is made; a
profiled tick computes the same bits; ``profile_nodes`` reads the node
spans."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each, so that parallel test workers running
# real-time paced tests are not crowded by idle OpenMP threads
torch.set_num_threads(1)

from torch.profiler import (ProfilerActivity, _ExperimentalConfig, profile,  # noqa: E402
                            record_function)

from mediastreamer2_tpu_torch import Factory, build_flagship  # noqa: E402
from mediastreamer2_tpu_torch.core.graph import clone_tree  # noqa: E402
from mediastreamer2_tpu_torch.core.ticker import Ticker  # noqa: E402
from mediastreamer2_tpu_torch.models import e2e_bench  # noqa: E402

B, TICKS = 8, 3
STAGES = tuple(f"ms2.aec/{s}" for s in ("analysis", "apply", "adapt", "update", "suppress"))
NODES = {"flagship": ("ec", "agc", "rs", "conf"),
         "e2e": ("up", "ec", "agc", "rs", "conf", "dn")}
EPS = 0.01          # us: the Chrome trace rounds times to ns


class Rig:
    """One of the two device programs the benchmark drives, at B legs on the
    CPU, with seeded inputs."""

    def __init__(self, kind):
        self.kind = kind
        rng = np.random.default_rng(3)
        if kind == "flagship":
            self.cg, self.params = build_flagship(Factory(), B, "cpu")
            self.ins = [{"mic": torch.from_numpy(rng.normal(0, 0.1, (B, 480)).astype(np.float32)),
                         "spk_ref": torch.from_numpy(
                             rng.normal(0, 0.1, (B, 480)).astype(np.float32))}
                        for _ in range(TICKS + 2)]
        else:
            self.cg, self.params = e2e_bench.build_e2e_graph(Factory(), B, "cpu")
            codes, mic = e2e_bench.echo_coupled_codes(B, TICKS + 2, seed=4)
            self.ins = [{"codes": torch.from_numpy(np.ascontiguousarray(codes[:, t * 80:(t + 1) * 80])),
                         "mic": torch.from_numpy(np.ascontiguousarray(mic[:, t * 480:(t + 1) * 480]))}
                        for t in range(TICKS + 2)]
        self.state = self.cg.init_state("cpu")

    def tick(self, t):
        ins = self.ins[t]
        if self.kind == "flagship":
            self.state, out, _ = self.cg.step(self.state, self.params, ins)
            return (out["out"],)
        self.state, tx, _, out = e2e_bench.e2e_tick(self.cg, self.state, self.params,
                                                    ins["codes"], ins["mic"])
        return tx, out


def _events(prof, tmp_path):
    """(user annotations, aten ops) of a profile: (name, start, end) each,
    from its Chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans, ops = [], []
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") != "X":
            continue
        row = (e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        if e.get("cat") == "user_annotation":
            spans.append(row)
        elif e.get("cat") == "cpu_op" and e["name"].startswith("aten::"):
            ops.append(row)
    return spans, ops


def _inside(a, b):
    return b[1] - EPS <= a[1] and a[2] <= b[2] + EPS


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _parent(ev, candidates):
    found = [c for c in candidates if c is not ev and _inside(ev, c)]
    assert len(found) == 1, (ev, found)
    return found[0]


@pytest.mark.parametrize("kind,env", [("flagship", {}), ("e2e", {}), ("e2e", {"PALLAS_MDF": "1"})],
                         ids=["flagship", "e2e", "e2e-megakernel"])
def test_spans_nest_and_cover_the_tick(tmp_path, monkeypatch, kind, env):
    """A few ticks under the profiler: one ``ms2.step`` a tick, one
    ``ms2.node/<name>`` a non-ext node inside it, the echo canceller's five
    stages inside ``ms2.node/ec`` in order, every aten op of the echo
    canceller inside one stage, and (e2e) the decode and encode spans
    beside the step, so that every op of a tick lies under an ``ms2.*``
    span."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rig = Rig(kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for t in range(TICKS):
            with record_function("test.tick"):
                rig.tick(t)
    spans, ops = _events(prof, tmp_path)
    ticks = _named(spans, "test.tick")
    steps = _named(spans, "ms2.step")
    assert len(ticks) == len(steps) == TICKS
    assert all(_parent(s, ticks) for s in steps)
    nodes = [s for s in spans if s[0].startswith("ms2.node/")]
    assert sorted({s[0] for s in nodes}) == sorted(f"ms2.node/{n}" for n in NODES[kind])
    assert len(nodes) == TICKS * len(NODES[kind])
    assert all(_parent(n, steps) for n in nodes)
    ecs = _named(spans, "ms2.node/ec")
    for ec in ecs:
        stages = sorted((s for s in spans if s[0].startswith("ms2.aec/") and _inside(s, ec)),
                        key=lambda s: s[1])
        assert tuple(s[0] for s in stages) == STAGES
        for a, b in zip(stages, stages[1:]):
            assert a[2] <= b[1] + EPS
        in_ec = [o for o in ops if _inside(o, ec)]
        assert in_ec and all(any(_inside(o, s) for s in stages) for o in in_ec)
    ends = [s for s in spans if s[0] in ("ms2.e2e/decode", "ms2.e2e/encode")]
    if kind == "e2e":
        assert len(ends) == 2 * TICKS
        assert all(_parent(s, ticks) and not any(_inside(s, st) for st in steps) for s in ends)
    else:
        assert ends == []
    # every operator of a tick runs under some ms2.* span
    ours = [s for s in spans if s[0].startswith("ms2.")]
    for o in ops:
        if any(_inside(o, t) for t in ticks):
            assert any(_inside(o, s) for s in ours), o


def test_no_span_is_made_while_no_profiler_records(monkeypatch):
    """Without a profiler, the graph step, the e2e tick and a ticker's tick
    never reach ``record_function``."""
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for kind in ("flagship", "e2e"):
        rig = Rig(kind)
        for t in range(2):
            rig.tick(t)
    rig = Rig("flagship")
    tk = Ticker(rig.cg, "cpu", realtime=False, pipeline_depth=1)
    tk.params = rig.params
    tk.run(3)
    tk.drain()
    assert tk.stats.ticks == 3


@pytest.mark.parametrize("kind,env", [("flagship", {}), ("e2e", {"PALLAS_MDF": "1"})],
                         ids=["flagship", "e2e-megakernel"])
def test_profiled_ticks_compute_the_same_bits(monkeypatch, kind, env):
    """Outputs and state after a few ticks are bit-equal with the profiler
    recording and without."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    plain, traced = Rig(kind), Rig(kind)
    outs_plain = [plain.tick(t) for t in range(TICKS + 2)]
    with profile(activities=[ProfilerActivity.CPU]):
        outs_traced = [traced.tick(t) for t in range(TICKS + 2)]
    for a, b in zip(outs_plain, outs_traced):
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    def flat(tree, key=""):
        if isinstance(tree, dict):
            return {k2: v for k, sub in tree.items() for k2, v in flat(sub, f"{key}/{k}").items()}
        return {key: tree}
    sp, st = flat(plain.state), flat(traced.state)
    assert sp.keys() == st.keys()
    for k in sp:
        assert torch.equal(sp[k], st[k]), k


def test_ticker_phases_are_spans(tmp_path):
    """A pipelined ticker's tick under the profiler: queue, pull, dispatch
    (holding the graph step) and publish, one each a tick once the pipe is
    full."""
    rig = Rig("flagship")
    tk = Ticker(rig.cg, "cpu", realtime=False, pipeline_depth=1)
    tk.params = rig.params
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tk.run(4)
    tk.drain()
    spans, _ = _events(prof, tmp_path)
    for phase in ("queue", "pull", "dispatch"):
        assert len(_named(spans, f"ms2.ticker/{phase}")) == 4, phase
    assert len(_named(spans, "ms2.ticker/publish")) == 3
    dispatches = _named(spans, "ms2.ticker/dispatch")
    assert all(_parent(s, dispatches) for s in _named(spans, "ms2.step"))


def test_e2e_run_phases_are_spans(tmp_path):
    """The e2e bench's loop over localhost UDP, unpaced, under the profiler
    (every thread's operators recorded): its four host phases a tick, and
    the graph step on the uploader thread."""
    b = e2e_bench.E2EConferenceBench(Factory(), n_legs=8, device="cpu")
    n = e2e_bench.WARMUP_TICKS + 3
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            res = b.run(n_ticks=n, paced=False)
    finally:
        b.close()
    assert res.out_finite
    spans, _ = _events(prof, tmp_path)
    for phase in ("edge_tx", "edge_rx", "submit"):
        assert len(_named(spans, f"ms2.e2e/{phase}")) == n, phase
    assert len(_named(spans, "ms2.e2e/pop")) == n - e2e_bench.DEPTH
    # the warm tick on this thread, then every tick on the uploader's
    assert len(_named(spans, "ms2.step")) == n + 1


def test_profile_nodes_reads_the_node_spans():
    """``profile_nodes`` on the flagship graph: a time for every non-ext
    node, each above zero, and the state passed in left as it was."""
    rig = Rig("flagship")
    for t in range(2):
        rig.tick(t)
    before = clone_tree(rig.state)
    times = rig.cg.profile_nodes(rig.state, rig.params, rig.ins[2], iters=2)
    assert list(times) == [n for n in (rig.cg.nodes[i].name for i in rig.cg.order)
                           if n in NODES["flagship"]]
    assert all(v > 0 for v in times.values())
    for node, entry in before.items():
        for k, v in entry.items():
            assert torch.equal(v, rig.state[node][k]), (node, k)
