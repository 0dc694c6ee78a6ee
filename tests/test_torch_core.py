"""The port's core runtime and stateless filters against the JAX package
on the CPU, and a check that the port never imports jax."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each, so that parallel test workers running
# real-time paced tests are not crowded by idle OpenMP threads
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mediastreamer2_tpu.core.block import Format as JFormat  # noqa: E402
from mediastreamer2_tpu.core.graph import GraphBuilder as JGraphBuilder  # noqa: E402
from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tfactory():
    return Factory()


def _single(gb_cls, factory, fmt, filt, B, **kw):
    g = gb_cls(factory, batch=B)
    src = g.add("ext_source", "in", fmt=fmt)
    node = g.add(filt, "f", **kw)
    g.chain(src, node, g.add("ext_sink", "out"))
    return g.build()


def _run_both(factory, tfactory, filt, rate, channels, B, ticks, seed, params=None, **kw):
    """Step one filter for `ticks` ticks in both packages on the same
    inputs; returns (jax outputs, port outputs), each [ticks, B, n]."""
    jcg = _single(JGraphBuilder, factory, JFormat(rate=rate, channels=channels), filt, B, **kw)
    tcg = _single(GraphBuilder, tfactory, Format(rate=rate, channels=channels), filt, B, **kw)
    jst, jpr = jcg.init_state(), jcg.init_params()
    tst, tpr = tcg.init_state("cpu"), tcg.init_params("cpu")
    for k, v in (params or {}).items():
        jpr["f"][k] = jnp.asarray(v)
        tpr["f"][k] = torch.from_numpy(v)
    n = rate // 100 * channels
    xs = np.random.default_rng(seed).uniform(-0.6, 0.6, (ticks, B, n)).astype(np.float32)
    jo, to = [], []
    for x in xs:
        jst, o, _ = jcg.step(jst, jpr, {"in": x})
        jo.append(np.asarray(o["out"]))
        tst, o, _ = tcg.step(tst, tpr, {"in": torch.from_numpy(x)})
        to.append(o["out"].numpy())
    return np.stack(jo), np.stack(to)


def test_unlinked_pin_rejected(tfactory):
    g = GraphBuilder(tfactory, batch=1)
    g.add("volume", "v")
    with pytest.raises(ValueError, match="unlinked"):
        g.build()


def test_cycle_rejected(tfactory):
    g = GraphBuilder(tfactory, batch=1)
    v = g.add("volume", "v")
    m = g.add("conf_mixer", "m")
    g.link(v, 0, m, 0)
    g.link(m, 0, v, 0)
    with pytest.raises(ValueError, match="cycle"):
        g.build()


def test_rate_mismatch_rejected(tfactory):
    g = GraphBuilder(tfactory, batch=1)
    near = g.add("ext_source", "near", fmt=Format(rate=48000))
    far = g.add("ext_source", "far", fmt=Format(rate=16000))
    ec = g.add("echo_canceller", "ec")
    g.link(near, 0, ec, 0)
    g.link(far, 0, ec, 1)
    with pytest.raises(ValueError, match="input rates disagree"):
        g.build()


def test_link_validation_and_run_scan(tfactory):
    B, K = 3, 4
    g = GraphBuilder(tfactory, batch=B)
    src = g.add("ext_source", "in", fmt=Format(rate=8000))
    sink = g.add("ext_sink", "out")
    g.link(src, 0, sink, 0)
    with pytest.raises(ValueError):
        g.link(src, 0, sink, 0)          # double-link
    with pytest.raises(ValueError):
        g.link(src, 5, sink, 0)          # bad pin
    cg = g.build()
    assert "ext_sink" in cg.describe()
    xs = torch.arange(K * B * 80, dtype=torch.float32).reshape(K, B, 80)
    _, outs, _ = cg.run_scan(cg.init_state("cpu"), cg.init_params("cpu"), {"in": xs})
    assert torch.equal(outs["out"], xs)
    with pytest.raises(ValueError, match="input shape"):
        cg.step({}, {}, {"in": torch.zeros((B, 81))})


def test_filter_def_decorator_registers_a_filter():
    from mediastreamer2_tpu_torch.core.filter import filter_def

    @filter_def("test_torch_double", 1, 1, interfaces=("gain",))
    def _double(state, ins, params, ctx):
        return state, (2 * ins[0],), {"peak": ins[0].abs().amax(dim=1)}

    f = Factory()
    assert f.lookup("test_torch_double").implements("gain")
    g = GraphBuilder(f, batch=2)
    g.chain(g.add("ext_source", "in", fmt=Format(rate=8000)),
            g.add("test_torch_double", "d"), g.add("ext_sink", "out"))
    x = torch.full((2, 80), 0.25)
    _, out, ev = g.build().step({}, {}, {"in": x})
    assert torch.equal(out["out"], 2 * x)
    assert torch.equal(ev["d.peak"], torch.full((2,), 0.25))


def test_factory_enable_disable():
    f = Factory()
    assert f.has("echo_canceller")
    f.enable_filter("echo_canceller", False)
    with pytest.raises(KeyError, match="disabled"):
        f.lookup("echo_canceller")
    f.enable_filter("echo_canceller")
    assert f.lookup("echo_canceller").name == "echo_canceller"


def test_registry(tfactory):
    assert tfactory.has("tee")
    assert tfactory.find_encoder("ulaw").name == "ulaw_enc"
    assert tfactory.find_decoder("alaw").name == "alaw_dec"
    assert tfactory.find_encoder("G722").name == "g722_enc"        # mime case ignored
    assert tfactory.find_decoder("opus") is None
    encs = tfactory.filters_implementing("audio_encoder")
    assert any(f.name == "ulaw_enc" for f in encs)


def test_registry_matches_jax(factory, tfactory):
    """Every filter both registries hold declares the same category,
    interfaces and codec format, and every codec lookup finds the same
    filter (the JAX registry is the reference)."""
    jf, tf = factory.filters(), tfactory.filters()
    assert set(tf) == set(jf)
    for name in jf:
        assert ((tf[name].category, tf[name].interfaces, tf[name].enc_fmt)
                == (jf[name].category, jf[name].interfaces, jf[name].enc_fmt)), name
    fmts = {f.enc_fmt for f in jf.values() if f.enc_fmt}
    assert {"ulaw", "alaw", "l16", "g722", "dvi4", "g726_32"} <= fmts
    for fmt in fmts:
        assert tfactory.find_encoder(fmt).name == factory.find_encoder(fmt).name
        assert tfactory.find_decoder(fmt).name == factory.find_decoder(fmt).name
    for iface in {i for f in jf.values() for i in f.interfaces}:
        assert (sorted(f.name for f in tfactory.filters_implementing(iface))
                == sorted(f.name for f in factory.filters_implementing(iface)))


def test_factory_filter_enable_disable():
    """The JAX ``test_core.py`` case: a disabled filter is neither found
    nor looked up, and codec lookup skips it."""
    f = Factory()
    assert f.filter_enabled("ulaw_enc")
    f.enable_filter("ulaw_enc", False)
    assert not f.filter_enabled("ulaw_enc") and not f.has("ulaw_enc")
    assert f.find_encoder("ulaw") is None
    assert "ulaw_enc" not in f.filters()
    with pytest.raises(KeyError):
        f.lookup("ulaw_enc")
    f.enable_filter("ulaw_enc", True)
    assert f.has("ulaw_enc") and f.find_encoder("ulaw") is not None
    with pytest.raises(KeyError):
        f.enable_filter("nonexistent")
    f.enable_statistics()
    assert f.statistics_enabled


def test_load_plugin(tmp_path, monkeypatch):
    """``load_plugin`` imports a module and calls its
    ``ms_plugin_init(factory)``, which registers a filter in that factory
    only; a module without it raises."""
    (tmp_path / "ms2_torch_test_plugin.py").write_text(
        "from mediastreamer2_tpu_torch.core.filter import FilterDef\n"
        "def ms_plugin_init(factory):\n"
        "    factory.register(FilterDef(\n"
        "        name='plugin_negate', ninputs=1, noutputs=1,\n"
        "        out_formats=lambda ctx: (ctx.in_formats[0],),\n"
        "        process=lambda st, ins, p, ctx: (st, (-ins[0],), {}),\n"
        "        category='other', interfaces=('negate',)))\n")
    (tmp_path / "ms2_torch_not_a_plugin.py").write_text("X = 1\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    f = Factory()
    f.load_plugin("ms2_torch_test_plugin")
    assert f.plugins == ["ms2_torch_test_plugin"]
    assert [d.name for d in f.filters_implementing("negate")] == ["plugin_negate"]
    assert not Factory().has("plugin_negate")
    g = GraphBuilder(f, batch=2)
    g.chain(g.add("ext_source", "in", fmt=Format(rate=8000)), g.add("plugin_negate", "n"),
            g.add("ext_sink", "out"))
    x = torch.full((2, 80), 0.5)
    assert torch.equal(g.build().step({}, {}, {"in": x})[1]["out"], -x)
    with pytest.raises(ImportError, match="ms_plugin_init"):
        f.load_plugin("ms2_torch_not_a_plugin")


def test_profile_nodes_reports_per_node_times(factory, tfactory):
    """The JAX ``test_core.py`` case on the port: a time for every node but
    the ext ones (the same nodes as the JAX package reports), and the
    state passed in is left as it was (a stateful codec's too)."""
    S = 80

    def build(gb_cls, f, fmt):
        g = gb_cls(f, batch=4)
        src = g.add("ext_source", "in", fmt=fmt(rate=8000))
        g.chain(src, g.add("ulaw_enc", "enc"), g.add("ulaw_dec", "dec"),
                g.add("audio_levels", "levels"), g.add("dvi4_enc", "denc"),
                g.add("ext_sink", "out"))
        return g.build()
    tcg = build(GraphBuilder, tfactory, Format)
    st = tcg.init_state("cpu")
    before = {k: {n: v.clone() for n, v in e.items()} for k, e in st.items()}
    x = torch.from_numpy(np.random.default_rng(1).uniform(-0.5, 0.5, (4, S)).astype(np.float32))
    times = tcg.profile_nodes(st, tcg.init_params("cpu"), ext_in={"in": x}, iters=3)
    jcg = build(JGraphBuilder, factory, JFormat)
    jtimes = jcg.profile_nodes(jcg.init_state(), jcg.init_params(),
                               ext_in={"in": np.zeros((4, S), np.float32)}, iters=3)
    assert set(times) == set(jtimes) == {"enc", "dec", "denc", "levels"}
    assert all(v >= 0 for v in times.values())
    for k, e in st.items():
        for n, v in e.items():
            assert torch.equal(v, before[k][n]), (k, n)


@pytest.mark.parametrize("rate_in,rate_out,channels", [
    (48000, 16000, 1), (8000, 48000, 1), (44100, 48000, 1), (16000, 8000, 2)])
def test_resample_matches_jax(factory, tfactory, rate_in, rate_out, channels):
    want, got = _run_both(factory, tfactory, "resample", rate_in, channels, B=4,
                          ticks=4, seed=rate_in, out_rate=rate_out)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("in_ch,out_ch", [(2, 1), (1, 2), (2, 3)])
def test_channel_adapter_matches_jax(factory, tfactory, in_ch, out_ch):
    want, got = _run_both(factory, tfactory, "channel_adapter", 8000, in_ch, B=3,
                          ticks=1, seed=in_ch, out_channels=out_ch)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("uniform", [True, False])
def test_conf_mixer_matches_jax(factory, tfactory, uniform):
    B, k = 8, 4
    rng = np.random.default_rng(5)
    params = {"gain": rng.uniform(0.5, 1.5, B).astype(np.float32),
              "active": rng.uniform(size=B) < 0.8,
              "mix_minus": rng.uniform(size=B) < 0.8,
              "out_gain": rng.uniform(0.5, 2.0, B).astype(np.float32)}
    if uniform:
        params["group_id"] = (np.arange(B) // k).astype(np.int32)
        kw = {"uniform_group_size": k}
    else:                              # unsorted, uneven groups
        params["group_id"] = np.array([2, 0, 2, 5, 0, 2, 7, 5], np.int32)
        kw = {}
    want, got = _run_both(factory, tfactory, "conf_mixer", 8000, 1, B=B, ticks=2,
                          seed=9, params=params, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_volume_matches_jax(factory, tfactory):
    B = 6
    rng = np.random.default_rng(8)
    params = {"agc_enabled": np.array([1, 1, 0, 0, 1, 0], bool),
              "ng_enabled": np.array([0, 1, 1, 0, 0, 0], bool),
              "dc_removal": np.array([1, 0, 1, 0, 1, 1], bool),
              "mute": np.array([0, 0, 0, 1, 0, 0], bool),
              "static_gain": rng.uniform(0.5, 2.0, B).astype(np.float32)}
    want, got = _run_both(factory, tfactory, "volume", 16000, 1, B=B, ticks=6,
                          seed=3, params=params)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cryptography'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import torch\n"
        "import mediastreamer2_tpu_torch as m\n"
        "for info in pkgutil.walk_packages(m.__path__, m.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "from mediastreamer2_tpu_torch.models.flagship import example_inputs\n"
        "cg, params = m.build_flagship(m.Factory(), 8, 'cpu')\n"
        "st = cg.init_state('cpu')\n"
        "ext = {k: torch.from_numpy(v) for k, v in example_inputs(8).items()}\n"
        "st, out, _ = cg.step(st, params, ext)\n"
        "assert out['out'].shape == (8, 160)\n"
        # the session layer, lazy imports included: a conference server and
        # echo-cancelling clients over loopback RTP, and a pipelined ticker
        # with its publish worker
        "import numpy as np\n"
        "from mediastreamer2_tpu_torch.core.ticker import Ticker\n"
        "from mediastreamer2_tpu_torch.models.audio_stream import (\n"
        "    AudioStreamBatch, AudioStreamFeatures)\n"
        "from mediastreamer2_tpu_torch.models.conference import AudioConferenceControl\n"
        "from mediastreamer2_tpu_torch.net.rtp import LoopbackPair\n"
        "ft = AudioStreamFeatures(echo_canceller=True, vad_dtx=True, dtmf=True,\n"
        "                         local_play=True)\n"
        "cl = AudioStreamBatch(m.Factory(), 2, mic_signal=np.ones(800, np.float32) / 4,\n"
        "                      features=ft, record_ticks=6, device='cpu')\n"
        "sv = AudioStreamBatch(m.Factory(), 2, conference=True, device='cpu')\n"
        "ctl = AudioConferenceControl(sv.ticker)\n"
        "for leg in range(2):\n"
        "    pair = LoopbackPair()\n"
        "    cl.set_transport(leg, pair.endpoint(0))\n"
        "    sv.set_transport(leg, pair.endpoint(1))\n"
        "    ctl.add_member(leg, 0)\n"
        "cl.enable_dtmf_receive(0, play_tone=True)\n"
        "sv.send_dtmf(0, '5')\n"
        "cl.play_announcement(np.ones(160, np.float32) / 8)\n"
        "for _ in range(6):\n"
        "    cl.ticker.do_tick()\n"
        "    sv.ticker.do_tick()\n"
        "assert cl.get_recording().shape == (2, 480)\n"
        "tk = Ticker(cl.graph, 'cpu', realtime=False, pipeline_depth=1)\n"
        "tk.async_publish = True\n"
        "tk.set_io(pull=lambda t: {'rtp_rx': np.zeros((2, 80), np.int32)})\n"
        "tk.run(3)\n"
        # call setup, its lazy libcrypto and libssl included: one ZRTP and one
        # DTLS-SRTP call over localhost UDP where OpenSSL is there
        "from mediastreamer2_tpu_torch.models.call_setup import CallSetup\n"
        "from mediastreamer2_tpu_torch.net import openssl\n"
        "for ka in ('zrtp', 'dtls') if openssl.libssl() is not None else ():\n"
        "    a = CallSetup(True, key_agreement=ka)\n"
        "    b = CallSetup(False, key_agreement=ka)\n"
        "    a.set_remote(*b.local_credentials(), [('127.0.0.1', b.sock.local_port)])\n"
        "    b.set_remote(*a.local_credentials(), [('127.0.0.1', a.sock.local_port)])\n"
        "    for _ in range(2000):\n"
        "        a.iterate(); b.iterate()\n"
        "        if a.ready and b.ready:\n"
        "            break\n"
        "    assert a.ready and b.ready and a.srtp_keys[:2] == b.srtp_keys[2:], ka\n"
        "    a.close(); b.close()\n"
        "bad = [k for k in sys.modules if k == 'mediastreamer2_tpu'\n"
        "       or k.startswith('mediastreamer2_tpu.') or k.startswith('jax.')\n"
        "       or k.startswith('cryptography.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_conf_mixer_segment_sum_scales_with_legs(factory, tfactory):
    """The segment-sum branch (no uniform groups) against the JAX mixer on
    ragged, unsorted groups with lone legs and an id outside [0, B), the
    membership changed between ticks (the port sorts the legs again) and
    changed back in place; no op of the port's step makes a [B, B]
    tensor."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Shapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    self.seen.append(tuple(t.shape))
            return out

    B, S, ticks = 12, 80, 4
    rng = np.random.default_rng(13)
    groups = [np.array([7, 2, 7, 0, 11, 2, 7, 5, 0, 7, 3, 9], np.int32),   # 3 and 9 alone
              np.array([4, 4, 1, 4, 8, -1, 6, 4, 8, 10, 1, 4], np.int32)]    # -1: no group
    params = {"gain": rng.uniform(0.5, 1.5, B).astype(np.float32),
              "active": rng.uniform(size=B) < 0.8,
              "mix_minus": rng.uniform(size=B) < 0.8,
              "out_gain": rng.uniform(0.5, 2.0, B).astype(np.float32)}
    jcg = _single(JGraphBuilder, factory, JFormat(rate=8000), "conf_mixer", B)
    tcg = _single(GraphBuilder, tfactory, Format(rate=8000), "conf_mixer", B)
    jst, jpr = jcg.init_state(), jcg.init_params()
    tst, tpr = tcg.init_state("cpu"), tcg.init_params("cpu")
    for k, v in params.items():
        jpr["f"][k] = jnp.asarray(v)
        tpr["f"][k] = torch.from_numpy(v)
    xs = rng.uniform(-0.6, 0.6, (ticks, B, S)).astype(np.float32)
    for t, x in enumerate(xs):
        gid = groups[(0, 1, 1, 0)[t]]
        jpr["f"]["group_id"] = jnp.asarray(gid)
        if t == 3:                                     # changed in place
            tpr["f"]["group_id"].copy_(torch.from_numpy(gid))
        else:
            tpr["f"]["group_id"] = torch.from_numpy(gid.copy())
        jst, jo, _ = jcg.step(jst, jpr, {"in": x})
        with Shapes() as shapes:
            tst, to, _ = tcg.step(tst, tpr, {"in": torch.from_numpy(x)})
        np.testing.assert_allclose(to["out"].numpy(), np.asarray(jo["out"]), rtol=0, atol=1e-6,
                                   err_msg=f"tick {t}")
        assert not [s for s in shapes.seen if list(s).count(B) >= 2], shapes.seen


@pytest.mark.parametrize("seed,channels", [(0, 1), (9, 2), ((5, 6), 1), (range(3, 133), 1),
                                           ((1, 2, 3), 2)])
def test_make_speechlike_matches_jax(seed, channels):
    """A seed gives the JAX signal bit for bit; a sequence of seeds (across
    the 128-seed chunks too) gives one row a seed."""
    from mediastreamer2_tpu.utils.signals import make_speechlike as jax_speech
    from mediastreamer2_tpu_torch.utils.signals import make_speechlike
    got = make_speechlike(1001, 16000, seed=seed, channels=channels)
    if isinstance(seed, int):
        want = jax_speech(1001, 16000, seed=seed, channels=channels)
    else:
        want = np.stack([jax_speech(1001, 16000, seed=s, channels=channels) for s in seed])
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("n,cut,max_shift", [(1, 0, None), (7, 2, 0), (100, 3, 3),
                                             (1601, 2, None), (1601, 40, 50), (512, 0, None)])
def test_audio_diff_matches_jax(n, cut, max_shift):
    """The port's audio_diff against the JAX package's on a 1-D pair and,
    batched, on rows of the same lengths (row i against row i), silent rows
    included."""
    from mediastreamer2_tpu.utils.audiodiff import audio_diff as jax_diff
    from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff
    rng = np.random.default_rng(n + cut)
    ref = rng.standard_normal((4, n))
    rec = np.roll(ref, 5, axis=1)[:, :n - cut] + 0.2 * rng.standard_normal((4, n - cut))
    rec[3] = 0.0
    want = [jax_diff(a, b, max_shift) for a, b in zip(ref, rec)]
    sim, shift = audio_diff(ref[0], rec[0], max_shift)
    assert isinstance(sim, float) and isinstance(shift, int)
    assert shift == want[0][1] and abs(sim - want[0][0]) < 1e-12
    sims, shifts = audio_diff(ref, rec, max_shift, device="cpu")
    assert shifts.tolist() == [k for _, k in want]
    np.testing.assert_allclose(sims, [s for s, _ in want], rtol=0, atol=1e-12)
