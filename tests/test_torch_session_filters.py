"""The filters of an audio stream's graph in the port against the JAX
package on the CPU: the same numpy inputs and params through one node in
each package, tick after tick. Outputs, state leaves and events agree to
1e-6; integer and boolean values bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each, so that parallel test workers running
# real-time paced tests are not crowded by idle OpenMP threads
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mediastreamer2_tpu.core.block import Format as JFormat  # noqa: E402
from mediastreamer2_tpu.core.graph import GraphBuilder as JGraphBuilder  # noqa: E402
from mediastreamer2_tpu.ops.fileio import recorder_get_audio as j_rec_audio  # noqa: E402
from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder  # noqa: E402
from mediastreamer2_tpu_torch.ops.fileio import recorder_get_audio  # noqa: E402
from mediastreamer2_tpu_torch.ops.tones import dtmf_freqs  # noqa: E402
from mediastreamer2_tpu_torch.utils import prng  # noqa: E402

RATE = 8000
S = RATE // 100
TOL = 1e-6


@pytest.fixture(scope="module")
def tfactory():
    return Factory()


def _build(gb_cls, fmt_cls, factory, filt, B, n_in, n_out, kw):
    g = gb_cls(factory, batch=B)
    if "fmt" in kw:
        kw = {**kw, "fmt": fmt_cls(rate=RATE)}
    node = g.add(filt, "f", **kw)
    for i in range(n_in):
        g.link(g.add("ext_source", f"in{i}", fmt=fmt_cls(rate=RATE)), 0, node, i)
    for i in range(n_out):
        g.link(node, i, g.add("ext_sink", f"out{i}"), 0)
    return g.build()


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if jnp.issubdtype(v.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(v))
    return np.asarray(v)


def _same(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def run_both(factory, tfactory, filt, B, ticks, n_in=1, n_out=1, seed=0, inputs=None,
             params=None, **kw):
    """Tick node ``f`` (filter ``filt``) in both packages and compare every
    output, event and state leaf after every tick. ``inputs(t)`` gives the
    [n_in, B, S] block of tick t (default: uniform noise); ``params(t)``
    a dict of numpy params set before tick t. Returns the port's final
    state and its outputs [ticks, n_out, B, S]."""
    rng = np.random.default_rng(seed)
    if inputs is None:
        xs = rng.uniform(-0.6, 0.6, (ticks, n_in, B, S)).astype(np.float32)
        inputs = xs.__getitem__
    jcg = _build(JGraphBuilder, JFormat, factory, filt, B, n_in, n_out, kw)
    tcg = _build(GraphBuilder, Format, tfactory, filt, B, n_in, n_out, kw)
    jst, jpr = jcg.init_state(), jcg.init_params()
    tst, tpr = tcg.init_state("cpu"), tcg.init_params("cpu")
    outs = []
    for t in range(ticks):
        for k, v in (params(t) if params else {}).items():
            jpr["f"][k] = jnp.asarray(v)
            tpr["f"][k] = torch.from_numpy(np.asarray(v))
        x = inputs(t)
        jst, jo, jev = jcg.step(jst, jpr, {f"in{i}": x[i] for i in range(n_in)})
        tst, to, tev = tcg.step(tst, tpr, {f"in{i}": torch.from_numpy(x[i])
                                           for i in range(n_in)})
        for k in jo:
            _same(to[k], jo[k], f"{filt} tick {t} {k}")
        assert set(tev) == set(jev)
        for k in jev:
            _same(tev[k], jev[k], f"{filt} tick {t} event {k}")
        assert set(tst.get("f") or {}) == set(jst.get("f") or {})
        for k, v in (jst.get("f") or {}).items():
            _same(tst["f"][k], v, f"{filt} tick {t} state {k}")
        outs.append([to[f"out{i}"].numpy() for i in range(n_out)])
    return tst, np.asarray(outs)


def test_prng_is_jax_threefry():
    """The port's threefry key split and normal draw are JAX's bits."""
    k = jax.random.key(0)
    tk = prng.key(0)
    for _ in range(3):
        k, sub = jax.random.split(k)
        ks = prng.split(tk)
        tk, tsub = ks[0], ks[1]
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jax.random.key_data(k)))
        np.testing.assert_array_equal(prng.bits32(tsub, (5, 7)).numpy(),
                                      np.asarray(jax.random.bits(sub, (5, 7))))
        np.testing.assert_allclose(prng.normal(tsub, (4, 80)).numpy(),
                                   np.asarray(jax.random.normal(sub, (4, 80))),
                                   rtol=0, atol=TOL)


def test_generic_plc(factory, tfactory):
    """Loss bursts of 1..4 ticks: waveform replay, comfort noise (JAX's
    random bits), the recovery crossfade and the carried key."""
    B, ticks = 4, 24
    lost = np.zeros((ticks, B), bool)
    lost[3, 0] = lost[5:8, 1] = lost[10:14, 2] = lost[4:6, 3] = lost[15:19, 0] = True
    _, outs = run_both(factory, tfactory, "generic_plc", B, ticks, seed=1,
                       params=lambda t: {"lost": lost[t]})
    # concealed ticks are not silence and not the (dropped) input
    assert np.abs(outs[8, 0, 2]).max() > 0


def test_tee_and_plumbing(factory, tfactory):
    _, outs = run_both(factory, tfactory, "tee", 3, 2, n_out=8, seed=2)
    assert all(np.array_equal(outs[:, i], outs[:, 0]) for i in range(8))
    run_both(factory, tfactory, "join", 3, 2, n_in=2, seed=3)
    run_both(factory, tfactory, "void_source", 3, 2, n_in=0, fmt=True)
    run_both(factory, tfactory, "void_sink", 3, 2, n_out=0, seed=4)


def test_delay_line(factory, tfactory):
    B, ticks = 4, 30
    delay = np.array([0, 1, 5, 20], np.int32)
    _, outs = run_both(factory, tfactory, "delay_line", B, ticks, seed=5,
                       params=lambda t: {"delay_ticks": delay}, max_delay_ms=200)
    assert not outs[:20, 0, 3].any() and outs[20:, 0, 3].all()   # 20 ticks late


def test_audio_levels(factory, tfactory):
    run_both(factory, tfactory, "audio_levels", 5, 6, seed=6)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_mixN(factory, tfactory, n):
    gains = np.random.default_rng(n).uniform(0.2, 1.5, (n, 3)).astype(np.float32)
    run_both(factory, tfactory, f"mix{n}", 3, 4, n_in=n, seed=n,
             params=lambda t: {"gains": gains})


def test_file_player(factory, tfactory):
    """Per-leg signals, play/pause and loop switches, ``eof`` events."""
    B, ticks = 3, 10
    sig = np.random.default_rng(7).uniform(-1, 1, (B, S * 4 + 30)).astype(np.float32)

    def params(t):
        return {"playing": np.array([True, t % 3 != 0, True]),
                "loop": np.array([False, False, t > 4])}
    run_both(factory, tfactory, "file_player", B, ticks, n_in=0, params=params,
             fmt=True, signal=sig)


def test_file_recorder(factory, tfactory):
    """Start/stop and the full buffer (max_ticks 6 of 9 ticks)."""
    B, ticks = 2, 9
    st, _ = run_both(factory, tfactory, "file_recorder", B, ticks, n_out=0, seed=8,
                     params=lambda t: {"recording": np.array(t != 2)}, max_ticks=6)
    assert recorder_get_audio(st["f"], 6, S).shape == (B, 6 * S)


def test_recorder_get_audio_matches_jax():
    rng = np.random.default_rng(9)
    buf = rng.standard_normal((2, 5 * S)).astype(np.float32)
    np.testing.assert_array_equal(recorder_get_audio({"buf": torch.from_numpy(buf)}, 3, S),
                                  j_rec_audio({"buf": jnp.asarray(buf)}, 3, S))


def test_dtmf_gen(factory, tfactory):
    """Dual tones with their envelope, single tones, silent passthrough and
    ``tone_done``."""
    B, ticks = 3, 8
    f1, f2 = dtmf_freqs("5")

    def params(t):
        return {"f1": np.array([f1, 1000.0, f1], np.float32),
                "f2": np.array([f2, 0.0, f2], np.float32),
                "remaining": np.maximum(np.array([800, 300, 0]) - S * t, 0).astype(np.int32),
                "silent_passthrough": np.array([False, True, False])}
    run_both(factory, tfactory, "dtmf_gen", B, ticks, seed=10, params=params)


def test_tone_detector(factory, tfactory):
    """DTMF digits in noise, one per leg, with rising-edge events."""
    B, ticks = 3, 10
    n = np.arange(S * ticks) / RATE
    rng = np.random.default_rng(11)
    sig = np.zeros((B, S * ticks), np.float32)
    for leg, key in enumerate("1#D"):
        fa, fb = dtmf_freqs(key)
        on = (n > 0.02) & (n < 0.07)
        sig[leg] = 0.3 * on * (np.sin(2 * np.pi * fa * n) + np.sin(2 * np.pi * fb * n))
    sig += 0.01 * rng.standard_normal(sig.shape).astype(np.float32)

    def inputs(t):
        return sig[None, :, t * S:(t + 1) * S]
    run_both(factory, tfactory, "tone_detector", B, ticks, inputs=inputs)


def test_vad_dtx(factory, tfactory):
    """Speech-level and quiet ticks through the VAD with silence detection
    on: voice decisions, hangover, DTX and silence events."""
    B, ticks = 3, 60
    rng = np.random.default_rng(12)
    level = np.ones((ticks, 1, B, 1), np.float32) * 0.3
    level[20:, :, 0] = 1e-3                    # leg 0 goes quiet for good
    level[10:25, :, 1] = 1e-4                  # leg 1 pauses
    xs = (rng.uniform(-1, 1, (ticks, 1, B, S)) * level).astype(np.float32)

    def params(t):
        return {"silence_detection": np.array([True, True, False]),
                "silence_duration_ticks": np.array([5, 5, 5], np.int32)}
    run_both(factory, tfactory, "vad_dtx", B, ticks, inputs=xs.__getitem__, params=params)


@pytest.mark.parametrize("gains", [None, [(1000.0, 2.0, 400.0), (3000.0, 0.2, 800.0)]],
                         ids=["flat", "ladder"])
def test_equalizer(factory, tfactory, gains):
    kw = {"gains": gains} if gains else {}
    run_both(factory, tfactory, "equalizer", 3, 4, seed=13, taps=32, **kw)


def test_generic_plc_draws_noise_only_when_mixed(tfactory):
    """The comfort noise (JAX's threefry, hundreds of operators eager) is
    drawn only on a tick where some leg has lost two ticks or more; its
    key still advances every tick, on the host."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    cg = _build(GraphBuilder, Format, tfactory, "generic_plc", 4, 1, 1, {})
    st, pr = cg.init_state("cpu"), cg.init_params("cpu")
    x = {"in0": torch.zeros((4, S))}
    ops = []
    for lost in ([0, 0, 0, 0], [0, 1, 0, 0], [0, 1, 0, 0], [0, 0, 0, 0]):
        pr["f"]["lost"] = torch.tensor(lost, dtype=torch.bool)
        key = st["f"]["rng"].clone()
        with Count() as c:
            st, _, _ = cg.step(st, pr, x)
        ops.append(c.n)
        assert not torch.equal(st["f"]["rng"], key)
    quiet, first_loss, second_loss, recovered = ops
    assert max(quiet, first_loss, recovered) < 60 < 200 < second_loss, ops
