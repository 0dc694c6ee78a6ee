"""The port's echo canceller on the CPU against the JAX package, on the
room-echo fixture of tests/test_aec.py (16 kHz, speech-like far end)."""
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each, so that parallel test workers running
# real-time paced tests are not crowded by idle OpenMP threads
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from conftest import make_speechlike  # noqa: E402
from test_aec import RATE, S, erle_db, room_ir, simulate  # noqa: E402
from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder  # noqa: E402
from mediastreamer2_tpu_torch.ops.aec import get_state_blob, set_state_blob  # noqa: E402
from mediastreamer2_tpu_torch.utils.audiodiff import snr_db  # noqa: E402


def port_simulate(near, far, B, ticks):
    """The same graph as test_aec.simulate, in the port. Returns the output
    of leg 0 [ticks*S], the final state, and the first tick after which the
    main taps are non-zero (the first promote), or None."""
    g = GraphBuilder(Factory(), batch=B)
    near_src = g.add("ext_source", "near", fmt=Format(rate=RATE))
    far_src = g.add("ext_source", "far", fmt=Format(rate=RATE))
    ec = g.add("echo_canceller", "ec", tail_ms=80)
    g.link(near_src, 0, ec, 0)
    g.link(far_src, 0, ec, 1)
    g.link(ec, 0, g.add("ext_sink", "out"), 0)
    cg = g.build()
    st, params = cg.init_state("cpu"), cg.init_params("cpu")
    outs, first_promote = [], None
    for t in range(ticks):
        blk = lambda x: torch.from_numpy(
            np.broadcast_to(x[t * S:(t + 1) * S], (B, S)).copy())
        st, out, _ = cg.step(st, params, {"near": blk(near), "far": blk(far)})
        outs.append(out["out"][0].numpy())
        if first_promote is None and bool(st["ec"]["Wm_r"].float().abs().max() > 0):
            first_promote = t
    return np.concatenate(outs), st, first_promote


@pytest.fixture(scope="module")
def runs(factory):
    ticks = 300
    near, echo, _, out_jax, _ = simulate(factory, B=2, ticks=ticks)
    far = make_speechlike(S * ticks, RATE, seed=0)
    out, st, first_promote = port_simulate(near, far, B=2, ticks=ticks)
    return {"echo": echo, "out_jax": out_jax, "out": out, "st": st,
            "first_promote": first_promote}


def test_aec_matches_jax_before_first_promote(runs):
    t = runs["first_promote"]
    assert t is not None and t >= 8          # HOLD_TICKS of evidence first
    np.testing.assert_allclose(runs["out"][:t * S], runs["out_jax"][:t * S],
                               rtol=0, atol=1e-5)


def test_aec_erle_convergence(runs):
    converged = slice(150 * S, 300 * S)
    e = erle_db(runs["echo"], runs["out"], converged)
    assert e > 15, f"converged ERLE {e:.1f} dB"
    assert e > erle_db(runs["echo"], runs["out"], slice(0, 30 * S))
    e_jax = erle_db(runs["echo"], runs["out_jax"], converged)
    assert abs(e - e_jax) < 2.0, (e, e_jax)


def test_aec_preserves_near_speech(factory):
    """tests/test_aec.py's second bar on the port: near speech enters at
    tick 150 under the far end's echo (double-talk) and comes through the
    canceller at an SNR above 5 dB over ticks 200-300. The port's number is
    held to the bar, not to JAX's (both sit just above it)."""
    ticks = 300
    near, _, near_sig, _, _ = simulate(factory, B=2, ticks=ticks, near_talk=True)
    far = make_speechlike(S * ticks, RATE, seed=0)
    out, st, _ = port_simulate(near, far, B=2, ticks=ticks)
    tail = slice(200 * S, 300 * S)
    s = snr_db(near_sig[tail], out[tail])
    assert s > 5, f"near speech SNR through the port's AEC {s:.2f} dB"
    assert st["ec"]["Ws_r"].dtype == torch.bfloat16          # the default shadow


def test_aec_bf16_shadow_quality_parity(monkeypatch):
    """tests/test_aec.py's third bar on the port: the bf16 shadow
    (stochastic rounding, AEC_BF16_SHADOW=1, the default) converges to an
    ERLE above 15 dB and within 2 dB of the f32 shadow's
    (AEC_BF16_SHADOW=0). The variable is read when the state is made."""
    ticks = 300
    rng = np.random.default_rng(0)
    n = S * ticks
    far = make_speechlike(n, RATE, seed=0)
    echo = np.convolve(far, room_ir(rng, 400))[:n].astype(np.float32)
    near = echo + 1e-4 * rng.standard_normal(n).astype(np.float32)
    converged = slice(150 * S, 300 * S)
    erle = {}
    for flag, dtype in (("0", torch.float32), ("1", torch.bfloat16)):
        monkeypatch.setenv("AEC_BF16_SHADOW", flag)
        out, st, _ = port_simulate(near, far, B=2, ticks=ticks)
        assert st["ec"]["Ws_r"].dtype == dtype, flag
        erle[flag] = erle_db(echo, out, converged)
    assert erle["1"] > 15, f"bf16-shadow converged ERLE {erle['1']:.1f} dB"
    assert erle["1"] > erle["0"] - 2.0, f"bf16 {erle['1']:.1f} vs f32 {erle['0']:.1f} dB"


def test_aec_state_blob_roundtrip(runs):
    st = runs["st"]["ec"]
    restored = set_state_blob(get_state_blob(st), "cpu")
    assert set(restored) == set(st)
    for k, v in st.items():
        assert restored[k].dtype == v.dtype, k
        assert torch.equal(restored[k], v), k


def test_aec_state_blob_reads_jax_blob(factory):
    """A state saved by the JAX package restores into the port."""
    from mediastreamer2_tpu.ops.aec import get_state_blob as jax_blob
    *_, st = simulate(factory, B=1, ticks=12)
    restored = set_state_blob(jax_blob(st["ec"]), "cpu")
    assert restored["Ws_r"].dtype == torch.bfloat16
    np.testing.assert_array_equal(restored["Wm_r"].float().numpy(),
                                  np.asarray(st["ec"]["Wm_r"], np.float32))
    assert int(restored["srk"]) == int(st["ec"]["srk"]) == 12


# --- the f32-shadow modes: megakernel (PALLAS_MDF=1) and AEC_BF16_SHADOW=0 ---
def _ec_graph(gb_cls, fmt_cls, factory, B):
    g = gb_cls(factory, batch=B)
    ns = g.add("ext_source", "near", fmt=fmt_cls(rate=16000))
    fs = g.add("ext_source", "far", fmt=fmt_cls(rate=16000))
    ec = g.add("echo_canceller", "ec", tail_ms=80)
    g.link(ns, 0, ec, 0)
    g.link(fs, 0, ec, 1)
    g.link(ec, 0, g.add("ext_sink", "out"), 0)
    return g.build()


def _run_f32_mode(factory, monkeypatch, env, B, ticks, seed=0):
    """The fixture of tests/test_mdf_kernels.py in both packages under the
    same environment; the JAX step is jitted, so its interpret-mode Pallas
    kernels trace once. Returns (JAX outputs, port outputs, JAX state, port
    state, the port's update calls by kernel)."""
    import jax
    from mediastreamer2_tpu.core.block import Format as JFormat
    from mediastreamer2_tpu.core.graph import GraphBuilder as JGraphBuilder
    from mediastreamer2_tpu_torch.ops import kernels

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = {"mdf_update": 0, "mdf_update_fused": 0}
    for name in calls:
        def spy(*a, _f=getattr(kernels, name), _n=name):
            calls[_n] += 1
            return _f(*a)
        monkeypatch.setattr(kernels, name, spy)
    jcg = _ec_graph(JGraphBuilder, JFormat, factory, B)
    tcg = _ec_graph(GraphBuilder, Format, Factory(), B)
    jst, jpr = jcg.init_state(), jcg.init_params()
    tst, tpr = tcg.init_state("cpu"), tcg.init_params("cpu")
    step = jax.jit(jcg.step)
    far = make_speechlike(S * ticks, RATE, seed=seed)
    near = 0.5 * np.roll(far, 30) + 0.01 * make_speechlike(S * ticks, RATE, seed=seed + 1)
    jo, to = [], []
    for t in range(ticks):
        ext = {"near": np.broadcast_to(near[t * S:(t + 1) * S], (B, S)).astype(np.float32),
               "far": np.broadcast_to(far[t * S:(t + 1) * S], (B, S)).astype(np.float32)}
        jst, o, _ = step(jst, jpr, ext)
        jo.append(np.asarray(o["out"]))
        tst, o, _ = tcg.step(tst, tpr, {k: torch.from_numpy(v) for k, v in ext.items()})
        to.append(o["out"].numpy())
    return np.stack(jo), np.stack(to), jst, tst, calls


@pytest.mark.parametrize("env,B,ticks,update", [
    ({"PALLAS_MDF": "1"}, 4, 30, "mdf_update"),
    ({"AEC_BF16_SHADOW": "0"}, 2, 40, "mdf_update_fused"),
], ids=["megakernel", "f32_shadow_jnp"])
def test_aec_f32_shadow_modes_match_jax(factory, monkeypatch, env, B, ticks, update):
    jout, tout, jst, tst, calls = _run_f32_mode(factory, monkeypatch, env, B, ticks)
    assert calls[update] == ticks and sum(calls.values()) == ticks, calls
    # the trees match key for key: an f32 shadow carries no rounding counter
    assert set(tst["ec"]) == set(jst["ec"]) and "srk" not in tst["ec"]
    assert tst["ec"]["Ws_r"].dtype == torch.float32
    assert tst["ec"]["Wm_r"].dtype == torch.bfloat16
    np.testing.assert_allclose(tout, jout, rtol=2e-4, atol=2e-5)
    wm_t = tst["ec"]["Wm_r"]
    wm_j = np.asarray(jst["ec"]["Wm_r"], np.float32)
    if update == "mdf_update":
        # test_mdf_pallas_matches_jnp's tolerance
        np.testing.assert_allclose(wm_t.float().numpy(), wm_j, rtol=2e-4, atol=2e-5)
    else:
        # test_fused_update_matches_jnp's tolerance for the same pair (the
        # fused update against the jnp branch): XLA's FMA moves an f32 ulp
        # of a promoted tap, which its RNE cast can turn into a bf16 ulp
        np.testing.assert_allclose(wm_t.float().numpy(), wm_j, rtol=1e-2, atol=1e-4)
        assert np.mean(wm_t.float().numpy() == wm_j) >= 0.99
    np.testing.assert_allclose(tst["ec"]["Es"].numpy(), np.asarray(jst["ec"]["Es"]),
                               rtol=2e-4, atol=1e-7)
    # the filter did adapt and promote in the window compared
    assert float(tst["ec"]["Wm_r"].float().abs().max()) > 0


@pytest.mark.parametrize("knob,value", [("AEC_HALF_UPDATE", "1"), ("AEC_CIRC_HIST", "1")])
def test_aec_unported_knobs_raise(monkeypatch, knob, value):
    monkeypatch.setenv(knob, value)
    cg = _ec_graph(GraphBuilder, Format, Factory(), 2)
    with pytest.raises(NotImplementedError, match=knob):
        cg.init_state("cpu")


def test_aec_megakernel_follows_the_tile_rule(monkeypatch):
    """PALLAS_MDF=1 at a batch the TPU kernel does not tile (B=40) takes
    the f32 jnp branch in JAX, so mdf_update_fused here."""
    from mediastreamer2_tpu_torch.ops import aec
    monkeypatch.setenv("PALLAS_MDF", "1")
    assert aec._megakernel_path(32) and aec._megakernel_path(64)
    assert aec._megakernel_path(8) and not aec._megakernel_path(40)
    monkeypatch.setenv("PALLAS_DISABLE", "1")
    assert not aec._megakernel_path(32)


def test_f32_shadow_tree_converts_both_ways(factory, monkeypatch):
    """A JAX f32-shadow state (AEC_BF16_SHADOW=0) converts into the port
    and back: f32 shadow taps, bf16 main taps and history, no srk."""
    import io
    import jax
    from mediastreamer2_tpu.core.block import Format as JFormat
    from mediastreamer2_tpu.core.graph import GraphBuilder as JGraphBuilder
    from mediastreamer2_tpu.ops.aec import get_state_blob as jax_blob
    from mediastreamer2_tpu_torch.utils.convert import from_jax, to_numpy

    monkeypatch.setenv("AEC_BF16_SHADOW", "0")
    jcg = _ec_graph(JGraphBuilder, JFormat, factory, 2)
    jst, jpr = jcg.init_state(), jcg.init_params()
    step = jax.jit(jcg.step)
    far = make_speechlike(S * 12, RATE, seed=4)
    for t in range(12):
        blk = np.broadcast_to(far[t * S:(t + 1) * S], (2, S)).astype(np.float32)
        jst, _, _ = step(jst, jpr, {"near": 0.5 * blk, "far": blk})
    tree = {"ec": dict(np.load(io.BytesIO(jax_blob(jst["ec"]))))}
    port = from_jax(tree, "cpu")["ec"]
    assert set(port) == set(jst["ec"]) and "srk" not in port
    assert port["Ws_r"].dtype == torch.float32 and port["Wm_r"].dtype == torch.bfloat16
    for k, v in jst["ec"].items():
        np.testing.assert_array_equal(port[k].float().numpy() if port[k].is_floating_point()
                                      else port[k].numpy(), np.asarray(v, np.float32)
                                      if port[k].is_floating_point() else np.asarray(v), k)
    back = to_numpy({"ec": port})["ec"]
    assert set(back["__bf16__"]) == {"Wm_r", "Wm_i", "Xh_r", "Xh_i"}
    assert back["Ws_r"].dtype == np.float32 and "srk" not in back
    again = from_jax({"ec": back}, "cpu")["ec"]
    for k, v in port.items():
        assert again[k].dtype == v.dtype and torch.equal(again[k], v), k
