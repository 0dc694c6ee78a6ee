"""The port's echo canceller on the CPU against the JAX package, on the
room-echo fixture of tests/test_aec.py (16 kHz, speech-like far end)."""
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each, so that parallel test workers running
# real-time paced tests are not crowded by idle OpenMP threads
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from conftest import make_speechlike  # noqa: E402
from test_aec import RATE, S, erle_db, simulate  # noqa: E402
from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder  # noqa: E402
from mediastreamer2_tpu_torch.ops.aec import get_state_blob, set_state_blob  # noqa: E402


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


def test_aec_state_blob_roundtrip(runs):
    st = runs["st"]["ec"]
    restored = set_state_blob(get_state_blob(st))
    assert set(restored) == set(st)
    for k, v in st.items():
        assert restored[k].dtype == v.dtype, k
        assert torch.equal(restored[k], v), k


def test_aec_state_blob_reads_jax_blob(factory):
    """A state saved by the JAX package restores into the port."""
    from mediastreamer2_tpu.ops.aec import get_state_blob as jax_blob
    *_, st = simulate(factory, B=1, ticks=12)
    restored = set_state_blob(jax_blob(st["ec"]))
    assert restored["Ws_r"].dtype == torch.bfloat16
    np.testing.assert_array_equal(restored["Wm_r"].float().numpy(),
                                  np.asarray(st["ec"]["Wm_r"], np.float32))
    assert int(restored["srk"]) == int(st["ec"]["srk"]) == 12
