"""The flagship conference leg (AEC -> AGC -> resample 48k->16k ->
mix-minus) in the port on the CPU against the JAX package, on the
echo-coupled fixture of tools/tpu_correctness.py."""
import io

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each, so that parallel test workers running
# real-time paced tests are not crowded by idle OpenMP threads
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mediastreamer2_tpu.models.flagship import build_flagship as jax_build  # noqa: E402
from mediastreamer2_tpu.ops.aec import get_state_blob as jax_state_blob  # noqa: E402
from mediastreamer2_tpu_torch import Factory, build_flagship  # noqa: E402
from mediastreamer2_tpu_torch.models.flagship import echo_coupled_inputs  # noqa: E402
from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff, quality_bar  # noqa: E402
from mediastreamer2_tpu_torch.utils.convert import from_jax, to_numpy  # noqa: E402

B, TICKS, S = 8, 60, 480


def _blocks(x, t):
    return np.ascontiguousarray(x[:, t * S:(t + 1) * S])


def _jax_tree_np(state):
    """A JAX state or params tree as numpy, bf16 leaves listed as the JAX
    echo canceller's get_state_blob hands them over."""
    out = {}
    for node, entry in state.items():
        if any(jnp.asarray(v).dtype == jnp.bfloat16 for v in entry.values()):
            out[node] = dict(np.load(io.BytesIO(jax_state_blob(entry))))
        else:
            out[node] = {k: np.asarray(v) for k, v in entry.items()}
    return out


def _run(factory, mic, far, t0, t1, jax_state=None, port_state=None,
         jax_params=None, port_params=None, snapshot_at=None):
    """Step both packages over ticks [t0, t1); returns final states and
    outputs [B, (t1-t0)*160], and with ``snapshot_at`` also copies of both
    states' volume and resample entries after that many ticks."""
    jcg, jpr = jax_build(factory, batch=B)
    tcg, tpr = build_flagship(Factory(), B, "cpu")
    jst = jcg.init_state() if jax_state is None else jax_state
    tst = tcg.init_state("cpu") if port_state is None else port_state
    jpr = jpr if jax_params is None else jax_params
    tpr = tpr if port_params is None else port_params
    step = jax.jit(jcg.step)
    jo, to = [], []
    snap = None
    for t in range(t0, t1):
        if t == snapshot_at:
            snap = ({n: dict(jst[n]) for n in ("agc", "rs")},
                    {n: {k: v.clone() for k, v in tst[n].items()} for n in ("agc", "rs")})
        ext = {"mic": _blocks(mic, t), "spk_ref": _blocks(far, t)}
        jst, o, _ = step(jst, jpr, ext)
        jo.append(np.asarray(o["out"]))
        tst, o, _ = tcg.step(tst, tpr, {k: torch.from_numpy(v) for k, v in ext.items()})
        to.append(o["out"].numpy())
    outs = (jst, tst, np.concatenate(jo, 1), np.concatenate(to, 1))
    return outs if snapshot_at is None else outs + (snap,)


@pytest.fixture(scope="module")
def run60(factory):
    mic, far = echo_coupled_inputs(B, TICKS)
    # the earliest promote lands on tick HOLD_TICKS - 1 = 7
    return _run(factory, mic, far, 0, TICKS, snapshot_at=7)


def _assert_quality(jout, tout):
    bar = quality_bar(jout, tout, leg_step=1)
    assert bar["pass"], bar
    for i in range(B):
        assert audio_diff(jout[i], tout[i])[0] >= 0.999, i


def _assert_leaves_close(jst, tst, rtol=0.0, atol=1e-5, nodes=("agc", "rs")):
    for node in nodes:
        for k, v in jst[node].items():
            np.testing.assert_allclose(tst[node][k].numpy(), np.asarray(v),
                                       rtol=rtol, atol=atol, err_msg=f"{node}.{k}")


def test_flagship_quality_matches_jax(run60):
    jst, tst, jout, tout, _ = run60
    assert tout.shape == (B, TICKS * 160)
    assert np.isfinite(tout).all()
    _assert_quality(jout, tout)


def test_flagship_volume_and_resample_state_match_jax(run60):
    jst, tst, _, _, (jsnap, tsnap) = run60
    # before any promote the two packages run the same arithmetic
    _assert_leaves_close(jsnap, tsnap)
    # after the promotes, the AEC outputs agree to the quality-equivalence
    # margin (rms ~1e-4 relative to the signal), and the AGC integrates that
    # difference into its energy and gain: hold them to 1e-3 relative
    # (the DC tracker, ~1e-4 in size, to the absolute 1e-5). The resampler's
    # history is the AGC's last output samples, which the quality bar on
    # the mixed output already covers.
    _assert_leaves_close(jst, tst, rtol=1e-3, atol=1e-5, nodes=("agc",))


def test_flagship_dc_mix_minus_exact(factory):
    """Distinct per-leg DC levels: each leg hears its group's sum minus
    itself (the check of __graft_entry__.py:78-93, with AGC off)."""
    jcg, jpr = jax_build(factory, batch=B)
    tcg, tpr = build_flagship(Factory(), B, "cpu")
    jpr["agc"]["agc_enabled"] = jnp.zeros((B,), bool)
    tpr["agc"]["agc_enabled"] = torch.zeros((B,), dtype=torch.bool)
    dc = 0.01 * (1.0 + np.arange(B, dtype=np.float32))
    ext = {"mic": np.broadcast_to(dc[:, None], (B, S)).copy(),
           "spk_ref": np.zeros((B, S), np.float32)}
    jst, tst = jcg.init_state(), tcg.init_state("cpu")
    for _ in range(4):                       # let the resampler settle on DC
        jst, jo, _ = jcg.step(jst, jpr, ext)
        tst, to, _ = tcg.step(tst, tpr, {k: torch.from_numpy(v) for k, v in ext.items()})
    got = to["out"].numpy()[:, -40:]
    want = np.repeat(dc.reshape(-1, 4).sum(axis=1), 4) - dc
    np.testing.assert_allclose(got, np.broadcast_to(want[:, None], got.shape),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(to["out"].numpy(), np.asarray(jo["out"]), rtol=0, atol=1e-6)


def test_flagship_state_carried_across(factory):
    """Run JAX for 5 ticks, convert its state and params into the port, then
    step both 5 more ticks on the same inputs."""
    mic, far = echo_coupled_inputs(B, 10, seed=3)
    jst, _, _, _ = _run(factory, mic, far, 0, 5)
    jcg, jpr = jax_build(factory, batch=B)
    tst = from_jax(_jax_tree_np(jst), "cpu")
    tpr = from_jax(_jax_tree_np(jpr), "cpu")
    assert tst["ec"]["Ws_r"].dtype == torch.bfloat16
    assert tst["ec"]["srk"].dtype == torch.int64 and int(tst["ec"]["srk"]) == 5
    assert "conf" not in tst and "conf" in tpr
    jst2, tst2, jout, tout = _run(factory, mic, far, 5, 10, jax_state=jst,
                                  port_state=tst, jax_params=jpr, port_params=tpr)
    _assert_quality(jout, tout)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-5)
    _assert_leaves_close(jst2, tst2)
    # the DFTs are matrix products summed in another order (MKL vs XLA);
    # the running history power Hp accumulates that over the window
    for k in ("Em", "Es", "Dn", "Hp"):
        np.testing.assert_allclose(tst2["ec"][k].numpy(), np.asarray(jst2["ec"][k]),
                                   rtol=1e-3, atol=1e-9, err_msg=k)
    assert int(tst2["ec"]["cpos"]) == int(jst2["ec"]["cpos"])


def test_convert_roundtrip(run60):
    _, tst, _, _, _ = run60
    back = from_jax(to_numpy(tst), "cpu")
    assert to_numpy(tst)["ec"]["srk"].dtype == np.uint32
    for node, entry in tst.items():
        for k, v in entry.items():
            assert back[node][k].dtype == v.dtype, (node, k)
            assert torch.equal(back[node][k], v), (node, k)
