"""The port's ``entry()`` (``mediastreamer2_tpu_torch/entry.py``) against the
JAX package's ``__graft_entry__.entry()``: the flagship at batch 64, one
tick each on the same inputs, held to ``tests/test_torch_flagship.py``'s
tolerances (outputs atol 1e-5; the AGC's and the resampler's state rtol
1e-3)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from mediastreamer2_tpu_torch import entry as port_entry  # noqa: E402


@pytest.fixture(scope="module")
def ticks():
    import __graft_entry__
    jfwd, (jst, jpr, jext) = __graft_entry__.entry()
    jst2, jout = jax.jit(jfwd)(jst, jpr, jext)
    fwd, (st, pr, ext) = port_entry.entry(device="cpu")
    ext_np = {k: v.numpy().copy() for k, v in ext.items()}
    st2, out = fwd(st, pr, ext)
    return {"jax": (jst2, jout, jext), "port": (st2, out, ext_np)}


def test_entry_is_the_flagship_at_batch_64(ticks):
    st, out, ext = ticks["port"]
    assert port_entry.BATCH == 64
    assert set(ext) == {"mic", "spk_ref"}
    assert all(v.shape == (64, 480) for v in ext.values())
    assert tuple(out["out"].shape) == (64, 160)
    assert out["out"].device.type == "cpu"
    assert bool(torch.isfinite(out["out"]).all())
    assert set(st) == {"ec", "agc", "rs"}          # the mixer carries no state


def test_entry_inputs_equal_jax(ticks):
    _, _, jext = ticks["jax"]
    _, _, ext = ticks["port"]
    for k, v in jext.items():
        np.testing.assert_array_equal(ext[k], np.asarray(v), k)


def test_entry_tick_matches_jax(ticks):
    jst, jout, _ = ticks["jax"]
    st, out, _ = ticks["port"]
    np.testing.assert_allclose(out["out"].numpy(), np.asarray(jout["out"]), rtol=0, atol=1e-5)
    for node in ("agc", "rs"):
        for k, v in jst[node].items():
            np.testing.assert_allclose(st[node][k].numpy(), np.asarray(v), rtol=1e-3, atol=1e-5,
                                       err_msg=f"{node}.{k}")


def test_entry_without_a_card_raises(monkeypatch):
    """``device=None`` means the CUDA card; with none it raises rather than
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()


def test_entry_main_on_the_cpu(capsys):
    assert port_entry.main(["--device", "cpu"]) == 0
    line = capsys.readouterr().out
    assert "out (64, 160)" in line and "finite True" in line
