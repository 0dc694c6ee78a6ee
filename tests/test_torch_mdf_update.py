"""The megakernel configuration's two kernels in the port (their plain
versions, on the CPU) against the JAX package's Pallas kernels in
interpret mode: ``mdf_update`` and ``mdf_apply`` with f32 shadow taps."""
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each, so that parallel test workers running
# real-time paced tests are not crowded by idle OpenMP threads
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mediastreamer2_tpu.ops import pallas_kernels as pk  # noqa: E402
from mediastreamer2_tpu_torch.ops import kernels  # noqa: E402

BF16 = torch.bfloat16
B, P, F = 4, 8, 161


def _bf16_np(a):
    """numpy float32 values that are exactly representable in bf16."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def _update_inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda scale, *shape: (scale * rng.standard_normal(shape)).astype(np.float32)
    a = {
        "Ws_r": f(0.1, B, P, F), "Ws_i": f(0.1, B, P, F),
        "Wm_r": _bf16_np(f(0.1, B, P, F)), "Wm_i": _bf16_np(f(0.1, B, P, F)),
        "Xh_r": _bf16_np(f(1.0, B, P, F)), "Xh_i": _bf16_np(f(1.0, B, P, F)),
        "Er": f(0.3, B, F), "Ei": f(0.3, B, F),
        "inv_norm": np.abs(f(0.5, B, F)), "gc_r": f(0.05, B, F), "gc_i": f(0.05, B, F),
        "mu": np.abs(f(0.6, B)),
    }
    # legs 0 and 1 promoted, leg 2 reseeded, leg 3 neither
    a["promote"] = np.array([1, 1, 0, 0], np.float32)
    a["reseed"] = np.array([0, 0, 1, 0], np.float32)
    return a


_ORDER = ("Ws_r", "Ws_i", "Wm_r", "Wm_i", "Xh_r", "Xh_i", "Er", "Ei",
          "inv_norm", "gc_r", "gc_i", "mu", "promote", "reseed")


@pytest.mark.parametrize("cpos", [0, 3, 7])
def test_mdf_update_matches_pallas(cpos):
    a = _update_inputs(20 + cpos)
    # JAX: Wm arrives as f32 and the result is rounded to bf16 with RNE by
    # the caller (ops/aec.py:441-446)
    ws_r, ws_i, wm_r, wm_i = pk.mdf_update(jnp.int32(cpos),
                                           *(jnp.asarray(a[k]) for k in _ORDER))
    t = {k: torch.from_numpy(a[k].copy()) for k in _ORDER}
    for k in ("Wm_r", "Wm_i", "Xh_r", "Xh_i"):
        t[k] = t[k].to(BF16)
    got = kernels.mdf_update(torch.tensor(cpos, dtype=torch.int32),
                             *(t[k] for k in _ORDER))
    # in place: the wrapper returns its own inputs, updated
    assert got[0] is t["Ws_r"] and got[2] is t["Wm_r"]
    # XLA on the CPU contracts a product and a sum into one FMA (checked
    # against an FMA emulation: it reproduces JAX bit for bit), the port
    # rounds each: one f32 ulp, ~1e-8 absolute where Ws + mu*g cancels
    np.testing.assert_allclose(t["Ws_r"].numpy(), np.asarray(ws_r), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t["Ws_i"].numpy(), np.asarray(ws_i), rtol=1e-6, atol=1e-7)
    # ...which the RNE cast to bf16 absorbs on these inputs
    np.testing.assert_array_equal(t["Wm_r"].float().numpy(),
                                  np.asarray(wm_r.astype(jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_array_equal(t["Wm_i"].float().numpy(),
                                  np.asarray(wm_i.astype(jnp.bfloat16).astype(jnp.float32)))
    # promoted legs took the update, the reseeded leg's shadow took main
    assert not np.array_equal(t["Wm_r"][0].float().numpy(), a["Wm_r"][0])
    np.testing.assert_array_equal(t["Wm_r"][3].float().numpy(), a["Wm_r"][3])
    np.testing.assert_array_equal(t["Ws_r"][2].numpy(), a["Wm_r"][2])


def test_mdf_update_blend_carries_non_finite_to_main():
    """The transfers are blends, not selects: an infinite update reaches the
    main taps of a leg that is not promoted (0 * inf = NaN), as on the TPU."""
    a = _update_inputs(5)
    a["Ws_r"][3, 1, 7] = np.inf
    want = pk.mdf_update(jnp.int32(0), *(jnp.asarray(a[k]) for k in _ORDER))
    t = {k: torch.from_numpy(a[k].copy()) for k in _ORDER}
    for k in ("Wm_r", "Wm_i", "Xh_r", "Xh_i"):
        t[k] = t[k].to(BF16)
    kernels.mdf_update(torch.tensor(0, dtype=torch.int32), *(t[k] for k in _ORDER))
    assert np.isnan(t["Wm_r"][3, 1, 7].item())
    assert np.isnan(np.asarray(want[2])[3, 1, 7])
    np.testing.assert_allclose(t["Ws_r"].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-7)


def test_mdf_apply_f32_shadow_matches_pallas():
    rng = np.random.default_rng(3)
    Bq = 8
    f = lambda scale, *shape: (scale * rng.standard_normal(shape)).astype(np.float32)
    wm = [_bf16_np(f(0.1, Bq, P, F)) for _ in range(2)]
    ws = [f(0.1, Bq, P, F) for _ in range(2)]
    xh = [_bf16_np(f(1.0, Bq, P, F)) for _ in range(2)]
    x = [f(1.0, Bq, F) for _ in range(2)]
    # JAX megakernel: block rounded through bf16 first (ops/aec.py:262-267)
    xq = [_bf16_np(v) for v in x]
    want = pk.mdf_apply(*(jnp.asarray(v) for v in wm + ws + xh + xq))
    th = [torch.from_numpy(v).to(BF16) for v in xh]
    got = kernels.mdf_apply(*(torch.from_numpy(v).to(BF16) for v in wm),
                            *(torch.from_numpy(v) for v in ws), *th,
                            *(torch.from_numpy(v) for v in x))
    for w, g in zip(want[:4], got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    # the shifted history, in place, bit for bit
    for w, h in zip(want[4:], th):
        np.testing.assert_array_equal(h.float().numpy(), np.asarray(w))


def test_launch_counts_name_all_four_kernels_and_cpu_launches_none():
    kernels.reset_launch_counts()
    a = _update_inputs(1)
    t = {k: torch.from_numpy(a[k].copy()) for k in _ORDER}
    for k in ("Wm_r", "Wm_i", "Xh_r", "Xh_i"):
        t[k] = t[k].to(BF16)
    kernels.mdf_update(torch.tensor(2, dtype=torch.int32), *(t[k] for k in _ORDER))
    assert kernels.launch_counts() == {"fused_volume": 0, "mdf_apply": 0,
                                       "mdf_update": 0, "mdf_update_fused": 0,
                                       "g722_encode": 0, "g722_decode": 0}


def test_mdf_update_rejects_other_devices():
    z3 = torch.zeros((1, 2, 3), device="meta")
    z2 = torch.zeros((1, 3), device="meta")
    z1 = torch.zeros((1,), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        kernels.mdf_update(torch.zeros((), dtype=torch.int32, device="meta"),
                           z3, z3, z3, z3, z3, z3, z2, z2, z2, z2, z2, z1, z1, z1)
