"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package: Pallas kernels in interpret mode, and the default path's jnp
expressions."""
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each, so that parallel test workers running
# real-time paced tests are not crowded by idle OpenMP threads
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mediastreamer2_tpu.ops import pallas_kernels as pk  # noqa: E402
from mediastreamer2_tpu.ops.aec import _sround_bf16  # noqa: E402
from mediastreamer2_tpu_torch.ops import kernels  # noqa: E402

BF16 = torch.bfloat16


def _bf16_np(a):
    """numpy float32 values that are exactly representable in bf16."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def _bits(t):
    """Raw bit patterns of a bf16 tensor as int32."""
    return t.view(torch.int16).numpy().astype(np.int32) & 0xFFFF


def _mdf_inputs(rng, B, P=8, F=481):
    bf = lambda scale: _bf16_np(scale * rng.standard_normal((B, P, F)))
    f = lambda scale, *shape: (scale * rng.standard_normal(shape)).astype(np.float32)
    return {
        "Wm_r": bf(0.1), "Wm_i": bf(0.1), "Ws_r": bf(0.1), "Ws_i": bf(0.1),
        "Xh_r": bf(1.0), "Xh_i": bf(1.0),
        "Er": f(0.3, B, F), "Ei": f(0.3, B, F),
        "inv_norm": np.abs(f(0.5, B, F)), "gc_r": f(0.05, B, F), "gc_i": f(0.05, B, F),
        "mu": np.abs(f(0.6, B)),
        "promote": rng.uniform(size=B) < 0.3, "reseed": rng.uniform(size=B) < 0.3,
        "hard_reset": rng.uniform(size=B) < 0.3,
    }


def _fv_inputs():
    rng = np.random.default_rng(0)
    B, S = 16, 480
    return (rng.uniform(-1.2, 1.2, (B, S)).astype(np.float32),
            rng.uniform(0.1, 2.0, B).astype(np.float32),
            rng.uniform(0.1, 2.0, B).astype(np.float32),
            rng.uniform(-0.1, 0.1, B).astype(np.float32),
            (rng.uniform(0, 1, B) > 0.5).astype(np.float32))


@pytest.mark.parametrize("jax_fn", ["fused_volume", "fused_volume_reference"])
def test_fused_volume_matches_jax(jax_fn):
    args = _fv_inputs()
    want = getattr(pk, jax_fn)(*map(jnp.asarray, args))
    got = kernels.fused_volume(*map(torch.from_numpy, args))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_fused_volume_counts_no_cpu_launch():
    kernels.reset_launch_counts()
    kernels.fused_volume(*map(torch.from_numpy, _fv_inputs()))
    assert kernels.launch_counts() == {"fused_volume": 0, "mdf_apply": 0,
                                       "mdf_update": 0, "mdf_update_fused": 0,
                                       "g722_encode": 0, "g722_decode": 0,
                                       "dvi4_encode": 0, "dvi4_decode": 0,
                                       "g726_encode": 0, "g726_decode": 0,
                                       "suppress_gain": 0, "spectrum_planes": 0,
                                       "planes_spectrum": 0, "aec_decide": 0}


def test_mdf_apply_matches_jax_default_path():
    rng = np.random.default_rng(1)
    B, P, F = 4, 8, 481
    a = _mdf_inputs(rng, B, P, F)
    Xr = (rng.standard_normal((B, F))).astype(np.float32)
    Xi = (rng.standard_normal((B, F))).astype(np.float32)
    # JAX default path, ops/aec.py:289-316
    j = {k: jnp.asarray(a[k], jnp.bfloat16) for k in
         ("Wm_r", "Wm_i", "Ws_r", "Ws_i", "Xh_r", "Xh_i")}
    Xh_r = jnp.concatenate([jnp.asarray(Xr)[:, None].astype(jnp.bfloat16),
                            j["Xh_r"][:, :-1]], axis=1)
    Xh_i = jnp.concatenate([jnp.asarray(Xi)[:, None].astype(jnp.bfloat16),
                            j["Xh_i"][:, :-1]], axis=1)
    xr, xi = Xh_r.astype(jnp.float32), Xh_i.astype(jnp.float32)
    wmr, wmi = j["Wm_r"].astype(jnp.float32), j["Wm_i"].astype(jnp.float32)
    wsr, wsi = j["Ws_r"].astype(jnp.float32), j["Ws_i"].astype(jnp.float32)
    terms = (wmr * xr - wmi * xi, wmr * xi + wmi * xr,
             wsr * xr - wsi * xi, wsr * xi + wsi * xr)
    want = jax.lax.reduce(terms, tuple(jnp.zeros((), jnp.float32) for _ in terms),
                          lambda acc, v: tuple(x + y for x, y in zip(acc, v)), (1,))

    t = {k: torch.from_numpy(a[k]).to(BF16) for k in j}
    got = kernels.mdf_apply(t["Wm_r"], t["Wm_i"], t["Ws_r"], t["Ws_i"],
                            t["Xh_r"], t["Xh_i"], torch.from_numpy(Xr),
                            torch.from_numpy(Xi))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    # the shifted history, in place, bit for bit
    np.testing.assert_array_equal(t["Xh_r"].float().numpy(),
                                  np.asarray(Xh_r.astype(jnp.float32)))
    np.testing.assert_array_equal(t["Xh_i"].float().numpy(),
                                  np.asarray(Xh_i.astype(jnp.float32)))


def _port_update(a, cpos, shadow_dtype, srk=None):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
    ws = {k: t[k].to(shadow_dtype).clone() for k in ("Ws_r", "Ws_i")}
    wm = {k: t[k].to(BF16).clone() for k in ("Wm_r", "Wm_i")}
    srk_t = None if srk is None else torch.tensor(srk, dtype=torch.int64)
    return kernels.mdf_update_fused(
        torch.tensor(cpos, dtype=torch.int32), ws["Ws_r"], ws["Ws_i"],
        wm["Wm_r"], wm["Wm_i"], t["Xh_r"].to(BF16), t["Xh_i"].to(BF16),
        t["Er"], t["Ei"], t["inv_norm"], t["gc_r"], t["gc_i"], t["mu"],
        t["promote"], t["reseed"], t["hard_reset"], srk_t)


@pytest.mark.parametrize("cpos", [0, 5])
def test_mdf_update_fused_f32_shadow_matches_pallas(monkeypatch, cpos):
    monkeypatch.setenv("AEC_PALLAS_UPDATE", "1")
    rng = np.random.default_rng(2 + cpos)
    a = _mdf_inputs(rng, B=32)
    a["Ws_r"] = (0.1 * rng.standard_normal(a["Ws_r"].shape)).astype(np.float32)
    a["Ws_i"] = (0.1 * rng.standard_normal(a["Ws_i"].shape)).astype(np.float32)
    f = lambda k: jnp.asarray(a[k])
    b = lambda k: jnp.asarray(a[k], jnp.bfloat16)
    m = lambda k: jnp.asarray(a[k].astype(np.float32))
    want = pk.mdf_update_fused(jnp.int32(cpos), f("Ws_r"), f("Ws_i"), b("Wm_r"),
                               b("Wm_i"), b("Xh_r"), b("Xh_i"), f("Er"), f("Ei"),
                               f("inv_norm"), f("gc_r"), f("gc_i"), f("mu"),
                               m("promote"), m("reseed"), m("hard_reset"))
    got = _port_update(a, cpos, torch.float32)
    # XLA may fuse a product and a sum into one FMA, which moves an f32 ulp:
    # where Ws + step cancels to near zero that is ~1e-8 absolute (atol),
    # and the promoted bf16 main taps can flip one bf16 ulp on a tie
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    for w, g in zip(want[2:], got[2:]):
        _assert_bf16_close(w, g)


def _assert_bf16_close(want, got):
    """Identical bits in >= 99.9% of elements, the rest one bf16 ulp off."""
    wb = np.asarray(jax.lax.bitcast_convert_type(want, jnp.uint16)).astype(np.int32)
    gb = _bits(got)
    assert np.mean(wb == gb) >= 0.999
    assert np.abs(wb - gb).max() <= 1


def _jax_default_update(a, cpos, srk):
    """The JAX default branch, ops/aec.py:487-496, 520-528 and 541-542."""
    B, P, F = a["Ws_r"].shape
    Xh_r, Xh_i = (jnp.asarray(a[k], jnp.bfloat16) for k in ("Xh_r", "Xh_i"))
    Ws = {k: jnp.asarray(a[k], jnp.bfloat16) for k in ("Ws_r", "Ws_i")}
    Wm = {k: jnp.asarray(a[k], jnp.bfloat16) for k in ("Wm_r", "Wm_i")}
    Er, Ei, inv_norm, gc_r, gc_i, mu = (jnp.asarray(a[k]) for k in
                                        ("Er", "Ei", "inv_norm", "gc_r", "gc_i", "mu"))
    xr, xi = Xh_r.astype(jnp.float32), Xh_i.astype(jnp.float32)
    Gr = xr * Er[:, None, :] + xi * Ei[:, None, :]
    Gi = xr * Ei[:, None, :] - xi * Er[:, None, :]
    pmask = jax.lax.broadcasted_iota(jnp.int32, (1, P, 1), 1) == cpos
    step_w = mu[:, None, None] * inv_norm[:, None, :]
    ws_r = Ws["Ws_r"].astype(jnp.float32) + jnp.where(
        pmask, (mu[:, None] * gc_r)[:, None, :], step_w * Gr)
    ws_i = Ws["Ws_i"].astype(jnp.float32) + jnp.where(
        pmask, (mu[:, None] * gc_i)[:, None, :], step_w * Gi)
    p3, r3, h3 = (jnp.asarray(a[k])[:, None, None] for k in
                  ("promote", "reseed", "hard_reset"))
    ws_r = jnp.where(h3, 0.0, jnp.where(r3, Wm["Wm_r"].astype(jnp.float32), ws_r))
    ws_i = jnp.where(h3, 0.0, jnp.where(r3, Wm["Wm_i"].astype(jnp.float32), ws_i))
    salt = jnp.uint32(srk) * jnp.uint32(2)
    ws_r = _sround_bf16(ws_r, salt)
    ws_i = _sround_bf16(ws_i, salt + jnp.uint32(1))
    wm_r = jnp.where(p3, ws_r.astype(jnp.bfloat16), Wm["Wm_r"])
    wm_i = jnp.where(p3, ws_i.astype(jnp.bfloat16), Wm["Wm_i"])
    return ws_r, ws_i, wm_r, wm_i


@pytest.mark.parametrize("cpos,srk", [(0, 0), (3, 12345), (7, 2**31 + 5)])
def test_mdf_update_fused_bf16_shadow_matches_jax_default(cpos, srk):
    rng = np.random.default_rng(10 + cpos)
    a = _mdf_inputs(rng, B=8)
    a["promote"] &= ~a["hard_reset"]
    want = jax.jit(_jax_default_update, static_argnums=(1, 2))(a, cpos, srk)
    got = _port_update(a, cpos, BF16, srk)
    # XLA may contract a product and a sum into one FMA, which moves an f32
    # ulp before the rounding and can flip one bf16 ulp after it
    for w, g in zip(want, got):
        _assert_bf16_close(w, g)


@pytest.mark.parametrize("salt", [0, 77, 2**32 - 1])
def test_sround_matches_jax(salt):
    rng = np.random.default_rng(salt % 1000)
    x = (rng.standard_normal((3, 8, 481)) * np.exp(rng.uniform(-20, 5, (3, 8, 481)))
         ).astype(np.float32)
    x[0, 0, :4] = [0.0, -0.0, 1.0, -1.0]
    want = _sround_bf16(jnp.asarray(x), jnp.uint32(salt))
    got = kernels.sround_bf16(torch.from_numpy(x), salt)
    np.testing.assert_array_equal(
        _bits(got), np.asarray(jax.lax.bitcast_convert_type(want, jnp.uint16)).astype(np.int32))


def test_wrapper_rejects_other_devices():
    x = torch.zeros((2, 480), device="meta")
    z = torch.zeros((2,), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        kernels.fused_volume(x, z, z, z, z)


def test_build_keeps_nvcc_output_beside_the_library(tmp_path, monkeypatch):
    """A library built once is not built again, and its build's output
    (the -Xptxas -v report phase 1 reads) comes back with it."""
    import sys
    from pathlib import Path
    fake = tmp_path / "nvcc"
    runs = tmp_path / "runs"
    fake.write_text(f"#!{sys.executable}\n"
                    "import sys\n"
                    f"open({str(runs)!r}, 'a').write('x')\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n"
                    "print('ptxas info    : Used 10 registers')\n")
    fake.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("// a source\n")
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    first = kernels._build_one(Path(src))
    second = kernels._build_one(Path(src))
    assert first == second and first[0].exists()
    assert "Used 10 registers" in second[1]
    assert runs.read_text() == "x"
