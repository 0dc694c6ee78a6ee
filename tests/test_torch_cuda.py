"""The port on a CUDA card against the port on the CPU, for code that has
no kernel of its own in the port. Marked ``cuda``: each test skips without
a card. On the card (without the test directory's conftest files, which
import JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _mixer_run(device, groups, params, xs):
    from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder
    B = xs.shape[1]
    g = GraphBuilder(Factory(), batch=B)
    g.chain(g.add("ext_source", "in", fmt=Format(rate=8000)), g.add("conf_mixer", "f"),
            g.add("ext_sink", "out"))
    cg = g.build()
    st, pr = cg.init_state(device), cg.init_params(device)
    for k, v in params.items():
        pr["f"][k] = torch.from_numpy(v).to(device)
    outs = []
    for t, x in enumerate(xs):
        pr["f"]["group_id"] = torch.from_numpy(groups[t]).to(device)
        st, o, _ = cg.step(st, pr, {"in": torch.from_numpy(x).to(device)})
        outs.append(o["out"].cpu())
    return torch.stack(outs)


@pytest.mark.cuda
def test_conf_mixer_segment_sum_on_the_card(card):
    """conf_mixer's segment-sum branch at 1,024 legs on the card equals the
    CPU's (atol 1e-6): ragged, unsorted groups and lone legs, the
    membership changed every tick; two runs on the card are equal to the
    bit (no atomics)."""
    B, S, ticks = 1024, 80, 3
    rng = np.random.default_rng(21)
    groups = [rng.integers(0, B // (3 + t), B).astype(np.int32) for t in range(ticks)]
    for g in groups:
        g[rng.choice(B, 20, replace=False)] = B - 1 - np.arange(20)     # lone legs
    params = {"gain": rng.uniform(0.5, 1.5, B).astype(np.float32),
              "active": rng.uniform(size=B) < 0.8,
              "mix_minus": rng.uniform(size=B) < 0.8,
              "out_gain": rng.uniform(0.5, 2.0, B).astype(np.float32)}
    xs = rng.uniform(-0.3, 0.3, (ticks, B, S)).astype(np.float32)
    want = _mixer_run(torch.device("cpu"), groups, params, xs)
    got = _mixer_run(card, groups, params, xs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert torch.equal(_mixer_run(card, groups, params, xs), got)


# the echo canceller's DFTs at the flagship's shapes (ops/rfft.py): the
# overlap-save pair at n = 960 and the suppressor's at n = 480
FLAGSHIP_DFTS = [("rfft", 960), ("irfft_tail", 960), ("rfft_tail", 960),
                 ("apply_constraint", 960), ("rfft", 480), ("irfft", 480)]
DFT_ROWS, DFT_SHARD = 4096, 1024


def _dft_case(name, n, rows, device):
    """(the transform, its arguments at ``rows`` rows on ``device``);
    spectra's DC and Nyquist imaginary parts are far from zero."""
    from mediastreamer2_tpu_torch.ops import rfft
    g = torch.Generator().manual_seed(22)
    rnd = lambda *shape: torch.randn(shape, generator=g).to(device)
    f = n // 2 + 1
    im = rnd(rows, f)
    im[:, 0], im[:, -1] = 3.0, -2.0
    spec = (rnd(rows, f), im)
    return {"rfft": (lambda x: rfft.rfft(x, n), (rnd(rows, n),)),
            "irfft": (lambda r, i: rfft.irfft(r, i, n), spec),
            "rfft_tail": (lambda x: rfft.rfft_tail(x, n), (rnd(rows, n // 2),)),
            "irfft_tail": (lambda r, i: rfft.irfft_tail(r, i, n), spec),
            "apply_constraint": (lambda r, i: rfft.apply_constraint(r, i, n), spec)}[name]


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", FLAGSHIP_DFTS)
def test_dft_rows_on_the_card_do_not_depend_on_the_batch(card, name, n):
    """Each DFT at 4,096 rows equals, bit for bit, the same rows run as
    1,024-row calls at offsets 0, 1,024, 2,048 and 3,072 (a shard's rows),
    by the FFT path."""
    from mediastreamer2_tpu_torch.ops import rfft
    fn, args = _dft_case(name, n, DFT_ROWS, card)
    before = rfft.calls["fft"]
    full = _outs(fn(*args))
    assert rfft.calls["fft"] == before + 1
    for off in range(0, DFT_ROWS, DFT_SHARD):
        part = _outs(fn(*(a[off:off + DFT_SHARD].clone() for a in args)))
        for p, f in zip(part, full):
            differ = (p.contiguous().view(torch.int32)
                      != f[off:off + DFT_SHARD].contiguous().view(torch.int32)).any(dim=-1)
            assert not bool(differ.any()), \
                f"{name} n={n}: rows {(off + differ.nonzero()[:, 0]).tolist()[:10]} differ"


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", FLAGSHIP_DFTS)
def test_dft_ffts_on_the_card_match_the_products(card, monkeypatch, name, n):
    """Each DFT's FFT is within 3e-6 of each row's peak of the basis
    product on the card (the DC and Nyquist imaginary parts, which the
    product ignores, far from zero)."""
    from mediastreamer2_tpu_torch.ops import rfft
    fn, args = _dft_case(name, n, DFT_SHARD, card)
    got = _outs(fn(*args))
    monkeypatch.setattr(rfft, "_fft_on", lambda t: False)
    want = _outs(fn(*args))
    peak = torch.stack([w.abs().amax(dim=-1) for w in want]).amax(dim=0)[:, None]
    err = max(float(((g - w).abs() / peak).max()) for g, w in zip(got, want))
    assert err <= 3e-6, f"{name} n={n}: {err:.3e} of the row's peak"


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", [("irfft_tail", 960), ("apply_constraint", 960),
                                    ("irfft", 480)])
def test_dft_c2r_on_the_card_ignores_dc_and_nyquist_imaginary_parts(card, name, n):
    """The complex-to-real transforms give the same bits with and without
    the imaginary parts of bins 0 and n/2, as the product does."""
    fn, (re, im) = _dft_case(name, n, DFT_SHARD, card)
    zeroed = im.clone()
    zeroed[:, [0, -1]] = 0.0
    for a, b in zip(_outs(fn(re, im)), _outs(fn(re, zeroed))):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [481, 241, 81])
def test_dft_layout_kernels_equal_their_plain_versions(card, F):
    """The FFT path's two layout passes on the card equal their plain
    versions bit for bit: complex spectra to planes (with and without the
    alternating sign) and planes to an unnormalised complex-to-real input
    (scaled by 1/n, DC and Nyquist imaginary parts zeroed, n even and odd)."""
    from mediastreamer2_tpu_torch.ops import kernels
    g = torch.Generator().manual_seed(23)
    re, im = (torch.randn((1000, F), generator=g).to(card) for _ in range(2))
    z = torch.complex(re, im)
    for alternate in (False, True):
        got = kernels.spectrum_planes(z, alternate)
        want = kernels.spectrum_planes_reference(z, alternate)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert got[0].is_contiguous() and got[1].is_contiguous()
    for n in (2 * F - 2, 2 * F - 1):
        got = kernels.planes_spectrum(re, im, n)
        assert torch.equal(got, kernels.planes_spectrum_reference(re, im, n))


@pytest.mark.cuda
def test_suppress_gain_equals_its_plain_version(card):
    """The suppressor's gain on the card equals, bit for bit, the plain
    PyTorch operations it replaces, silent error spectra included, with
    the gain at its floor, at one and between."""
    from mediastreamer2_tpu_torch.ops import aec, kernels
    B, F = 2048, 241
    g = torch.Generator().manual_seed(25)
    planes = [torch.randn((B, F), generator=g) * torch.exp(-6 * torch.rand((B, 1), generator=g))
              for _ in range(4)]
    planes[0][::7] = 0.0                    # silent error spectra
    planes[1][::7] = 0.0
    planes[2][1::5] = 0.0                   # no echo estimate: a gain of one
    planes[3][1::5] = 0.0
    leak = torch.rand(B, generator=g).clamp(0.01, 1.0)
    args = [t.to(card) for t in planes + [leak]]
    consts = (aec.SUPPRESS_BETA, aec.SUPPRESS_FLOOR)
    got = kernels.suppress_gain(*args, *consts)
    want = kernels.suppress_gain_reference(*args, *consts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    live = args[0] != 0
    gain = got[0][live] / args[0][live]
    assert bool((gain == 1.0).any()) and bool((gain < 0.16).any())
    assert bool(((gain > 0.2) & (gain < 0.9)).any())


# aec_decide's row lengths: the flagship's 48 kHz, the wideband and
# narrowband sessions', and 44.1 kHz, whose rows take the sample-by-sample
# path (441 samples are not whole float4s); 960 (48 kHz stereo, 96 kHz)
# and 882 (44.1 kHz stereo), rows longer than the kernel's registers hold
DECIDE_S = [480, 160, 80, 441, 960, 882]
DECIDE_B = [1, 1024, 4096]
DECIDE_TICKS = 24


def _smoke():
    """chip_smoke.py's phase-2 helpers (its module defines only)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("suppress", [True, False], ids=["suppress", "no_suppress"])
@pytest.mark.parametrize("S", DECIDE_S)
def test_aec_decide_matches_its_plain_version(card, S, suppress):
    """aec_decide on the card against its plain version on the card, on
    echo-coupled legs of every kind (``chip_smoke.decide_args``: promoting,
    reseeding, diverging, silent, alike; 10% disabled) stepped from the
    same state each tick (the plain version's) for DECIDE_TICKS ticks at
    1, 1,024 and 4,096 legs: flags, counters and e_s equal on every leg, the
    rest within rtol 1e-5 (``chip_smoke.check_decide``: PyTorch's
    reductions sum a leg's squares in another order), and at 4,096 legs
    every flag raised on some leg. Each 4,096-row call equals, bit for bit,
    its rows run as 1,024-row calls at the four offsets."""
    from mediastreamer2_tpu_torch.ops import aec, kernels
    smoke = _smoke()
    fn = lambda *a: tuple(o for o in kernels.aec_decide(*a, aec.DECIDE, suppress)
                          if o is not None)
    for B in DECIDE_B:
        g = torch.Generator(device=card).manual_seed(26 + B + S)
        rows = smoke.decide_args(g, B, S)[3:-1]
        raised = torch.zeros(3, dtype=torch.int64, device=card)
        before = kernels.aec_decide.launches
        for t in range(DECIDE_TICKS):
            fresh = smoke.decide_args(g, B, S)
            args = (*fresh[:3], *rows, fresh[-1])
            _, want = smoke.check_decide(kernels, f"B={B} S={S} tick {t}", args, suppress)
            raised += torch.stack([f.bool().sum() for f in want[-3:]])
            if B == DECIDE_B[-1]:
                smoke._slices_equal(f"aec_decide B={B} S={S} tick {t}", fn, args)
            rows = want[3:3 + len(kernels.DECIDE_ROWS)]
        assert kernels.aec_decide.launches - before == DECIDE_TICKS * (
            6 if B == DECIDE_B[-1] else 1)
        if B == DECIDE_B[-1]:
            assert bool((raised > 0).all()), f"S={S}: flags raised {raised.tolist()}"
