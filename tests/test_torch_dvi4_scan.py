"""The algebra of the DVI4 kernels (``csrc/adpcm_kernels.cu``) on the CPU,
where the CUDA kernels cannot run: torch models of the kernels' order of
work, held bit for bit (tolerance 0: integer codec) to the plain versions
``dvi4_decode_reference`` / ``dvi4_encode_reference``, which
``tests/test_torch_adpcm.py`` holds to the JAX package.

- The decoder's model: a tick in chunks of W lanes; two Kogge-Stone scans a
  chunk over clamped-add maps x -> min(max(x + a, lo), hi), written as
  triples (a, lo, hi) (the index triples (adj(code), 0, 88), then the pred
  triples (+-vpdiff, -32768, 32767)); identity triples on lanes past S;
  the last lane's index and pred carried into the next chunk.
- The encoder's model: the three compare-and-subtract rounds give delta
  and vpdiff, and the next step is selected by delta from the five steps
  the next index can take, read before delta is known. Beside it, the
  seven thresholds' count, the quantizer's other bit-exact form, is held
  to the rounds at every step.

Both run at W = 16 and 32 lanes, on ticks of S = 1, 7, 31, 32, 33, 80 and 200
samples with the state carried, on speech and on ``chip_smoke.py``'s clamp
fixtures, which reach pred -32768 and 32767 and index 0 and 88. Those
fixtures go through the JAX package too."""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mediastreamer2_tpu.ops import adpcm as ja  # noqa: E402
from mediastreamer2_tpu_torch.ops import kernels  # noqa: E402
from mediastreamer2_tpu_torch.ops.adpcm import dvi4_tables  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEGS = 8                    # enough legs for every clamp in 240 samples
SAMPLES = 240               # a fixture's length, cut into ticks of S
TICK_SIZES = (1, 7, 31, 32, 33, 80, 200)
LANES = (16, 32)
STEP, ADJ = dvi4_tables("cpu")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)              # defines only; main() needs a card
    return mod


def _zeros():
    return torch.zeros(LEGS, dtype=torch.int32), torch.zeros(LEGS, dtype=torch.int32)


def _ticks(x, S):
    """[B, n] -> ticks of S samples (the last one shorter)."""
    return [x[:, j:j + S].contiguous() for j in range(0, x.shape[1], S)]


def _clamp(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def clamp_scan(a, lo, hi):
    """Inclusive Kogge-Stone scan of (a, lo, hi) [B, W] over the W lanes, in
    the kernel's order: at offset d, lane i >= d composes lane i - d's map
    (first) with its own."""
    W = a.shape[1]
    d = 1
    while d < W:
        pa, pl, ph = (torch.cat([t[:, :d], t[:, :-d]], dim=1) for t in (a, lo, hi))
        take = torch.arange(W) >= d
        a, lo, hi = (torch.where(take, new, old) for new, old in (
            (pa + a, a), (_clamp(pl + a, lo, hi), lo), (_clamp(ph + a, lo, hi), hi)))
        d *= 2
    return a, lo, hi


def decode_scan_model(codes, pred, index, W):
    """The decoder's order: codes [B, S] -> pcm [B, S]; ``pred`` and
    ``index`` updated in place."""
    B, S = codes.shape
    full = lambda v: torch.full((B, W), v, dtype=torch.int32)      # noqa: E731
    out = []
    for j0 in range(0, S, W):
        n = min(W, S - j0)
        code = torch.cat([codes[:, j0:j0 + n], torch.zeros((B, W - n), dtype=torch.int32)], 1)
        valid = torch.arange(W) < n
        ia, il, ih = clamp_scan(torch.where(valid, ADJ[code & 7], 0), full(0), full(88))
        after = _clamp(index[:, None] + ia, il, ih)
        before = torch.cat([index[:, None], after[:, :-1]], dim=1)
        index.copy_(after[:, -1])
        step = STEP[before]
        delta = code & 7
        vpdiff = ((step >> 3) + torch.where((delta & 4) != 0, step, 0)
                  + torch.where((delta & 2) != 0, step >> 1, 0)
                  + torch.where((delta & 1) != 0, step >> 2, 0))
        v = torch.where(valid, torch.where((code & 8) != 0, -vpdiff, vpdiff), 0)
        pa, pl, ph = clamp_scan(v, full(-32768), full(32767))
        p = _clamp(pred[:, None] + pa, pl, ph)
        pred.copy_(p[:, -1])
        out.append(p[:, :n])
    return torch.cat(out, dim=1)


def encode_model(pcm, pred, index):
    """The encoder's order: pcm [B, S] -> codes [B, S]; ``pred`` and
    ``index`` updated in place."""
    step = STEP[index]
    out = []
    for j in range(pcm.shape[1]):
        # the steps of the five indices the next sample can have
        cand = STEP[torch.clamp(index[:, None] + torch.tensor([-1, 2, 4, 6, 8]), 0, 88)]
        diff = pcm[:, j] - pred
        rest, vpdiff, delta = diff.abs(), step >> 3, torch.zeros_like(step)
        for bit, s in ((4, step), (2, step >> 1), (1, step >> 2)):
            b = rest >= s
            rest, vpdiff = torch.where(b, rest - s, rest), torch.where(b, vpdiff + s, vpdiff)
            delta = delta | torch.where(b, bit, 0)
        pred.copy_(torch.clamp(torch.where(diff < 0, pred - vpdiff, pred + vpdiff),
                               -32768, 32767))
        index.copy_(torch.clamp(index + torch.where(delta < 4, -1, 2 * delta - 6), 0, 88))
        step = cand.gather(1, torch.clamp(delta - 3, min=0)[:, None].long())[:, 0]
        assert torch.equal(step, STEP[index])
        out.append(torch.where(diff < 0, 8, 0).to(torch.int32) | delta)
    return torch.stack(out, dim=1)


def _signals(smoke):
    """{name: (int32 [LEGS, SAMPLES], direction)}: speech and the square wave
    through the encoder, random codes through the decoder."""
    return {"speech": (smoke.speech_fixture(LEGS, SAMPLES, seed=4), "encode"),
            "square": (smoke.dvi4_square_fixture(LEGS, SAMPLES), "encode"),
            "random codes": (smoke.dvi4_clamp_codes(LEGS, SAMPLES, seed=7), "decode")}


@pytest.mark.parametrize("S", TICK_SIZES)
@pytest.mark.parametrize("W", LANES)
@pytest.mark.parametrize("signal", ["speech", "square", "random codes"])
def test_decode_scan_model_equals_plain(smoke, signal, W, S):
    """The scans decode the encoder's codes of speech and of the square wave,
    and random codes, to the plain decoder's samples, pred and index after
    every tick."""
    x, direction = _signals(smoke)[signal]
    x = torch.from_numpy(x)
    if direction == "encode":
        x = kernels.dvi4_encode_reference(x, *_zeros())[0]
    st_m, st_p = _zeros(), _zeros()
    for t, codes in enumerate(_ticks(x, S)):
        got = decode_scan_model(codes, *st_m, W)
        want = kernels.dvi4_decode_reference(codes, *st_p)[0]
        assert torch.equal(got, want), (signal, W, S, t)
        assert all(torch.equal(a, b) for a, b in zip(st_m, st_p)), (signal, W, S, t)


@pytest.mark.parametrize("S", TICK_SIZES)
@pytest.mark.parametrize("signal", ["speech", "square"])
def test_encode_model_equals_plain(smoke, signal, S):
    """The rounds and the selected next step give the plain encoder's
    codes, pred and index after every tick."""
    x = torch.from_numpy(_signals(smoke)[signal][0])
    st_m, st_p = _zeros(), _zeros()
    for t, pcm in enumerate(_ticks(x, S)):
        got = encode_model(pcm, *st_m)
        want = kernels.dvi4_encode_reference(pcm, *st_p)[0]
        assert torch.equal(got, want), (signal, S, t)
        assert all(torch.equal(a, b) for a, b in zip(st_m, st_p)), (signal, S, t)


def test_threshold_count_equals_the_three_rounds_at_every_step():
    """For each of the 89 steps and every |diff| up to 70,000: the count of
    the thresholds reached is the rounds' delta, and step >> 3 plus the steps
    between them is the rounds' vpdiff."""
    mag = torch.arange(0, 70001, dtype=torch.int32)[None]
    step = STEP[:, None]
    h, q = step >> 1, step >> 2
    thr = (q, h, h + q, step, step + q, step + h, step + h + q)
    inc = (q, h - q, q, step - h - q, q, h - q, q)
    delta = sum((mag >= t).to(torch.int32) for t in thr)
    vpdiff = (step >> 3) + sum(torch.where(mag >= t, i, 0) for t, i in zip(thr, inc))
    rest, want_v = mag.expand(89, -1), (step >> 3).expand(89, -1)
    bits = []
    for s in (step, h, q):
        b = rest >= s
        rest, want_v = torch.where(b, rest - s, rest), torch.where(b, want_v + s, want_v)
        bits.append(b.to(torch.int32))
    assert torch.equal(delta, (bits[0] << 2) | (bits[1] << 1) | bits[2])
    assert torch.equal(vpdiff, want_v)


def test_clamp_scan_composes_clamped_adds():
    """A lane's scanned triple, applied to any start, equals its lanes' maps
    applied one after another, with the limits driven past by large adds."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-70000, 70000, (64, 32)).astype(np.int32))
    lo = torch.from_numpy(rng.integers(-40000, 0, (64, 32)).astype(np.int32))
    hi = lo + torch.from_numpy(rng.integers(0, 60000, (64, 32)).astype(np.int32))
    x0 = torch.from_numpy(rng.integers(-50000, 50000, 64).astype(np.int32))
    sa, sl, sh = clamp_scan(a, lo, hi)
    x = x0
    for i in range(32):
        x = _clamp(x + a[:, i], lo[:, i], hi[:, i])
        assert torch.equal(_clamp(x0 + sa[:, i], sl[:, i], sh[:, i]), x), i


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_clamp_fixtures_reach_every_clamp(smoke, direction):
    """The square wave then silence (through the encoder) and the random codes
    (through the decoder) reach pred -32768 and 32767 and index 0 and 88 on
    LEGS legs, as chip_smoke.py asserts at 1,024: the outputs reach the
    values themselves."""
    zeros = _zeros()
    if direction == "encode":
        codes = kernels.dvi4_encode_reference(
            torch.from_numpy(smoke.dvi4_square_fixture(LEGS, SAMPLES)), *_zeros())[0]
    else:
        codes = torch.from_numpy(smoke.dvi4_clamp_codes(LEGS, SAMPLES, seed=7))
    hits = smoke.dvi4_clamp_hits(codes, *zeros)
    assert set(hits) == set(smoke.DVI4_CLAMPS) and min(hits.values()) > 0, hits
    pcm = kernels.dvi4_decode_reference(codes, *_zeros())[0]
    assert int(pcm.min()) == -32768 and int(pcm.max()) == 32767


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_clamp_fixtures_match_the_jax_package(smoke, direction):
    """The plain versions on the clamp fixtures, two ticks of 120 samples,
    equal the JAX package's adpcm_encode / adpcm_decode in output and
    state."""
    if direction == "encode":
        x = smoke.dvi4_square_fixture(LEGS, SAMPLES)
        jfn, pfn = ja.adpcm_encode, kernels.dvi4_encode_reference
    else:
        x = smoke.dvi4_clamp_codes(LEGS, SAMPLES, seed=7)
        jfn, pfn = ja.adpcm_decode, kernels.dvi4_decode_reference
    jst = (np.zeros(LEGS, np.int32), np.zeros(LEGS, np.int32))
    pst = _zeros()
    for block in (x[:, :120], x[:, 120:]):
        jout, *jst = jfn(block, *jst)
        pout = pfn(torch.from_numpy(np.ascontiguousarray(block)), *pst)[0]
        np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))
        for a, b in zip(pst, jst):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_empty_tick_leaves_the_state(direction):
    """A tick of no samples gives an empty output and leaves pred and index
    as they were, as the kernels do (and as JAX's scan of length 0)."""
    fn = getattr(kernels, f"dvi4_{direction}_reference")
    pred = torch.tensor([5, -7], dtype=torch.int32)
    index = torch.tensor([0, 88], dtype=torch.int32)
    out, p, ix = fn(torch.zeros((2, 0), dtype=torch.int32), pred.clone(), index.clone())
    assert out.shape == (2, 0) and out.dtype == torch.int32
    assert torch.equal(p, pred) and torch.equal(ix, index)
    jout, jp, jix = getattr(ja, f"adpcm_{direction}")(np.zeros((2, 0), np.int32),
                                                      pred.numpy(), index.numpy())
    assert np.asarray(jout).shape == (2, 0)
    np.testing.assert_array_equal(np.asarray(jp), pred.numpy())
    np.testing.assert_array_equal(np.asarray(jix), index.numpy())
