"""The port's DVI4 codec (``ops/adpcm.py``; the plain versions of its CUDA
kernels in ``ops/kernels.py``) against CPython's ``audioop`` and the JAX
package on the CPU. Integer codec: every comparison of codes, samples and
state is exact (tolerance 0); the graph round trip goes through float PCM
and is held to the JAX test's bar (audio_diff > 0.9, shift 0)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mediastreamer2_tpu.ops import adpcm as ja  # noqa: E402
from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder, tick_samples  # noqa: E402
from mediastreamer2_tpu_torch.core.ticker import Ticker  # noqa: E402
from mediastreamer2_tpu_torch.ops import adpcm as ta  # noqa: E402
from mediastreamer2_tpu_torch.ops import kernels  # noqa: E402
from mediastreamer2_tpu_torch.ops.fileio import recorder_get_audio  # noqa: E402
from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff  # noqa: E402
from mediastreamer2_tpu_torch.utils.convert import from_jax, to_numpy  # noqa: E402
from mediastreamer2_tpu_torch.utils.signals import make_speechlike  # noqa: E402

audioop = pytest.importorskip("audioop")
S = 80


def _zeros(B):
    return torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32)


def test_tables_equal_the_jax_package():
    step, index = ta.dvi4_tables("cpu")
    np.testing.assert_array_equal(step.numpy(), ja._STEP_TABLE)
    np.testing.assert_array_equal(index.numpy(), ja._INDEX_TABLE)
    assert step.dtype == torch.int32 and len(step) == 89


def test_encode_matches_audioop():
    sig = make_speechlike(1600, 8000, seed=1)
    pcm = np.clip(np.round(sig * 32768), -32768, 32767).astype(np.int32)
    codes, _, _ = ta.adpcm_encode(torch.from_numpy(pcm[None]), *_zeros(1))
    ref_bytes, _ = audioop.lin2adpcm(pcm.astype("<i2").tobytes(), 2, None)
    ref = np.frombuffer(ref_bytes, np.uint8)
    ref_codes = np.empty(len(ref) * 2, np.uint8)
    ref_codes[0::2] = ref >> 4
    ref_codes[1::2] = ref & 0xF
    np.testing.assert_array_equal(codes[0].numpy(), ref_codes)


def test_decode_matches_audioop():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16, 400).astype(np.int32)
    dec, _, _ = ta.adpcm_decode(torch.from_numpy(codes[None]), *_zeros(1))
    packed = bytes((int(codes[i]) << 4) | int(codes[i + 1]) for i in range(0, len(codes), 2))
    ref, _ = audioop.adpcm2lin(packed, 2, None)
    np.testing.assert_array_equal(dec[0].numpy().astype(np.int16), np.frombuffer(ref, "<i2"))


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_ticks_match_jax_with_state_carried(direction):
    """Five ticks of 4 legs through the JAX package and the port, each from
    the state the last tick left: codes or samples, ``pred`` and ``index``
    bit-equal after every tick (full-scale noise saturates the predictor)."""
    rng = np.random.default_rng(5)
    B, ticks = 4, 5
    if direction == "encode":
        data = rng.integers(-32768, 32768, (B, S * ticks)).astype(np.int32)
        jfn, tfn = ja.adpcm_encode, ta.adpcm_encode
    else:
        data = rng.integers(0, 16, (B, S * ticks)).astype(np.int32)
        jfn, tfn = ja.adpcm_decode, ta.adpcm_decode
    jp, ji = jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32)
    tp, ti = _zeros(B)
    for t in range(ticks):
        blk = data[:, t * S:(t + 1) * S]
        jo, jp, ji = jfn(jnp.asarray(blk), jp, ji)
        to, tp2, ti2 = tfn(torch.from_numpy(blk.copy()), tp, ti)
        assert tp2 is tp and ti2 is ti                 # updated in place
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert to.dtype == tp.dtype == ti.dtype == torch.int32


def test_tick_by_tick_equals_one_shot():
    rng = np.random.default_rng(6)
    pcm = rng.integers(-20000, 20000, (3, S * 6)).astype(np.int32)
    one, p1, i1 = kernels.dvi4_encode_reference(torch.from_numpy(pcm), *_zeros(3))
    p, i = _zeros(3)
    parts = [kernels.dvi4_encode(torch.from_numpy(pcm[:, k * S:(k + 1) * S].copy()), p, i)[0]
             for k in range(6)]
    assert torch.equal(torch.cat(parts, dim=1), one)
    assert torch.equal(p, p1) and torch.equal(i, i1)
    dec_one, _, _ = kernels.dvi4_decode_reference(one, *_zeros(3))
    p, i = _zeros(3)
    parts = [kernels.dvi4_decode(one[:, k * S:(k + 1) * S].contiguous(), p, i)[0]
             for k in range(6)]
    assert torch.equal(torch.cat(parts, dim=1), dec_one)


def test_dvi4_graph_roundtrip():
    B, ticks = 3, 60
    sig = make_speechlike(S * ticks, 8000, seed=7)
    g = GraphBuilder(Factory(), batch=B)
    p = g.add("file_player", "play", fmt=Format(rate=8000), signal=sig)
    g.chain(p, g.add("dvi4_enc", "enc"), g.add("dvi4_dec", "dec"),
            g.add("file_recorder", "rec", max_ticks=ticks))
    cg = g.build()
    st, _, _ = cg.run_scan(cg.init_state("cpu"), cg.init_params("cpu"), {}, length=ticks)
    rec = recorder_get_audio(st["rec"], ticks, S)
    sim, shift = audio_diff(sig, rec[0])
    assert sim > 0.9 and shift == 0
    assert cg.out_formats[1][0].kind == "dvi4"


def test_state_crosses_the_packages_both_ways():
    """A dvi4 state as a flat dict of int32 leaves: JAX -> port through
    ``from_jax``, port -> JAX through ``to_numpy``, dtype kept, and both
    packages continue equal from the carried state."""
    rng = np.random.default_rng(8)
    pcm = rng.integers(-25000, 25000, (2, S * 2)).astype(np.int32)
    _, jp, ji = ja.adpcm_encode(jnp.asarray(pcm[:, :S]), jnp.zeros(2, jnp.int32),
                                jnp.zeros(2, jnp.int32))
    st = from_jax({"pred": np.asarray(jp), "index": np.asarray(ji)}, "cpu")
    assert st["pred"].dtype == st["index"].dtype == torch.int32
    tc, _, _ = ta.adpcm_encode(torch.from_numpy(pcm[:, S:].copy()), st["pred"], st["index"])
    back = to_numpy(st)
    assert back["pred"].dtype == back["index"].dtype == np.int32
    jc, jp2, ji2 = ja.adpcm_encode(jnp.asarray(pcm[:, S:]), jp, ji)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(back["pred"], np.asarray(jp2))
    # and the other way: the port's state continues in JAX
    jc3, _, _ = ja.adpcm_encode(jnp.asarray(pcm[:, :S]), jnp.asarray(back["pred"]),
                                jnp.asarray(back["index"]))
    tc3, _, _ = ta.adpcm_encode(torch.from_numpy(pcm[:, :S].copy()), st["pred"], st["index"])
    np.testing.assert_array_equal(tc3.numpy(), np.asarray(jc3))


def test_ticker_save_load_state_resumes_a_dvi4_chain():
    """A new ticker restored from ``save_state`` continues exactly where
    the old one stopped, the codec's predictor included (equal samples)."""
    ticks = 40
    sig = np.sin(np.arange(S * ticks) / 3.0).astype(np.float32) * 0.5

    def run(tk, n, outs):
        tk.set_io(push=lambda t, o: outs.append(o["out"][0].copy()))
        tk.warm_up()
        tk.run(n)

    def build():
        g = GraphBuilder(Factory(), batch=1)
        p = g.add("file_player", "play", fmt=Format(rate=8000), signal=sig)
        g.chain(p, g.add("dvi4_enc"), g.add("dvi4_dec"), g.add("ext_sink", "out"))
        return Ticker(g.build(), device="cpu", realtime=False)

    outs_ref, outs = [], []
    run(build(), ticks, outs_ref)
    a = build()
    run(a, ticks // 2, outs)
    blob = a.save_state()
    b = build()
    b.load_state(blob)
    run(b, ticks - ticks // 2, outs)
    np.testing.assert_array_equal(np.concatenate(outs), np.concatenate(outs_ref))
    assert b.state["dvi4_enc#1"]["index"].dtype == torch.int32


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """On the CPU the wrappers run the plain versions; a tensor on neither
    the CPU nor CUDA raises (no silent path)."""
    meta = torch.zeros((1, S), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        kernels.dvi4_encode(meta, *_zeros(1))
    assert tick_samples(8000) == S
    assert {"dvi4_encode", "dvi4_decode"} <= set(kernels.launch_counts())
