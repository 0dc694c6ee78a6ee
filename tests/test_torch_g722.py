"""The port's G.722 codec (``ops/g722.py``; the plain versions of its CUDA
kernels in ``ops/kernels.py``) against the ITU vectors and the JAX
package on the CPU. Every comparison is exact (integer codec: tolerance 0),
except the recordings of the stream test, which pass through float PCM:
there the wire codes are held equal and the recordings to audio_diff >=
0.999 and 1e-6 absolute."""
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mediastreamer2_tpu.core.block import Format as JFormat  # noqa: E402
from mediastreamer2_tpu.core.graph import GraphBuilder as JGraphBuilder  # noqa: E402
from mediastreamer2_tpu.core.ticker import Ticker as JTicker  # noqa: E402
from mediastreamer2_tpu.models import audio_stream as j_as  # noqa: E402
from mediastreamer2_tpu.net import rtp as j_rtp  # noqa: E402
from mediastreamer2_tpu.ops import g722 as jg  # noqa: E402
from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder  # noqa: E402
from mediastreamer2_tpu_torch.core.ticker import Ticker  # noqa: E402
from mediastreamer2_tpu_torch.models import audio_stream as t_as  # noqa: E402
from mediastreamer2_tpu_torch.net import rtp as t_rtp  # noqa: E402
from mediastreamer2_tpu_torch.ops import g722 as tg  # noqa: E402
from mediastreamer2_tpu_torch.ops import kernels  # noqa: E402
from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff  # noqa: E402
from mediastreamer2_tpu_torch.utils.convert import to_numpy  # noqa: E402
from mediastreamer2_tpu_torch.utils.signals import make_speechlike  # noqa: E402

_VEC = np.load(os.path.join(os.path.dirname(__file__), "data", "g722_vectors.npz"))
S16 = 160          # samples a tick at 16 kHz
C = 80             # code slots a tick


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_same_state(jst, tst):
    want = dict(_leaves({k: np.asarray(v) if not isinstance(v, dict) else
                         {kk: np.asarray(vv) for kk, vv in v.items()}
                         for k, v in jst.items()}))
    got = dict(_leaves(to_numpy(tst)))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.int32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_plain_versions_match_itu_vectors(direction):
    """The slot loop in torch int32 against the vectors of the reference's
    bundled ITU g722_encode.c / g722_decode.c (3,200 samples), bit for bit."""
    if direction == "encode":
        got, _ = kernels.g722_encode_reference(
            torch.from_numpy(_VEC["pcm"].astype(np.int32)[None]), tg.g722_state(1, "cpu"))
        want = _VEC["code"]
    else:
        got, _ = kernels.g722_decode_reference(
            torch.from_numpy(_VEC["code"].astype(np.int32)[None]), tg.g722_state(1, "cpu"))
        want = _VEC["dec"]
    np.testing.assert_array_equal(got[0].numpy(), want.astype(np.int32))


# the 10 ms tick (80 slots, 4 legs), and at 3 legs ticks of 1 slot and of 7
# (the new delay line still holds samples of the one before: JAX's is the
# last 24 of concat(x[2:], new) slot by slot) and of 160 (longer than the
# kernels' chunk of slots staged at a time)
@pytest.mark.parametrize("direction,B,slots", [
    pytest.param("encode", 4, C, id="encode"), pytest.param("decode", 4, C, id="decode")]
    + [pytest.param(d, 3, n, id=f"{d}-C{n}") for n in (1, 7, 160) for d in ("encode", "decode")])
def test_three_ticks_match_jax_with_state_carried(direction, B, slots):
    """Three ticks through JAX's g722_encode / g722_decode and the port's
    wrappers (their plain versions here, decomposed as the kernels are: the
    QMF of the whole tick in one pass), state carried across: the same codes
    or samples, and the same state leaf by leaf through utils/convert.py."""
    ticks = 3
    if direction == "encode":
        data = np.random.default_rng(1).integers(-30000, 30000, (B, 2 * slots * ticks))
        data, width, jfn, tfn = data.astype(np.int32), 2 * slots, jg.g722_encode, tg.g722_encode
    else:
        data = np.random.default_rng(2).integers(0, 256, (B, slots * ticks)).astype(np.int32)
        width, jfn, tfn = slots, jg.g722_decode, tg.g722_decode
    jst, tst = jg.g722_state(B), tg.g722_state(B, "cpu")
    for t in range(ticks):
        blk = data[:, t * width:(t + 1) * width]
        jout, jst = jfn(jnp.asarray(blk), jst)
        tout, tst = tfn(torch.from_numpy(blk.copy()), tst)
        assert tout.dtype == torch.int32
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    _assert_same_state(jst, tst)


def test_batch_independence():
    """Each leg's state advances on its own: the ITU vector on leg 0 still
    encodes bit for bit beside two other signals."""
    pcm = _VEC["pcm"].astype(np.int32)
    batch = np.stack([pcm, np.roll(pcm, 160), pcm // 2])
    codes, _ = tg.g722_encode(torch.from_numpy(batch), tg.g722_state(3, "cpu"))
    np.testing.assert_array_equal(codes[0].numpy(), _VEC["code"].astype(np.int32))
    assert (codes[2] != codes[0]).any()


def test_wrappers_launch_nothing_on_the_cpu_and_refuse_other_devices():
    kernels.reset_launch_counts()
    codes, st = tg.g722_encode(torch.zeros((2, S16), dtype=torch.int32), tg.g722_state(2, "cpu"))
    tg.g722_decode(codes, st)
    assert kernels.launch_counts()["g722_encode"] == 0
    assert kernels.launch_counts()["g722_decode"] == 0
    with pytest.raises(RuntimeError, match="no kernel"):
        tg.g722_encode(torch.zeros((1, S16), dtype=torch.int32, device="meta"),
                       tg.g722_state(1, "meta"))



def test_state_resolves_its_device_as_every_entry_point():
    """``g722_state(B)`` with no device lands on the card, as every entry
    point's ``device=None`` does (``core/ticker.resolve_device``), and
    raises where there is none."""
    if torch.cuda.is_available():
        assert tg.g722_state(1)["x"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tg.g722_state(1)

def test_filters_halve_and_double_the_rate():
    """g722_enc's output runs at half the input rate (one code per 8 kHz
    slot), g722_dec's at twice its input's (the RFC 3551 PT 9 clock)."""
    g = GraphBuilder(Factory(), batch=1)
    src = g.add("ext_source", "in", fmt=Format(rate=16000))
    enc, dec = g.add("g722_enc", "enc"), g.add("g722_dec", "dec")
    g.chain(src, enc, dec, g.add("ext_sink", "out"))
    cg = g.build()
    fmts = {cg.nodes[i].name: cg.out_formats[i][0] for i in range(len(cg.nodes))
            if cg.out_formats[i]}
    assert (fmts["enc"].kind, fmts["enc"].rate) == ("g722", 8000)
    assert (fmts["dec"].kind, fmts["dec"].rate) == ("pcm", 16000)


def test_g722_stream_over_rtp(factory):
    """Port of tests/test_g722.py::test_g722_stream_over_rtp with do_tick:
    16 kHz audio over PT 9 on the 8 kHz RTP clock. The wire codes of both
    packages are equal, tick by tick; the recordings agree (audio_diff >=
    0.999, 1e-6 absolute) and carry the signal (> 0.9)."""
    ticks = 60
    sig = make_speechlike(S16 * ticks, 16000, seed=5)

    def call(mod, rtp, fac, **kw):
        tx = mod.AudioStreamBatch(fac, 1, codec="g722", rate=16000, mic_signal=sig, **kw)
        rx = mod.AudioStreamBatch(fac, 1, codec="g722", rate=16000, record_ticks=ticks + 30,
                                  **kw)
        pair = rtp.LoopbackPair()
        tx.set_transport(0, pair.endpoint(0))
        rx.set_transport(0, pair.endpoint(1))
        assert tx.sessions[0].clock_rate == 8000 and tx.S_rtp == 80      # the quirk
        codes = []
        push = tx.ticker._io_push
        tx.ticker.set_io(pull=tx.ticker._io_pull,
                         push=lambda t, out: (codes.append(np.asarray(out["rtp_tx"]).copy()),
                                              push(t, out)))
        for s in (tx, rx):
            s.ticker.realtime = False
            s.ticker.warm_up()
        for _ in range(ticks + 10):
            tx.ticker.do_tick()
            rx.ticker.do_tick()
        for _ in range(20):
            rx.ticker.do_tick()
        return np.stack(codes), rx.get_recording()[0]
    jcodes, jrec = call(j_as, j_rtp, factory)
    tcodes, trec = call(t_as, t_rtp, Factory(), device="cpu")
    np.testing.assert_array_equal(tcodes, jcodes)
    assert audio_diff(jrec, trec)[0] >= 0.999
    np.testing.assert_allclose(trec, jrec, rtol=0, atol=1e-6)
    assert audio_diff(sig, trec)[0] > 0.9


def _codec_graph(gb_cls, fmt_cls, fac, sig):
    g = gb_cls(fac, batch=2)
    p = g.add("file_player", "play", fmt=fmt_cls(rate=16000), signal=sig)
    enc, tee, dec = g.add("g722_enc", "enc"), g.add("tee", "tee"), g.add("g722_dec", "dec")
    g.chain(p, enc, tee)
    g.link(tee, 0, g.add("ext_sink", "codes"), 0)
    g.link(tee, 1, dec, 0)
    g.link(dec, 0, g.add("ext_sink", "out"), 0)
    return g.build()


def _jax_blob(tk):
    """A JAX Ticker's state as the port's save_state writes it: the JAX
    package's format (``node::leaf``) with the G.722 bands nested as
    ``node::band::leaf``. (The JAX package's own save_state stops at a
    nested state: it writes flat states only.)"""
    flat = {}
    for node, st in tk.state.items():
        for k, v in (st or {}).items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    flat[f"{node}::{k}::{kk}"] = np.asarray(vv)
            else:
                flat[f"{node}::{k}"] = np.asarray(v)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def _jax_load(tk, blob):
    """The port's blob into a JAX Ticker's state (at the next tick)."""
    data = np.load(io.BytesIO(blob))
    tree = {}
    for key in data.files:
        parts = key.split("::")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(data[key])

    def apply(t):
        t.state = {n: tree.get(n, st) for n, st in t.state.items()}
    tk.mutate(apply)


@pytest.mark.parametrize("way", ["jax_to_torch", "torch_to_jax"])
def test_save_state_crosses_packages(factory, way):
    """A G.722 codec state saved from one package's Ticker loads into the
    other's, and the next tick's codes and decoded samples are the same."""
    ticks = 4
    sig = make_speechlike(S16 * (ticks + 2), 16000, seed=8)
    jtk = JTicker(_codec_graph(JGraphBuilder, JFormat, factory, sig), realtime=False)
    ttk = Ticker(_codec_graph(GraphBuilder, Format, Factory(), sig), "cpu", realtime=False)
    src, dst = (jtk, ttk) if way == "jax_to_torch" else (ttk, jtk)
    src.run(ticks)
    if way == "jax_to_torch":
        ttk.load_state(_jax_blob(jtk))
    else:
        blob = ttk.save_state()
        assert "enc::lo::det" in np.load(io.BytesIO(blob)).files
        _jax_load(jtk, blob)
    want, got = src.do_tick(), dst.do_tick()
    np.testing.assert_array_equal(np.asarray(got["codes"]), np.asarray(want["codes"]))
    np.testing.assert_array_equal(np.asarray(got["out"]), np.asarray(want["out"]))
    assert np.abs(np.asarray(want["out"])).max() > 1e-3
