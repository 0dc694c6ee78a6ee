"""The port's G.711 / L16 codecs against the JAX package, bit for bit: every
code, every 16-bit PCM value, and a dense float sweep with the ties of
``float_to_pcm16``'s rounding."""
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each, so that parallel test workers running
# real-time paced tests are not crowded by idle OpenMP threads
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mediastreamer2_tpu.ops import g711 as jg  # noqa: E402
from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder  # noqa: E402
from mediastreamer2_tpu_torch.ops import g711 as tg  # noqa: E402

ALL_PCM = np.arange(-32768, 32768, dtype=np.int32)
ALL_CODES = np.arange(256, dtype=np.int32)


def _same(port_fn, jax_fn, x):
    got = port_fn(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_fn(jnp.asarray(x)))
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("codec", ["ulaw", "alaw"])
def test_encode_every_pcm_value_and_decode_every_code(codec):
    codes = _same(getattr(tg, f"{codec}_encode"), getattr(jg, f"{codec}_encode"), ALL_PCM)
    assert codes.min() >= 0 and codes.max() <= 255
    pcm = _same(getattr(tg, f"{codec}_decode"), getattr(jg, f"{codec}_decode"), ALL_CODES)
    # decode then encode gives the code back (both zero codes decode to 0)
    back = getattr(tg, f"{codec}_encode")(torch.from_numpy(pcm)).numpy()
    same = back == ALL_CODES
    assert same.sum() >= 255


def test_float_to_pcm16_dense_sweep_and_ties():
    rng = np.random.default_rng(0)
    sweep = np.concatenate([
        np.linspace(-1.2, 1.2, 200_001, dtype=np.float32),
        rng.uniform(-1, 1, 50_000).astype(np.float32),
        # every +-0.5 LSB tie in [-1, 1]: round half to even in both
        (np.arange(-32768, 32768, dtype=np.float32) + 0.5) / 32768.0,
        (np.arange(-32768, 32768, dtype=np.float32) - 0.5) / 32768.0,
        np.array([-1.0, 1.0, 0.0, -0.0, 1.5, -1.5], np.float32),
    ])
    pcm = _same(tg.float_to_pcm16, jg.float_to_pcm16, sweep)
    assert pcm[-6:].tolist() == [-32768, 32767, 0, 0, 32767, -32768]
    # ties: 0.5 and 1.5 LSB round to the even neighbour, 0 and 2
    ties = torch.tensor([0.5, 1.5, -0.5, -1.5], dtype=torch.float32) / 32768.0
    assert tg.float_to_pcm16(ties).tolist() == [0, 2, 0, -2]
    _same(tg.pcm16_to_float, jg.pcm16_to_float, ALL_PCM)


@pytest.mark.parametrize("codec", ["ulaw", "alaw", "l16"])
def test_codec_filters_match_jax(factory, codec):
    """enc -> dec through the registered filters of both packages."""
    from mediastreamer2_tpu.core.block import Format as JFormat
    from mediastreamer2_tpu.core.graph import GraphBuilder as JGraphBuilder

    def build(gb_cls, fmt_cls, fac):
        g = gb_cls(fac, batch=4)
        src = g.add("ext_source", "in", fmt=fmt_cls(rate=8000))
        enc, dec = g.add(f"{codec}_enc"), g.add(f"{codec}_dec")
        g.chain(src, enc, dec, g.add("ext_sink", "out"))
        return g.build()

    x = (0.3 * np.random.default_rng(1).standard_normal((4, 80))).astype(np.float32)
    jcg = build(JGraphBuilder, JFormat, factory)
    tcg = build(GraphBuilder, Format, Factory())
    _, jo, _ = jcg.step(jcg.init_state(), jcg.init_params(), {"in": x})
    _, to, _ = tcg.step(tcg.init_state("cpu"), tcg.init_params("cpu"),
                        {"in": torch.from_numpy(x)})
    np.testing.assert_array_equal(to["out"].numpy(), np.asarray(jo["out"]))
    assert tcg.out_formats[1][0].kind == codec
