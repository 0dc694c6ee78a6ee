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
