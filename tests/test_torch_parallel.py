"""Leg sharding in the port (``parallel/sharding.py``, ``parallel/dryrun.py``)
on the CPU: four gloo processes, B = 8 (two legs a shard), held to the
unsharded port bit for bit and to the JAX package's sharded graphs on its
virtual CPU mesh. One world runs most shard-side checks
(``parallel/checks.run_jobs``); the failure cases spawn their own.

The port's CPU DFT products follow the thread count, so this process runs
one thread, as each shard does (``spawn_shards``): with eight threads here
the unsharded taps differ from the shards' in a few bf16 steps."""
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mediastreamer2_tpu.core.block import Format as JFormat  # noqa: E402
from mediastreamer2_tpu.core.graph import GraphBuilder as JGraphBuilder  # noqa: E402
from mediastreamer2_tpu.models.flagship import build_flagship as jax_flagship  # noqa: E402
from mediastreamer2_tpu.models.flagship import example_inputs as jax_example_inputs  # noqa: E402
from mediastreamer2_tpu.ops.aec import _sround_bf16  # noqa: E402
from mediastreamer2_tpu.parallel.sharding import make_mesh as jax_mesh  # noqa: E402
from mediastreamer2_tpu.parallel.sharding import shard_tree as jax_shard_tree  # noqa: E402
from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder, build_flagship  # noqa: E402
from mediastreamer2_tpu_torch.core.filter import LegShard  # noqa: E402
from mediastreamer2_tpu_torch.models.e2e_bench import build_e2e_graph, e2e_tick  # noqa: E402
from mediastreamer2_tpu_torch.models.flagship import echo_coupled_inputs  # noqa: E402
from mediastreamer2_tpu_torch.ops import kernels  # noqa: E402
from mediastreamer2_tpu_torch.parallel import checks, dryrun, sharding  # noqa: E402

B, WORLD, S = 8, 4, 480
TIMEOUT_S = 30.0            # a collective's timeout; the parent adds 30 s of start-up
TAP_TICKS = 10
MIX_S = 160
MIXER_CASES = {             # name -> (k, group_id): k = 0 is the segment sum
    "uniform_spanning": (4, None),      # two legs a shard: every group spans two
    "uniform_all_shards": (8, None),    # one group over all four shards
    "uniform_aligned": (2, None),       # every group inside a shard: no exchange
    "segment_permuted": (0, np.random.default_rng(5).permutation(B).astype(np.int32) // 4),
}


def _mixer_input():
    return (0.3 * np.random.default_rng(4).standard_normal((B, MIX_S))).astype(np.float32)


def _e2e_fixture(ticks=2):
    rng = np.random.default_rng(3)
    return (rng.integers(0, 255, (B, ticks * 80)).astype(np.uint8),
            (0.1 * rng.standard_normal((B, ticks * S))).astype(np.float32))


def _jax_params_np(params):
    return {n: {k: np.asarray(v) for k, v in e.items()} for n, e in params.items()}


@pytest.fixture(scope="module")
def world(factory, tmp_path_factory):
    """Every shard-side check that needs no failure, in one four-rank world:
    results[rank][job]."""
    _, jparams = jax_flagship(factory, batch=B, conf_size=4)
    ext = jax_example_inputs(B, seed=7)
    mic, far = echo_coupled_inputs(B, TAP_TICKS)
    codes, emic = _e2e_fixture()
    jobs = [("mixer", dict(x=_mixer_input(), k=k, group_id=g)) for k, g in MIXER_CASES.values()]
    jobs += [("flagship", dict(mic=ext["mic"], far=ext["spk_ref"], ticks=1,
                               params=_jax_params_np(jparams))),
             ("flagship", dict(mic=mic, far=far, ticks=TAP_TICKS, taps=True)),
             ("e2e", dict(codes=codes, mic=emic, ticks=2)),
             ("dc_mix_minus", dict(batch=B)),
             ("environment", {}),
             ("modules", {})]
    init = str(tmp_path_factory.mktemp("rendezvous") / "world")
    return sharding.spawn_shards(checks.run_jobs, WORLD, init_file=init, device="cpu",
                                 timeout_s=TIMEOUT_S, args=(jobs,))


def _job(world, i):
    return [r[i] for r in world]


def _unsharded_flagship(mic, far, ticks, params=None):
    cg, pr = build_flagship(Factory(), B, "cpu")
    st = cg.init_state("cpu")
    pr = pr if params is None else params
    outs = []
    for t in range(ticks):
        st, o, _ = cg.step(st, pr, {"mic": torch.from_numpy(mic[:, t * S:(t + 1) * S].copy()),
                                    "spk_ref": torch.from_numpy(far[:, t * S:(t + 1) * S].copy())})
        outs.append(o["out"])
    return st, torch.cat(outs, dim=1).numpy()


def _jax_mixer(factory, x, k, group_id):
    g = JGraphBuilder(factory, batch=B)
    src = g.add("ext_source", "x", fmt=JFormat(rate=100 * MIX_S))
    mix = g.add("conf_mixer", "conf", **({"uniform_group_size": k} if k else {}))
    g.chain(src, mix, g.add("ext_sink", "out"))
    cg = g.build()
    params = cg.init_params()
    if group_id is not None:
        params["conf"]["group_id"] = jnp.asarray(group_id)
    return np.asarray(jax.jit(cg.step)(cg.init_state(), params, {"x": x})[1]["out"])


@pytest.mark.parametrize("case", list(MIXER_CASES))
def test_cross_shard_mixer_is_bit_equal_to_unsharded(world, factory, case):
    """conf_mixer across four shards: bit for bit the unsharded port's
    mixer (each rank runs both on identical inputs), one exchange a call
    unless every group lies inside a shard, and within 1e-6 of JAX's
    conf_mixer on the same inputs."""
    i = list(MIXER_CASES).index(case)
    k, gid = MIXER_CASES[case]
    res = _job(world, i)
    for r in res:
        np.testing.assert_array_equal(r["out"], r["ref"])
        assert r["collectives"] == (0 if case == "uniform_aligned" else 1)
    got = np.concatenate([r["out"] for r in res]).view(np.float32)
    np.testing.assert_allclose(got, _jax_mixer(factory, _mixer_input(), k, gid), atol=1e-6, rtol=0)


def test_spanning_groups_come_from_shared_numbers():
    from mediastreamer2_tpu_torch.ops.mixer import spanning_groups
    assert spanning_groups(8, 4, 4) == [0, 1]        # boundaries at 2 and 6 cut groups 0, 1
    assert spanning_groups(8, 8, 4) == [0]
    assert spanning_groups(8, 2, 4) == []
    assert spanning_groups(4096, 4, 4) == []          # phase 15a's aligned groups
    assert spanning_groups(12, 6, 4) == [0, 1]        # boundaries 3 and 9 cut, 6 does not


def test_sround_lin0_on_a_row_slice_equals_the_full_rows():
    """sround_bf16 with lin0 = offset * P * F on rows [2, 4) equals those
    rows of the full tensor's rounding and of JAX's _sround_bf16, bit for
    bit; with lin0 = 0 (the fault a shard would have) it differs. The index
    wraps mod 2**32, as JAX's uint32 iota."""
    P, F = 8, 481
    x = np.random.default_rng(11).standard_normal((B, P, F)).astype(np.float32) * 0.1
    salt = 2 * 12345
    full = kernels.sround_bf16(torch.from_numpy(x), salt)
    want = np.asarray(_sround_bf16(jnp.asarray(x), jnp.uint32(salt))).view(np.int16)
    np.testing.assert_array_equal(full.view(torch.int16).numpy(), want)
    part = kernels.sround_bf16(torch.from_numpy(x[2:4]), salt, lin0=2 * P * F)
    np.testing.assert_array_equal(part.view(torch.int16).numpy(), want[2:4])
    zero = kernels.sround_bf16(torch.from_numpy(x[2:4]), salt)
    assert (zero.view(torch.int16).numpy() != want[2:4]).sum() > 1000
    wrapped = kernels.sround_bf16(torch.from_numpy(x[2:4]), salt, lin0=2 * P * F + 2 ** 32)
    assert torch.equal(wrapped.view(torch.int16), part.view(torch.int16))


def test_mdf_update_fused_reference_lin0_equals_the_full_rows():
    """The plain twin of mdf_update_fused (bf16 shadow) on rows [2, 4) with
    lin0 equals those rows of the full call bit for bit; lin0 = 0 differs."""
    P, F = 8, 481
    g = torch.Generator().manual_seed(3)
    rnd = lambda *shape, s=1.0: s * torch.randn(shape, generator=g)
    flag = lambda: torch.rand((B,), generator=g) < 0.3
    taps = [rnd(B, P, F, s=0.1).to(torch.bfloat16) for _ in range(4)]
    rest = ([rnd(B, P, F).to(torch.bfloat16) for _ in range(2)]
            + [rnd(B, F, s=0.3), rnd(B, F, s=0.3), rnd(B, F).abs(), rnd(B, F, s=0.05),
               rnd(B, F, s=0.05), rnd(B).abs() * 0.6, flag(), flag(), flag()])
    cpos, srk = torch.tensor(3, dtype=torch.int32), torch.tensor(77, dtype=torch.int64)
    full = [t.clone() for t in taps]
    kernels.mdf_update_fused_reference(cpos, *full, *rest, srk)
    cut = lambda ts: [t[2:4].clone() for t in ts]
    part, zero = cut(taps), cut(taps)
    kernels.mdf_update_fused_reference(cpos, *part, *cut(rest), srk, lin0=2 * P * F)
    kernels.mdf_update_fused(cpos, *zero, *cut(rest), srk)      # the CPU wrapper: the twin
    for a, b in zip(part, full):
        assert torch.equal(a.view(torch.int16), b[2:4].view(torch.int16))
    assert any(not torch.equal(a.view(torch.int16), b[2:4].view(torch.int16))
               for a, b in zip(zero[:2], full[:2]))


def test_sharded_flagship_matches_jax_sharded(world, factory):
    """One tick of the flagship on four port shards, params carried from
    JAX by utils/convert.from_jax: within 2e-5 of JAX's flagship sharded on
    its make_mesh(4) (the bar of tests/test_parallel.py), and bit for bit
    the unsharded port."""
    jcg, jparams = jax_flagship(factory, batch=B, conf_size=4)
    ext = jax_example_inputs(B, seed=7)
    mesh = jax_mesh(4)
    _, jout, _ = jax.jit(jcg.step)(jax_shard_tree(jcg.init_state(), mesh, B),
                                   jax_shard_tree(jparams, mesh, B),
                                   jax_shard_tree(ext, mesh, B))
    got = np.concatenate([r["out"] for r in _job(world, len(MIXER_CASES))])
    np.testing.assert_allclose(got, np.asarray(jout["out"]), atol=2e-5)
    from mediastreamer2_tpu_torch.utils.convert import from_jax
    _, ref = _unsharded_flagship(ext["mic"], ext["spk_ref"], 1,
                                 from_jax(_jax_params_np(jparams), "cpu"))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_sharded_flagship_taps_after_ten_ticks(world):
    """Ten echo-coupled ticks: every shard's output and bf16 taps (Ws, Wm)
    equal the unsharded run's rows bit for bit: the stochastic rounding
    hashes each leg's index in the whole batch."""
    res = _job(world, len(MIXER_CASES) + 1)
    mic, far = echo_coupled_inputs(B, TAP_TICKS)
    st, ref = _unsharded_flagship(mic, far, TAP_TICKS)
    got = np.concatenate([r["out"] for r in res])
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    for k in checks.TAP_KEYS:
        np.testing.assert_array_equal(np.concatenate([r["taps"][k] for r in res]),
                                      checks.bits(st["ec"][k]))
    assert all(r["collectives"] == TAP_TICKS for r in res)   # groups of 4 span two shards
    assert all(r["finite"] for r in res)


def test_sharded_e2e_codes_equal_unsharded(world):
    """The e2e step (mu-law -> flagship chain -> mu-law) on four shards
    gives the unsharded port's codes, as tests/test_parallel.py's
    test_sharded_e2e_graph_with_codec_boundary requires of JAX."""
    codes, mic = _e2e_fixture()
    cg, params = build_e2e_graph(Factory(), B, "cpu")
    st = cg.init_state("cpu")
    want = []
    for t in range(2):
        st, tx, _, _ = e2e_tick(cg, st, params, torch.from_numpy(codes[:, t * 80:(t + 1) * 80]),
                                torch.from_numpy(mic[:, t * S:(t + 1) * S].copy()))
        want.append(tx.numpy())
    got = np.concatenate(_job(world, len(MIXER_CASES) + 2))
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))


def test_dc_mix_minus_across_shards(world):
    """tests/test_parallel.py's test_cross_shard_conference_mixing on the
    port: leg i hears its group's DC sum minus its own (rtol 0.05)."""
    for got, want in _job(world, len(MIXER_CASES) + 3):
        np.testing.assert_allclose(got, want, rtol=0.05)
        dc = 0.01 * (1.0 + np.arange(B))
        assert np.all(np.abs(got - (np.repeat(dc.reshape(-1, 4).sum(1), 4) - dc)) < 0.05 * got)


def test_shards_load_no_jax(world):
    """Every child reports no module of JAX or of the JAX package."""
    assert [r[-1] for r in world] == [[]] * WORLD


def test_shards_run_with_no_cublas_workspace_and_one_thread(world):
    """spawn_shards sets each child's process settings: no cuBLAS workspace
    (a product's algorithm then does not follow the batch on the card) and
    one thread (the CPU's products follow the thread count)."""
    assert [r[-2] for r in world] == [{"CUBLAS_WORKSPACE_CONFIG": ":0:0", "threads": 1}] * WORLD


def test_dryrun_multichip_on_the_cpu(tmp_path, capsys):
    reports = dryrun.dryrun_multichip(4, device="cpu", timeout_s=TIMEOUT_S)
    assert [r["device"] for r in reports] == ["cpu"] * 4
    assert all(r["out_shape"] == (B, 160) and r["max_abs_err"] <= 2e-5 for r in reports)
    assert all(r["edge_packets"] == dryrun.EDGE_TICKS * 2 and not r["foreign_modules"]
               for r in reports)
    assert "dryrun_multichip(4): ok" in capsys.readouterr().out


def test_nccl_with_more_ranks_than_cards_raises(tmp_path):
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one card.*gloo"):
        sharding.spawn_shards(checks.run_jobs, 2, backend="nccl",
                              init_file=str(tmp_path / "r"), args=([],))


def test_uneven_batch_raises():
    mesh = sharding.LegMesh(rank=0, world=3, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="do not split evenly"):
        sharding.leg_sharding(mesh, B)
    cg, _ = build_flagship(Factory(), B, "cpu")
    with pytest.raises(ValueError, match="do not split evenly"):
        sharding.sharded_step(cg, mesh)
    with pytest.raises(ValueError, match="holds 2 legs, not 4"):
        GraphBuilder(Factory(), 4, shard=LegShard(offset=0, global_batch=B, world=4))


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="inside a process group"):
        sharding.make_mesh(4, devices="cpu")


def test_leg_axes_follow_the_graph_not_dim_zero():
    """mix2's gains are [2, B]: sharded_step finds their leg axis (1) from
    the global and local graphs' shapes, cuts them there, and a shard's
    output is the unsharded rows. No collective runs, so no process group
    is needed."""
    g = GraphBuilder(Factory(), batch=B)
    a = g.add("ext_source", "a", fmt=Format(rate=16000))
    b = g.add("ext_source", "b", fmt=Format(rate=16000))
    mix = g.add("mix2", "mix")
    g.link(a, 0, mix, 0)
    g.link(b, 0, mix, 1)
    g.link(mix, 0, g.add("ext_sink", "out"), 0)
    cg = g.build()
    params = cg.init_params("cpu")
    params["mix"]["gains"] = torch.linspace(0.1, 1.6, 2 * B).reshape(2, B)
    rng = np.random.default_rng(9)
    ext = {k: (0.3 * rng.standard_normal((B, 160))).astype(np.float32) for k in "ab"}
    ref = cg.step({}, params, {k: torch.from_numpy(v) for k, v in ext.items()})[1]["out"]
    for rank in range(WORLD):
        mesh = sharding.LegMesh(rank=rank, world=WORLD, device=torch.device("cpu"))
        run = sharding.sharded_step(cg, mesh)
        assert run.param_axes == {"mix": {"gains": 1}}
        assert run.ext_axes == {"a": 0, "b": 0}
        out = run({}, params, ext)[1]["out"]
        assert torch.equal(out, ref[2 * rank:2 * rank + 2])
        assert torch.equal(sharding.shard_tree(params, mesh, B, run.param_axes)["mix"]["gains"],
                           params["mix"]["gains"][:, 2 * rank:2 * rank + 2])


def test_a_failing_rank_fails_the_world_within_its_deadline(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)of 4 .*--- rank 2 ---.*fails on purpose"):
        sharding.spawn_shards(checks.run_jobs, WORLD, init_file=str(tmp_path / "r"),
                              device="cpu", timeout_s=TIMEOUT_S,
                              args=([("fail", dict(rank=2))],))
    assert time.monotonic() - t0 < TIMEOUT_S + 30.0


def test_a_hung_collective_ends_at_its_timeout(tmp_path):
    """Rank 1 holds back from a collective for 60 s; the other ranks' gloo
    all_reduce times out after 3 s and fails the world, long before."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)spawn_shards: rank.* of 4 .*--- rank [023] ---"):
        sharding.spawn_shards(checks.run_jobs, WORLD, init_file=str(tmp_path / "r"),
                              device="cpu", timeout_s=3.0,
                              args=([("skip_collective", dict(rank=1, hold_s=60.0))],))
    assert time.monotonic() - t0 < 3.0 + 30.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32, torch.int64,
                                   torch.bool, torch.uint8, torch.float64])
def test_exchange_bits_round_trip(dtype):
    """The exchange's integer view of each dtype the port's trees hold
    comes back bit for bit, -0.0 and NaN included."""
    from mediastreamer2_tpu_torch.core.collective import _as_int, _from_int
    x = torch.tensor([0.0, -0.0, 1.5, -2.25, float("nan"), 7.0]).to(dtype)
    i = _as_int(x)
    assert i.dtype in (torch.int32, torch.int64)
    back = _from_int(i + torch.zeros_like(i), dtype)
    assert back.dtype == dtype
    if dtype.is_floating_point:
        assert torch.equal(back.view(torch.int8), x.view(torch.int8))
    else:
        assert torch.equal(back, x)


def test_large_results_travel_through_files(tmp_path):
    """A shard's result keeps its small values in the pipe's message and
    sends each numpy array of SPILL_BYTES or more through a file, read back
    equal in the parent."""
    big = np.arange(sharding.SPILL_BYTES // 4, dtype=np.float32)
    small = np.arange(5, dtype=np.int16)
    tree = [{"out": big, "n": 3, "taps": {"w": small}}, (big[::-1].copy(), "x")]
    spilled = sharding._spill(tree, str(tmp_path / "rank0"))
    assert isinstance(spilled[0]["out"], sharding._Spilled)
    assert spilled[0]["taps"]["w"] is small and spilled[0]["n"] == 3
    back = sharding._unspill(spilled)
    np.testing.assert_array_equal(back[0]["out"], big)
    np.testing.assert_array_equal(back[1][0], big[::-1])
    assert isinstance(back[1], tuple) and back[1][1] == "x"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rank0.0.npy", "rank0.1.npy"]
