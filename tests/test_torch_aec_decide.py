"""``kernels.aec_decide`` on the CPU: its plain version, called through
the wrapper by the echo canceller's graph, gives the bits of the inline
PyTorch code it took over from ``ops/aec._aec_process`` (kept below as it
was), on every path of the update and with the suppressor on and off;
and every threshold the kernel and its plain version use is one that
``ops/aec.py`` names."""
import dataclasses
import inspect
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each, so that parallel test workers running
# real-time paced tests are not crowded by idle OpenMP threads
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder  # noqa: E402
from mediastreamer2_tpu_torch.core.trace import span  # noqa: E402
from mediastreamer2_tpu_torch.ops import aec, kernels  # noqa: E402
from mediastreamer2_tpu_torch.ops.aec import (  # noqa: E402
    _ADAPT, _ANALYSIS, _APPLY, _SUPPRESS, _UPDATE, COPY_RATIO, ERLE_GATE, ERR_EWMA, HOLD_TICKS,
    LEAK_RISE, RESET_RATIO, STORE_DTYPE, SUPPRESS_BETA, SUPPRESS_FLOOR, _megakernel_path)
from mediastreamer2_tpu_torch.ops.rfft import (apply_constraint, cabs2, cmul_conj,  # noqa: E402
                                               irfft, irfft_tail, rfft, rfft_tail)

RATE, S, B, TICKS = 16000, 160, 4, 240


# ``_aec_process`` as it was before ``kernels.aec_decide``, line for line
def _inline_process(state, ins, params, ctx):
    near, far = ins
    B, S = near.shape
    two_s = 2 * S
    P = state["Wm_r"].shape[1]
    bf16_shadow = state["Ws_r"].dtype == STORE_DTYPE
    # a shard takes the unsharded graph's branch (the rule reads the whole
    # batch) and rounds its rows by their index in the whole batch
    megakernel = not bf16_shadow and _megakernel_path(ctx.global_batch)
    lin0 = ctx.shard.offset * P * state["Wm_r"].shape[2] if ctx.shard is not None else 0

    with span(_ANALYSIS):
        far_blk = torch.cat([state["far_prev"], far], dim=1)            # [B, 2S]
        Xr, Xi = rfft(far_blk, two_s)                                   # [B, F]
        # the block leaving the history this tick, read before the in-place
        # shift, in the storage dtype so the telescoping power sum adds and
        # removes identical quantized values
        drop_pow = cabs2(state["Xh_r"][:, -1].float(), state["Xh_i"][:, -1].float())
        inst_q = cabs2(Xr.to(STORE_DTYPE).float(), Xi.to(STORE_DTYPE).float())

    # --- history shift + dual filter apply (in place on Xh) ----------------
    with span(_APPLY):
        Xh_r, Xh_i = state["Xh_r"], state["Xh_i"]
        Ym_r, Ym_i, Ys_r, Ys_i = kernels.mdf_apply(
            state["Wm_r"], state["Wm_i"], state["Ws_r"], state["Ws_i"],
            Xh_r, Xh_i, Xr, Xi)
        y_m = irfft_tail(Ym_r, Ym_i, two_s)
        y_s = irfft_tail(Ys_r, Ys_i, two_s)
        e_m = near - y_m
        e_s = near - y_s

    # --- shadow adaptation inputs ------------------------------------------
    with span(_ADAPT):
        Er, Ei = rfft_tail(e_s, two_s)
        # exact MDF-NLMS normalization by the running per-bin history power
        Hp = torch.clamp(state["Hp"] + inst_q - drop_pow, min=0.0)
        # fade out bins where the far end carries no energy (continuous ramp)
        thr = 1e-3 * Hp.mean(dim=1, keepdim=True) + 1e-12
        bin_w = torch.clamp(Hp / thr - 1.0, 0.0, 1.0)
        inv_norm = bin_w / (Hp + 1e-5)
        mu = params["mu"] * params["adapt"].to(torch.float32)
        # causality constraint on ONE partition per tick, round-robin
        cpos = state["cpos"]
        cidx = cpos.reshape(1).long()
        hp_r = torch.index_select(Xh_r, 1, cidx)[:, 0].float()
        hp_i = torch.index_select(Xh_i, 1, cidx)[:, 0].float()
        gp_r, gp_i = cmul_conj(hp_r, hp_i, Er, Ei)
        gc_r, gc_i = apply_constraint(gp_r * inv_norm, gp_i * inv_norm, two_s)

        # --- two-path transfer decisions (per-leg, hysteretic) --------------
        near_pow = (near * near).mean(dim=1)
        Em = ERR_EWMA * state["Em"] + (1 - ERR_EWMA) * (e_m * e_m).mean(dim=1)
        Es = ERR_EWMA * state["Es"] + (1 - ERR_EWMA) * (e_s * e_s).mean(dim=1)
        Dn = ERR_EWMA * state["Dn"] + (1 - ERR_EWMA) * near_pow
        # shadow-error floor via min statistics
        Nf = torch.where(Dn > 1e-7, torch.minimum(state["Nf"] * 1.01, Es), state["Nf"])
        at_floor = Es < 2.0 * Nf
        better = (Es < COPY_RATIO * Em) & ((Es < ERLE_GATE * Dn) | at_floor)
        worse = (Es > RESET_RATIO * Em) & (Em < 0.8 * Dn)
        zero = torch.zeros_like(state["promote_cnt"])
        promote_cnt = torch.where(better, state["promote_cnt"] + 1, zero)
        reseed_cnt = torch.where(worse, state["reseed_cnt"] + 1, zero)
        promote = promote_cnt >= HOLD_TICKS
        reseed = reseed_cnt >= HOLD_TICKS
        promote_cnt = torch.where(promote, zero, promote_cnt)
        reseed_cnt = torch.where(reseed, zero, reseed_cnt)
        # catastrophic-divergence insurance (leaky evidence counter)
        active = Dn > 1e-5
        diverged = ((torch.minimum(Em, Es) > 1.05 * Dn) | (Es > 10.0 * Dn)) & active
        diverge_cnt = torch.where(
            diverged, state["diverge_cnt"] + 1,
            torch.where(active, torch.clamp(state["diverge_cnt"] - 1, min=0),
                        state["diverge_cnt"]))
        hard_reset = diverge_cnt >= 2 * HOLD_TICKS
        diverge_cnt = torch.where(hard_reset, zero, diverge_cnt)
        # never promote taps declared catastrophically diverged this tick
        promote = promote & ~hard_reset

    # --- gradient + NLMS update + transfer copies (in place on Ws, Wm) ------
    with span(_UPDATE):
        if megakernel:
            Ws_r, Ws_i, Wm_r, Wm_i = kernels.mdf_update(
                cpos, state["Ws_r"], state["Ws_i"], state["Wm_r"], state["Wm_i"],
                Xh_r, Xh_i, Er, Ei, inv_norm, gc_r, gc_i, mu,
                promote.to(torch.float32), reseed.to(torch.float32))
            h3 = hard_reset[:, None, None]
            Ws_r.masked_fill_(h3, 0.0)
            Ws_i.masked_fill_(h3, 0.0)
        else:
            Ws_r, Ws_i, Wm_r, Wm_i = kernels.mdf_update_fused(
                cpos, state["Ws_r"], state["Ws_i"], state["Wm_r"], state["Wm_i"],
                Xh_r, Xh_i, Er, Ei, inv_norm, gc_r, gc_i, mu, promote, reseed,
                hard_reset, state.get("srk"), lin0)
        Em = torch.where(promote, Es, Em)
        Es = torch.where(reseed, Em, Es)
        Es = torch.where(hard_reset, Dn, Es)

    with span(_SUPPRESS):
        e = torch.where(promote[:, None], e_s, e_m)
        y = torch.where(promote[:, None], y_s, y_m)
        # per-tick output limiter: blend back toward the mic (continuously) if
        # the selected filter makes this block worse than the raw mic
        blk_err = (e * e).mean(dim=1)
        w_bad = torch.clamp(blk_err / (2.0 * near_pow + 1e-9) - 1.0, 0.0, 1.0)[:, None]
        e = (1.0 - w_bad) * e + w_bad * near
        y = (1.0 - w_bad) * y
        e = torch.where(params["enabled"][:, None], e, near)

        new_state = {"Wm_r": Wm_r, "Wm_i": Wm_i, "Ws_r": Ws_r, "Ws_i": Ws_i,
                     "Xh_r": Xh_r, "Xh_i": Xh_i, "far_prev": far, "Hp": Hp,
                     "Em": Em, "Es": Es, "Dn": Dn, "Nf": Nf,
                     "leak": state["leak"],
                     "promote_cnt": promote_cnt, "reseed_cnt": reseed_cnt,
                     "diverge_cnt": diverge_cnt,
                     "cpos": torch.remainder(cpos + 1, P).to(torch.int32)}
        if bf16_shadow:
            new_state["srk"] = state["srk"] + 1
        # --- residual echo suppression --------------------------------------
        if ctx.params.get("no_suppress"):
            # build-time suppressor bypass (static)
            return new_state, (e,), {}

        # over-subtract only the estimated residual (leak * |Y|); `leak` is the
        # residual/echo power ratio, tracked as a slow minimum
        Ey = (y * y).mean(dim=1)
        inst_leak = (e * e).mean(dim=1) / (Ey + 1e-9)
        rise = torch.where(Dn < 1.5 * Ey, LEAK_RISE, 1.0)
        leak = torch.clamp(torch.minimum(state["leak"] * rise, inst_leak), 0.01, 1.0)
        Ehr, Ehi = rfft(e, S)
        Yhr, Yhi = rfft(y, S)
        # gain = clamp((|E| - beta sqrt(leak) |Y|) / |E|, floor, 1) on E
        e_sup = irfft(*kernels.suppress_gain(Ehr, Ehi, Yhr, Yhi, leak, SUPPRESS_BETA,
                                             SUPPRESS_FLOOR), S)
        out = torch.where((params["suppress"] & params["enabled"])[:, None], e_sup, e)
        new_state["leak"] = leak
        return new_state, (out,), {}



def _graph(factory, no_suppress):
    g = GraphBuilder(factory, batch=B)
    near = g.add("ext_source", "near", fmt=Format(rate=RATE))
    far = g.add("ext_source", "far", fmt=Format(rate=RATE))
    ec = g.add("echo_canceller", "ec", tail_ms=80, no_suppress=no_suppress)
    g.link(near, 0, ec, 0)
    g.link(far, 0, ec, 1)
    g.link(ec, 0, g.add("ext_sink", "out"), 0)
    return g.build()


def _inputs():
    """[TICKS, B, S] mic and far end, one case a leg: 0 a steady echo
    (promotes), 1 an echo path that turns over at tick 120, 2 loud
    double-talk over ticks 120-179 (the shadow is thrown off while main
    holds: reseeds), 3 no echo at all, a leg whose taps start as noise
    (diverges and hard-resets)."""
    rng = np.random.default_rng(26)
    n = TICKS * S
    far = 0.2 * rng.standard_normal((B, n))
    ir = rng.standard_normal((B, 300)) * np.exp(-np.arange(300) / 60.0)
    ir *= 0.5 / np.sqrt((ir ** 2).sum(axis=1, keepdims=True))
    echo = np.stack([np.convolve(far[b], ir[b])[:n] for b in range(B)])
    echo[1, 120 * S:] = -np.roll(echo[1], 37)[120 * S:]
    echo[3] = 0.0
    mic = echo + 0.01 * rng.standard_normal((B, n))
    mic[2, 120 * S:180 * S] += 0.4 * rng.standard_normal(60 * S)
    shape = lambda x: np.ascontiguousarray(x.reshape(B, TICKS, S).transpose(1, 0, 2))
    return shape(mic).astype(np.float32), shape(far).astype(np.float32)


def _run(factory, no_suppress):
    """Outputs and EC states of every tick; leg 3's taps start as noise,
    its divergence counter 10, and it is disabled (its output the mic)."""
    cg = _graph(factory, no_suppress)
    st, pr = cg.init_state("cpu"), cg.init_params("cpu")
    gen = torch.Generator().manual_seed(5)
    for k in ("Wm_r", "Wm_i", "Ws_r", "Ws_i"):
        t = st["ec"][k]
        t[3] = (0.3 * torch.randn(t[3].shape, generator=gen)).to(t.dtype)
    st["ec"]["diverge_cnt"][3] = 10
    pr["ec"]["enabled"][3] = False
    mic, far = _inputs()
    outs, states = [], []
    for t in range(TICKS):
        st, o, _ = cg.step(st, pr, {"near": torch.from_numpy(mic[t]),
                                    "far": torch.from_numpy(far[t])})
        outs.append(o["out"].clone())
        states.append({k: v.clone() for k, v in st["ec"].items()})
    return outs, states


@pytest.mark.parametrize("no_suppress", [False, True], ids=["suppress", "no_suppress"])
@pytest.mark.parametrize("env", [{}, {"PALLAS_MDF": "1"}], ids=["fused", "megakernel"])
def test_aec_decide_twin_gives_the_inline_code_bits(monkeypatch, env, no_suppress):
    """The graph through ``kernels.aec_decide`` (its plain version on the
    CPU) against the graph with the old inline code, tick by tick: every
    output sample and every state tensor bit for bit, over ticks in which
    some leg promoted, reseeded and hard-reset; one call a tick, bool
    flags."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    inline = Factory()
    inline.register(dataclasses.replace(inline.lookup("echo_canceller"),
                                        process=_inline_process))
    want_out, want_st = _run(inline, no_suppress)
    seen = {"calls": 0, "promote": 0, "reseed": 0, "hard_reset": 0}
    real = kernels.aec_decide

    def spy(*a, **kw):
        res = real(*a, **kw)
        seen["calls"] += 1
        for name, flag in zip(("promote", "reseed", "hard_reset"), res[-3:]):
            seen[name] += int(flag.bool().sum())
        assert all(f.dtype == torch.bool for f in res[-3:])
        assert (res[2] is None) == no_suppress
        return res
    monkeypatch.setattr(kernels, "aec_decide", spy)
    got_out, got_st = _run(Factory(), no_suppress)
    assert seen["calls"] == TICKS
    assert seen["promote"] and seen["reseed"] and seen["hard_reset"], seen
    for t in range(TICKS):
        assert torch.equal(got_out[t], want_out[t]), f"tick {t}: output"
        assert set(got_st[t]) == set(want_st[t])
        for k, v in want_st[t].items():
            assert got_st[t][k].dtype == v.dtype and torch.equal(got_st[t][k], v), \
                f"tick {t}: {k}"


def test_aec_decide_kernel_constants_are_the_filters():
    """``aec.DECIDE`` holds ``ops/aec.py``'s named thresholds in
    ``kernels.DecideConsts``' order, which is csrc's DecConsts; neither the
    kernel nor its plain version writes a number of its own (0 and 1
    aside: a weight's range, an empty counter), so the policy's numbers live
    in ``ops/aec.py`` alone."""
    assert aec.DECIDE == (
        aec.ERR_EWMA, 1 - aec.ERR_EWMA, aec.COPY_RATIO, aec.ERLE_GATE, aec.RESET_RATIO,
        aec.NF_CREEP, aec.NF_ACTIVE, aec.FLOOR_RATIO, aec.MAIN_GATE, aec.ACTIVE_POW,
        aec.DIVERGE_RATIO, aec.BLOWUP_RATIO, aec.LIMIT_RATIO, aec.LEAK_RISE, aec.LEAK_GATE,
        aec.LEAK_FLOOR, aec.POW_EPS, aec.HOLD_TICKS, aec.DIVERGE_HOLD)
    src = Path(kernels.SOURCES[0]).read_text()
    struct = re.search(r"struct DecConsts \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(\w+)\s*[,;]", re.sub(r"\b(float|int)\b", "", struct))
    assert tuple(fields) == kernels.DecideConsts._fields
    assert int(re.search(r"#define DEC_NCONST (\d+)", src).group(1)) == len(aec.DECIDE)
    # floating-point literals (whole numbers index rows and count lanes)
    number = re.compile(r"(?<![\w.])(\d+\.\d*(?:e-?\d+)?|\d+e-?\d+|\.\d+)f?(?![\w.])")
    body = src[src.index("aec_decide_kernel(DecArgs"):src.index("// The FFT path's layout")]
    body = re.sub(r"//[^\n]*", "", body)
    assert {float(n) for n in number.findall(body)} <= {0.0, 1.0}, \
        "a number in aec_decide_kernel: pass it in DecConsts"
    twin = inspect.getsource(kernels.aec_decide_reference)
    twin = re.sub(r"#[^\n]*", "", twin.split('"""', 2)[2])
    assert {float(n) for n in number.findall(twin)} <= {0.0, 1.0}, \
        "a number in aec_decide_reference: name it in ops/aec.py and pass it in DecideConsts"


def test_aec_decide_counts_no_cpu_launch():
    kernels.reset_launch_counts()
    z = torch.zeros((2, S))
    rows = [torch.ones(2) if k == "Dn" else torch.zeros(2, dtype=torch.int32)
            if k.endswith("_cnt") else torch.full((2,), 1e-6) for k in kernels.DECIDE_ROWS]
    out = kernels.aec_decide(z, z, z, *rows, torch.ones(2, dtype=torch.bool), aec.DECIDE)
    assert len(out) == 3 + len(kernels.DECIDE_ROWS) + 3
    assert kernels.launch_counts()["aec_decide"] == 0
