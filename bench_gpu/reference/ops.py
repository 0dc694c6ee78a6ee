"""Plain PyTorch versions of every filter the benchmark's graphs run.

Frozen copies, at commit 19e7661, of the port's plain arithmetic, so that a
later change to the program cannot move the yardstick:

* DFT bases and products: ``mediastreamer2_tpu_torch/ops/rfft.py``
* echo canceller: ``mediastreamer2_tpu_torch/ops/aec.py`` (``_aec_process``)
  with the kernels' plain versions from ``ops/kernels.py``
  (``mdf_apply_reference``, ``mdf_update_reference``,
  ``mdf_update_fused_reference``, ``sround_bf16``)
* AGC: ``ops/volume.py`` (``_vol_process``) and ``fused_volume_reference``
* polyphase resampler: ``ops/resample.py`` (``resample_matrix``)
* mix-minus in contiguous groups: ``ops/mixer.py`` (``_uniform_mix``)
* G.711 mu-law: ``ops/g711.py``

Nothing here imports the program. The functions are pure: each takes a
state dict and returns a new one (the port updates taps in place). Every
tensor may live on the CPU or the card; the products run as plain
``x @ w`` in float32, or, for the benchmark's control, with both operands
rounded to TF32 first (10 mantissa bits, round to nearest), which is what a
TF32 tensor-core product does to its inputs.

The stochastic rounding hashes each element's index in the whole batch:
``row_base`` gives, for each row held here, the linear index of its first
element in the whole ``[B, P, F]`` tensor, so a sample of legs rounds as the
full batch does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STORE = torch.bfloat16
M32 = 0xFFFFFFFF


def tick_samples(rate: int) -> int:
    return rate // 100


def round_tf32(x):
    """float32 -> float32 holding a TF32 value (10 mantissa bits), rounded
    to nearest, ties away from zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Products:
    """The constant matrices of the DFTs and resamplers, built in float64
    with numpy and stored as float32 on ``device``; ``tf32`` rounds both
    operands of every product to TF32."""

    def __init__(self, device, tf32: bool = False):
        self.device = torch.device(device)
        self.tf32 = tf32
        self._cache = {}

    def mm(self, x, w):
        if self.tf32:
            return round_tf32(x) @ round_tf32(w)
        return x @ w

    def _mats(self, key, make):
        if key not in self._cache:
            self._cache[key] = tuple(torch.from_numpy(np.ascontiguousarray(m)).to(self.device)
                                     for m in make())
        return self._cache[key]

    # -- DFTs: numpy.fft.rfft / irfft conventions --------------------------
    def _fwd(self, n):
        def make():
            k, t = np.arange(n // 2 + 1), np.arange(n)
            ang = 2 * np.pi * np.outer(t, k) / n
            c, s = np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)
            return c, s, c[n // 2:], s[n // 2:]
        return self._mats(("fwd", n), make)

    def _inv(self, n):
        def make():
            f = n // 2 + 1
            ang = 2 * np.pi * np.outer(np.arange(f), np.arange(n)) / n
            w = np.full(f, 2.0)
            w[0] = 1.0
            if n % 2 == 0:
                w[-1] = 1.0
            cw = (np.cos(ang) * w[:, None] / n).astype(np.float32)
            sw = (-np.sin(ang) * w[:, None] / n).astype(np.float32)
            return cw, sw, cw[:, n // 2:], sw[:, n // 2:]
        return self._mats(("inv", n), make)

    def _con(self, n):
        def make():
            f = n // 2 + 1
            k, t = np.arange(f), np.arange(n)
            ang_i = 2 * np.pi * np.outer(k, t) / n
            w = np.full(f, 2.0)
            w[0] = 1.0
            if n % 2 == 0:
                w[-1] = 1.0
            cw = np.cos(ang_i) * w[:, None] / n
            sw = -np.sin(ang_i) * w[:, None] / n
            ang_f = 2 * np.pi * np.outer(t, k) / n
            c, s = np.cos(ang_f), -np.sin(ang_f)
            h = n // 2
            return tuple((a @ b).astype(np.float32)
                         for a, b in ((cw[:, :h], c[:h]), (cw[:, :h], s[:h]),
                                      (sw[:, :h], c[:h]), (sw[:, :h], s[:h])))
        return self._mats(("con", n), make)

    def rfft(self, x, n):
        c, s, _, _ = self._fwd(n)
        return self.mm(x, c), self.mm(x, s)

    def irfft(self, re, im, n):
        cw, sw, _, _ = self._inv(n)
        return self.mm(re, cw) + self.mm(im, sw)

    def rfft_tail(self, x_tail, n):
        _, _, c, s = self._fwd(n)
        return self.mm(x_tail, c), self.mm(x_tail, s)

    def irfft_tail(self, re, im, n):
        _, _, cw, sw = self._inv(n)
        return self.mm(re, cw) + self.mm(im, sw)

    def constraint(self, re, im, n):
        arr, ari, air, aii = self._con(n)
        return (self.mm(re, arr) + self.mm(im, air), self.mm(re, ari) + self.mm(im, aii))

    # -- polyphase resampler -------------------------------------------------
    def resample_t(self, rate_in, rate_out):
        """(R.T [H + N_in, N_out] on the device, H)."""
        R, H = resample_matrix(rate_in, rate_out)
        return self._mats(("rs", rate_in, rate_out), lambda: (R.T,))[0], H


HALF_TAPS = 16
KAISER_BETA = 8.6
ROLLOFF = 0.945


def resample_matrix(rate_in: int, rate_out: int):
    """(R [N_out, H + N_in] float32, H): one tick's Kaiser-windowed sinc
    polyphase map."""
    n_in, n_out = tick_samples(rate_in), tick_samples(rate_out)
    ratio = rate_in / rate_out
    stretch = max(1.0, ratio)
    support = HALF_TAPS * stretch
    delay_out = int(math.ceil(support / ratio))
    shift = delay_out * ratio
    H = int(math.ceil(shift + support))
    fc = ROLLOFF * 0.5 / stretch
    m = np.arange(H + n_in, dtype=np.float64)
    centers = (H - shift) + np.arange(n_out, dtype=np.float64) * ratio
    t = m[None, :] - centers[:, None]
    x = t / support
    win = np.where(np.abs(x) < 1.0,
                   np.i0(KAISER_BETA * np.sqrt(np.maximum(0.0, 1 - x * x))) / np.i0(KAISER_BETA),
                   0.0)
    R = 2 * fc * np.sinc(2 * fc * t) * win
    R /= R.sum(axis=1, keepdims=True)
    return R.astype(np.float32), H


def resample_init(B, rate_in, rate_out, device):
    _, H = resample_matrix(rate_in, rate_out)
    return {"hist": torch.zeros((B, H), dtype=torch.float32, device=device)}


def resample_step(pr: Products, st, x, rate_in, rate_out):
    RT, H = pr.resample_t(rate_in, rate_out)
    x_ext = torch.cat([st["hist"], x], dim=1)
    return {"hist": x_ext[:, -H:].contiguous()}, pr.mm(x_ext, RT)


# -- AGC (volume) -------------------------------------------------------------
EN_EWMA, AGC_SPEED_UP, AGC_SPEED_DOWN, MIN_GAIN, MAX_GAIN = 0.3, 0.12, 0.02, 0.01, 30.0
AGC_TARGET = 0.05


def volume_init(B, device):
    f = lambda v: torch.full((B,), v, dtype=torch.float32, device=device)
    return {"energy": f(0.0), "gain": f(1.0), "dc": f(0.0), "level_db": f(-120.0)}


def volume_step(st, x):
    """AGC on, static gain 1; noise gate, echo limiter, DC removal and mute
    off (the graphs' parameters)."""
    e_prev = st["energy"]
    rms = torch.sqrt(e_prev)
    level_db = 10.0 * torch.log10(e_prev + 1e-12)
    target = torch.clamp(AGC_TARGET / (rms + 1e-9), MIN_GAIN, MAX_GAIN)
    speed = torch.where(target < st["gain"], AGC_SPEED_UP, AGC_SPEED_DOWN)
    g1 = st["gain"] + speed * (target - st["gain"])
    g0 = st["gain"]
    S = x.shape[1]
    mean = x.mean(dim=1)
    ramp = torch.arange(S, dtype=torch.float32, device=x.device)[None, :] / S
    g = g0[:, None] * (1 - ramp) + g1[:, None] * ramp
    y = torch.clamp(x * g, -1.0, 1.0)
    e_block = (x * x).mean(dim=1)
    return {"energy": (1 - EN_EWMA) * e_prev + EN_EWMA * e_block, "gain": g1,
            "dc": 0.9 * st["dc"] + 0.1 * mean, "level_db": level_db}, y


# -- mix-minus in contiguous groups -------------------------------------------
def mix_minus(x, k):
    B, S = x.shape
    mix = torch.repeat_interleave(x.reshape(B // k, k, S).sum(dim=1), k, dim=0)
    return torch.clamp(mix - x, -1.0, 1.0)


# -- G.711 mu-law ---------------------------------------------------------------
_ULAW_SEG = (0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF, 0x1FFF)


def float_to_pcm16(x):
    return torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(torch.int32)


def pcm16_to_float(p):
    return p.to(torch.float32) / 32768.0


def ulaw_encode(pcm):
    pcm = pcm >> 2
    neg = pcm < 0
    mag = torch.clamp(torch.where(neg, -pcm, pcm), max=8159) + 33
    seg = torch.zeros_like(mag)
    for t in _ULAW_SEG:
        seg += (mag > t).to(torch.int32)
    uval = torch.where(seg >= 8, 0x7F, (seg << 4) | ((mag >> (seg + 1)) & 0xF))
    return torch.where(neg, uval ^ 0x7F, uval ^ 0xFF)


def ulaw_decode(u):
    u = (~u.to(torch.int32)) & 0xFF
    t = (((u & 0xF) << 3) + 0x84) << ((u & 0x70) >> 4)
    return torch.where((u & 0x80) != 0, 0x84 - t, t - 0x84)


# -- echo canceller ---------------------------------------------------------------
MU, ERR_EWMA, COPY_RATIO, ERLE_GATE, RESET_RATIO = 0.6, 0.6, 0.4, 0.2, 1.5
HOLD_TICKS, SUPPRESS_BETA, SUPPRESS_FLOOR, LEAK_RISE = 8, 2.5, 0.15, 1.01


def aec_init(B, S, P, bf16_shadow, device):
    F = S + 1
    z3 = lambda dt=STORE: torch.zeros((B, P, F), dtype=dt, device=device)
    f = lambda v: torch.full((B,), v, dtype=torch.float32, device=device)
    i = lambda: torch.zeros((B,), dtype=torch.int32, device=device)
    sdt = STORE if bf16_shadow else torch.float32
    st = {"Wm_r": z3(), "Wm_i": z3(), "Ws_r": z3(sdt), "Ws_i": z3(sdt),
          "Xh_r": z3(), "Xh_i": z3(),
          "far_prev": torch.zeros((B, S), dtype=torch.float32, device=device),
          "Hp": torch.zeros((B, F), dtype=torch.float32, device=device),
          "Em": f(1e-6), "Es": f(1e-6), "Dn": f(1e-6),
          "promote_cnt": i(), "reseed_cnt": i(), "diverge_cnt": i(),
          "Nf": f(1.0), "leak": f(1.0),
          "cpos": torch.zeros((), dtype=torch.int32, device=device)}
    if bf16_shadow:
        st["srk"] = torch.zeros((), dtype=torch.int64, device=device)
    return st


def _mul32(a, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def sround_bf16(x, salt, row_base):
    """Stochastic f32 -> bf16 rounding by a hash of each element's linear
    index in the whole batch (``row_base[b]`` + its index in row b) and
    ``salt``."""
    x = x.contiguous()
    per_row = x[0].numel()
    lin = (torch.arange(per_row, dtype=torch.int64, device=x.device)[None, :]
           + row_base.to(torch.int64)[:, None]) & M32
    lin = lin.reshape(x.shape)
    bits = x.view(torch.int32).to(torch.int64) & M32
    salt = torch.as_tensor(salt, dtype=torch.int64, device=x.device) & M32
    h = (_mul32(lin, 2654435761) + _mul32(salt, 0x9E3779B9)) & M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    top = ((bits + (h & 0xFFFF)) & M32) >> 16
    top = top - ((top >> 15) << 16)
    return top.to(torch.int16).view(torch.bfloat16)


def aec_step(pr: Products, st, near, far, megakernel: bool, row_base):
    """One tick of the two-path FDAF echo canceller with its residual
    suppressor (all legs enabled, adapting, suppressing, mu = 0.6). The
    shadow's dtype picks the update: bf16 taps by the fused update with
    stochastic rounding; f32 taps by the megakernel update, then the hard
    reset (``megakernel``), or the fused update's f32 mode."""
    B, S = near.shape
    n2 = 2 * S
    P = st["Wm_r"].shape[1]
    bf16_shadow = st["Ws_r"].dtype == STORE
    megakernel = megakernel and not bf16_shadow

    far_blk = torch.cat([st["far_prev"], far], dim=1)
    Xr, Xi = pr.rfft(far_blk, n2)
    drop_pow = st["Xh_r"][:, -1].float() ** 2 + st["Xh_i"][:, -1].float() ** 2
    inst_q = Xr.to(STORE).float() ** 2 + Xi.to(STORE).float() ** 2

    # history shift, then both filters summed over p = 0..P-1 in order
    Xh_r = torch.cat([Xr.to(STORE)[:, None], st["Xh_r"][:, :-1]], dim=1)
    Xh_i = torch.cat([Xi.to(STORE)[:, None], st["Xh_i"][:, :-1]], dim=1)
    acc = [torch.zeros_like(Xr) for _ in range(4)]
    for p in range(P):
        hr, hi = Xh_r[:, p].float(), Xh_i[:, p].float()
        mr, mi = st["Wm_r"][:, p].float(), st["Wm_i"][:, p].float()
        sr, si = st["Ws_r"][:, p].float(), st["Ws_i"][:, p].float()
        acc[0] = acc[0] + (mr * hr - mi * hi)
        acc[1] = acc[1] + (mr * hi + mi * hr)
        acc[2] = acc[2] + (sr * hr - si * hi)
        acc[3] = acc[3] + (sr * hi + si * hr)
    y_m = pr.irfft_tail(acc[0], acc[1], n2)
    y_s = pr.irfft_tail(acc[2], acc[3], n2)
    e_m, e_s = near - y_m, near - y_s

    Er, Ei = pr.rfft_tail(e_s, n2)
    Hp = torch.clamp(st["Hp"] + inst_q - drop_pow, min=0.0)
    thr = 1e-3 * Hp.mean(dim=1, keepdim=True) + 1e-12
    inv_norm = torch.clamp(Hp / thr - 1.0, 0.0, 1.0) / (Hp + 1e-5)
    mu = torch.full((B,), MU, dtype=torch.float32, device=near.device)
    cpos = st["cpos"]
    c = int(cpos)
    hp_r, hp_i = Xh_r[:, c].float(), Xh_i[:, c].float()
    gp_r, gp_i = hp_r * Er + hp_i * Ei, hp_r * Ei - hp_i * Er
    gc_r, gc_i = pr.constraint(gp_r * inv_norm, gp_i * inv_norm, n2)

    Em = ERR_EWMA * st["Em"] + (1 - ERR_EWMA) * (e_m * e_m).mean(dim=1)
    Es = ERR_EWMA * st["Es"] + (1 - ERR_EWMA) * (e_s * e_s).mean(dim=1)
    Dn = ERR_EWMA * st["Dn"] + (1 - ERR_EWMA) * (near * near).mean(dim=1)
    Nf = torch.where(Dn > 1e-7, torch.minimum(st["Nf"] * 1.01, Es), st["Nf"])
    at_floor = Es < 2.0 * Nf
    better = (Es < COPY_RATIO * Em) & ((Es < ERLE_GATE * Dn) | at_floor)
    worse = (Es > RESET_RATIO * Em) & (Em < 0.8 * Dn)
    zero = torch.zeros_like(st["promote_cnt"])
    promote_cnt = torch.where(better, st["promote_cnt"] + 1, zero)
    reseed_cnt = torch.where(worse, st["reseed_cnt"] + 1, zero)
    promote, reseed = promote_cnt >= HOLD_TICKS, reseed_cnt >= HOLD_TICKS
    promote_cnt = torch.where(promote, zero, promote_cnt)
    reseed_cnt = torch.where(reseed, zero, reseed_cnt)
    active = Dn > 1e-5
    diverged = ((torch.minimum(Em, Es) > 1.05 * Dn) | (Es > 10.0 * Dn)) & active
    diverge_cnt = torch.where(diverged, st["diverge_cnt"] + 1,
                              torch.where(active, torch.clamp(st["diverge_cnt"] - 1, min=0),
                                          st["diverge_cnt"]))
    hard_reset = diverge_cnt >= 2 * HOLD_TICKS
    diverge_cnt = torch.where(hard_reset, zero, diverge_cnt)
    promote = promote & ~hard_reset

    # NLMS gradient, the constrained partition, the two-path transfers
    pmask = (torch.arange(P, device=near.device) == c)[None, :, None]
    xr, xi = Xh_r.float(), Xh_i.float()
    p3, r3, h3 = promote[:, None, None], reseed[:, None, None], hard_reset[:, None, None]
    Wm_rf, Wm_if = st["Wm_r"].float(), st["Wm_i"].float()
    if megakernel:
        inv = inv_norm[:, None, :]
        er, ei = Er[:, None, :], Ei[:, None, :]
        gr = torch.where(pmask, gc_r[:, None, :], (xr * er + xi * ei) * inv)
        gi = torch.where(pmask, gc_i[:, None, :], (xr * ei - xi * er) * inv)
        m = mu[:, None, None]
        pf, rf = p3.float(), r3.float()
        up_r, up_i = st["Ws_r"] + m * gr, st["Ws_i"] + m * gi
        Wm_r = (pf * up_r + (1 - pf) * Wm_rf).to(STORE)
        Wm_i = (pf * up_i + (1 - pf) * Wm_if).to(STORE)
        Ws_r = (rf * Wm_rf + (1 - rf) * up_r).masked_fill(h3, 0.0)
        Ws_i = (rf * Wm_if + (1 - rf) * up_i).masked_fill(h3, 0.0)
    else:
        Gr = xr * Er[:, None, :] + xi * Ei[:, None, :]
        Gi = xr * Ei[:, None, :] - xi * Er[:, None, :]
        step_w = mu[:, None, None] * inv_norm[:, None, :]
        up_r = st["Ws_r"].float() + torch.where(pmask, (mu[:, None] * gc_r)[:, None, :], step_w * Gr)
        up_i = st["Ws_i"].float() + torch.where(pmask, (mu[:, None] * gc_i)[:, None, :], step_w * Gi)
        n_r = torch.where(h3, 0.0, torch.where(r3, Wm_rf, up_r))
        n_i = torch.where(h3, 0.0, torch.where(r3, Wm_if, up_i))
        if bf16_shadow:
            salt = st["srk"].to(torch.int64) * 2
            n_r = sround_bf16(n_r, salt, row_base)
            n_i = sround_bf16(n_i, salt + 1, row_base)
            m_r, m_i = n_r, n_i
        else:
            m_r, m_i = up_r.to(STORE), up_i.to(STORE)
        Wm_r = torch.where(p3, m_r, st["Wm_r"])
        Wm_i = torch.where(p3, m_i, st["Wm_i"])
        Ws_r, Ws_i = n_r, n_i
    Em = torch.where(promote, Es, Em)
    Es = torch.where(reseed, Em, Es)
    Es = torch.where(hard_reset, Dn, Es)

    e = torch.where(promote[:, None], e_s, e_m)
    y = torch.where(promote[:, None], y_s, y_m)
    blk_near = (near * near).mean(dim=1)
    blk_err = (e * e).mean(dim=1)
    w_bad = torch.clamp(blk_err / (2.0 * blk_near + 1e-9) - 1.0, 0.0, 1.0)[:, None]
    e = (1.0 - w_bad) * e + w_bad * near
    y = (1.0 - w_bad) * y

    Ey = (y * y).mean(dim=1)
    inst_leak = (e * e).mean(dim=1) / (Ey + 1e-9)
    rise = torch.where(Dn < 1.5 * Ey, LEAK_RISE, 1.0)
    leak = torch.clamp(torch.minimum(st["leak"] * rise, inst_leak), 0.01, 1.0)
    Ehr, Ehi = pr.rfft(e, S)
    mag_e = torch.sqrt(Ehr * Ehr + Ehi * Ehi + 1e-18)
    Yhr, Yhi = pr.rfft(y, S)
    mag_y = torch.sqrt(Yhr * Yhr + Yhi * Yhi + 1e-18)
    gain = torch.clamp((mag_e - SUPPRESS_BETA * torch.sqrt(leak)[:, None] * mag_y)
                       / (mag_e + 1e-9), SUPPRESS_FLOOR, 1.0)
    out = pr.irfft(Ehr * gain, Ehi * gain, S)

    new = {"Wm_r": Wm_r, "Wm_i": Wm_i, "Ws_r": Ws_r, "Ws_i": Ws_i,
           "Xh_r": Xh_r, "Xh_i": Xh_i, "far_prev": far, "Hp": Hp,
           "Em": Em, "Es": Es, "Dn": Dn, "Nf": Nf, "leak": leak,
           "promote_cnt": promote_cnt, "reseed_cnt": reseed_cnt, "diverge_cnt": diverge_cnt,
           "cpos": torch.remainder(cpos + 1, P).to(torch.int32)}
    if bf16_shadow:
        new["srk"] = st["srk"] + 1
    flags = {"promote": promote, "reseed": reseed, "hard_reset": hard_reset}
    return new, out, flags
