"""The hand-written CUDA kernels of the port: build, loader, wrappers, plain
versions and launch counters.

Four kernels in ``csrc/ms2_kernels.cu``, one for each function of the JAX
package that reaches ``pl.pallas_call``
(``mediastreamer2_tpu/ops/pallas_kernels.py``), and the G.722 codec's two in
``csrc/g722_kernels.cu`` and the DVI4 and G.726 codecs' four in
``csrc/adpcm_kernels.cu``, which replace ``lax.scan`` loops (eager PyTorch
would launch each sample's operations one by one):

================  =======================================================
wrapper           replaces
================  =======================================================
fused_volume      ``fused_volume`` / ``_fused_volume_kernel`` (:38-84)
mdf_apply         ``mdf_apply`` / ``_mdf_apply_kernel`` (:113-150)
mdf_update        ``mdf_update`` / ``_mdf_update_kernel`` (:153-201)
mdf_update_fused  ``mdf_update_fused`` / ``_mdf_update_fused_kernel`` (:227-310)
g722_encode       ``g722_encode``, ``mediastreamer2_tpu/ops/g722.py:213``
g722_decode       ``g722_decode``, ``mediastreamer2_tpu/ops/g722.py:221``
dvi4_encode       ``adpcm_encode``, ``mediastreamer2_tpu/ops/adpcm.py:78``
dvi4_decode       ``adpcm_decode``, ``mediastreamer2_tpu/ops/adpcm.py:84``
g726_encode       ``g726_encode``, ``mediastreamer2_tpu/ops/g726.py:172``
g726_decode       ``g726_decode``, ``mediastreamer2_tpu/ops/g726.py:180``
================  =======================================================

``ms2_kernels.cu`` also holds four kernels that replace no loop or Pallas
call of the JAX package, only chains of the port's PyTorch operations on
the echo canceller's path: ``aec_decide`` (its time-domain passes and
per-leg two-path decisions, some ninety [B, S] and [B] operations),
``suppress_gain`` (its residual-echo suppressor's gain on the error
spectrum, some twenty [B, F] passes) and the two layout passes of the DFTs'
FFT path (``spectrum_planes``, ``planes_spectrum``, which ``ops/rfft.py``
calls on the card). They count their launches as the others do.

Build: at first use, ``nvcc`` compiles each source for ``sm_90a`` into a
shared library with a plain C interface under ``_build/``, named by a hash
of the source and the flags (the sources build side by side), and
``ctypes`` loads them. Nothing is compiled or loaded when this module is
imported.

Each wrapper takes tensors on one device. On a CPU tensor it runs its plain
PyTorch version (``*_reference``), the version the CPU tests hold to the JAX
package. On a CUDA tensor it checks dtypes, shapes and contiguity, launches
the kernel on the current stream and adds one to its ``launches`` counter;
it raises on anything else. The plain versions run on either device, which
is how the kernels are checked against them on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "ms2_kernels.cu", _PKG / "csrc" / "g722_kernels.cu",
           _PKG / "csrc" / "adpcm_kernels.cu")
BUILD_DIR = _PKG / "_build"
MDF_MAX_P = 16          # partitions mdf_apply takes (csrc MDF_MAX_P)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels are built from source at first use")


def _build_one(source: Path) -> tuple:
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{source.stem}_{key}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({res.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return out, log


def build() -> tuple:
    """Compile each source unless a build of that exact source and these
    flags exists, one nvcc per source, started together. Returns (library
    paths, nvcc's output, ``-Xptxas -v`` included; kept beside each library,
    so a library already built returns its build's output too)."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        done = list(pool.map(_build_one, SOURCES))
    return tuple(p for p, _ in done), "".join(log for _, log in done)


def _load():
    global _lib
    if _lib is None:
        paths, _ = build()
        main, g722, adpcm = (ctypes.CDLL(str(p)) for p in paths)
        P, I = ctypes.c_void_p, ctypes.c_int
        main.ms2_fused_volume.argtypes = [I] + [P] * 8 + [I, I, P]
        main.ms2_mdf_apply.argtypes = [I, I] + [P] * 12 + [I, I, I, P]
        main.ms2_mdf_update.argtypes = [I] + [P] * 15 + [I, I, I, P]
        main.ms2_mdf_update_fused.argtypes = [I, I] + [P] * 17 + [ctypes.c_uint32, I, I, I, P]
        Fl = ctypes.c_float
        main.ms2_suppress_gain.argtypes = [I] + [P] * 6 + [I, I, Fl, Fl, P]
        main.ms2_spectrum_planes.argtypes = [I] + [P] * 3 + [I, I, I, P]
        main.ms2_planes_spectrum.argtypes = [I] + [P] * 3 + [I, I, Fl, I, P]
        LL = ctypes.c_longlong
        main.ms2_aec_decide.argtypes = [I, P, P, LL, LL, LL, I, I, P]
        g722.ms2_g722_encode.argtypes = [I, P, P, P, I, I, P]
        g722.ms2_g722_decode.argtypes = [I, P, P, P, I, I, P]
        adpcm.ms2_dvi4_encode.argtypes = [I, P, P, P, P, I, I, P]
        adpcm.ms2_dvi4_decode.argtypes = [I, P, P, P, P, I, I, P]
        adpcm.ms2_g726_encode.argtypes = [I, I, P, P, P, I, I, P]
        adpcm.ms2_g726_decode.argtypes = [I, I, P, P, P, I, I, P]
        adpcm.ms2_adpcm_empty.argtypes = [I, I, P]
        fns = (main.ms2_fused_volume, main.ms2_mdf_apply, main.ms2_mdf_update,
               main.ms2_mdf_update_fused, main.ms2_suppress_gain, main.ms2_spectrum_planes,
               main.ms2_planes_spectrum, main.ms2_aec_decide, g722.ms2_g722_encode,
               g722.ms2_g722_decode, adpcm.ms2_dvi4_encode, adpcm.ms2_dvi4_decode,
               adpcm.ms2_g726_encode, adpcm.ms2_g726_decode, adpcm.ms2_adpcm_empty)
        for fn in fns:
            fn.restype = I
        _lib = types.SimpleNamespace(**{fn.__name__: fn for fn in fns})
    return _lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _cuda_device(t: torch.Tensor) -> torch.device:
    """The tensor's device when the kernel path applies to it; raises for a
    device that is neither the CPU nor CUDA."""
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for tensors on {t.device}")
    return t.device


def _launch(fn, device: torch.device, *args):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(device.index, *args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")


_ptr = torch.Tensor.data_ptr


def _wrappers():
    return (fused_volume, mdf_apply, mdf_update, mdf_update_fused, g722_encode, g722_decode,
            dvi4_encode, dvi4_decode, g726_encode, g726_decode, suppress_gain, spectrum_planes,
            planes_spectrum, aec_decide)


def launch_counts() -> dict:
    return {f.__name__: f.launches for f in _wrappers()}


def reset_launch_counts():
    for f in _wrappers():
        f.launches = 0


# ---------------------------------------------------------------------------
# fused_volume
# ---------------------------------------------------------------------------
def fused_volume_reference(x, gain_start, gain_end, dc, dc_enabled):
    """Plain version (semantics of ``pallas_kernels.py:87-94``)."""
    B, S = x.shape
    mean = x.mean(dim=1)
    x = x - (dc * dc_enabled)[:, None]
    ramp = torch.arange(S, dtype=torch.float32, device=x.device)[None, :] / S
    g = gain_start[:, None] * (1 - ramp) + gain_end[:, None] * ramp
    return torch.clamp(x * g, -1.0, 1.0), (x * x).mean(dim=1), mean


def fused_volume(x, gain_start, gain_end, dc, dc_enabled):
    """DC removal + linear gain ramp + clip + metering in one pass.
    x [B,S] f32; per-leg f32 [B]. Returns (y [B,S], energy [B], mean [B])."""
    if x.device.type == "cpu":
        return fused_volume_reference(x, gain_start, gain_end, dc, dc_enabled)
    dev = _cuda_device(x)
    B, S = x.shape
    _check("x", x, torch.float32, (B, S), dev)
    for name, t in (("gain_start", gain_start), ("gain_end", gain_end),
                    ("dc", dc), ("dc_enabled", dc_enabled)):
        _check(name, t, torch.float32, (B,), dev)
    y = torch.empty_like(x)
    energy = torch.empty((B,), dtype=torch.float32, device=dev)
    mean = torch.empty((B,), dtype=torch.float32, device=dev)
    _launch(_load().ms2_fused_volume, dev, _ptr(x), _ptr(gain_start),
            _ptr(gain_end), _ptr(dc), _ptr(dc_enabled), _ptr(y), _ptr(energy),
            _ptr(mean), B, S)
    fused_volume.launches += 1
    return y, energy, mean


fused_volume.launches = 0


# ---------------------------------------------------------------------------
# mdf_apply
# ---------------------------------------------------------------------------
def mdf_apply_reference(Wm_r, Wm_i, Ws_r, Ws_i, Xh_r, Xh_i, Xr, Xi):
    """Plain version: shift the history in place, then sum over p in
    order 0..P-1, as the kernel does. Ws may be bf16 or f32; every operand
    is read as f32."""
    for h, x in ((Xh_r, Xr), (Xh_i, Xi)):
        h[:, 1:] = h[:, :-1].clone()
        h[:, 0] = x.to(h.dtype)
    B, P, F = Wm_r.shape
    acc = [torch.zeros((B, F), dtype=torch.float32, device=Xr.device) for _ in range(4)]
    for p in range(P):
        hr = Xh_r[:, p].float()
        hi = Xh_i[:, p].float()
        mr, mi = Wm_r[:, p].float(), Wm_i[:, p].float()
        sr, si = Ws_r[:, p].float(), Ws_i[:, p].float()
        acc[0] = acc[0] + (mr * hr - mi * hi)
        acc[1] = acc[1] + (mr * hi + mi * hr)
        acc[2] = acc[2] + (sr * hr - si * hi)
        acc[3] = acc[3] + (sr * hi + si * hr)
    return tuple(acc)


def mdf_apply(Wm_r, Wm_i, Ws_r, Ws_i, Xh_r, Xh_i, Xr, Xi):
    """Shift the far-end history (bf16 [B,P,F], in place: the new block
    Xr/Xi [B,F] f32, rounded to bf16, goes to p=0) and apply both filters.
    Wm is bf16 [B,P,F]; Ws is bf16 (the default shadow) or f32 (the
    f32-shadow modes) [B,P,F]. Returns (Ym_r, Ym_i, Ys_r, Ys_i), f32 [B,F].

    The block that drops out of the history is overwritten: read it first."""
    if Xr.device.type == "cpu":
        return mdf_apply_reference(Wm_r, Wm_i, Ws_r, Ws_i, Xh_r, Xh_i, Xr, Xi)
    dev = _cuda_device(Xr)
    B, P, F = Wm_r.shape
    if P > MDF_MAX_P:
        raise ValueError(f"mdf_apply: {P} partitions, the kernel holds at most {MDF_MAX_P}")
    shadow_f32 = Ws_r.dtype == torch.float32
    sdt = torch.float32 if shadow_f32 else torch.bfloat16
    for name, t, dt in (("Wm_r", Wm_r, torch.bfloat16), ("Wm_i", Wm_i, torch.bfloat16),
                        ("Ws_r", Ws_r, sdt), ("Ws_i", Ws_i, sdt),
                        ("Xh_r", Xh_r, torch.bfloat16), ("Xh_i", Xh_i, torch.bfloat16)):
        _check(name, t, dt, (B, P, F), dev)
    _check("Xr", Xr, torch.float32, (B, F), dev)
    _check("Xi", Xi, torch.float32, (B, F), dev)
    outs = [torch.empty((B, F), dtype=torch.float32, device=dev) for _ in range(4)]
    _launch(_load().ms2_mdf_apply, dev, int(shadow_f32), *map(_ptr, (Wm_r, Wm_i, Ws_r, Ws_i,
                                                      Xh_r, Xh_i, Xr, Xi)),
            *map(_ptr, outs), B, P, F)
    mdf_apply.launches += 1
    return tuple(outs)


mdf_apply.launches = 0


# ---------------------------------------------------------------------------
# mdf_update
# ---------------------------------------------------------------------------
def mdf_update_reference(cpos, Ws_r, Ws_i, Wm_r, Wm_i, Xh_r, Xh_i, Er, Ei,
                         inv_norm, gc_r, gc_i, mu, promote, reseed):
    """Plain version (the arithmetic of ``_mdf_update_kernel``,
    ``pallas_kernels.py:153-175``, then the RNE cast of Wm of
    ``ops/aec.py:445-446``); updates Ws and Wm in place, as the kernel does."""
    P = Ws_r.shape[1]
    use_c = (torch.arange(P, device=Ws_r.device) == cpos)[None, :, None]
    xr, xi = Xh_r.float(), Xh_i.float()
    er, ei = Er[:, None, :], Ei[:, None, :]
    inv = inv_norm[:, None, :]
    gr = torch.where(use_c, gc_r[:, None, :], (xr * er + xi * ei) * inv)
    gi = torch.where(use_c, gc_i[:, None, :], (xr * ei - xi * er) * inv)
    m = mu[:, None, None]
    pr, rs = promote[:, None, None], reseed[:, None, None]
    outs = []
    for ws, wm, g in ((Ws_r, Wm_r, gr), (Ws_i, Wm_i, gi)):
        up = ws + m * g
        wmf = wm.float()
        outs.append(((pr * up + (1 - pr) * wmf).to(torch.bfloat16),
                     rs * wmf + (1 - rs) * up))
    for (wm_new, ws_new), ws, wm in zip(outs, (Ws_r, Ws_i), (Wm_r, Wm_i)):
        wm.copy_(wm_new)
        ws.copy_(ws_new)
    return Ws_r, Ws_i, Wm_r, Wm_i


def mdf_update(cpos, Ws_r, Ws_i, Wm_r, Wm_i, Xh_r, Xh_i, Er, Ei, inv_norm,
               gc_r, gc_i, mu, promote, reseed):
    """The megakernel configuration's NLMS update + round-robin constraint
    + promote / reseed blends, in place (no hard reset: the caller applies
    it after, as ``ops/aec.py:543-546`` does).

    cpos: int32 scalar tensor; Ws: f32 [B,P,F]; Wm, Xh: bf16 [B,P,F];
    Er, Ei, inv_norm, gc_r, gc_i: f32 [B,F]; mu, promote, reseed: f32 [B]
    (promote and reseed 0/1). Returns (Ws_r, Ws_i, Wm_r, Wm_i), the updated
    inputs; Wm is the blend rounded to bf16 with RNE."""
    if Ws_r.device.type == "cpu":
        return mdf_update_reference(cpos, Ws_r, Ws_i, Wm_r, Wm_i, Xh_r, Xh_i,
                                    Er, Ei, inv_norm, gc_r, gc_i, mu, promote, reseed)
    dev = _cuda_device(Ws_r)
    B, P, F = Ws_r.shape
    for name, t, dt in (("Ws_r", Ws_r, torch.float32), ("Ws_i", Ws_i, torch.float32),
                        ("Wm_r", Wm_r, torch.bfloat16), ("Wm_i", Wm_i, torch.bfloat16),
                        ("Xh_r", Xh_r, torch.bfloat16), ("Xh_i", Xh_i, torch.bfloat16)):
        _check(name, t, dt, (B, P, F), dev)
    for name, t in (("Er", Er), ("Ei", Ei), ("inv_norm", inv_norm),
                    ("gc_r", gc_r), ("gc_i", gc_i)):
        _check(name, t, torch.float32, (B, F), dev)
    for name, t in (("mu", mu), ("promote", promote), ("reseed", reseed)):
        _check(name, t, torch.float32, (B,), dev)
    _check("cpos", cpos, torch.int32, (), dev)
    _launch(_load().ms2_mdf_update, dev,
            *map(_ptr, (cpos, Ws_r, Ws_i, Wm_r, Wm_i, Xh_r, Xh_i, Er, Ei,
                        inv_norm, gc_r, gc_i, mu, promote, reseed)), B, P, F)
    mdf_update.launches += 1
    return Ws_r, Ws_i, Wm_r, Wm_i


mdf_update.launches = 0


# ---------------------------------------------------------------------------
# mdf_update_fused
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """(a * c) mod 2**32 for int64 tensors a in [0, 2**32) and a constant c
    in [0, 2**32), without overflowing int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def sround_bf16(x, salt, lin0: int = 0):
    """Stochastically round f32 -> bf16, bit for bit as ``_sround_bf16`` in
    ``mediastreamer2_tpu/ops/aec.py:137-154``: add 16 bits of a hash of the
    row-major linear index and ``salt`` to the f32 bit pattern, truncate.

    ``lin0`` is the linear index of ``x``'s first element in the whole
    tensor that ``x`` is rows of (a shard's ``offset * P * F``), so a
    shard rounds its rows as the unsharded tensor does; the index wraps
    mod 2**32 as JAX's uint32 iota does.

    The uint32 arithmetic runs in int64 masked to 32 bits, since PyTorch on
    the CPU has no uint32 add or shift. ``salt`` is an int or an int64
    tensor scalar."""
    x = x.contiguous()
    dev = x.device
    lin = (torch.arange(x.numel(), dtype=torch.int64, device=dev).reshape(x.shape)
           + (lin0 & _M32)) & _M32
    bits = x.view(torch.int32).to(torch.int64) & _M32
    salt = torch.as_tensor(salt, dtype=torch.int64, device=dev) & _M32
    h = (_mul32(lin, 2654435761) + _mul32(salt, 0x9E3779B9)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    top = (((bits + (h & 0xFFFF)) & _M32) >> 16)            # 0 .. 0xFFFF
    top = top - ((top >> 15) << 16)                           # as int16
    return top.to(torch.int16).view(torch.bfloat16)


def mdf_update_fused_reference(cpos, Ws_r, Ws_i, Wm_r, Wm_i, Xh_r, Xh_i,
                               Er, Ei, inv_norm, gc_r, gc_i, mu, promote,
                               reseed, hard_reset, srk=None, lin0: int = 0):
    """Plain version; updates Ws and Wm in place, as the kernel does.
    ``lin0``: the stochastic rounding's index offset (``sround_bf16``)."""
    B, P, F = Ws_r.shape
    dev = Ws_r.device
    pmask = torch.arange(P, device=dev)[None, :, None] == cpos
    xr, xi = Xh_r.float(), Xh_i.float()
    Gr = xr * Er[:, None, :] + xi * Ei[:, None, :]
    Gi = xr * Ei[:, None, :] - xi * Er[:, None, :]
    step_w = mu[:, None, None] * inv_norm[:, None, :]
    up_r = Ws_r.float() + torch.where(pmask, (mu[:, None] * gc_r)[:, None, :], step_w * Gr)
    up_i = Ws_i.float() + torch.where(pmask, (mu[:, None] * gc_i)[:, None, :], step_w * Gi)
    p3 = promote[:, None, None]
    r3 = reseed[:, None, None]
    h3 = hard_reset[:, None, None]
    n_r = torch.where(h3, 0.0, torch.where(r3, Wm_r.float(), up_r))
    n_i = torch.where(h3, 0.0, torch.where(r3, Wm_i.float(), up_i))
    if Ws_r.dtype == torch.bfloat16:
        salt = torch.as_tensor(srk, dtype=torch.int64, device=dev) * 2
        n_r = sround_bf16(n_r, salt, lin0)
        n_i = sround_bf16(n_i, salt + 1, lin0)
        m_r, m_i = n_r, n_i
    else:
        m_r, m_i = up_r.to(torch.bfloat16), up_i.to(torch.bfloat16)
    Wm_r.copy_(torch.where(p3, m_r, Wm_r))
    Wm_i.copy_(torch.where(p3, m_i, Wm_i))
    Ws_r.copy_(n_r)
    Ws_i.copy_(n_i)
    return Ws_r, Ws_i, Wm_r, Wm_i


def mdf_update_fused(cpos, Ws_r, Ws_i, Wm_r, Wm_i, Xh_r, Xh_i, Er, Ei,
                     inv_norm, gc_r, gc_i, mu, promote, reseed, hard_reset,
                     srk=None, lin0: int = 0):
    """NLMS update + round-robin constraint + two-path transfers, in place.

    cpos: int32 scalar tensor (partition constrained this tick);
    Ws: f32 or bf16 [B,P,F] (its dtype picks the mode, see the kernel's
    note); Wm, Xh: bf16 [B,P,F]; Er, Ei, inv_norm, gc_r, gc_i: f32 [B,F];
    mu: f32 [B]; promote, reseed, hard_reset: bool [B]; srk: int64 scalar
    tensor, the stochastic-rounding counter (bf16 mode only); lin0: the
    rounding hash's index of element 0 (a shard's ``offset * P * F``,
    mod 2**32; ``sround_bf16``).
    Returns (Ws_r, Ws_i, Wm_r, Wm_i), the updated inputs."""
    if Ws_r.device.type == "cpu":
        return mdf_update_fused_reference(cpos, Ws_r, Ws_i, Wm_r, Wm_i, Xh_r,
                                          Xh_i, Er, Ei, inv_norm, gc_r, gc_i,
                                          mu, promote, reseed, hard_reset, srk, lin0)
    dev = _cuda_device(Ws_r)
    B, P, F = Ws_r.shape
    bf16_shadow = Ws_r.dtype == torch.bfloat16
    sdt = torch.bfloat16 if bf16_shadow else torch.float32
    for name, t, dt in (("Ws_r", Ws_r, sdt), ("Ws_i", Ws_i, sdt),
                        ("Wm_r", Wm_r, torch.bfloat16), ("Wm_i", Wm_i, torch.bfloat16),
                        ("Xh_r", Xh_r, torch.bfloat16), ("Xh_i", Xh_i, torch.bfloat16)):
        _check(name, t, dt, (B, P, F), dev)
    for name, t in (("Er", Er), ("Ei", Ei), ("inv_norm", inv_norm),
                    ("gc_r", gc_r), ("gc_i", gc_i)):
        _check(name, t, torch.float32, (B, F), dev)
    _check("mu", mu, torch.float32, (B,), dev)
    for name, t in (("promote", promote), ("reseed", reseed), ("hard_reset", hard_reset)):
        _check(name, t, torch.bool, (B,), dev)
    _check("cpos", cpos, torch.int32, (), dev)
    if bf16_shadow:
        if srk is None:
            raise ValueError("srk is required with a bf16 shadow")
        _check("srk", srk, torch.int64, (), dev)
    _launch(_load().ms2_mdf_update_fused, dev, int(bf16_shadow),
            *map(_ptr, (cpos, Ws_r, Ws_i, Wm_r, Wm_i, Xh_r, Xh_i, Er, Ei,
                        inv_norm, gc_r, gc_i, mu, promote, reseed, hard_reset)),
            _ptr(srk) if bf16_shadow else None, lin0 & _M32, B, P, F)
    mdf_update_fused.launches += 1
    return Ws_r, Ws_i, Wm_r, Wm_i


mdf_update_fused.launches = 0


# ---------------------------------------------------------------------------
# suppress_gain: the echo canceller's residual-echo suppressor gain
# ---------------------------------------------------------------------------
def suppress_gain_reference(Er, Ei, Yr, Yi, leak, beta, floor_gain):
    """Plain version (the port's ``ops/aec.py`` before the kernel)."""
    mag_e = torch.sqrt(Er * Er + Ei * Ei + 1e-18)
    mag_y = torch.sqrt(Yr * Yr + Yi * Yi + 1e-18)
    resid_mag = torch.sqrt(leak)[:, None] * mag_y
    gain = torch.clamp((mag_e - beta * resid_mag) / (mag_e + 1e-9), floor_gain, 1.0)
    return Er * gain, Ei * gain


def suppress_gain(Er, Ei, Yr, Yi, leak, beta, floor_gain):
    """The suppressor's gain on the error spectrum: (Er, Ei) of the error
    and (Yr, Yi) of the echo estimate [B, F] f32, ``leak`` [B] -> the
    error spectrum times clamp((|E| - beta sqrt(leak) |Y|) / |E|, floor, 1),
    as (re, im) planes of one [2, B, F] tensor."""
    if Er.device.type == "cpu":
        return suppress_gain_reference(Er, Ei, Yr, Yi, leak, beta, floor_gain)
    dev = _cuda_device(Er)
    B, F = Er.shape
    for name, t in (("Er", Er), ("Ei", Ei), ("Yr", Yr), ("Yi", Yi)):
        _check(name, t, torch.float32, (B, F), dev)
    _check("leak", leak, torch.float32, (B,), dev)
    if B * F >= 2 ** 31:
        raise ValueError(f"Er: {B} x {F} elements, at most 2^31 - 1")
    out = torch.empty((2, B, F), dtype=torch.float32, device=dev)
    _launch(_load().ms2_suppress_gain, dev, *map(_ptr, (Er, Ei, Yr, Yi, leak, out)), B, F,
            beta, floor_gain)
    suppress_gain.launches += 1
    return out[0], out[1]


suppress_gain.launches = 0


# ---------------------------------------------------------------------------
# aec_decide: the echo canceller's time-domain passes and two-path decisions
# ---------------------------------------------------------------------------
# the echo canceller's [B] state rows that aec_decide reads and returns, in
# its argument and output order
DECIDE_ROWS = ("Em", "Es", "Dn", "Nf", "promote_cnt", "reseed_cnt", "diverge_cnt", "leak")


class DecideConsts(NamedTuple):
    """The two-path decisions' and the leak tracker's thresholds, as
    ``ops/aec.py`` names them (``aec.DECIDE``); the kernel takes them in
    this order (csrc: DecConsts)."""
    err_ewma: float         # ERR_EWMA
    err_new: float          # 1 - ERR_EWMA
    copy_ratio: float       # COPY_RATIO
    erle_gate: float        # ERLE_GATE
    reset_ratio: float      # RESET_RATIO
    nf_creep: float         # NF_CREEP
    nf_active: float        # NF_ACTIVE
    floor_ratio: float      # FLOOR_RATIO
    main_gate: float        # MAIN_GATE
    active_pow: float       # ACTIVE_POW
    diverge_ratio: float    # DIVERGE_RATIO
    blowup_ratio: float     # BLOWUP_RATIO
    limit_ratio: float      # LIMIT_RATIO
    leak_rise: float        # LEAK_RISE
    leak_gate: float        # LEAK_GATE
    leak_floor: float       # LEAK_FLOOR
    eps: float              # POW_EPS
    hold: int               # HOLD_TICKS
    diverge_hold: int       # DIVERGE_HOLD


def aec_decide_reference(near, y_m, y_s, Em, Es, Dn, Nf, promote_cnt, reseed_cnt,
                         diverge_cnt, leak, enabled, c, suppress=True):
    """Plain version: the port's ``ops/aec.py`` code before the kernel, in
    its order of operations, with ``c``'s thresholds."""
    e_m = near - y_m
    e_s = near - y_s
    # --- two-path transfer decisions (per-leg, hysteretic) ------------------
    near_pow = (near * near).mean(dim=1)
    Em = c.err_ewma * Em + c.err_new * (e_m * e_m).mean(dim=1)
    Es = c.err_ewma * Es + c.err_new * (e_s * e_s).mean(dim=1)
    Dn = c.err_ewma * Dn + c.err_new * near_pow
    # shadow-error floor via min statistics
    Nf = torch.where(Dn > c.nf_active, torch.minimum(Nf * c.nf_creep, Es), Nf)
    at_floor = Es < c.floor_ratio * Nf
    better = (Es < c.copy_ratio * Em) & ((Es < c.erle_gate * Dn) | at_floor)
    worse = (Es > c.reset_ratio * Em) & (Em < c.main_gate * Dn)
    zero = torch.zeros_like(promote_cnt)
    promote_cnt = torch.where(better, promote_cnt + 1, zero)
    reseed_cnt = torch.where(worse, reseed_cnt + 1, zero)
    promote = promote_cnt >= c.hold
    reseed = reseed_cnt >= c.hold
    promote_cnt = torch.where(promote, zero, promote_cnt)
    reseed_cnt = torch.where(reseed, zero, reseed_cnt)
    # catastrophic-divergence insurance (leaky evidence counter)
    active = Dn > c.active_pow
    diverged = ((torch.minimum(Em, Es) > c.diverge_ratio * Dn) | (Es > c.blowup_ratio * Dn)) \
        & active
    diverge_cnt = torch.where(
        diverged, diverge_cnt + 1,
        torch.where(active, torch.clamp(diverge_cnt - 1, min=0), diverge_cnt))
    hard_reset = diverge_cnt >= c.diverge_hold
    diverge_cnt = torch.where(hard_reset, zero, diverge_cnt)
    # never promote taps declared catastrophically diverged this tick
    promote = promote & ~hard_reset
    # the transfers' error energies (the taps move in the update)
    Em = torch.where(promote, Es, Em)
    Es = torch.where(reseed, Em, Es)
    Es = torch.where(hard_reset, Dn, Es)
    e = torch.where(promote[:, None], e_s, e_m)
    y = torch.where(promote[:, None], y_s, y_m)
    # per-tick output limiter: blend back toward the mic (continuously) if
    # the selected filter makes this block worse than the raw mic
    blk_err = (e * e).mean(dim=1)
    w_bad = torch.clamp(blk_err / (c.limit_ratio * near_pow + c.eps) - 1.0, 0.0, 1.0)[:, None]
    e = (1.0 - w_bad) * e + w_bad * near
    y = (1.0 - w_bad) * y
    e = torch.where(enabled[:, None], e, near)
    if suppress:
        # `leak` is the residual/echo power ratio, tracked as a slow minimum
        Ey = (y * y).mean(dim=1)
        inst_leak = (e * e).mean(dim=1) / (Ey + c.eps)
        rise = torch.where(Dn < c.leak_gate * Ey, c.leak_rise, 1.0)
        leak = torch.clamp(torch.minimum(leak * rise, inst_leak), c.leak_floor, 1.0)
    else:
        y = None
    return (e_s, e, y, Em, Es, Dn, Nf, promote_cnt, reseed_cnt, diverge_cnt, leak,
            promote, reseed, hard_reset)


def aec_decide(near, y_m, y_s, Em, Es, Dn, Nf, promote_cnt, reseed_cnt, diverge_cnt, leak,
               enabled, c, suppress=True):
    """The echo canceller's error signals, two-path decisions, output
    limiter and (``suppress``) the suppressor's leak tracker, a leg a row,
    with the thresholds ``c`` (a ``DecideConsts``).

    near, y_m, y_s: f32 [B, S] (each row's samples contiguous, the rows at
    any stride: y_m and y_s are views of the overlap-save output); the [B]
    state rows of ``DECIDE_ROWS`` (f32, the counters int32); enabled: bool
    [B]. Returns (e_s, e, y, the new state rows in ``DECIDE_ROWS``'s order,
    promote, reseed, hard_reset): e_s the shadow's error, e and y the
    output and the echo estimate the suppressor takes ([B, S] f32; y None
    without the suppressor, and leak then the one given); the flags bool
    [B]."""
    rows_in = (Em, Es, Dn, Nf, promote_cnt, reseed_cnt, diverge_cnt, leak)
    if near.device.type == "cpu":
        return aec_decide_reference(near, y_m, y_s, *rows_in, enabled, c, suppress)
    dev = _cuda_device(near)
    B, S = near.shape
    if S < 1:
        raise ValueError("aec_decide: no samples a tick")
    for name, t in (("near", near), ("y_m", y_m), ("y_s", y_s)):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != (B, S):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, expected "
                             f"float32 {(B, S)} on {dev}")
        if t.stride(1) != 1:
            raise ValueError(f"{name}: a row's samples are not contiguous")
    for name, t in zip(DECIDE_ROWS, rows_in):
        _check(name, t, torch.int32 if name.endswith("_cnt") else torch.float32, (B,), dev)
    _check("enabled", enabled, torch.bool, (B,), dev)
    sig = torch.empty((3 if suppress else 2, B, S), dtype=torch.float32, device=dev)
    rows = torch.empty((8, B), dtype=torch.float32, device=dev)
    flags = torch.empty((3, B), dtype=torch.bool, device=dev)
    ptrs = (ctypes.c_void_p * 17)(
        *map(_ptr, (near, y_m, y_s, *rows_in, enabled, sig[0], sig[1])),
        _ptr(sig[2]) if suppress else None, _ptr(rows), _ptr(flags))
    consts = (ctypes.c_float * len(c))(*c)
    _launch(_load().ms2_aec_decide, dev, ptrs, consts, near.stride(0), y_m.stride(0),
            y_s.stride(0), B, S)
    aec_decide.launches += 1
    counts = rows[4:7].view(torch.int32)
    return (sig[0], sig[1], sig[2] if suppress else None, rows[0], rows[1], rows[2], rows[3],
            counts[0], counts[1], counts[2], rows[7] if suppress else leak, flags[0], flags[1],
            flags[2])


aec_decide.launches = 0


# ---------------------------------------------------------------------------
# spectrum_planes / planes_spectrum: the DFTs' FFT path's layout passes
# ---------------------------------------------------------------------------
def spectrum_planes_reference(z, alternate=False):
    """Plain version: (re, im) of ``z`` [..., F] complex64, both planes of
    one contiguous [2, ..., F] copy (times (-1)^k with ``alternate``)."""
    factor = torch.ones((z.shape[-1],), dtype=torch.float32, device=z.device)
    if alternate:
        factor[1::2] = -1.0
    ri = torch.view_as_real(z).movedim(-1, 0)
    out = torch.mul(ri, factor, out=torch.empty(ri.shape, dtype=torch.float32, device=z.device))
    return out[0], out[1]


def spectrum_planes(z, alternate=False):
    """A complex spectrum as contiguous planes: ``z`` [..., F] complex64 ->
    (re, im) [..., F] float32, both planes of one [2, ..., F] tensor, times
    (-1)^k with ``alternate`` (the spectrum of a block shifted by n/2)."""
    if z.device.type == "cpu":
        return spectrum_planes_reference(z, alternate)
    dev = _cuda_device(z)
    if z.dtype != torch.complex64 or not z.is_contiguous():
        raise ValueError(f"z: {z.dtype}, contiguous {z.is_contiguous()}: needs contiguous "
                         f"complex64")
    F = z.shape[-1]
    rows = z.numel() // F if F else 0
    if rows * F >= 2 ** 31:
        raise ValueError(f"z: {rows} x {F} elements, at most 2^31 - 1")
    out = torch.empty((2, *z.shape), dtype=torch.float32, device=dev)
    p = out.data_ptr()
    _launch(_load().ms2_spectrum_planes, dev, z.data_ptr(), p, p + 4 * rows * F, rows, F,
            int(alternate))
    spectrum_planes.launches += 1
    return out[0], out[1]


spectrum_planes.launches = 0


def planes_spectrum_reference(re, im, n):
    """Plain version: (re + i im) / n, the imaginary part zeroed at DC and,
    for an even ``n``, at Nyquist."""
    scale = 1.0 / n
    w = torch.full((re.shape[-1],), scale, dtype=torch.float32, device=re.device)
    w[0] = 0.0
    if n % 2 == 0:
        w[-1] = 0.0
    return torch.complex(re * scale, im * w)


def planes_spectrum(re, im, n):
    """The input of an unnormalised complex-to-real transform of length
    ``n``: (re, im) [..., F] float32 -> (re + i im) / n [..., F] complex64,
    the imaginary parts of DC and (n even) Nyquist zeroed, as a real
    signal's spectrum has them."""
    if re.device.type == "cpu":
        return planes_spectrum_reference(re, im, n)
    dev = _cuda_device(re)
    F = re.shape[-1]
    for name, t in (("re", re), ("im", im)):
        _check(name, t, torch.float32, re.shape, dev)
    rows = re.numel() // F if F else 0
    if rows * F >= 2 ** 31:
        raise ValueError(f"re: {rows} x {F} elements, at most 2^31 - 1")
    z = torch.empty(re.shape, dtype=torch.complex64, device=dev)
    _launch(_load().ms2_planes_spectrum, dev, re.data_ptr(), im.data_ptr(), z.data_ptr(),
            rows, F, 1.0 / n, int(n % 2 == 0))
    planes_spectrum.launches += 1
    return z


planes_spectrum.launches = 0


# ---------------------------------------------------------------------------
# g722_encode / g722_decode
# ---------------------------------------------------------------------------
_BAND_KEYS = ("s", "sp", "sz", "r", "a", "p", "d", "b", "nb", "det")
_I32 = torch.int32


def g722_state_leaves(state) -> list:
    """The 21 leaves of a ``g722_state`` tree in the kernels' order:
    lo.{s, sp, sz, r, a, p, d, b, nb, det}, hi.{the same}, x."""
    return [state[band][k] for band in ("lo", "hi") for k in _BAND_KEYS] + [state["x"]]


def _g722_sat16(x):
    return torch.clamp(x, -32768, 32767)


# The plain versions carry both ADPCM bands in one set of tensors: every
# leaf stacked as [B, 2, ...], the lower band at index 0 and the higher at
# 1, so that block 4 and the log scale factor run once for both bands (the
# slot's arithmetic is the same; half the operations to launch). Per-band
# constants of _scalel (nb's clamp, the shift base) become [2] tensors, and
# its WL / WH tables one table with the higher band's at offset 8.
def _g722_scalel(z, il4, T):
    """LOGSCL/LOGSCH + SCALEL/SCALEH (``g722.py:128-136``), both bands:
    il4 [B, 2] -> z's nb and det, updated."""
    nb = torch.minimum(torch.clamp(((z["nb"] * 127) >> 7) + T["wl_wh"][il4 + T["wl_off"]],
                                   min=0), T["nb_max"])
    v = T["ilb"][(nb >> 6) & 31]
    wd2 = T["shift_base"] - (nb >> 11)
    # both shifts by a count >= 0 (a negative count is not a shift)
    wd3 = torch.where(wd2 < 0, v << torch.clamp(-wd2, min=0), v >> torch.clamp(wd2, min=0))
    z["nb"], z["det"] = nb, wd3 << 2


def _g722_block4(z, d):
    """ITU G.722 block 4 (``g722.py:83-125``), both bands: the pole/zero
    predictor's adaptation with the quantized differences d [B, 2] and the
    next prediction."""
    r, a, p, dd, b = z["r"], z["a"], z["p"], z["d"], z["b"]
    r0 = _g722_sat16(z["s"] + d)                                 # RECONS
    p0 = _g722_sat16(z["sz"] + d)                                # PARREC
    sg0 = p0 >> 15
    same1 = sg0 == (p[..., 1] >> 15)
    # UPPOL2
    wd1 = _g722_sat16(a[..., 1] << 2)
    wd2 = torch.clamp(torch.where(same1, -wd1, wd1), max=32767)
    wd3 = ((sg0 == (p[..., 2] >> 15)).to(_I32) * 256 - 128 + (wd2 >> 7)
           + ((a[..., 2] * 32512) >> 15))
    ap2 = torch.clamp(wd3, -12288, 12288)
    # UPPOL1
    ap1 = _g722_sat16(same1.to(_I32) * 384 - 192 + ((a[..., 1] * 32640) >> 15))
    wd3 = _g722_sat16(15360 - ap2)
    ap1 = torch.minimum(torch.maximum(ap1, -wd3), wd3)
    # UPZERO
    step = ((d != 0).to(_I32) * 128)[..., None]
    wd2 = torch.where((dd[..., 1:7] >> 15) == (d >> 15)[..., None], step, -step)
    bp = _g722_sat16(wd2 + ((b[..., 1:7] * 32640) >> 15))
    # DELAYA
    dd = torch.cat([d[..., None], d[..., None], dd[..., 1:6]], dim=-1)
    b = torch.cat([b[..., :1], bp], dim=-1)
    r2 = r[..., 1]
    z.update(r=torch.stack([r0, r0, r2], dim=-1), p=torch.stack([p0, p0, p[..., 1]], dim=-1),
             a=torch.stack([a[..., 0], ap1, ap2], dim=-1), d=dd, b=b)
    # FILTEP
    sp = _g722_sat16(((ap1 * _g722_sat16(r0 + r0)) >> 15) + ((ap2 * _g722_sat16(r2 + r2)) >> 15))
    # FILTEZ (torch.sum of int32 would return int64: keep int32, as jnp.sum)
    sz = _g722_sat16(((b[..., 1:7] * _g722_sat16(dd[..., 1:7] + dd[..., 1:7])) >> 15)
                     .sum(dim=-1, dtype=_I32))
    z.update(s=_g722_sat16(sp + sz), sp=sp, sz=sz)


def _g722_stack(state):
    return {k: torch.stack([state["lo"][k], state["hi"][k]], dim=1) for k in _BAND_KEYS}


def _g722_store(state, z, x):
    """Write the loop's final state into ``state``'s tensors, in place (as
    the kernels do)."""
    for k in _BAND_KEYS:
        state["lo"][k].copy_(z[k][:, 0])
        state["hi"][k].copy_(z[k][:, 1])
    state["x"].copy_(x)


def _g722_qmf(line, T):
    """The QMF's two 12-tap sums for every code slot of a tick at once, as
    the kernels compute them over their lanes: line int32 [B, 22 + 2C], the
    delay line's 22 carried samples and then 2 samples a slot; slot j's
    window is line[:, 2j:2j + 24]. Returns (the even-indexed samples by the
    QMF, the odd-indexed by the QMF reversed), int32 [B, C] each: the
    reference's sumodd and sumeven (xout2 and xout1 when decoding)."""
    w = line.unfold(1, 24, 2)                                    # [B, C, 24]
    return ((w[..., 0::2] * T["qmf"]).sum(dim=-1, dtype=_I32),
            (w[..., 1::2] * T["qmf_rev"]).sum(dim=-1, dtype=_I32))


def g722_encode_reference(pcm, state):
    """Plain version of ``_enc_step`` (``g722.py:139-178``) over a tick in
    torch int32, decomposed as the kernel is: the QMF of every slot in one
    pass over the delay line, then the slot loop of the two ADPCM bands
    (stacked). pcm int32 [B, S] (S even) -> codes int32 [B, S/2]; updates
    ``state``'s tensors in place."""
    from mediastreamer2_tpu_torch.ops.g722 import g722_tables
    T = g722_tables(pcm.device)
    S = pcm.shape[1]
    z = _g722_stack(state)
    # QMF transmit: split the bands of every slot
    line = torch.cat([state["x"][:, 2:], pcm], dim=1)
    sumodd, sumeven = _g722_qmf(line, T)
    xbands = torch.stack([sumeven + sumodd, sumeven - sumodd], dim=2) >> 13  # [B, C, 2]
    codes = []
    for j in range(S // 2):
        e = _g722_sat16(xbands[:, j] - z["s"])                   # el, eh [B, 2]
        wd = torch.where(e >= 0, e, -(e + 1))
        det_lo, det_hi = z["det"][:, 0], z["det"][:, 1]
        # lower band (6-bit)
        th = (T["q6"][None, 1:30] * det_lo[:, None]) >> 12
        i = 1 + (wd[:, :1] >= th).sum(dim=1)
        ilow = torch.where(e[:, 0] < 0, T["iln"][i], T["ilp"][i])
        ril = ilow >> 2
        # higher band (2-bit)
        mih = (wd[:, 1] >= ((564 * det_hi) >> 12)).long() + 1
        ihigh = torch.where(e[:, 1] < 0, T["ihn"][mih], T["ihp"][mih])
        d = torch.stack([(det_lo * T["qm4"][ril]) >> 15, (det_hi * T["qm2"][ihigh]) >> 15], dim=1)
        _g722_scalel(z, torch.stack([T["rl42"][ril], T["rh2"][ihigh]], dim=1), T)
        _g722_block4(z, d)
        codes.append((ihigh << 6) | ilow)
    _g722_store(state, z, line[:, -24:])
    return torch.stack(codes, dim=1), state


def g722_decode_reference(codes, state):
    """Plain version of ``_dec_step`` (``g722.py:181-210``) over a tick in
    torch int32, decomposed as the kernel is: the slot loop of the two ADPCM
    bands, then the QMF of every slot in one pass over the delay line.
    codes int32 [B, C] -> pcm int32 [B, 2C] (16 kHz), wrapped to int16 as
    the reference's cast does; updates ``state`` in place."""
    from mediastreamer2_tpu_torch.ops.g722 import g722_tables
    T = g722_tables(codes.device)
    B, C = codes.shape
    z = _g722_stack(state)
    recon = []
    for j in range(C):
        code = codes[:, j]
        ilow = code & 0x3F
        ihigh = (code >> 6) & 3
        det_lo, s = z["det"][:, 0], z["s"]
        # lower band: 6-bit inverse quantizer for the signal, 4-bit for the
        # adaptation; higher band: 2-bit
        rlow = torch.clamp(s[:, 0] + ((det_lo * T["qm6"][ilow]) >> 15), -16384, 16383)
        d = (z["det"] * T["qm4_qm2"][torch.stack([ilow >> 2, ihigh], dim=1) + T["qm_off"]]) >> 15
        rhigh = torch.clamp(d[:, 1] + s[:, 1], -16384, 16383)
        _g722_scalel(z, torch.stack([T["rl42"][ilow >> 2], T["rh2"][ihigh]], dim=1), T)
        _g722_block4(z, d)
        recon.append(torch.stack([rlow + rhigh, rlow - rhigh], dim=1))
    # QMF receive: recombine every slot into two 16 kHz samples
    line = torch.cat([state["x"][:, 2:], torch.stack(recon, dim=1).reshape(B, 2 * C)], dim=1)
    xout2, xout1 = _g722_qmf(line, T)
    _g722_store(state, z, line[:, -24:])
    pcm = torch.stack([xout1 >> 12, xout2 >> 12], dim=2).reshape(B, 2 * C)
    return ((pcm + 32768) & 0xFFFF) - 32768, state


_G722_LEAF_SHAPES = {"s": (), "sp": (), "sz": (), "r": (3,), "a": (3,), "p": (3,),
                     "d": (7,), "b": (7,), "nb": (), "det": ()}


def _g722_launch(fn, inp, out, state, dev, C):
    B = inp.shape[0]
    for band in ("lo", "hi"):
        for k in _BAND_KEYS:
            _check(f"{band}.{k}", state[band][k], torch.int32,
                   (B,) + _G722_LEAF_SHAPES[k], dev)
    _check("x", state["x"], torch.int32, (B, 24), dev)
    ptrs = (ctypes.c_void_p * 21)(*map(_ptr, g722_state_leaves(state)))
    _launch(fn, dev, _ptr(inp), _ptr(out), ptrs, B, C)


def g722_encode(pcm, state):
    """G.722 encode of one tick for every leg: pcm int32 [B, S] (16 kHz,
    S even) -> codes int32 [B, S/2]. ``state`` (``ops/g722.g722_state``) is
    updated in place and returned."""
    if pcm.device.type == "cpu":
        return g722_encode_reference(pcm, state)
    dev = _cuda_device(pcm)
    B, S = pcm.shape
    if S % 2:
        raise ValueError(f"g722_encode: {S} samples a tick, expected an even count")
    _check("pcm", pcm, torch.int32, (B, S), dev)
    if pcm.data_ptr() % 8:
        raise ValueError("g722_encode: pcm must be 8-byte aligned (read as sample pairs)")
    codes = torch.empty((B, S // 2), dtype=torch.int32, device=dev)
    _g722_launch(_load().ms2_g722_encode, pcm, codes, state, dev, S // 2)
    g722_encode.launches += 1
    return codes, state


g722_encode.launches = 0


def g722_decode(codes, state):
    """G.722 decode of one tick for every leg: codes int32 [B, C] -> pcm
    int32 [B, 2C] (16 kHz). ``state`` is updated in place and returned."""
    if codes.device.type == "cpu":
        return g722_decode_reference(codes, state)
    dev = _cuda_device(codes)
    B, C = codes.shape
    _check("codes", codes, torch.int32, (B, C), dev)
    pcm = torch.empty((B, 2 * C), dtype=torch.int32, device=dev)
    _g722_launch(_load().ms2_g722_decode, codes, pcm, state, dev, C)
    g722_decode.launches += 1
    return pcm, state


g722_decode.launches = 0


# ---------------------------------------------------------------------------
# dvi4_encode / dvi4_decode
# ---------------------------------------------------------------------------
def dvi4_encode_reference(pcm, pred, index):
    """Plain version: the sample loop of ``_enc_step`` (``adpcm.py:35-58``) in
    torch int32. pcm int32 [B, S] -> codes int32 [B, S] (0..15); updates
    ``pred`` and ``index`` (int32 [B]) in place, as the kernel does."""
    from mediastreamer2_tpu_torch.ops.adpcm import dvi4_tables
    step_tab, idx_tab = dvi4_tables(pcm.device)
    p, ix = pred, index
    codes = []
    for j in range(pcm.shape[1]):
        step = step_tab[ix]
        diff = pcm[:, j] - p
        sign = (diff < 0).to(_I32) << 3
        diff = diff.abs()
        vpdiff = step >> 3
        b2 = diff >= step
        diff = torch.where(b2, diff - step, diff)
        vpdiff = vpdiff + torch.where(b2, step, 0)
        b1 = diff >= (step >> 1)
        diff = torch.where(b1, diff - (step >> 1), diff)
        vpdiff = vpdiff + torch.where(b1, step >> 1, 0)
        b0 = diff >= (step >> 2)
        vpdiff = vpdiff + torch.where(b0, step >> 2, 0)
        delta = (b2.to(_I32) << 2) | (b1.to(_I32) << 1) | b0.to(_I32)
        p = torch.clamp(torch.where(sign > 0, p - vpdiff, p + vpdiff), -32768, 32767)
        ix = torch.clamp(ix + idx_tab[delta], 0, 88)
        codes.append(sign | delta)
    pred.copy_(p)
    index.copy_(ix)
    return (torch.stack(codes, dim=1) if codes else torch.empty_like(pcm)), pred, index


def dvi4_decode_reference(codes, pred, index):
    """Plain version: the loop of ``_dec_step`` (``adpcm.py:61-75``). codes
    int32 [B, S] -> pcm int32 [B, S]; updates ``pred`` and ``index`` in
    place."""
    from mediastreamer2_tpu_torch.ops.adpcm import dvi4_tables
    step_tab, idx_tab = dvi4_tables(codes.device)
    p, ix = pred, index
    out = []
    for j in range(codes.shape[1]):
        code = codes[:, j]
        step = step_tab[ix]
        delta = code & 7
        vpdiff = ((step >> 3) + torch.where((delta & 4) != 0, step, 0)
                  + torch.where((delta & 2) != 0, step >> 1, 0)
                  + torch.where((delta & 1) != 0, step >> 2, 0))
        p = torch.clamp(torch.where((code & 8) > 0, p - vpdiff, p + vpdiff), -32768, 32767)
        ix = torch.clamp(ix + idx_tab[delta], 0, 88)
        out.append(p)
    pred.copy_(p)
    index.copy_(ix)
    return (torch.stack(out, dim=1) if out else torch.empty_like(codes)), pred, index


def _dvi4_launch(fn, inp, out, pred, index, dev):
    B, S = inp.shape
    _check("pred", pred, torch.int32, (B,), dev)
    _check("index", index, torch.int32, (B,), dev)
    _launch(fn, dev, _ptr(inp), _ptr(out), _ptr(pred), _ptr(index), B, S)


def dvi4_encode(pcm, pred, index):
    """DVI4 (IMA ADPCM) encode of one tick for every leg: pcm int32 [B, S]
    -> codes int32 [B, S] (0..15). ``pred`` and ``index`` (int32 [B]) are
    updated in place and returned: (codes, pred, index)."""
    if pcm.device.type == "cpu":
        return dvi4_encode_reference(pcm, pred, index)
    dev = _cuda_device(pcm)
    _check("pcm", pcm, torch.int32, tuple(pcm.shape), dev)
    codes = torch.empty_like(pcm)
    _dvi4_launch(_load().ms2_dvi4_encode, pcm, codes, pred, index, dev)
    dvi4_encode.launches += 1
    return codes, pred, index


dvi4_encode.launches = 0


def dvi4_decode(codes, pred, index):
    """DVI4 decode of one tick for every leg: codes int32 [B, S] -> pcm
    int32 [B, S]. ``pred`` and ``index`` are updated in place and returned."""
    if codes.device.type == "cpu":
        return dvi4_decode_reference(codes, pred, index)
    dev = _cuda_device(codes)
    _check("codes", codes, torch.int32, tuple(codes.shape), dev)
    pcm = torch.empty_like(codes)
    _dvi4_launch(_load().ms2_dvi4_decode, codes, pcm, pred, index, dev)
    dvi4_decode.launches += 1
    return pcm, pred, index


dvi4_decode.launches = 0


def empty_launch(device: torch.device, blocks: int):
    """Launch the ADPCM library's empty kernel (``blocks`` blocks of one
    warp) on ``device``'s current stream: the launch floor under the
    kernels, for timing. Counted nowhere."""
    if device.type != "cuda":
        raise RuntimeError(f"no kernel for {device}")
    _launch(_load().ms2_adpcm_empty, device, blocks)


# ---------------------------------------------------------------------------
# g726_encode / g726_decode
# ---------------------------------------------------------------------------
# the 14 leaves of a ``g726_state``, in the kernels' order
G726_KEYS = ("b", "dq", "a1", "a2", "sr1", "sr2", "p1", "p2", "yu", "yl", "dms", "dml",
             "ap", "td")


# The plain versions keep the JAX package's association order in every
# expression (``g726.py:86-167``), and so does the kernel: the codes hang on
# float comparisons, where one ulp flips a code.
def _g726_scale(z):
    al = torch.clamp(z["ap"] / 256.0, 0.0, 1.0)
    return al * z["yu"] + (1.0 - al) * (z["yl"] / 64.0)


def _g726_estimate(z):
    """(sez, se): the zero section's estimate, its six taps summed left to
    right (a chain, so that no backend reduces in another order than the
    kernel), and the whole predictor's."""
    prod = z["b"] * z["dq"]
    sez = prod[:, 0]
    for k in range(1, 6):
        sez = sez + prod[:, k]
    return sez, sez + z["a1"] * z["sr1"] + z["a2"] * z["sr2"]


def _g726_reconstruct(z, code, sez, se, y, T, half):
    """``reconstruct`` + ``_adapt``: code [B] -> (the next state, sr)."""
    # a code outside [0, 2^bits) reads the table's last entry, as JAX's
    # clamped gather does
    mag = torch.clamp(torch.where(code >= half, code - half, half - 1 - code), max=half - 1)
    sign = torch.where(code >= half, 1.0, -1.0)
    dql = T["dqln"][mag] + y / 4.0
    dq = sign * torch.exp2(dql / 128.0)
    dq = torch.where(dql < -1024, 0.0, dq)
    sr = se + dq
    yu = torch.clamp(y + (T["W"][mag] * 32.0 - y) / 32.0, 544.0, 5120.0)
    yl = z["yl"] + (yu - z["yl"] / 64.0)
    yl = torch.clamp(yl, 544.0 * 64, 5120.0 * 64)
    f = T["F"][mag]
    dms = z["dms"] + (f * 32.0 - z["dms"]) / 32.0
    dml = z["dml"] + (f * 128.0 - z["dml"]) / 128.0
    td = (z["a2"] < -0.71875).to(torch.float32)
    tr = (z["td"] > 0) & (dq.abs() > 1.5 * torch.exp2(z["yl"] / 64.0 / 128.0))
    ax = torch.where((y < 1536.0) | (td > 0)
                     | ((dms / 4.0 - dml / 16.0).abs() >= dml / 128.0), 1.0, 0.0)
    ap = torch.where(tr, 256.0, z["ap"] + (ax * 512.0 - z["ap"]) / 16.0)
    sign_dq = torch.sign(dq)
    b = torch.where(tr[:, None], 0.0,
                    z["b"] * (1 - 1.0 / 256.0)
                    + (1.0 / 128.0) * sign_dq[:, None] * torch.sign(z["dq"]))
    p0 = dq + sez
    sign_p0 = torch.sign(p0)
    sign_p1 = torch.sign(z["p1"])
    a2 = z["a2"] * (1 - 1.0 / 128.0) + (1.0 / 128.0) * (
        sign_p0 * torch.sign(z["p2"])
        - 4.0 * torch.clamp(z["a1"] * sign_p0 * sign_p1, -0.25, 0.25))
    a2 = torch.clamp(a2, -0.75, 0.75)
    a1 = z["a1"] * (1 - 1.0 / 256.0) + (3.0 / 256.0) * sign_p0 * sign_p1
    lim = 1.0 - (1.0 / 16.0) - a2
    a1 = torch.minimum(torch.maximum(a1, -lim), lim)
    zero = torch.zeros_like(a1)
    return {"b": b, "dq": torch.cat([dq[:, None], z["dq"][:, :5]], dim=1),
            "a1": torch.where(tr, zero, a1), "a2": torch.where(tr, zero, a2),
            "sr1": sr, "sr2": z["sr1"], "p1": p0, "p2": z["p1"],
            "yu": yu, "yl": yl, "dms": dms, "dml": dml, "ap": ap, "td": td}, sr


def _g726_store(state, z):
    # after a one-sample tick z's leaves include state's own tensors (z["sr2"]
    # is state["sr1"]): read every value before writing any
    new = [z[k].clone() for k in G726_KEYS]
    for k, v in zip(G726_KEYS, new):
        state[k].copy_(v)


def g726_encode_reference(pcm, state, bits: int = 4):
    """Plain version: the sample loop of ``enc_step`` (``g726.py:152-163``)
    in torch float32. pcm int32 [B, S] (int16 range) -> codes int32 [B, S]
    in [0, 2^bits); updates ``state``'s tensors in place."""
    from mediastreamer2_tpu_torch.ops.g726 import g726_tables
    T = g726_tables(bits, pcm.device)
    half = (1 << bits) // 2
    x = pcm.to(torch.float32) / 4.0                    # 14-bit domain
    z = dict(state)
    codes = []
    for j in range(pcm.shape[1]):
        sez, se = _g726_estimate(z)
        d = x[:, j] - se
        y = _g726_scale(z)
        dl = torch.log2(torch.clamp(d.abs(), min=1e-6)) * 128.0
        dln = dl - y / 4.0
        mag = torch.clamp((dln[:, None] >= T["qtab"]).sum(dim=1, dtype=_I32), max=half - 1)
        code = torch.where(d >= 0, half + mag, half - 1 - mag)
        z, _ = _g726_reconstruct(z, code, sez, se, y, T, half)
        codes.append(code)
    _g726_store(state, z)
    return torch.stack(codes, dim=1), state


def g726_decode_reference(codes, state, bits: int = 4):
    """Plain version: the loop of ``dec_step`` (``g726.py:165-167``). codes
    int32 [B, S] -> pcm float32 [B, S] (the reconstruction times 4, clipped
    to the int16 range); updates ``state`` in place."""
    from mediastreamer2_tpu_torch.ops.g726 import g726_tables
    T = g726_tables(bits, codes.device)
    half = (1 << bits) // 2
    z = dict(state)
    out = []
    for j in range(codes.shape[1]):
        sez, se = _g726_estimate(z)
        z, sr = _g726_reconstruct(z, codes[:, j], sez, se, _g726_scale(z), T, half)
        out.append(sr)
    _g726_store(state, z)
    return torch.clamp(torch.stack(out, dim=1) * 4.0, -32768, 32767), state


_G726_LEAF_SHAPES = {"b": (6,), "dq": (6,)}


def _g726_launch(fn, bits, inp, out, state, dev):
    if bits not in (2, 3, 4, 5):
        raise ValueError(f"g726: {bits} bits a sample, expected 2, 3, 4 or 5")
    B, S = inp.shape
    for k in G726_KEYS:
        _check(k, state[k], torch.float32, (B,) + _G726_LEAF_SHAPES.get(k, ()), dev)
    ptrs = (ctypes.c_void_p * len(G726_KEYS))(*(_ptr(state[k]) for k in G726_KEYS))
    _launch(fn, dev, bits, _ptr(inp), _ptr(out), ptrs, B, S)


def g726_encode(pcm, state, bits: int = 4):
    """G.726 encode of one tick for every leg at ``bits`` bits a sample (2,
    3, 4, 5: 16, 24, 32, 40 kbit/s): pcm int32 [B, S] (int16 range) ->
    codes int32 [B, S]. ``state`` (``ops/g726.g726_state``) is updated in
    place and returned."""
    if pcm.device.type == "cpu":
        return g726_encode_reference(pcm, state, bits)
    dev = _cuda_device(pcm)
    _check("pcm", pcm, torch.int32, tuple(pcm.shape), dev)
    codes = torch.empty_like(pcm)
    _g726_launch(_load().ms2_g726_encode, bits, pcm, codes, state, dev)
    g726_encode.launches += 1
    return codes, state


g726_encode.launches = 0


def g726_decode(codes, state, bits: int = 4):
    """G.726 decode of one tick for every leg: codes int32 [B, S] -> pcm
    float32 [B, S] in the int16 range. ``state`` is updated in place and
    returned."""
    if codes.device.type == "cpu":
        return g726_decode_reference(codes, state, bits)
    dev = _cuda_device(codes)
    _check("codes", codes, torch.int32, tuple(codes.shape), dev)
    pcm = torch.empty(tuple(codes.shape), dtype=torch.float32, device=dev)
    _g726_launch(_load().ms2_g726_decode, bits, codes, pcm, state, dev)
    g726_decode.launches += 1
    return pcm, state


g726_decode.launches = 0
