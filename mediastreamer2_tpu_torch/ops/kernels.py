"""The flagship leg's hand-written CUDA kernels: build, loader, wrappers,
plain versions and launch counters (port of ``mediastreamer2_tpu/ops/pallas_kernels.py``).

Three kernels, all in ``csrc/ms2_kernels.cu``:

================  =======================================================
wrapper           replaces (``mediastreamer2_tpu/ops/pallas_kernels.py``)
================  =======================================================
fused_volume      ``fused_volume`` / ``_fused_volume_kernel`` (:38-84)
mdf_apply         ``mdf_apply`` / ``_mdf_apply_kernel`` (:113-150)
mdf_update_fused  ``mdf_update_fused`` / ``_mdf_update_fused_kernel`` (:227-310)
================  =======================================================

``mdf_update`` (:153-201), the f32 partner of ``mdf_apply``, is not ported
yet.

Build: at first use, ``nvcc`` compiles the source for ``sm_90a`` into a
shared library with a plain C interface under ``_build/``, named by a hash
of the source and the flags, and ``ctypes`` loads it. Nothing is compiled or
loaded when this module is imported.

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
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ms2_kernels.cu"
BUILD_DIR = _PKG / "_build"
MDF_MAX_P = 16          # partitions one mdf_apply thread holds (csrc MDF_MAX_P)
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


def build() -> tuple:
    """Compile the kernels unless a build of this exact source and these
    flags exists. Returns (library path, nvcc's output; empty when the
    library was already built)."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libms2_kernels_{key}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
    os.replace(tmp, out)
    return out, log


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ms2_fused_volume.argtypes = [I] + [P] * 8 + [I, I, P]
        lib.ms2_mdf_apply.argtypes = [I] + [P] * 12 + [I, I, I, P]
        lib.ms2_mdf_update_fused.argtypes = [I, I] + [P] * 17 + [I, I, I, P]
        for fn in (lib.ms2_fused_volume, lib.ms2_mdf_apply, lib.ms2_mdf_update_fused):
            fn.restype = I
        _lib = lib
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


def launch_counts() -> dict:
    return {f.__name__: f.launches for f in (fused_volume, mdf_apply, mdf_update_fused)}


def reset_launch_counts():
    for f in (fused_volume, mdf_apply, mdf_update_fused):
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
    order 0..P-1, as the kernel does."""
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
    Xr/Xi [B,F] f32, rounded to bf16, goes to p=0) and apply both filters
    (bf16 [B,P,F]). Returns (Ym_r, Ym_i, Ys_r, Ys_i), f32 [B,F].

    The block that drops out of the history is overwritten: read it first."""
    if Xr.device.type == "cpu":
        return mdf_apply_reference(Wm_r, Wm_i, Ws_r, Ws_i, Xh_r, Xh_i, Xr, Xi)
    dev = _cuda_device(Xr)
    B, P, F = Wm_r.shape
    if P > MDF_MAX_P:
        raise ValueError(f"mdf_apply: {P} partitions, the kernel holds at most {MDF_MAX_P}")
    for name, t in (("Wm_r", Wm_r), ("Wm_i", Wm_i), ("Ws_r", Ws_r),
                    ("Ws_i", Ws_i), ("Xh_r", Xh_r), ("Xh_i", Xh_i)):
        _check(name, t, torch.bfloat16, (B, P, F), dev)
    _check("Xr", Xr, torch.float32, (B, F), dev)
    _check("Xi", Xi, torch.float32, (B, F), dev)
    outs = [torch.empty((B, F), dtype=torch.float32, device=dev) for _ in range(4)]
    _launch(_load().ms2_mdf_apply, dev, *map(_ptr, (Wm_r, Wm_i, Ws_r, Ws_i,
                                                      Xh_r, Xh_i, Xr, Xi)),
            *map(_ptr, outs), B, P, F)
    mdf_apply.launches += 1
    return tuple(outs)


mdf_apply.launches = 0


# ---------------------------------------------------------------------------
# mdf_update_fused
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """(a * c) mod 2**32 for int64 tensors a in [0, 2**32) and a constant c
    in [0, 2**32), without overflowing int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def sround_bf16(x, salt):
    """Stochastically round f32 -> bf16, bit for bit as ``_sround_bf16`` in
    ``mediastreamer2_tpu/ops/aec.py:137-154``: add 16 bits of a hash of the
    row-major linear index and ``salt`` to the f32 bit pattern, truncate.

    The uint32 arithmetic runs in int64 masked to 32 bits, since PyTorch on
    the CPU has no uint32 add or shift. ``salt`` is an int or an int64
    tensor scalar."""
    x = x.contiguous()
    dev = x.device
    lin = torch.arange(x.numel(), dtype=torch.int64, device=dev).reshape(x.shape) & _M32
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
                               reseed, hard_reset, srk=None):
    """Plain version; updates Ws and Wm in place, as the kernel does."""
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
        n_r = sround_bf16(n_r, salt)
        n_i = sround_bf16(n_i, salt + 1)
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
                     srk=None):
    """NLMS update + round-robin constraint + two-path transfers, in place.

    cpos: int32 scalar tensor (partition constrained this tick);
    Ws: f32 or bf16 [B,P,F] (its dtype picks the mode, see the kernel's
    note); Wm, Xh: bf16 [B,P,F]; Er, Ei, inv_norm, gc_r, gc_i: f32 [B,F];
    mu: f32 [B]; promote, reseed, hard_reset: bool [B]; srk: int64 scalar
    tensor, the stochastic-rounding counter (bf16 mode only).
    Returns (Ws_r, Ws_i, Wm_r, Wm_i), the updated inputs."""
    if Ws_r.device.type == "cpu":
        return mdf_update_fused_reference(cpos, Ws_r, Ws_i, Wm_r, Wm_i, Xh_r,
                                          Xh_i, Er, Ei, inv_norm, gc_r, gc_i,
                                          mu, promote, reseed, hard_reset, srk)
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
            _ptr(srk) if bf16_shadow else None, B, P, F)
    mdf_update_fused.launches += 1
    return Ws_r, Ws_i, Wm_r, Wm_i


mdf_update_fused.launches = 0
