"""The yardstick's arithmetic: the card's peak and the bytes each kernel's
work needs.

The four cost functions are frozen copies of ``chip_smoke.py``'s
(``fused_volume_cost``, ``mdf_apply_cost``, ``mdf_update_cost``,
``mdf_update_fused_cost``, the last as corrected at commit 19e7661): each
input byte read once, each output byte written once; ``mdf_update_fused``
counts what the call's flags need. Only the bytes are used: none of the
four does a matrix product, and each is bound by memory.
"""
from __future__ import annotations

# H100 SXM, 80 GB HBM3, NVIDIA's data sheet (at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12


def fused_volume_cost(B, S):
    """x read, y written ([B, S] f32), four [B] f32 in, energy and mean out."""
    return 4 * B * S * 2 + 4 * B * (4 + 2)


def mdf_apply_cost(B, P, F, ws_bytes):
    """Wm (bf16) and Ws read over P partitions; the history Xh (bf16)
    shifted in place: partitions 0..P-2 read, all P written; Xr/Xi in and
    Ym/Ys out ([B, F] f32)."""
    return (B * F * (P * (2 * 2 + 2 * ws_bytes) + (P - 1) * 2 * 2 + P * 2 * 2)
            + 4 * B * F * (2 + 4))


def mdf_update_cost(B, P, F):
    """Ws (f32) and Wm (bf16) read and written, Xh read; Er, Ei, inv_norm,
    gc_r, gc_i in ([B, F] f32); mu, promote, reseed ([B] f32) and cpos in."""
    return B * P * F * (2 * 4 * 2 + 2 * 2 * 2 + 2 * 2) + 4 * B * F * 5 + 4 * B * 3 + 4


def mdf_update_fused_cost(B, P, F, ws_bytes, wm_read_legs=0, wm_write_legs=0,
                          update_legs=None):
    """Ws written on every leg; Ws and Xh read, and the five [B, F] f32
    operands, only on the ``update_legs`` that compute the update (all B
    by default); Wm read on the legs that reseed (and are not hard-reset)
    and written on the legs promoted; the [B] flags, mu, cpos and srk in."""
    upd = B if update_legs is None else update_legs
    return (B * P * F * 2 * ws_bytes + upd * (P * F * (2 * ws_bytes + 2 * 2) + 4 * F * 5)
            + P * F * 2 * 2 * (wm_read_legs + wm_write_legs) + B * (4 + 3) + 4 + 8)


def update_mix(promote, reseed, hard_reset, bf16_shadow=True):
    """(update legs, Wm-read legs, Wm-write legs) of one call's flags ([B]
    bool tensors): in the bf16 mode a leg that reseeds or hard-resets needs
    no update; in the f32 mode a promoted leg needs it all the same."""
    quiet = reseed | hard_reset
    update = ~quiet if bf16_shadow else (~quiet | promote)
    return (int(update.sum()), int((reseed & ~hard_reset).sum()), int(promote.sum()))


def bound_s(nbytes) -> float:
    """The least time the card's memory takes to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S
