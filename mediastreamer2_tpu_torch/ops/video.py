"""Video pipeline ops -- YUV420 <-> RGB, rescale, rotation, test pattern
(port of ``mediastreamer2_tpu/ops/video.py``).

Reference: src/voip/msvideo.c (YUV buffer mgmt :158-315, scaler with
libyuv/swscale backends :526-715, NEON rotation in msvideo_neon.c),
src/videofilters/pixconv.c, sizeconv.c, mire.c (synthetic moving pattern),
and the GLSL YUV->RGB shaders under utils/opengles_display.c:312-377.

Frames are batched tensors on the graph's device: YUV420 packed as
``[legs, h*3/2, w]`` float32 (Y plane stacked over interleaved half-res U,V
rows), RGB as ``[legs, h, w, 3]``. Color conversion is a 3x3 contraction
over the channel dim, rotation a ``rot90``. The JAX module is plain jnp
(no Pallas kernel), so these are PyTorch ops, no hand kernel.

Rescaling: the JAX package calls ``jax.image.resize(..., "linear")``, which
antialiases when it scales down (a triangle kernel widened by the scale);
``F.interpolate(mode="bilinear", antialias=True, align_corners=False)``
computes the same weights (``resize``). A resize to the same size is the
identity in both.

The mire: the JAX filter builds ``[B, h, w]`` int32 iotas and resizes
``[B, h, w]`` chroma planes. Its U depends on x alone and V on y alone,
and the resize is separable with weights that sum to one, so the port
computes a row of U and a column of V per leg, resizes those, and
broadcasts (the same values to an ulp; at 1,024 VGA legs a full-size
iota is 1.26 GB).
"""
from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F

from mediastreamer2_tpu_torch.core.block import Format
from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter

# BT.601 full-range matrices (same space the reference's shaders use)
_YUV2RGB = np.array([[1.0, 0.0, 1.402],
                     [1.0, -0.344136, -0.714136],
                     [1.0, 1.772, 0.0]], np.float32)
_RGB2YUV = np.linalg.inv(_YUV2RGB).astype(np.float32)


def resize(p: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(p, (..., out_h, out_w), "linear")`` over the last
    two dims of a float tensor (antialiased when scaling down)."""
    h, w = p.shape[-2], p.shape[-1]
    if (h, w) == (out_h, out_w):
        return p
    lead = p.shape[:-2]
    x = p.reshape(-1, 1, h, w)
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.reshape(*lead, out_h, out_w)


def split_yuv420(frame, w: int, h: int):
    """[B, h*3/2, w] -> (Y [B,h,w], U [B,h/2,w/2], V [B,h/2,w/2])."""
    y = frame[:, :h, :]
    uv = frame[:, h:, :].reshape(frame.shape[0], h // 2, 2, w // 2)
    return y, uv[:, :, 0, :], uv[:, :, 1, :]


def join_yuv420(y, u, v):
    B, h, w = y.shape
    uv = torch.stack([u, v], dim=2).reshape(B, h // 2, w)
    return torch.cat([y, uv], dim=1)


def nv12_to_i420(y, uv, nv21: bool = False):
    """Semi-planar (biplanar) -> planar chroma (the framework tester's
    'copy ycbcrbiplanar to true yuv', msvideo.c ms_yuv_buf copy helpers).

    y [B,h,w]; uv [B,h/2,w] with interleaved CbCr (CrCb when nv21)."""
    B, hh, w = uv.shape
    pairs = uv.reshape(B, hh, w // 2, 2)
    u = pairs[..., 1] if nv21 else pairs[..., 0]
    v = pairs[..., 0] if nv21 else pairs[..., 1]
    return y, u, v


def i420_to_nv12(y, u, v, nv21: bool = False):
    """Planar -> semi-planar interleaved chroma."""
    a, b = (v, u) if nv21 else (u, v)
    B, hh, hw = u.shape
    return y, torch.stack([a, b], dim=-1).reshape(B, hh, hw * 2)


def nv12_to_yuv420_frame(y, uv, degrees: int = 0, out_w: int = 0,
                         out_h: int = 0, nv21: bool = False):
    """Biplanar input -> packed I420 frame with optional rotation and
    rescale (rotation before scaling, like ms_yuv_buf_copy_with_rotation)."""
    yy, u, v = nv12_to_i420(y, uv, nv21=nv21)
    frame = join_yuv420(yy, u, v)
    B, h, w = yy.shape
    if degrees:
        frame = rotate_yuv420(frame, w, h, degrees)
        if degrees in (90, 270):
            w, h = h, w
    if out_w and out_h and (out_w, out_h) != (w, h):
        frame = scale_yuv420(frame, w, h, out_w, out_h)
    return frame


def _matrix(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(m).to(like.device)


def yuv420_to_rgb(frame, w: int, h: int):
    y, u, v = split_yuv420(frame, w, h)
    yuv = torch.stack([y, resize(u, h, w) - 0.5, resize(v, h, w) - 0.5], dim=-1)
    rgb = torch.einsum("bhwc,rc->bhwr", yuv, _matrix(_YUV2RGB, frame))
    return rgb.clamp(0.0, 1.0)


def rgb_to_yuv420(rgb):
    B, h, w, _ = rgb.shape
    yuv = torch.einsum("bhwc,rc->bhwr", rgb, _matrix(_RGB2YUV, rgb))
    u = resize(yuv[..., 1] + 0.5, h // 2, w // 2)
    v = resize(yuv[..., 2] + 0.5, h // 2, w // 2)
    return join_yuv420(yuv[..., 0].clamp(0, 1), u.clamp(0, 1), v.clamp(0, 1))


def scale_yuv420(frame, w: int, h: int, out_w: int, out_h: int):
    """MSScaler equivalent (msvideo.c:526-715, libyuv I420Scale path)."""
    y, u, v = split_yuv420(frame, w, h)
    return join_yuv420(resize(y, out_h, out_w), resize(u, out_h // 2, out_w // 2),
                       resize(v, out_h // 2, out_w // 2))


def rotate_yuv420(frame, w: int, h: int, degrees: int):
    """90-degree-step rotation, clockwise (reference: ms_video_rotate...,
    NEON asm)."""
    if degrees % 360 == 0:
        return frame
    y, u, v = split_yuv420(frame, w, h)
    k = (degrees // 90) % 4
    rot = lambda p: torch.rot90(p, k=-k, dims=(1, 2))    # noqa: E731
    return join_yuv420(rot(y), rot(u), rot(v))


def mirror_yuv420(frame, w: int, h: int):
    y, u, v = split_yuv420(frame, w, h)
    m = lambda p: torch.flip(p, dims=(2,))               # noqa: E731
    return join_yuv420(m(y), m(u), m(v))


# ---------------------------------------------------------------- filters
def _mire_init(ctx, device):
    return {"frame_idx": torch.zeros((ctx.batch,), dtype=torch.int32, device=device)}


def _mire_process(state, ins, params, ctx):
    """Moving color-bar/checker pattern (parity: src/videofilters/mire.c);
    see the module docstring for the separable chroma."""
    fmt: Format = ctx.params["fmt"]
    w, h = fmt.width, fmt.height
    idx = state["frame_idx"]
    dev = idx.device
    xs = torch.arange(w, dtype=torch.int32, device=dev)
    ys = torch.arange(h, dtype=torch.int32, device=dev)
    off = idx[:, None]                                              # [B, 1]
    xcell = torch.div(xs[None, :] + off, 32, rounding_mode="floor")  # [B, w]
    ycells = (xcell[:, None, :] + (ys // 32)[None, :, None]) % 8    # [B, h, w]
    ycells = ycells.to(torch.float32) / 8.0
    u_row = 0.5 + 0.4 * torch.sin(2 * np.pi * (xs[None, :] + off * 2).to(torch.float32) / w)
    v_col = 0.5 + 0.4 * torch.cos(2 * np.pi * (ys[None, :] + off * 2).to(torch.float32) / h)
    B = idx.shape[0]
    # both as rows: bilinear_aa keeps a one-column input's first row
    u = resize(u_row[:, None, :], 1, w // 2).expand(B, h // 2, w // 2)
    v = resize(v_col[:, None, :], 1, h // 2).transpose(1, 2).expand(B, h // 2, w // 2)
    return {"frame_idx": idx + 1}, (join_yuv420(ycells, u, v),), {}


register_filter(FilterDef(
    name="mire", ninputs=0, noutputs=1,
    out_formats=lambda ctx: (ctx.params["fmt"],), init=_mire_init, process=_mire_process,
    interfaces=("video_source",),
))


def _pixconv_formats(ctx):
    return (ctx.in_formats[0].with_(kind=ctx.params.get("to", "rgb")),)


def _pixconv_process(state, ins, params, ctx):
    f = ctx.in_formats[0]
    to = ctx.params.get("to", "rgb")
    if f.kind == "yuv420" and to == "rgb":
        return state, (yuv420_to_rgb(ins[0], f.width, f.height),), {}
    if f.kind == "rgb" and to == "yuv420":
        return state, (rgb_to_yuv420(ins[0]),), {}
    if f.kind == to:
        return state, (ins[0],), {}
    raise ValueError(f"pixconv {f.kind}->{to} unsupported")


register_filter(FilterDef(
    name="pix_conv", ninputs=1, noutputs=1,
    out_formats=_pixconv_formats, process=_pixconv_process,
))


def _sizeconv_formats(ctx):
    f = ctx.in_formats[0]
    return (f.with_(width=int(ctx.params["out_w"]), height=int(ctx.params["out_h"])),)


def _sizeconv_process(state, ins, params, ctx):
    f = ctx.in_formats[0]
    ow, oh = int(ctx.params["out_w"]), int(ctx.params["out_h"])
    if f.kind == "yuv420":
        return state, (scale_yuv420(ins[0], f.width, f.height, ow, oh),), {}
    rgb = ins[0].permute(0, 3, 1, 2)                     # [B, 3, h, w]
    return state, (resize(rgb, oh, ow).permute(0, 2, 3, 1),), {}


register_filter(FilterDef(
    name="size_conv", ninputs=1, noutputs=1,
    out_formats=_sizeconv_formats, process=_sizeconv_process,
))


def _rot_formats(ctx):
    f = ctx.in_formats[0]
    if int(ctx.params.get("degrees", 0)) % 180 == 90:
        return (f.with_(width=f.height, height=f.width),)
    return (f,)


def _rot_process(state, ins, params, ctx):
    f = ctx.in_formats[0]
    out = rotate_yuv420(ins[0], f.width, f.height, int(ctx.params.get("degrees", 0)))
    if ctx.params.get("mirror", False):
        fo = _rot_formats(ctx)[0]
        out = mirror_yuv420(out, fo.width, fo.height)
    return state, (out,), {}


register_filter(FilterDef(
    name="video_transform", ninputs=1, noutputs=1,
    out_formats=_rot_formats, process=_rot_process,
))


# analyse display: checker/average analysis for tests
# (parity: src/videofilters/msanalysedisplay.c)
def _analyse_process(state, ins, params, ctx):
    f = ctx.in_formats[0]
    if f.kind == "yuv420":
        mean = split_yuv420(ins[0], f.width, f.height)[0].mean(dim=(1, 2))
    else:
        mean = ins[0].mean(dim=(1, 2, 3))
    return state, (), {"frame_mean": mean}


register_filter(FilterDef(
    name="analyse_display", ninputs=1, noutputs=0,
    out_formats=lambda ctx: (), process=_analyse_process,
    interfaces=("video_display",),
))


def _update_slice(dst, src, starts):
    """``jax.lax.dynamic_update_slice``: starts clamped so ``src`` fits."""
    out = dst.clone()
    idx = tuple(slice(s, s + n) for s, n in
                ((min(max(s, 0), d - n), n) for s, d, n in zip(starts, dst.shape, src.shape)))
    out[idx] = src
    return out


def compose_selfview(main, pip, corner: str = "bottom_right",
                     scale: float = 0.25, margin: int = 8):
    """Composite display with local self-view inset -- MSVideoOut's layout
    (reference: src/videofilters/videoout.c + layouts.c math).

    main/pip: packed-I420 float blocks [B, h*3/2, w]; the pip is rescaled
    to ``scale`` of the main picture and written into the chosen corner."""
    B, bh, w = main.shape
    h = bh * 2 // 3
    pw = max(16, int(w * scale) // 2 * 2)
    ph = max(12, int(h * scale) // 2 * 2)
    pip_small = scale_yuv420(pip, w, h, pw, ph)          # [B, ph*3/2, pw]
    if corner == "bottom_right":
        x0, y0 = w - pw - margin, h - ph - margin
    elif corner == "bottom_left":
        x0, y0 = margin, h - ph - margin
    elif corner == "top_right":
        x0, y0 = w - pw - margin, margin
    else:                                                # top_left
        x0, y0 = margin, margin
    x0, y0 = max(0, x0), max(0, y0) // 2 * 2
    out_y = _update_slice(main[:, :h], pip_small[:, :ph], (0, y0, x0))
    # chroma rows are interleaved U,V half-res pairs in the packed layout
    main_uv = main[:, h:].reshape(B, h // 2, 2, w // 2)
    pip_uv = pip_small[:, ph:].reshape(B, ph // 2, 2, pw // 2)
    out_uv = _update_slice(main_uv, pip_uv, (0, y0 // 2, 0, x0 // 2))
    return torch.cat([out_y, out_uv.reshape(B, h // 2, w)], dim=1)


# --------------------------------------------------------- pix-stride copy
def plane_copy_with_strides(src: np.ndarray, src_row_stride: int,
                            src_pix_stride: int, src_roi,
                            dst: np.ndarray, dst_row_stride: int,
                            dst_pix_stride: int, dst_roi):
    """One plane of ms_yuv_buf_copy_with_pix_strides (msvideo.c plane_copy):
    copy a src ROI into a dst ROI where each may be planar (pix stride 1)
    or semi-planar interleaved (pix stride 2). Host-side numpy: a byte
    layout shuffle, not device math."""
    sx, sy, w, h = src_roi
    dx, dy, _, _ = dst_roi
    src = np.asarray(src).reshape(-1)
    dst = dst.reshape(-1)
    for row in range(h):
        r0 = (sy + row) * src_row_stride + sx * src_pix_stride
        w0 = (dy + row) * dst_row_stride + dx * dst_pix_stride
        dst[w0:w0 + w * dst_pix_stride:dst_pix_stride] = \
            src[r0:r0 + w * src_pix_stride:src_pix_stride]


def yuv_copy_with_pix_strides(src_planes, src_row_strides, src_pix_strides,
                              src_roi, dst_planes, dst_row_strides,
                              dst_pix_strides, dst_roi):
    """ms_yuv_buf_copy_with_pix_strides (msvideo.c:245): Y plane copies the
    full ROI, chroma planes copy the ROI halved in every coordinate.
    ROI = (x, y, w, h). Supports planar<->semi-planar (NV12-style UV
    interleave via pixel stride 2) and "sliding" (src ROI != dst ROI)."""
    plane_copy_with_strides(src_planes[0], src_row_strides[0],
                            src_pix_strides[0], src_roi,
                            dst_planes[0], dst_row_strides[0],
                            dst_pix_strides[0], dst_roi)
    half = lambda r: (r[0] // 2, r[1] // 2, r[2] // 2, r[3] // 2)   # noqa: E731
    s2, d2 = half(src_roi), half(dst_roi)
    for p in (1, 2):
        plane_copy_with_strides(src_planes[p], src_row_strides[p],
                                src_pix_strides[p], s2,
                                dst_planes[p], dst_row_strides[p],
                                dst_pix_strides[p], d2)
