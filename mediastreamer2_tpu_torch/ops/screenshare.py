"""Screen sharing source -- X11 screen capture as a WebCam (a copy of
``mediastreamer2_tpu/ops/screenshare.py``: numpy and ctypes).

Reference: src/videofilters/msscreensharing.cpp (+ _x11.cpp: XOpenDisplay /
XGetImage of the root window feeding the MSScreenSharing filter, with the
MSFilterScreenSharingInterface trait).

Binding: libX11 via ctypes, dlopen-gated — absent on a headless server
image (no libX11, no DISPLAY), in which case ``screenshare_available()`` is
False and the source never registers; deployments with a desktop get
root-window capture at the stream's fps with BGRA -> packed-I420
conversion done host-side (pixel math itself is trivial next to XGetImage).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import os
from typing import Optional

import numpy as np

_x11 = None
try:
    _p = ctypes.util.find_library("X11")
    if _p:
        _x11 = ctypes.CDLL(_p)
        _x11.XOpenDisplay.restype = ctypes.c_void_p
        _x11.XOpenDisplay.argtypes = [ctypes.c_char_p]
        _x11.XDefaultRootWindow.argtypes = [ctypes.c_void_p]
        _x11.XDefaultRootWindow.restype = ctypes.c_ulong
        _x11.XGetImage.restype = ctypes.c_void_p
        _x11.XGetImage.argtypes = [ctypes.c_void_p, ctypes.c_ulong,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_uint, ctypes.c_uint,
                                   ctypes.c_ulong, ctypes.c_int]
except OSError:                                    # pragma: no cover
    _x11 = None

ZPIXMAP = 2
ALLPLANES = 0xFFFFFFFFFFFFFFFF
# XImage field offsets (stable public struct head: width, height, xoffset,
# format, char *data, ...)
_XI_W, _XI_H, _XI_DATA = 0, 4, 16


def screenshare_available() -> bool:
    if _x11 is None or not os.environ.get("DISPLAY"):
        return False
    dpy = _x11.XOpenDisplay(None)
    if not dpy:
        return False
    _x11.XCloseDisplay(ctypes.c_void_p(dpy))
    return True


def bgra_to_i420_block(bgra: np.ndarray) -> np.ndarray:
    """[H, W, 4] uint8 BGRA -> packed-I420 float block [H*3/2, W]
    (BT.601, the msscreensharing pixel path)."""
    b = bgra[..., 0].astype(np.float32)
    g = bgra[..., 1].astype(np.float32)
    r = bgra[..., 2].astype(np.float32)
    y = (0.257 * r + 0.504 * g + 0.098 * b + 16.0) / 255.0
    u = (-0.148 * r - 0.291 * g + 0.439 * b + 128.0) / 255.0
    v = (0.439 * r - 0.368 * g - 0.071 * b + 128.0) / 255.0
    u2 = u[::2, ::2]
    v2 = v[::2, ::2]
    h, w = y.shape
    uv = np.stack([u2, v2], axis=1).reshape(h // 2, w)
    return np.concatenate([y, uv], axis=0).astype(np.float32)


class ScreenShareSource:
    """Root-window grabber with the WebCam pull shape (one leg)."""

    def __init__(self, width: int, height: int):
        if not screenshare_available():
            raise RuntimeError("X11 screen capture unavailable")
        self.w, self.h = width, height
        self.dpy = _x11.XOpenDisplay(None)
        self.root = _x11.XDefaultRootWindow(ctypes.c_void_p(self.dpy))
        self.frames_grabbed = 0

    def grab_block(self) -> Optional[np.ndarray]:
        img = _x11.XGetImage(ctypes.c_void_p(self.dpy), self.root, 0, 0,
                             self.w, self.h, ALLPLANES, ZPIXMAP)
        if not img:
            return None
        data_ptr = ctypes.cast(img + _XI_DATA,
                               ctypes.POINTER(ctypes.c_void_p))[0]
        raw = ctypes.string_at(data_ptr, self.w * self.h * 4)
        _x11.XDestroyImage(ctypes.c_void_p(img))
        bgra = np.frombuffer(raw, np.uint8).reshape(self.h, self.w, 4)
        self.frames_grabbed += 1
        return bgra_to_i420_block(bgra)

    def close(self):
        if self.dpy:
            _x11.XCloseDisplay(ctypes.c_void_p(self.dpy))
            self.dpy = None
