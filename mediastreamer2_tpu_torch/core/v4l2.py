"""V4L2 camera capture -- real-webcam source (a copy of
``mediastreamer2_tpu/core/v4l2.py``: numpy, ioctl and mmap).

Reference: src/videofilters/msv4l2.c (979 LoC): VIDIOC_* ioctl cycle
(QUERYCAP / S_FMT / REQBUFS / QUERYBUF+mmap / STREAMON / DQBUF-QBUF)
feeding MSV4l2's filter; registered via a webcam detector.

V4L2 is a pure kernel ioctl ABI (no user-space library), so this binding
is fcntl.ioctl + struct packing.  Gated: ``v4l2_available()`` is False on
headless images without /dev/video*; with a device present the
source delivers YUYV frames converted to the framework's packed-I420
blocks host-side.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import mmap
import os
import struct
from typing import List, Optional

import numpy as np

# ioctl codes (linux/videodev2.h, x86-64)
VIDIOC_QUERYCAP = 0x80685600
VIDIOC_S_FMT = 0xC0D05605
VIDIOC_REQBUFS = 0xC0145608
VIDIOC_QUERYBUF = 0xC0585609
VIDIOC_QBUF = 0xC058560F
VIDIOC_DQBUF = 0xC0585611
VIDIOC_STREAMON = 0x40045612
VIDIOC_STREAMOFF = 0x40045613

V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_MEMORY_MMAP = 1
V4L2_PIX_FMT_YUYV = 0x56595559       # 'YUYV'


def list_devices() -> List[str]:
    return sorted(glob.glob("/dev/video*"))


def v4l2_available() -> bool:
    for dev in list_devices():
        try:
            fd = os.open(dev, os.O_RDWR | os.O_NONBLOCK)
        except OSError:
            continue
        try:
            caps = bytearray(104)
            fcntl.ioctl(fd, VIDIOC_QUERYCAP, caps)
            return True
        except OSError:
            continue
        finally:
            os.close(fd)
    return False


def yuyv_to_i420_block(yuyv: np.ndarray, w: int, h: int) -> np.ndarray:
    """[h, w*2] uint8 YUYV -> packed-I420 float block [h*3/2, w]."""
    row = yuyv.reshape(h, w // 2, 4)
    y = np.empty((h, w), np.uint8)
    y[:, 0::2] = row[:, :, 0]
    y[:, 1::2] = row[:, :, 2]
    u = row[0::2, :, 1]                   # subsample vertically
    v = row[0::2, :, 3]
    uv = np.stack([u, v], axis=1).reshape(h // 2, w)
    block = np.concatenate([y, uv], axis=0)
    return block.astype(np.float32) / 255.0


class V4l2WebCam:
    """One V4L2 capture device with the WebCam pull shape (one leg).

    The mmap/DQBUF cycle mirrors msv4l2.c's buffer loop; grab_block()
    returns the latest frame or None when the device has no frame ready
    (the stream layer's dead-camera watchdog then covers failures)."""

    N_BUFFERS = 4

    def __init__(self, device: str = "/dev/video0", width: int = 320,
                 height: int = 240):
        self.w, self.h = width, height
        self.fd = os.open(device, os.O_RDWR | os.O_NONBLOCK)
        self.frames_grabbed = 0
        # S_FMT: v4l2_format { type u32; pad; pix: {w,h,fmt,field,...} }
        fmt = bytearray(208)
        struct.pack_into("I", fmt, 0, V4L2_BUF_TYPE_VIDEO_CAPTURE)
        struct.pack_into("IIII", fmt, 8, width, height,
                         V4L2_PIX_FMT_YUYV, 1)
        fcntl.ioctl(self.fd, VIDIOC_S_FMT, fmt)
        got_w, got_h = struct.unpack_from("II", fmt, 8)
        self.w, self.h = got_w, got_h
        # REQBUFS
        req = bytearray(20)
        struct.pack_into("III", req, 0, self.N_BUFFERS,
                         V4L2_BUF_TYPE_VIDEO_CAPTURE, V4L2_MEMORY_MMAP)
        fcntl.ioctl(self.fd, VIDIOC_REQBUFS, req)
        count = struct.unpack_from("I", req, 0)[0]
        self.maps = []
        for i in range(count):
            buf = bytearray(88)
            struct.pack_into("I", buf, 0, i)                 # index
            struct.pack_into("I", buf, 4, V4L2_BUF_TYPE_VIDEO_CAPTURE)
            struct.pack_into("I", buf, 40, V4L2_MEMORY_MMAP)
            fcntl.ioctl(self.fd, VIDIOC_QUERYBUF, buf)
            length = struct.unpack_from("I", buf, 48)[0]
            offset = struct.unpack_from("I", buf, 44)[0]
            self.maps.append(mmap.mmap(self.fd, length,
                                       offset=offset))
            fcntl.ioctl(self.fd, VIDIOC_QBUF, buf)
        fcntl.ioctl(self.fd, VIDIOC_STREAMON,
                    struct.pack("I", V4L2_BUF_TYPE_VIDEO_CAPTURE))

    def grab_block(self) -> Optional[np.ndarray]:
        buf = bytearray(88)
        struct.pack_into("I", buf, 4, V4L2_BUF_TYPE_VIDEO_CAPTURE)
        struct.pack_into("I", buf, 40, V4L2_MEMORY_MMAP)
        try:
            fcntl.ioctl(self.fd, VIDIOC_DQBUF, buf)
        except OSError:
            return None                   # no frame ready (non-blocking)
        idx = struct.unpack_from("I", buf, 0)[0]
        raw = np.frombuffer(self.maps[idx], np.uint8,
                            count=self.w * self.h * 2)
        frame = yuyv_to_i420_block(raw.reshape(self.h, self.w * 2),
                                   self.w, self.h)
        fcntl.ioctl(self.fd, VIDIOC_QBUF, buf)
        self.frames_grabbed += 1
        return frame

    def close(self):
        try:
            fcntl.ioctl(self.fd, VIDIOC_STREAMOFF,
                        struct.pack("I", V4L2_BUF_TYPE_VIDEO_CAPTURE))
        except OSError:
            pass
        for m in self.maps:
            m.close()
        os.close(self.fd)
