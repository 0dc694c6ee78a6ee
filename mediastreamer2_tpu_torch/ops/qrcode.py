"""QR-code reader on a video branch (a copy of
``mediastreamer2_tpu/ops/qrcode.py``: numpy and cv2).

Reference: src/videofilters/zxing_qrcode.cpp (195 LoC — MSQrCodeReader
filter decoding QR codes from the camera branch, firing
MS_QRCODE_READER_QRCODE_FOUND events).  zxing-cpp is not bound here;
OpenCV's QRCodeDetector fills the same role (host-side branchy work, per
the design rules).  Gated: qrcode_available() is False without cv2.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

try:
    import cv2
    _detector = None
except ImportError:                                # pragma: no cover
    cv2 = None


def qrcode_available() -> bool:
    return cv2 is not None


class QrCodeReader:
    """Scan frames for QR codes; collects decoded texts like the
    reference's event stream (search window resets on found)."""

    def __init__(self):
        if cv2 is None:
            raise RuntimeError("cv2 not available")
        self._det = cv2.QRCodeDetector()
        self.found: List[str] = []
        self.frames_scanned = 0

    def scan_gray(self, gray: np.ndarray) -> Optional[str]:
        """gray: [H, W] uint8 luma plane (Y of YUV420 — no conversion
        needed, QR is luminance-only)."""
        self.frames_scanned += 1
        try:
            text, _, _ = self._det.detectAndDecode(gray)
        except cv2.error:
            return None
        if text:
            self.found.append(text)
            return text
        return None

    def scan_yuv_block(self, frame: np.ndarray, width: int,
                       height: int) -> Optional[str]:
        """Framework packed-I420 block ([h*3/2, w] float 0..1 or uint8)."""
        y = frame[:height]
        if y.dtype != np.uint8:
            y = (np.clip(y, 0, 1) * 255).astype(np.uint8)
        return self.scan_gray(np.ascontiguousarray(y))
