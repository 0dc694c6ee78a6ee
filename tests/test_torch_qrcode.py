"""The port's QR reader (``ops/qrcode.py``, OpenCV's detector) against the
JAX package's on the same frames: the two cases of ``tests/test_qrcode.py``
(a luma frame, a packed-YUV block as float and as u8), each reader giving
the same texts and the same ``found`` log. Skipped without cv2, where the
reader must raise."""
import numpy as np
import pytest

from mediastreamer2_tpu.ops import qrcode as j_qr
from mediastreamer2_tpu_torch.ops import qrcode as t_qr

pytestmark = pytest.mark.skipif(not t_qr.qrcode_available(), reason="no cv2")


def _make_qr(text):
    import cv2
    try:
        return cv2.QRCodeEncoder.create().encode(text)
    except (AttributeError, cv2.error):
        pytest.skip("cv2 QRCodeEncoder missing")


def test_availability_agrees():
    assert t_qr.qrcode_available() == j_qr.qrcode_available()


def test_qr_detect_from_luma():
    import cv2
    big = cv2.resize(_make_qr("sip:conf@example.com"), (240, 240),
                     interpolation=cv2.INTER_NEAREST)
    frame = np.full((320, 320), 255, np.uint8)
    frame[40:280, 40:280] = big
    plain = np.full((320, 320), 128, np.uint8)
    readers = (j_qr.QrCodeReader(), t_qr.QrCodeReader())
    for r in readers:
        assert r.scan_gray(frame) == "sip:conf@example.com"
        assert r.scan_gray(plain) is None
    assert readers[1].found == readers[0].found == ["sip:conf@example.com"]
    assert readers[1].frames_scanned == readers[0].frames_scanned == 2


@pytest.mark.parametrize("as_u8", [False, True])
def test_qr_from_packed_yuv_block(as_u8):
    import cv2
    big = cv2.resize(_make_qr("hello-tpu"), (200, 200), interpolation=cv2.INTER_NEAREST)
    h, w = 240, 320
    y = np.full((h, w), 255, np.uint8)
    y[20:220, 60:260] = big
    block = np.concatenate([y.astype(np.float32) / 255.0,
                            np.full((h // 2, w), 0.5, np.float32)], axis=0)
    if as_u8:
        block = np.round(block * 255).astype(np.uint8)
    got = [r.scan_yuv_block(block, w, h) for r in (j_qr.QrCodeReader(), t_qr.QrCodeReader())]
    assert got == ["hello-tpu", "hello-tpu"]
