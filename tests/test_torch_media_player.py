"""The port's MediaPlayer, MediaRecorder and A/V call recording against the
JAX package's on the CPU: on the same WAV, SMFF and Matroska files (PCM,
A_MS/ACM µ-law, A-law and PCM, Opus) the two players give equal output
blocks tick by tick, bit for bit at the file's rate and within 1e-6
through the resampler, with equal positions and EOF events, through
pause, seek and loop; the recorders write byte-equal files; VP8 and
H.264 video tracks play through ``on_video`` as JAX's, and the A/V
recordings' VP8 tracks are byte-equal; entry points run on the card unless
told ``"cpu"``."""
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mediastreamer2_tpu.core.factory import Factory as JFactory  # noqa: E402
from mediastreamer2_tpu.io import mkv as j_mkv  # noqa: E402
from mediastreamer2_tpu.io.smff import SmffTrack as JSmffTrack  # noqa: E402
from mediastreamer2_tpu.io.smff import SmffWriter as JSmffWriter  # noqa: E402
from mediastreamer2_tpu.io.wav import write_wav as j_write_wav  # noqa: E402
from mediastreamer2_tpu.models import media_player as j_mp  # noqa: E402
from mediastreamer2_tpu_torch import Factory, tick_samples  # noqa: E402
from mediastreamer2_tpu_torch.io import mkv as t_mkv  # noqa: E402
from mediastreamer2_tpu_torch.io import smff as t_smff  # noqa: E402
from mediastreamer2_tpu_torch.io.wav import read_wav  # noqa: E402
from mediastreamer2_tpu_torch.models import media_player as t_mp  # noqa: E402
from mediastreamer2_tpu_torch.models.audio_stream import AudioStreamBatch  # noqa: E402
from mediastreamer2_tpu_torch.net.rtp import LoopbackPair  # noqa: E402
from mediastreamer2_tpu_torch.ops import host_codecs as t_hc  # noqa: E402
from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff  # noqa: E402
from mediastreamer2_tpu_torch.utils.signals import make_speechlike  # noqa: E402

needs_opus = pytest.mark.skipif(not t_hc.opus_available(), reason="libopus missing")


def _pcm16(n, rate, seed):
    """Speech on the int16 grid, so every container holds it exactly."""
    return np.round(make_speechlike(n, rate, seed=seed) * 32767).astype("<i2")


def _acm(tag, rate, bits):
    """WAVEFORMATEX: tag, channels, rate, bytes/s, block align, bits, cbSize."""
    return struct.pack("<HHIIHHH", tag, 1, rate, rate * bits // 8, bits // 8, bits, 0)


def _write_files(tmp_path, rate=8000, n=1234):
    """One file per container and codec, all written by the JAX package's
    writers (the port's write the same bytes: test_torch_containers.py)."""
    pcm = _pcm16(n, rate, seed=rate // 1000)
    files = {}
    p = str(tmp_path / "a.wav")
    j_write_wav(p, pcm / 32768.0, rate)
    files["wav"] = p
    p = str(tmp_path / "a.smff")
    w = JSmffWriter(p, [JSmffTrack(0, "pcm16", rate, 1)])
    for k in range(0, n, 80):
        w.write_frame(0, k * 1000 // rate, pcm[k:k + 80].tobytes())
    w.close()
    files["smff"] = p
    ulaw = np.random.default_rng(1).integers(0, 256, n, dtype=np.uint8)
    for name, codec, priv, data in (
            ("pcm", "A_PCM/INT/LIT", b"", pcm.tobytes()),
            ("ulaw", "A_MS/ACM", _acm(7, rate, 8), ulaw.tobytes()),
            ("alaw", "A_MS/ACM", _acm(6, rate, 8), ulaw.tobytes()),
            ("acm_pcm", "A_MS/ACM", _acm(1, rate, 16), pcm.tobytes())):
        p = str(tmp_path / f"{name}.mkv")
        w = j_mkv.MkvWriter(p, [j_mkv.MkvTrack(1, j_mkv.TRACK_TYPE_AUDIO, codec,
                                               sampling_rate=rate, channels=1,
                                               codec_private=priv)])
        step = 160 if codec == "A_PCM/INT/LIT" else 80
        bps = 2 if codec == "A_PCM/INT/LIT" or name == "acm_pcm" else 1
        for k in range(0, len(data), step * bps):
            w.write_frame(1, k // bps * 1000 // rate, data[k:k + step * bps])
        w.close()
        files[name] = p
    return files


class _Pair:
    """The JAX and the port's MediaPlayer on one file, ticked in lockstep."""

    def __init__(self, path, out_rate=None):
        self.j = j_mp.MediaPlayer(JFactory(), out_rate=out_rate)
        self.t = t_mp.MediaPlayer(Factory(), out_rate=out_rate, device="cpu")
        self.blocks = ([], [])
        self.eofs = ([], [])
        for k, mp in enumerate((self.j, self.t)):
            mp.set_output(self.blocks[k].append)
            mp.on_eof = lambda k=k: self.eofs[k].append(1)
            mp.open(path)
            mp.ticker.realtime = False
        self.play(True)

    def play(self, on):
        self.j.ticker.mutate(lambda tk: tk.params["play"].__setitem__(
            "playing", jnp.full((1,), on, bool)))
        self.t._set_play_param("playing", on)

    def tick(self, n):
        for _ in range(n):
            for mp in (self.j, self.t):
                mp.ticker.do_tick()
                mp.ticker.event_queue.pump()

    def check(self, atol):
        jb, tb = (np.stack(b) for b in self.blocks)
        assert tb.shape == jb.shape
        if atol:
            np.testing.assert_allclose(tb, jb, rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(tb, jb)
        assert len(self.eofs[1]) == len(self.eofs[0])
        assert self.t.get_position_ms() == self.j.get_position_ms()
        return tb


@pytest.mark.parametrize("out_rate", [None, 48000])
@pytest.mark.parametrize("kind", ["wav", "smff", "pcm", "ulaw", "alaw", "acm_pcm"])
def test_player_blocks_equal_jax_through_eof_pause_seek_loop(tmp_path, kind, out_rate):
    files = _write_files(tmp_path)
    pair = _Pair(files[kind], out_rate)
    assert (pair.t.rate, pair.t.duration_ms) == (pair.j.rate, pair.j.duration_ms) == (8000, 154)
    atol = 1e-6 if out_rate else 0
    pair.tick(5)
    pair.play(False)                                   # pause holds the position
    pair.tick(3)
    assert pair.t.get_position_ms() == 50
    pair.play(True)
    pair.tick(14)                                      # past EOF: one event
    out = pair.check(atol)
    assert len(pair.eofs[1]) == 1
    for mp in (pair.j, pair.t):
        mp.seek_ms(60)
        mp.set_loop(True)
    pair.tick(30)                                      # wraps twice
    pair.check(atol)
    assert len(pair.eofs[1]) == 3
    if not out_rate:
        # the played samples are the file's content, read by the JAX package
        read = {"wav": read_wav, "smff": j_mp._read_smff_audio}.get(kind, j_mp._read_mkv_audio)
        sig = read(files[kind])[0]
        assert len(sig) == 1234
        want = np.concatenate([sig[:400], np.zeros(240), sig[400:], np.zeros(22 * 80 - 1474)])
        np.testing.assert_array_equal(out.reshape(-1), want.astype(np.float32))


def test_acm_g711_decodes_equal_jax(tmp_path):
    files = _write_files(tmp_path, rate=16000, n=2000)
    for kind in ("ulaw", "alaw", "acm_pcm", "pcm"):
        want, rate = j_mp._read_mkv_audio(files[kind])
        got, trate = t_mp._read_mkv_audio(files[kind], "cpu")
        assert trate == rate == 16000 and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ext", [".wav", ".smff"])
def test_recorder_files_byte_equal_and_read_back(tmp_path, ext):
    rate, ticks = 16000, 23
    S = tick_samples(rate)
    sig = _pcm16(S * ticks, rate, seed=9) / 32768.0
    paths = []
    for pkg, rec in (("jax", j_mp.MediaRecorder(JFactory(), rate=rate, max_seconds=1)),
                     ("torch", t_mp.MediaRecorder(Factory(), rate=rate, max_seconds=1,
                                                  device="cpu"))):
        rec.set_input(lambda t: sig[t * S:(t + 1) * S])
        rec.ticker.realtime = False
        rec.run(ticks)
        paths.append(rec.stop_and_save(str(tmp_path / f"{pkg}{ext}")))
    data = [open(p, "rb").read() for p in paths]
    assert data[1] == data[0]
    back = (read_wav(paths[1])[0] if ext == ".wav"
            else t_mp._read_smff_audio(paths[1])[0])
    np.testing.assert_array_equal(back, sig.astype(np.float32))


@needs_opus
def test_recorder_mkv_opus_round_trip(tmp_path):
    """As the JAX package's tests/test_mkv.py: Opus in MKV, played back
    above 0.8 audio_diff; the two packages' files byte-equal."""
    rate, ticks = 48000, 60
    S = tick_samples(rate)
    sig = make_speechlike(S * ticks, rate, seed=12)
    paths = []
    for pkg, rec in (("jax", j_mp.MediaRecorder(JFactory(), rate=rate, max_seconds=1)),
                     ("torch", t_mp.MediaRecorder(Factory(), rate=rate, max_seconds=1,
                                                  device="cpu"))):
        rec.set_input(lambda t: sig[t * S:(t + 1) * S])
        rec.ticker.realtime = False
        rec.run(ticks)
        paths.append(rec.stop_and_save(str(tmp_path / f"{pkg}.mkv")))
    assert open(paths[1], "rb").read() == open(paths[0], "rb").read()
    mp = t_mp.MediaPlayer(Factory(), device="cpu")
    got = []
    mp.set_output(got.append)
    mp.open(paths[1])
    assert 550 <= mp.duration_ms <= 650
    mp.ticker.realtime = False
    mp._set_play_param("playing", True)
    for _ in range(ticks + 5):
        mp.ticker.do_tick()
    sim, _ = audio_diff(sig, np.concatenate(got))
    assert sim > 0.8, sim


def test_mkv_without_libopus_raises_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(t_hc, "_opus", None)
    rec = t_mp.MediaRecorder(Factory(), rate=16000, max_seconds=1, device="cpu")
    rec.ticker.realtime = False
    rec.run(3)
    path = tmp_path / "x.mkv"
    with pytest.raises(RuntimeError, match="libopus"):
        rec.stop_and_save(str(path))
    assert not path.exists()


@needs_opus
def test_save_av_recording_writes_the_calls_audio(tmp_path):
    """The call's recording as Opus MKV, byte-equal to the JAX package's
    write_av_mkv of the same recording."""
    ticks = 30
    S = tick_samples(8000)
    f = Factory()
    tx = AudioStreamBatch(f, 1, mic_signal=make_speechlike(S * ticks, 8000, seed=4),
                          device="cpu")
    rx = AudioStreamBatch(f, 1, record_ticks=ticks, device="cpu")
    pair = LoopbackPair()
    tx.set_transport(0, pair.endpoint(0))
    rx.set_transport(0, pair.endpoint(1))
    for s in (tx, rx):
        s.ticker.realtime = False
    for _ in range(ticks):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
    path = str(tmp_path / "call.mkv")
    rx.save_av_recording(path)
    want = str(tmp_path / "want.mkv")
    j_mp.write_av_mkv(want, rx.get_recording()[0], 8000, [], None)
    assert open(path, "rb").read() == open(want, "rb").read()
    assert t_mkv.MkvReader(path).tracks[1].codec_id == "A_OPUS"


def test_video_waits_raise(tmp_path, monkeypatch):
    """The video branches are ported: a file with a VP8 or H.264 track opens
    with its video branch (a StreamRegulator of the track's frames) and
    plays its audio, a track of another codec (AV1) is left out, and
    ``on_video`` takes a callback. Where the track's library is missing
    (monkeypatched away) opening raises ``RuntimeError`` naming it
    (libvpx, libavcodec), as do the recorder's ``enable_video`` and
    ``write_av_mkv`` with frames, which then writes nothing; the only
    refusal left is the library's own."""
    from mediastreamer2_tpu_torch.ops import h264 as t_h264
    from mediastreamer2_tpu_torch.ops import vp8 as t_vp8
    rate = 8000
    pcm = _pcm16(800, rate, seed=2).tobytes()
    libs = {"V_VP8": (t_vp8, "_vpx", "libvpx", t_vp8.vp8_available()),
            "V_MPEG4/ISO/AVC": (t_h264, "_av", "libavcodec", t_h264.h264_available())}
    sps, pps = bytes([0x67, 0x42, 0x00, 0x1F, 0xAB]), bytes([0x68, 0xCE, 0x3C, 0x80])
    avcc = (bytes([1, 0x42, 0x00, 0x1F, 0xFF, 0xE1]) + len(sps).to_bytes(2, "big") + sps
            + bytes([1]) + len(pps).to_bytes(2, "big") + pps)
    for codec in ("V_VP8", "V_MPEG4/ISO/AVC", "V_AV1"):
        p = str(tmp_path / f"{codec.replace('/', '_')}.mkv")
        w = t_mkv.MkvWriter(p, [
            t_mkv.MkvTrack(1, t_mkv.TRACK_TYPE_AUDIO, "A_PCM/INT/LIT", sampling_rate=rate,
                           channels=1),
            t_mkv.MkvTrack(2, t_mkv.TRACK_TYPE_VIDEO, codec, width=64, height=48,
                           codec_private=avcc if "AVC" in codec else b"")])
        w.write_frame(1, 0, pcm)
        w.write_frame(2, 0, b"\x00" * 30)
        w.close()
        mp = t_mp.MediaPlayer(Factory(), device="cpu")
        mp.on_video = print
        if codec == "V_AV1":
            mp.open(p)
            assert mp.duration_ms == 100 and mp._video_reg is None
            continue
        module, attr, lib, present = libs[codec]
        if present:
            mp.open(p)
            assert mp.duration_ms == 100 and mp._video_reg is not None
        with monkeypatch.context() as m:
            m.setattr(module, attr, None)
            m.setattr(module, "_verified", None, raising=False)
            m.setattr(module, "_checked", None, raising=False)
            with pytest.raises(RuntimeError, match=lib):
                t_mp.MediaPlayer(Factory(), device="cpu").open(p)
    p = str(tmp_path / "av.smff")
    w = t_smff.SmffWriter(p, [t_smff.SmffTrack(0, "pcm16", rate, 1),
                              t_smff.SmffTrack(1, "vp8", 64, 48)])
    w.write_frame(0, 0, pcm)
    w.close()
    monkeypatch.setattr(t_vp8, "_vpx", None)
    monkeypatch.setattr(t_vp8, "_verified", None)
    with pytest.raises(RuntimeError, match="libvpx"):
        t_mp.MediaPlayer(Factory(), device="cpu").open(p)
    rec = t_mp.MediaRecorder(Factory(), rate=rate, max_seconds=1, device="cpu")
    with pytest.raises(RuntimeError, match="enable_video first"):
        rec.push_video_frame(np.zeros((72, 64), np.float32))
    for fn in (lambda: rec.enable_video(64, 48),
               lambda: t_mp.write_av_mkv(str(tmp_path / "v.mkv"), np.zeros(80, np.float32),
                                         rate, [(0, np.zeros((72, 64), np.float32))], (64, 48))):
        with pytest.raises(RuntimeError, match="libvpx"):
            fn()
    assert not (tmp_path / "v.mkv").exists()


def test_parse_avcc_equal_jax():
    sps, pps = bytes([0x67, 0x42, 0x00, 0x1F, 0xAB]), bytes([0x68, 0xCE, 0x3C, 0x80])
    avcc = (bytes([1, 0x42, 0x00, 0x1F, 0xFF, 0xE1]) + len(sps).to_bytes(2, "big") + sps
            + bytes([1]) + len(pps).to_bytes(2, "big") + pps)
    for priv in (avcc, avcc[:-5], b"\x00" * 8, b"\x01\x02"):
        assert t_mp._parse_avcc(priv) == j_mp._parse_avcc(priv)
    assert t_mp._parse_avcc(avcc) == (4, [sps, pps])


def test_entry_points_run_on_the_card_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: t_mp.MediaPlayer(Factory()), lambda: t_mp.MediaRecorder(Factory())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    files = _write_files(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mp._read_mkv_audio(files["ulaw"])


def _vp8_or_skip():
    from mediastreamer2_tpu_torch.ops.vp8 import vp8_available
    if not vp8_available():
        pytest.skip("libvpx missing")


def _fixed_vp8_speed(monkeypatch):
    """Both packages' VP8 encoders at a fixed speed (``cpu_used=-10``): at
    the default libvpx picks its speed from measured encode times, and the
    bytes of one package's runs differ under load (tests/test_torch_vp8.py)."""
    import functools
    from mediastreamer2_tpu.ops import vp8 as j_vp8
    from mediastreamer2_tpu_torch.ops import vp8 as t_vp8
    for m in (j_vp8, t_vp8):
        monkeypatch.setattr(m, "Vp8Encoder", functools.partial(m.Vp8Encoder, cpu_used=-10))


def _mire_blocks(n, w=64, h=48, seed=0):
    """Packed-I420 float blocks [h*3/2, w] that move from frame to frame."""
    rng = np.random.default_rng(seed)
    base = rng.random((h * 3 // 2, w)).astype(np.float32)
    return [np.roll(base, 3 * k, axis=1) for k in range(n)]


def _av_file(tmp_path, container, video):
    """PCM audio (1 s) with a 25 fps VP8 or H.264 track of 20 frames, made
    by the port's encoders."""
    rate, w, h = 8000, 64, 48
    pcm = _pcm16(rate, rate, seed=5)
    blocks = _mire_blocks(20)
    frames, priv = [], b""
    if video == "vp8":
        from mediastreamer2_tpu_torch.ops.vp8 import Vp8Encoder
        enc = Vp8Encoder(w, h, fps=25)
        for k, b in enumerate(blocks):
            arr = (b * 255).astype(np.uint8)
            uv = arr[h:].reshape(h // 2, 2, w // 2)
            data, key = enc.encode_planes(arr[:h], uv[:, 0], uv[:, 1], force_keyframe=(k == 0))
            frames.append((40 * k, data, key))
    else:
        from mediastreamer2_tpu_torch.net.h26x import split_annexb
        from mediastreamer2_tpu_torch.ops.h264 import H264Encoder
        enc = H264Encoder(w, h, 300_000, 25)
        sets = None
        for k, b in enumerate(blocks):
            arr = (b * 255).astype(np.uint8)
            uv = arr[h:].reshape(h // 2, 2, w // 2)
            au = enc.encode(arr[:h].tobytes() + uv[:, 0].tobytes() + uv[:, 1].tobytes(),
                            keyframe=(k == 0))
            nals = split_annexb(au)
            if sets is None:
                sets = [n for n in nals if n[0] & 0x1F in (7, 8)]
            body = b"".join(len(n).to_bytes(4, "big") + n for n in nals
                            if n[0] & 0x1F not in (7, 8))
            frames.append((40 * k, body, k == 0))
        sps, pps = sets
        priv = (bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]) + len(sps).to_bytes(2, "big")
                + sps + bytes([1]) + len(pps).to_bytes(2, "big") + pps)
    p = str(tmp_path / f"{video}.{container}")
    if container == "mkv":
        codec = "V_VP8" if video == "vp8" else "V_MPEG4/ISO/AVC"
        wr = t_mkv.MkvWriter(p, [
            t_mkv.MkvTrack(1, t_mkv.TRACK_TYPE_AUDIO, "A_PCM/INT/LIT", sampling_rate=rate,
                           channels=1),
            t_mkv.MkvTrack(2, t_mkv.TRACK_TYPE_VIDEO, codec, width=w, height=h,
                           codec_private=priv)])
        for k in range(0, len(pcm), 160):
            wr.write_frame(1, k * 1000 // rate, pcm[k:k + 160].tobytes())
        for ts, data, key in frames:
            wr.write_frame(2, ts, data, keyframe=key)
    else:
        wr = t_smff.SmffWriter(p, [t_smff.SmffTrack(0, "pcm16", rate, 1),
                                   t_smff.SmffTrack(1, "vp8", w, h)])
        for k in range(0, len(pcm), 80):
            wr.write_frame(0, k * 1000 // rate, pcm[k:k + 80].tobytes())
        for ts, data, key in frames:
            wr.write_frame(1, ts, data, keyframe=key)
    wr.close()
    return p


@pytest.mark.parametrize("container,video", [("mkv", "vp8"), ("smff", "vp8"),
                                             ("mkv", "h264")])
def test_video_tracks_play_through_on_video_equal_jax(tmp_path, container, video):
    """Both players on one A/V file in lockstep, paused for a stretch: the
    same frames (every plane equal) reach ``on_video`` at the same ticks,
    paced by the play position (a frame every 4 ticks at 25 fps), and the
    audio blocks stay equal."""
    _vp8_or_skip()
    if video == "h264":
        from mediastreamer2_tpu_torch.ops.h264 import h264_available
        if not h264_available():
            pytest.skip("libavcodec missing")
    path = _av_file(tmp_path, container, video)
    pair = _Pair(path)
    seen = ([], [])
    for k, mp in enumerate((pair.j, pair.t)):
        mp.on_video = lambda yuv, k=k: seen[k].append(
            (mp.ticker.stats.ticks, [np.array(p) for p in yuv]))
    pair.tick(30)
    pair.play(False)
    pair.tick(10)
    pair.play(True)
    pair.tick(50)
    pair.check(0)
    assert len(seen[1]) == len(seen[0]) == pair.t.video_frames_played == 20
    assert [t for t, _ in seen[1]] == [t for t, _ in seen[0]]
    assert seen[1][1][0] - seen[1][0][0] in (3, 4, 5)
    for (_, a), (_, b) in zip(*seen):
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p, q)
    assert seen[1][-1][1][0].shape == (48, 64)


@needs_opus
def test_av_recording_vp8_track_byte_equal_jax(tmp_path, monkeypatch):
    """An audio call linked to a video call (``link_video``): the call's
    A/V MKV (``save_av_recording``) is byte-equal to the JAX package's
    ``write_av_mkv`` of the same recording and frames, VP8 track included
    (both encoders at a fixed speed), and reads back with the frames'
    timestamps."""
    _vp8_or_skip()
    _fixed_vp8_speed(monkeypatch)
    from mediastreamer2_tpu_torch import Format
    from mediastreamer2_tpu_torch.models.video_stream import VideoStreamBatch
    ticks = 40
    S = tick_samples(8000)
    f = Factory()
    tx = AudioStreamBatch(f, 1, mic_signal=make_speechlike(S * ticks, 8000, seed=4),
                          device="cpu")
    rx = AudioStreamBatch(f, 1, record_ticks=ticks, device="cpu")
    fmt = Format(kind="yuv420", width=64, height=48, fps=25.0)
    vtx = VideoStreamBatch(f, 1, fmt=fmt, fps=25.0, device="cpu")
    vrx = VideoStreamBatch(f, 1, fmt=fmt, fps=25.0, device="cpu")
    pair, vpair = LoopbackPair(), LoopbackPair()
    tx.set_transport(0, pair.endpoint(0))
    rx.set_transport(0, pair.endpoint(1))
    vtx.set_transport(0, vpair.endpoint(0))
    vrx.set_transport(0, vpair.endpoint(1))
    vtx.bind_assemblers()
    vrx.bind_assemblers()
    rx.link_video(vrx)
    streams = (tx, rx, vtx, vrx)
    for s in streams:
        s.ticker.realtime = False
    for _ in range(ticks):
        for s in streams:
            s.ticker.do_tick()
    assert len(rx._av_frames) == vrx.stats[0].frames_received >= 8
    path, want = str(tmp_path / "call.mkv"), str(tmp_path / "want.mkv")
    rx.save_av_recording(path)
    j_mp.write_av_mkv(want, rx.get_recording()[0], 8000, rx._av_frames, rx._av_wh)
    assert open(path, "rb").read() == open(want, "rb").read()
    r = t_mkv.MkvReader(path)
    assert [t.codec_id for t in r.tracks.values()] == ["A_OPUS", "V_VP8"]
    ts = [fr.ts_ms for fr in r.frames() if fr.track == 2]
    assert ts == [t for t, _ in rx._av_frames]
    rx.unlink_video()
    assert vrx._frame_listeners == {}


@needs_opus
@pytest.mark.parametrize("ext", ["mkv", "smff"])
def test_recorder_video_track_byte_equal_jax(tmp_path, monkeypatch, ext):
    """``MediaRecorder`` with ``enable_video``: the .mkv (Opus + VP8) and
    .smff (pcm16 + VP8) files equal the JAX recorder's, byte for byte (both
    encoders at a fixed speed)."""
    _vp8_or_skip()
    _fixed_vp8_speed(monkeypatch)
    rate, ticks = 16000, 30
    S = tick_samples(rate)
    sig = make_speechlike(S * ticks, rate, seed=8).astype(np.float32)
    blocks = _mire_blocks(8, seed=3)
    paths = []
    for k, rec in enumerate((j_mp.MediaRecorder(JFactory(), rate=rate, max_seconds=1),
                             t_mp.MediaRecorder(Factory(), rate=rate, max_seconds=1,
                                                device="cpu"))):
        rec.ticker.realtime = False
        rec.set_input(lambda t: sig[t * S:(t + 1) * S])
        rec.enable_video(64, 48)
        rec.ticker.warm_up()
        for t in range(ticks):
            if t % 4 == 0 and t // 4 < len(blocks):
                rec.push_video_frame(blocks[t // 4])
            rec.ticker.do_tick()
        paths.append(rec.stop_and_save(str(tmp_path / f"r{k}.{ext}")))
    assert open(paths[1], "rb").read() == open(paths[0], "rb").read()
