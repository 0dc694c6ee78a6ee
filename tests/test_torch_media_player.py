"""The port's MediaPlayer, MediaRecorder and A/V call recording against the
JAX package's on the CPU: on the same WAV, SMFF and Matroska files (PCM,
A_MS/ACM µ-law, A-law and PCM, Opus) the two players give equal output
blocks tick by tick, bit for bit at the file's rate and within 1e-6
through the resampler, with equal positions and EOF events, through
pause, seek and loop; the recorders write byte-equal files; what raises
waits for the video path; entry points run on the card unless told
``"cpu"``."""
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


def test_video_waits_raise(tmp_path):
    """A file with a VP8 or H.264 track, on_video, enable_video,
    push_video_frame and write_av_mkv's video track all raise the named
    wait; a file whose video track is of another codec plays its audio."""
    rate = 8000
    pcm = _pcm16(800, rate, seed=2).tobytes()
    for codec in ("V_VP8", "V_MPEG4/ISO/AVC", "V_AV1"):
        p = str(tmp_path / f"{codec.replace('/', '_')}.mkv")
        w = t_mkv.MkvWriter(p, [
            t_mkv.MkvTrack(1, t_mkv.TRACK_TYPE_AUDIO, "A_PCM/INT/LIT", sampling_rate=rate,
                           channels=1),
            t_mkv.MkvTrack(2, t_mkv.TRACK_TYPE_VIDEO, codec, width=64, height=48)])
        w.write_frame(1, 0, pcm)
        w.write_frame(2, 0, b"\x00" * 30)
        w.close()
        mp = t_mp.MediaPlayer(Factory(), device="cpu")
        if codec == "V_AV1":
            mp.open(p)
            assert mp.duration_ms == 100
            continue
        with pytest.raises(NotImplementedError, match="StreamRegulator"):
            mp.open(p)
    p = str(tmp_path / "av.smff")
    w = t_smff.SmffWriter(p, [t_smff.SmffTrack(0, "pcm16", rate, 1),
                              t_smff.SmffTrack(1, "vp8", 64, 48)])
    w.write_frame(0, 0, pcm)
    w.close()
    with pytest.raises(NotImplementedError, match="VP8"):
        t_mp.MediaPlayer(Factory(), device="cpu").open(p)
    with pytest.raises(NotImplementedError, match="VP8"):
        t_mp.MediaPlayer(Factory(), device="cpu").on_video = print
    rec = t_mp.MediaRecorder(Factory(), rate=rate, max_seconds=1, device="cpu")
    for fn in (lambda: rec.enable_video(64, 48), lambda: rec.push_video_frame(None),
               lambda: t_mp.write_av_mkv(str(tmp_path / "v.mkv"), np.zeros(80, np.float32),
                                         rate, [(0, None)], (64, 48))):
        with pytest.raises(NotImplementedError, match="VP8"):
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
