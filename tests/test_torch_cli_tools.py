"""The port's CLI (``python -m mediastreamer2_tpu_torch.tools.mediastream``)
on the CPU: the seven cases of tests/test_cli_tools.py on the port, each
held to the JAX package's ``tools/mediastream.py`` on the same inputs where
both run here (tones' WAV within 1e-6 and the same digits, audiocmp's
similarity to 1e-6, mtu's line, pcap-play's WAV bit-equal with the same
lost and late counts, record's WAV within 1e-6), mkvstream of VP8 and H.264
from fixed bytes parsed back, one ``call`` process against this test as its
RTP peer, and the two-process call; ``call``'s pair in lock step
against the JAX package's (with ``--ec --agc``, and with a side that
starts late). The subcommands JAX's file does not test
(ring, echo, play, bench) run once each."""
import importlib.util
import os
import socket
import subprocess
import sys
import time
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from mediastreamer2_tpu_torch.io.wav import read_wav, write_wav  # noqa: E402
from mediastreamer2_tpu_torch.tools import mediastream as cli  # noqa: E402
from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import mediastream as jax_cli  # noqa: E402


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py's phase 16 fixtures (the pcap and MKV writers, the
    mkvstream check); it defines only on import."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ns(**kw):
    return types.SimpleNamespace(device="cpu", **kw)


def _jax(fn, args):
    """A JAX subcommand's exit code (0 where it does not call sys.exit)."""
    try:
        fn(args)
    except SystemExit as e:
        return e.code
    return 0


def test_tones_generate_detect_matches_jax(tmp_path, capsys):
    out, jout = str(tmp_path / "tones.wav"), str(tmp_path / "jax.wav")
    assert cli.cmd_tones(_ns(digits="14#", rate=8000, duration_ms=80, outfile=out)) == 0
    assert _jax(jax_cli.cmd_tones, _ns(digits="14#", rate=8000, duration_ms=80,
                                       outfile=jout)) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[2] == "generated '14#' -> detected '14#'"
    a, ra = read_wav(out)
    b, rb = read_wav(jout)
    assert ra == rb == 8000 and a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_tones_digits_and_audio_at_16k_match_jax(capsys):
    got, audio = cli.tones("0*D9", rate=16000, duration_ms=60, device="cpu")
    assert got == "0*D9"
    assert _jax(jax_cli.cmd_tones, _ns(digits="0*D9", rate=16000, duration_ms=60,
                                       outfile="")) == 0
    assert "detected '0*D9'" in capsys.readouterr().out
    assert audio.dtype == np.float32 and len(audio) == 4 * 9 * 160


def test_tones_wrong_digit_exits_1(monkeypatch, capsys):
    """A digit the detector misses exits 1 (printed as '?')."""
    from mediastreamer2_tpu_torch.ops import tones as port_tones
    monkeypatch.setattr(port_tones, "classify_dtmf", lambda hits: None)
    assert cli.cmd_tones(_ns(digits="12", rate=8000, duration_ms=80, outfile="")) == 1
    assert "detected '??'" in capsys.readouterr().out


def test_audiocmp_matches_jax(tmp_path, capsys):
    from mediastreamer2_tpu_torch.utils.signals import make_speechlike
    speech = make_speechlike(4000, 8000, seed=3)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    write_wav(a, speech, 8000)
    write_wav(b, np.roll(speech, 80) * 0.7, 8000)         # shifted + gain
    args = _ns(file1=a, file2=b, max_shift_percent=10, threshold=0.9)
    assert cli.cmd_audiocmp(args) == 0 == _jax(jax_cli.cmd_audiocmp, args)
    port_line, jax_line = capsys.readouterr().out.splitlines()
    assert port_line == jax_line and "(shift 80 samples)" in port_line
    x, _ = read_wav(a)
    y, _ = read_wav(b)
    from mediastreamer2_tpu.utils.audiodiff import audio_diff as jax_diff
    sim, shift = audio_diff(x, y, max_shift=400)
    jsim, jshift = jax_diff(x, y, max_shift=400)
    assert sim == pytest.approx(jsim, abs=1e-6) and shift == jshift == 80
    # a rate mismatch exits 2; under the threshold 1
    write_wav(b, speech, 16000)
    assert cli.cmd_audiocmp(args) == 2
    write_wav(b, np.random.default_rng(4).standard_normal(4000).astype(np.float32), 8000)
    assert cli.cmd_audiocmp(args) == 1


def test_mtu_discover_matches_jax(capsys):
    assert cli.cmd_mtu(_ns(host="127.0.0.1", port=5060)) == 0
    jax_cli.cmd_mtu(_ns(host="127.0.0.1", port=5060))
    port_line, jax_line = capsys.readouterr().out.splitlines()
    assert port_line.startswith("mtu to 127.0.0.1: ") and port_line == jax_line


def test_pcap_playback_bit_equal_to_jax(tmp_path, capsys, smoke):
    """A capture written from a seed, with a reordered pair and a missing
    packet, replayed by both packages: the same WAV to the bit and the
    same counts (one lost, none late)."""
    pcap = str(tmp_path / "call.pcap")
    codes = smoke.pcap_fixture(pcap)
    out, jout = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    assert cli.cmd_pcap_play(_ns(file=pcap, pt=0, rate=8000, outfile=out)) == 0
    jax_cli.cmd_pcap_play(_ns(file=pcap, pt=0, rate=8000, outfile=jout))
    lines = capsys.readouterr().out.splitlines()
    n = smoke.PCAP_PACKETS - 1
    assert lines[0] == f"{n} RTP packets in {pcap}"
    assert lines[1].endswith(f"-> {out} (lost 1, late 0)")
    assert lines[0] == lines[2].replace(jout, out).replace(pcap, pcap)
    assert lines[1].replace(out, "X") == lines[3].replace(jout, "X")
    a, ra = read_wav(out)
    b, rb = read_wav(jout)
    assert ra == rb == 8000
    np.testing.assert_array_equal(a, b)
    assert len(a) == 80 * n and len(codes) == n + 1
    # the helper the CLI uses reads the same counts
    count, blocks, ticks, lost, late = cli.pcap_decode(pcap, 0, "cpu")
    assert (count, len(blocks), lost, late) == (n, n, 1, 0)


def test_pcap_playback_without_outfile(tmp_path, capsys, smoke):
    pcap = str(tmp_path / "call.pcap")
    smoke.pcap_fixture(pcap, seed=7, packets=100)
    assert cli.cmd_pcap_play(_ns(file=pcap, pt=0, rate=8000, outfile="")) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"99 RTP packets in {pcap}"
    assert out[1].startswith("replayed ") and out[1].endswith(" ticks (lost 1, late 0)")


def test_record_wav_matches_jax(tmp_path, capsys):
    out, jout = str(tmp_path / "rec.wav"), str(tmp_path / "jax.wav")
    assert cli.cmd_record(_ns(outfile=out, rate=8000, seconds=1, card="")) == 0
    jax_cli.cmd_record(_ns(outfile=jout, rate=8000, seconds=1, card=""))
    audio, rate = read_wav(out)
    jaudio, jrate = read_wav(jout)
    assert rate == jrate == 8000 and len(audio) >= 7000
    assert float(np.abs(audio).max()) > 0.1                # the tone is there
    assert audio.shape == jaudio.shape
    np.testing.assert_allclose(audio, jaudio, rtol=0, atol=1e-6)
    assert capsys.readouterr().out.splitlines()[0] == f"recorded 1s -> {out}"


def test_record_mkv_without_libopus_raises_before_recording(tmp_path, monkeypatch):
    from mediastreamer2_tpu_torch.ops import host_codecs
    monkeypatch.setattr(host_codecs, "opus_available", lambda: False)
    out = str(tmp_path / "rec.mkv")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="libopus"):
        cli.main(["--device", "cpu", "record", out, "--seconds", "1"])
    assert time.perf_counter() - t0 < 0.9 and not os.path.exists(out)


@pytest.mark.parametrize("codec", ["vp8", "h264"])
def test_mkvstream_packets_parse_back(tmp_path, smoke, codec):
    """mkvstream of an MKV of fixed bytes (no encoder needed): every frame
    comes back from its RTP packets (H.264 with its parameter sets before
    the first frame and each keyframe)."""
    packets, frames = smoke.mkvstream_check(str(tmp_path), codec, "cpu")
    assert frames == smoke.MKV_FRAMES and packets > frames     # frames cut at the MTU


def test_mkvstream_without_a_video_track_exits_1(tmp_path, capsys):
    from mediastreamer2_tpu_torch.io.mkv import TRACK_TYPE_AUDIO, MkvTrack, MkvWriter
    path = str(tmp_path / "audio.mkv")
    w = MkvWriter(path, [MkvTrack(1, TRACK_TYPE_AUDIO, "A_PCM/INT/LIT", sampling_rate=8000,
                                  channels=1)])
    w.write_frame(1, 0, bytes(160))
    w.close()
    assert cli.main(["mkvstream", path, "127.0.0.1:9", "--device", "cpu"]) == 1
    assert capsys.readouterr().out.strip() == "no video track"


def test_ring_echo_play_and_bench(tmp_path, capsys):
    """The subcommands tests/test_cli_tools.py leaves out, a second each."""
    wav = str(tmp_path / "ring.wav")
    write_wav(wav, cli.ring_signal()[:4000], 8000)
    assert cli.main(["--device", "cpu", "ring", "--seconds", "1"]) == 0
    assert cli.main(["--device", "cpu", "echo", "--seconds", "1"]) == 0
    assert cli.main(["--device", "cpu", "play", wav]) == 0
    assert cli.main(["bench", "--legs", "4", "--seconds", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "rang for 1s (" in out and "echo loop ran 100 ticks" in out
    assert f"playing {wav} (500 ms)" in out and "\ndone\n" in out
    assert "4 duplex legs x 100 ticks in" in out


def test_device_defaults_to_the_card(monkeypatch):
    """Without --device the programs run on the CUDA card and raise where
    there is none; --device may stand before or after the subcommand."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["tones", "1"])
    parser = cli.build_parser()
    assert parser.parse_args(["tones", "1"]).device is None
    assert parser.parse_args(["--device", "cpu", "tones", "1"]).device == "cpu"
    assert parser.parse_args(["tones", "1", "--device", "cpu"]).device == "cpu"


def _free_udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_call_process_records_what_its_peer_sends(tmp_path):
    """One ``mediastream call`` process (2 s, mu-law) with this test as its
    RTP peer: once the call's first packet arrives, the test sends speech
    a packet a tick; the call's recording of it is above 0.8."""
    from mediastreamer2_tpu_torch.net.rtp import RtpPacket
    from mediastreamer2_tpu_torch.ops.g711 import float_to_pcm16, ulaw_encode
    from mediastreamer2_tpu_torch.utils.signals import make_speechlike
    peer = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    peer.bind(("127.0.0.1", 0))
    peer.settimeout(0.05)
    port = _free_udp_port()
    out = str(tmp_path / "rec.wav")
    sig = make_speechlike(80 * 150, 8000, seed=12)
    codes = ulaw_encode(float_to_pcm16(torch.from_numpy(sig))).numpy().astype(np.uint8)
    cmd = [sys.executable, "-m", "mediastreamer2_tpu_torch.tools.mediastream", "--device",
           "cpu", "call", "--seconds", "2", "--local-port", str(port), "--remote",
           f"127.0.0.1:{peer.getsockname()[1]}", "--outfile", out]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        heard = 0
        deadline = time.monotonic() + 60
        while not heard and time.monotonic() < deadline and proc.poll() is None:
            try:
                peer.recv(2048)
                heard = 1
            except socket.timeout:
                pass
        assert heard, "the call sent nothing"
        t0 = time.monotonic()
        for k in range(150):
            pkt = RtpPacket(payload_type=0, seq=k, timestamp=80 * k, ssrc=0x77,
                            payload=codes[80 * k:80 * (k + 1)].tobytes())
            peer.sendto(pkt.pack(), ("127.0.0.1", port))
            time.sleep(max(0.0, t0 + 0.01 * (k + 1) - time.monotonic()))
        text, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        peer.close()
    assert proc.returncode == 0, text.decode()[-800:]
    assert f"recorded -> {out}" in text.decode()
    rec, rate = read_wav(out)
    assert rate == 8000 and len(rec) == 200 * 80
    assert audio_diff(sig, rec)[0] > 0.8


def _call_pair_in_lock_step(package, offset, ec_agc=True, ticks=500):
    """``call``'s pair as ``cmd_call`` builds it (a 1-leg mu-law
    ``AudioStreamBatch`` each, PLC, with ``ec_agc`` AEC + AGC, speech-like
    WAV seeds 71 and 72 as in chip_smoke.py's 16c) over a ``LoopbackPair`` of
    ``package``, ticked in turn without pacing, side 1 starting ``offset``
    ticks after side 0: each side's audio_diff against the other's
    speech."""
    import importlib
    from mediastreamer2_tpu_torch.utils.signals import make_speechlike
    mod = lambda name: importlib.import_module(f"{package}.{name}")
    stream, rtp = mod("models.audio_stream"), mod("net.rtp")
    kw = {"device": "cpu"} if package == "mediastreamer2_tpu_torch" else {}
    sigs = [make_speechlike(8000 * 4, 8000, seed=71 + side) for side in (0, 1)]
    feats = stream.AudioStreamFeatures(echo_canceller=ec_agc, agc=ec_agc, plc=True)
    factory = mod("core.factory").Factory()
    pair = rtp.LoopbackPair()
    sides = []
    for side in (0, 1):
        st = stream.AudioStreamBatch(factory, 1, codec="ulaw", rate=8000, features=feats,
                                     mic_signal=sigs[side], record_ticks=ticks, **kw)
        st.set_transport(0, pair.endpoint(side))
        st.ticker.realtime = False
        sides.append(st)
    for t in range(ticks + offset):
        if t < ticks:
            sides[0].ticker.do_tick()
        if t >= offset:
            sides[1].ticker.do_tick()
    return [audio_diff(sigs[1 - side], sides[side].get_recording()[0])[0] for side in (0, 1)]


@pytest.mark.parametrize("offset", [0, 20])
def test_call_pair_with_ec_agc_reads_as_jax(offset):
    """16c's ``--ec --agc`` pair reads under 1 because each side's echo
    canceller ducks its mic while the other talks (both talk throughout),
    and how much depends on how the two starts line up: in lock step over
    a loopback, 5 s, the port's pair reads what the JAX package's reads,
    side for side (the card's 16c pair, started together, reads the same
    at offset 0)."""
    port = _call_pair_in_lock_step("mediastreamer2_tpu_torch", offset)
    jax = _call_pair_in_lock_step("mediastreamer2_tpu", offset)
    print(f"call --ec --agc in lock step, side 1 {offset} ticks late: port "
          f"{port[0]:.4f} / {port[1]:.4f}, JAX {jax[0]:.4f} / {jax[1]:.4f}")
    assert port == pytest.approx(jax, abs=1e-3)


def test_call_pair_started_late_reads_as_jax():
    """A side that starts ticking 21 ticks after its socket began to queue
    the other's packets (a loopback queues them as a bound UDP socket
    does) plays them in order, but its jitter buffer trims the standing
    backlog by a packet every ~51 ticks; each trim moves the rest of the
    recording a tick, and audio_diff's single lag reads the pieces far
    under 0.8, in the JAX package as in the port. The other side hears its
    peer whole. So chip_smoke.py's 16c releases its two call processes
    together."""
    port = _call_pair_in_lock_step("mediastreamer2_tpu_torch", 21, ec_agc=False)
    jax = _call_pair_in_lock_step("mediastreamer2_tpu", 21, ec_agc=False)
    print(f"call pair, side 1 21 ticks late: port {port[0]:.4f} / {port[1]:.4f}, "
          f"JAX {jax[0]:.4f} / {jax[1]:.4f}")
    assert port == pytest.approx(jax, abs=1e-3)
    assert port[0] > 0.99 and port[1] < 0.8


@pytest.mark.slow
def test_cli_two_process_call(tmp_path):
    """tests/test_cli_tools.py's two-process call on the port: two ``call``
    processes exchange G.711 over localhost UDP for 5 s; each records what
    the other sent (above 0.8). Slow, as JAX's is: two interpreters paced
    in real time for 5 s. chip_smoke's 16c runs such pairs on the card."""
    from mediastreamer2_tpu_torch.utils.signals import make_speechlike
    sig_a = make_speechlike(8000 * 4, 8000, seed=71)
    sig_b = make_speechlike(8000 * 4, 8000, seed=72)
    in_a, in_b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    out_a, out_b = str(tmp_path / "ra.wav"), str(tmp_path / "rb.wav")
    write_wav(in_a, sig_a, 8000)
    write_wav(in_b, sig_b, 8000)
    pa, pb = _free_udp_port(), _free_udp_port()
    cmd = [sys.executable, "-m", "mediastreamer2_tpu_torch.tools.mediastream", "--device",
           "cpu", "call", "--seconds", "5"]
    procs = [subprocess.Popen(cmd + ["--local-port", str(mine), "--remote", f"127.0.0.1:{peer}",
                                     "--infile", fin, "--outfile", fout],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for mine, peer, fin, fout in ((pa, pb, in_a, out_a), (pb, pa, in_b, out_b))]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=60)
            assert p.returncode == 0, out.decode()[-800:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ra, _ = read_wav(out_a)
    rb, _ = read_wav(out_b)
    assert audio_diff(sig_b, ra)[0] > 0.8          # A recorded B's speech
    assert audio_diff(sig_a, rb)[0] > 0.8
