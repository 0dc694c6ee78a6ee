"""The port's containers and captures against the JAX package's on the CPU:
the WAV, SMFF, Matroska and pcap writers give byte-equal files from the
same inputs; the readers give equal samples, tracks, frames, timestamps and
packets on files the JAX package wrote and on hand-built ones (big-endian
and nanosecond pcap, every link type, IPv6, a pcapng with SHB, IDB with
``if_tsresol`` and EPB, a Matroska file with unknown sizes and unknown
elements); ``PcapRtpPlayer`` and ``replay_capture`` give equal counters on
a pathological capture; and the readers raise the same exception types on
garbage."""
import random
import struct
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)              # tiny shapes: one thread, as the other port tests

from mediastreamer2_tpu.io import mkv as j_mkv  # noqa: E402
from mediastreamer2_tpu.io import pcap as j_pcap  # noqa: E402
from mediastreamer2_tpu.io import smff as j_smff  # noqa: E402
from mediastreamer2_tpu.io import wav as j_wav  # noqa: E402
from mediastreamer2_tpu.net import jitter as j_jit  # noqa: E402
from mediastreamer2_tpu.net import rtp as j_rtp  # noqa: E402
from mediastreamer2_tpu_torch.io import mkv as t_mkv  # noqa: E402
from mediastreamer2_tpu_torch.io import pcap as t_pcap  # noqa: E402
from mediastreamer2_tpu_torch.io import smff as t_smff  # noqa: E402
from mediastreamer2_tpu_torch.io import wav as t_wav  # noqa: E402
from mediastreamer2_tpu_torch.net import jitter as t_jit  # noqa: E402
from mediastreamer2_tpu_torch.net import rtp as t_rtp  # noqa: E402

PACKAGES = {"jax": (j_wav, j_smff, j_mkv, j_pcap, j_jit, j_rtp),
            "torch": (t_wav, t_smff, t_mkv, t_pcap, t_jit, t_rtp)}


def _fields(obj):
    return {k: v for k, v in vars(obj).items()}


def _both(tmp_path, name, write):
    """write(package modules, path) for each package; returns the two
    files' bytes (JAX, port)."""
    out = []
    for pkg, mods in PACKAGES.items():
        path = tmp_path / f"{pkg}_{name}"
        write(mods, str(path))
        out.append(path.read_bytes())
    return out


# ------------------------------------------------------------------------ WAV
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_writer_byte_equal_and_readers_agree(tmp_path, channels):
    rng = np.random.default_rng(channels)
    x = np.clip(rng.normal(0, 0.4, 3000 * channels), -1.2, 1.2).astype(np.float32)
    jb, tb = _both(tmp_path, "a.wav", lambda m, p: m[0].write_wav(p, x, 16000, channels))
    assert jb == tb
    path = str(tmp_path / "jax_a.wav")
    for fn in ("read_wav", "read_wav_multi"):
        want, got = getattr(j_wav, fn)(path), getattr(t_wav, fn)(path)
        assert len(want) == len(got) and want[1:] == got[1:]
        np.testing.assert_array_equal(got[0], want[0])
    # an 8-bit file and a header that claims more frames than it holds
    p8 = str(tmp_path / "u8.wav")
    with wave.open(p8, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(1)
        w.setframerate(8000)
        w.writeframes(rng.integers(0, 256, 801, dtype=np.uint8).tobytes())
    raw = bytearray(open(p8, "rb").read())
    raw[40:44] = struct.pack("<I", 5000)
    open(p8, "wb").write(bytes(raw[:-1]))
    want, got = j_wav.read_wav_multi(p8), t_wav.read_wav_multi(p8)
    assert want[1:] == got[1:]
    np.testing.assert_array_equal(got[0], want[0])


# ----------------------------------------------------------------------- SMFF
def _smff_tracks(m):
    return [m.SmffTrack(m.KIND_AUDIO, "pcm16", 16000, 1), m.SmffTrack(m.KIND_VIDEO, "vp8", 64, 48),
            m.SmffTrack(m.KIND_AUDIO, "opus", 48000, 2)]


def _smff_frames(seed=4):
    rng = np.random.default_rng(seed)
    frames = []
    for k in range(40):
        track = int(rng.integers(0, 3))
        frames.append((track, 10 * k + int(rng.integers(0, 7)),
                       rng.bytes(int(rng.integers(0, 90))), bool(k % 3)))
    return frames


def test_smff_writer_byte_equal_and_reader_agrees(tmp_path):
    frames = _smff_frames()

    def write(mods, path):
        w = mods[1].SmffWriter(path, _smff_tracks(mods[1]))
        for f in frames:
            w.write_frame(*f)
        w.close()
    jb, tb = _both(tmp_path, "a.smff", write)
    assert jb == tb
    assert jb[:4] == b"SMFF" and struct.unpack("!I", jb[8:12])[0] > 16   # big-endian root
    path = str(tmp_path / "jax_a.smff")
    jr, tr = j_smff.SmffReader(path), t_smff.SmffReader(path)
    assert [_fields(t) for t in tr.tracks] == [_fields(t) for t in jr.tracks]
    for from_ms in (0, 137, 10 ** 6):
        assert ([_fields(f) for f in tr.frames(from_ms)]
                == [_fields(f) for f in jr.frames(from_ms)])
    assert [tr.duration_ms(k) for k in range(3)] == [jr.duration_ms(k) for k in range(3)]


# ------------------------------------------------------------------- Matroska
def _mkv_tracks(m):
    return [m.MkvTrack(1, m.TRACK_TYPE_AUDIO, "A_OPUS", sampling_rate=48000.0, channels=2,
                       codec_private=b"OpusHead" + bytes(11)),
            m.MkvTrack(2, m.TRACK_TYPE_VIDEO, "V_VP8", width=640, height=360),
            m.MkvTrack(3, m.TRACK_TYPE_AUDIO, "A_PCM/INT/LIT", sampling_rate=8000.0, channels=1)]


def test_mkv_writer_byte_equal_and_reader_agrees(tmp_path):
    rng = np.random.default_rng(7)
    # 3.5 s of frames: several clusters; payloads past the one-byte sizes
    frames = [(int(rng.integers(1, 4)), 20 * k, rng.bytes(int(rng.integers(0, 300))),
               bool(rng.integers(0, 2))) for k in range(175)]

    def write(mods, path):
        w = mods[2].MkvWriter(path, _mkv_tracks(mods[2]))
        for f in frames:
            w.write_frame(*f)
        w.close()
    jb, tb = _both(tmp_path, "a.mkv", write)
    assert jb == tb
    path = str(tmp_path / "jax_a.mkv")
    jr, tr = j_mkv.MkvReader(path), t_mkv.MkvReader(path)
    assert tr.timecode_scale == jr.timecode_scale
    assert {k: _fields(t) for k, t in tr.tracks.items()} == \
        {k: _fields(t) for k, t in jr.tracks.items()}
    for from_ms in (0, 1990, 10 ** 6):
        assert ([_fields(f) for f in tr.frames(from_ms)]
                == [_fields(f) for f in jr.frames(from_ms)])
    assert len(list(tr.frames())) == len(frames)


def test_mkv_reader_unknown_sizes_and_elements(tmp_path):
    """A hand-built file: an unknown-size segment, a Void element and an
    unknown top-level element skipped, a float32 sampling rate, two-byte
    sizes, and a last cluster of unknown size."""
    m = j_mkv
    void = m._elem(0xEC, bytes(5))
    odd = m._elem(0x1254C367, m._string(0x4487, "x"))           # Tags, skipped
    info = m._elem(m.SEG_INFO, m._uint(m.TIMECODE_SCALE, 1_000_000))
    entry = (m._uint(m.TRACK_NUMBER, 1) + m._uint(m.TRACK_TYPE, m.TRACK_TYPE_AUDIO)
             + m._string(m.CODEC_ID, "A_PCM/INT/LIT")
             + m._elem(m.T_AUDIO, m._elem(m.A_SAMPLING, struct.pack(">f", 16000.0))
                       + m._uint(m.A_CHANNELS, 1)))
    tracks = m._elem(m.TRACKS, m._elem(m.TRACK_ENTRY, entry))

    def block(rel, data, key=True):
        return m._elem(m.SIMPLE_BLOCK, bytes([0x81]) + struct.pack(">h", rel)
                       + bytes([0x80 if key else 0]) + data)
    c1 = m._elem(m.CLUSTER, m._uint(m.CLU_TIMECODE, 0) + block(0, b"a" * 200) + block(10, b"b"))
    c2 = (m._id_bytes(m.CLUSTER) + b"\x01\xff\xff\xff\xff\xff\xff\xff"
          + m._uint(m.CLU_TIMECODE, 1000) + block(-5, b"c", False) + block(20, b"d" * 3))
    blob = (m._elem(m.EBML_HEADER, m._string(m.DOC_TYPE, "webm")) + void
            + m._id_bytes(m.SEGMENT) + b"\x01\xff\xff\xff\xff\xff\xff\xff"
            + info + odd + void + tracks + c1 + c2)
    path = tmp_path / "hand.mkv"
    path.write_bytes(blob)
    jr, tr = j_mkv.MkvReader(str(path)), t_mkv.MkvReader(str(path))
    assert tr.tracks[1].sampling_rate == 16000.0
    assert {k: _fields(t) for k, t in tr.tracks.items()} == \
        {k: _fields(t) for k, t in jr.tracks.items()}
    want = [_fields(f) for f in jr.frames()]
    assert [_fields(f) for f in tr.frames()] == want
    assert [(f["ts_ms"], f["keyframe"]) for f in want] == [(0, True), (10, True), (995, False),
                                                           (1020, True)]


# ----------------------------------------------------------------------- pcap
def _rtp_capture(mods, n=60, seed=0):
    rng = np.random.default_rng(seed)
    rtp = mods[5]
    pkts = []
    for seq in range(n):
        p = rtp.RtpPacket(9, (40000 + seq) & 0xFFFF, 80 * seq, 0x1234,
                          rng.bytes(80), marker=seq == 0)
        pkts.append(mods[3].CapturedPacket(ts=1.5 + 0.01 * seq + 1e-6 * int(rng.integers(0, 999)),
                                           udp_payload=p.pack(), src_port=seq % 3 and 4000))
    return pkts


def test_pcap_writer_byte_equal_and_reader_agrees(tmp_path):
    def write(mods, path):
        mods[3].write_pcap(path, _rtp_capture(mods), src=("192.168.1.2", 6000),
                           dst=("10.1.2.3", 7000))
    jb, tb = _both(tmp_path, "a.pcap", write)
    assert jb == tb
    path = str(tmp_path / "jax_a.pcap")
    for fn in ("read_pcap", "read_capture"):
        want = [_fields(p) for p in getattr(j_pcap, fn)(path)]
        assert [_fields(p) for p in getattr(t_pcap, fn)(path)] == want
    assert len(want) == 60 and want[1]["src_port"] == 4000 and want[0]["src_port"] == 6000


def _udp(sport, dport, payload):
    return struct.pack("!HHHH", sport, dport, 8 + len(payload), 0) + payload


def _ip4(udp, proto=17):
    return struct.pack("!BBHHHBBH4s4s", 0x45, 0, 20 + len(udp), 0, 0, 64, proto, 0,
                       bytes(4), bytes(4)) + udp


def _ip6(udp):
    return struct.pack("!IHBB16s16s", 6 << 28, len(udp), 17, 64, bytes(16), bytes(16)) + udp


def _frames():
    """(link type, frame) pairs: every link type, IPv4 and IPv6, and
    frames each reader must skip."""
    u = [_udp(5000 + k, 6000 + k, bytes([k]) * (10 + k)) for k in range(8)]
    eth = bytes(12)
    return [
        (t_pcap.LINKTYPE_ETHERNET, eth + b"\x08\x00" + _ip4(u[0])),
        (t_pcap.LINKTYPE_ETHERNET, eth + b"\x86\xdd" + _ip6(u[1])),
        (t_pcap.LINKTYPE_ETHERNET, eth + b"\x08\x06" + bytes(28)),          # ARP: skipped
        (t_pcap.LINKTYPE_LINUX_SLL, bytes(14) + b"\x08\x00" + _ip4(u[2])),
        (t_pcap.LINKTYPE_NULL, struct.pack("<I", 2) + _ip4(u[3])),
        (t_pcap.LINKTYPE_NULL, struct.pack(">I", 2) + _ip4(u[4])),
        (t_pcap.LINKTYPE_NULL, struct.pack("<I", 24) + _ip6(u[5])),       # AF_INET6: skipped
        (t_pcap.LINKTYPE_RAW, _ip4(u[6])),
        (t_pcap.LINKTYPE_RAW, _ip4(u[7], proto=6)),                        # TCP: skipped
        (t_pcap.LINKTYPE_RAW, _ip4(b"\x00" * 4)),                          # short UDP
    ]


@pytest.mark.parametrize("endian,magic,div", [
    ("<", 0xA1B2C3D4, 10 ** 6), (">", 0xA1B2C3D4, 10 ** 6),
    ("<", 0xA1B23C4D, 10 ** 9), (">", 0xA1B23C4D, 10 ** 9)])
def test_pcap_readers_agree_on_hand_built_captures(tmp_path, endian, magic, div):
    """A classic capture a link type at a time (usec and nsec, both byte
    orders), packets at fractional times."""
    for lt in sorted({lt for lt, _ in _frames()}):
        blob = struct.pack(endian + "IHHiIII", magic, 2, 4, 0, 0, 65535, lt)
        for k, (flt, frame) in enumerate(_frames()):
            if flt == lt:
                blob += struct.pack(endian + "IIII", 100 + k, (k * 12345) % div,
                                    len(frame), len(frame)) + frame
        path = tmp_path / f"lt{lt}.pcap"
        path.write_bytes(blob)
        want = [_fields(p) for p in j_pcap.read_capture(str(path))]
        assert [_fields(p) for p in t_pcap.read_capture(str(path))] == want
        assert len(want) == {t_pcap.LINKTYPE_ETHERNET: 2, t_pcap.LINKTYPE_LINUX_SLL: 1,
                             t_pcap.LINKTYPE_NULL: 2, t_pcap.LINKTYPE_RAW: 1}[lt]


def test_pcapng_reader_agrees(tmp_path):
    """SHB, two IDBs (Ethernet at the default microseconds; raw IP with
    if_tsresol 9, nanoseconds, and another at 2^-20 s), EPBs on each, and a
    block of another type skipped."""
    def block(btype, body):
        body += bytes(-len(body) % 4)
        n = 12 + len(body)
        return struct.pack("<II", btype, n) + body + struct.pack("<I", n)

    def idb(link, tsresol=None):
        opts = b""
        if tsresol is not None:
            opts = struct.pack("<HH", 9, 1) + bytes([tsresol]) + bytes(3)
        return block(1, struct.pack("<HHI", link, 0, 65535) + opts + struct.pack("<HH", 0, 0))

    def epb(iface, ts, frame):
        return block(6, struct.pack("<IIIII", iface, ts >> 32, ts & 0xFFFFFFFF, len(frame),
                                    len(frame)) + frame)
    shb = block(0x0A0D0D0A, struct.pack("<IHHq", 0x1A2B3C4D, 1, 0, -1))
    eth, raw = _frames()[0][1], _frames()[7][1]
    blob = (shb + idb(t_pcap.LINKTYPE_ETHERNET) + idb(t_pcap.LINKTYPE_RAW, 9)
            + idb(t_pcap.LINKTYPE_RAW, 0x80 | 20)
            + epb(0, 1_700_000_000_123_456, eth) + block(5, bytes(16))
            + epb(1, 1_700_000_000_123_456_789, raw) + epb(2, 3 << 20, raw)
            + epb(7, 42, eth))                                   # unknown interface
    path = tmp_path / "a.pcapng"
    path.write_bytes(blob)
    want = [_fields(p) for p in j_pcap.read_capture(str(path))]
    assert [_fields(p) for p in t_pcap.read_capture(str(path))] == want
    assert [p["ts"] for p in want] == [1_700_000_000.123456, 1_700_000_000.1234568, 3.0,
                                       42e-6]


def _scenario(mods, path, n=200, late=None, lost=()):
    """The JAX package's tests/test_pcap_bundle.py capture: 10 ms packets,
    ``lost`` missing, ``late`` {seq: seconds} delayed, sorted by time."""
    late = late or {}
    pkts = []
    for seq in range(n):
        if seq in lost:
            continue
        rtp = mods[5].RtpPacket(0, seq, seq * 80, 0x1234, bytes([seq & 0xFF] * 80))
        pkts.append(mods[3].CapturedPacket(ts=seq * 0.010 + late.get(seq, 0.0),
                                           udp_payload=rtp.pack()))
    pkts.sort(key=lambda p: p.ts)
    mods[3].write_pcap(path, pkts)


LOST = {20, 21, 50, 77, 90, 120, 121, 122, 150, 180}
LATE = {60: 0.25, 61: 0.25, 100: 0.4, 101: 0.4, 102: 0.4}


def test_pcap_rtp_player_and_replay_capture_counters_agree(tmp_path):
    counters = {}
    for pkg, mods in PACKAGES.items():
        path = str(tmp_path / f"{pkg}.pcap")
        _scenario(mods, path, lost=LOST, late=LATE)
        player = mods[3].PcapRtpPlayer(path, payload_type=0)
        jb = mods[4].JitterBuffer(mods[4].JBParams(nom_depth_ticks=4))
        got, concealed, seqs, now = 0, 0, [], 0.0
        for _ in range(260):
            for pkt in player.due(now):
                seqs.append(pkt.seq)
                jb.put(pkt)
            payload = jb.get_tick()
            got += payload is not None
            concealed += payload is None
            now += 0.010
        replay = {tick_s: mods[4].replay_capture(path, mods[4].JitterBuffer(), payload_type=0,
                                                 tick_s=tick_s) for tick_s in (None, 0.01)}
        counters[pkg] = dict(got=got, concealed=concealed, seqs=seqs, finished=player.finished,
                             lost=jb.lost, late=jb.late, replay=replay,
                             other_pt=mods[3].PcapRtpPlayer(path, payload_type=8).packets)
    assert counters["torch"] == counters["jax"]
    c = counters["torch"]
    assert c["got"] >= 180 and c["lost"] >= len(LOST) and c["late"] >= 3 and c["finished"]
    assert c["replay"][None]["recv"] == 190 and c["other_pt"] == []


def _rand_blobs(seed, n=60, max_len=512):
    """The JAX package's tests/test_parser_robustness.py garbage."""
    rng = random.Random(seed)
    blobs = [b"", b"\x00", b"\x80", b"\xff" * 4]
    for _ in range(n):
        blobs.append(bytes(rng.randrange(256) for _ in range(rng.randrange(max_len))))
    return blobs


def _outcome(fn, path):
    try:
        fn(path)
    except Exception as e:                    # noqa: BLE001 - the type is compared
        return type(e).__name__
    return None


@pytest.mark.parametrize("magic", [b"", b"\x0a\x0d\x0d\x0a", b"\xd4\xc3\xb2\xa1", b"SMFF",
                                   b"\x1a\x45\xdf\xa3"])
def test_readers_survive_garbage_with_the_same_exceptions(tmp_path, magic):
    """Each reader on each blob (and on the blob behind each container's
    magic) raises what the JAX package's raises, or nothing when it does."""
    readers = [(j_pcap.read_capture, t_pcap.read_capture), (j_mkv.MkvReader, t_mkv.MkvReader),
               (j_smff.SmffReader, t_smff.SmffReader)]
    for k, blob in enumerate(_rand_blobs(5)):
        p = tmp_path / f"junk{k}"
        p.write_bytes(magic + blob)
        for jfn, tfn in readers:
            assert _outcome(tfn, str(p)) == _outcome(jfn, str(p)), (k, tfn)
