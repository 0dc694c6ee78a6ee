#!/usr/bin/env python
"""CLI softphone and leg runner on the port (counterpart of the JAX
package's ``tools/mediastream.py``; the reference's tools/mediastream.c,
bench.c, ring.c, echo.c, tones.c, msaudiocmp.c, mtudiscover.c,
pcap_playback.c, recorder.c and mkvstream.c).

    python -m mediastreamer2_tpu_torch.tools.mediastream [--device cpu] <cmd> ...

Examples:
  # duplex G.711 call leg to a remote endpoint
  python -m mediastreamer2_tpu_torch.tools.mediastream call --local-port 7078 \\
      --remote 1.2.3.4:7078 --codec ulaw --rate 8000 --ec --agc

  # N batched loopback legs for load testing (bench.c pattern)
  python -m mediastreamer2_tpu_torch.tools.mediastream bench --legs 50 --seconds 5

  # play a wav
  python -m mediastreamer2_tpu_torch.tools.mediastream play file.wav

The eleven subcommands take the JAX program's arguments and print its
lines. Departures from it:

* ``--device`` replaces ``--platform {cpu,tpu,default}``. It defaults to
  the CUDA card, as every entry point of the port does, and raises without
  one; ``--device cpu`` runs the kernels' plain versions on the CPU. Each
  subcommand builds its streams and graphs there (``pcap-play`` decodes
  there). It may stand before or after the subcommand;
* each ``cmd_*`` returns the exit code that the JAX program passes to
  ``sys.exit`` (``tones``, ``audiocmp``, ``mkvstream``), and ``main(argv)``
  returns it;
* ``record`` to ``.mkv`` / ``.webm`` checks for libopus before it records
  and raises naming it (the JAX program raises when it saves);
* ``tones`` prints ``?`` for a digit it did not detect (the JAX program
  raises a TypeError joining ``None``);
* a subcommand that needs a codec library the host lacks (``call --codec
  opus`` or ``gsm``, ``record x.mkv``) raises naming it; nothing falls
  back.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def cmd_call(args):
    from mediastreamer2_tpu_torch.core.factory import Factory
    from mediastreamer2_tpu_torch.io.wav import read_wav
    from mediastreamer2_tpu_torch.models.audio_stream import (AudioStreamBatch,
                                                              AudioStreamFeatures)
    from mediastreamer2_tpu_torch.net.rtp import UdpTransport

    factory = Factory()
    feats = AudioStreamFeatures(echo_canceller=args.ec, agc=args.agc,
                                noise_gate=args.ng, plc=True, vad_dtx=args.vad)
    sig = None
    if args.infile:
        sig, rate = read_wav(args.infile)
        if rate != args.rate:
            print(f"warning: file rate {rate} != {args.rate}")
    card = None
    if args.card:
        from mediastreamer2_tpu_torch.core.devices import SndCardManager
        mgr = SndCardManager()
        card = mgr.get_card(args.card) or (mgr.cards[0] if mgr.cards else None)
        print(f"sound card: {card}")
    stream = AudioStreamBatch(factory, 1, codec=args.codec, rate=args.rate,
                              features=feats, mic_signal=sig,
                              record_ticks=args.seconds * 100, snd_card=card,
                              device=args.device)
    mcast = args.multicast
    t = UdpTransport(local_port=args.local_port,
                     bind_host="0.0.0.0" if mcast else "127.0.0.1",
                     reuse_addr=bool(mcast))
    if mcast:
        t.join_multicast_group(mcast)
        t.set_remote(mcast, args.local_port)
    if args.remote:
        host, port = args.remote.rsplit(":", 1)
        t.set_remote(host, int(port))
    if args.symmetric:
        t.set_symmetric(True)
    if args.dscp:
        t.set_dscp(args.dscp)
    if args.use_native_pump:
        from mediastreamer2_tpu_torch.native import NativeIoPump
        t.attach_pump(NativeIoPump())
    stream.set_transport(0, t)
    if args.srtp_key:
        import binascii
        from mediastreamer2_tpu_torch.net.srtp import SUITES
        km = binascii.unhexlify(args.srtp_key)
        _k, klen, slen, _t = SUITES[args.srtp_suite]
        stream.enable_srtp(0, km[:klen], km[klen:klen + slen],
                           km[:klen], km[klen:klen + slen], suite=args.srtp_suite)
    print(f"call leg up: 127.0.0.1:{t.local_port} -> {args.remote} "
          f"codec={args.codec}@{args.rate} features={feats}")
    stream.run(args.seconds * 100)
    st = stream.get_stats(0)
    print(f"sent={st.sent_packets} recv={st.recv_packets} "
          f"jb_lost={stream.sessions[0].jitter_buffer.lost} "
          f"load={stream.ticker.get_average_load():.3f} "
          f"late={stream.ticker.stats.late_ticks}")
    if args.outfile and stream.get_recording() is not None:
        from mediastreamer2_tpu_torch.io.wav import write_wav
        write_wav(args.outfile, stream.get_recording()[0], args.rate)
        print(f"recorded -> {args.outfile}")
    return 0


def cmd_bench(args):
    """Loopback leg scaling (tools/bench.c: 50 legs per block)."""
    from mediastreamer2_tpu_torch.core.factory import Factory
    from mediastreamer2_tpu_torch.models.audio_stream import AudioStreamBatch
    from mediastreamer2_tpu_torch.net.rtp import LoopbackPair
    from mediastreamer2_tpu_torch.utils.signals import make_speechlike

    factory = Factory()
    B = args.legs
    ticks = args.seconds * 100
    sig = make_speechlike(80 * ticks, 8000)
    tx = AudioStreamBatch(factory, B, mic_signal=sig, device=args.device)
    rx = AudioStreamBatch(factory, B, device=args.device)
    for leg in range(B):
        pair = LoopbackPair()
        tx.set_transport(leg, pair.endpoint(0))
        rx.set_transport(leg, pair.endpoint(1))
    tx.ticker.warm_up()
    rx.ticker.warm_up()
    rx.start(ticks + 20)
    t0 = time.perf_counter()
    tx.run(ticks)
    dt = time.perf_counter() - t0
    tx.stop()
    rx.stop()
    print(f"{B} duplex legs x {ticks} ticks in {dt:.2f}s "
          f"(tx load {tx.ticker.get_average_load():.3f}, "
          f"late {tx.ticker.stats.late_ticks})")
    return 0


def ring_signal(rate: int = 8000) -> np.ndarray:
    """The default ring: 440 Hz, on and off at 2 Hz, one second."""
    t = np.arange(rate) / rate
    return (0.4 * np.sin(2 * np.pi * 440 * t) * (np.sin(2 * np.pi * 2 * t) > 0)).astype(np.float32)


def cmd_ring(args):
    """Ring-tone playback (reference tools/ring.c)."""
    from mediastreamer2_tpu_torch.core.factory import Factory
    from mediastreamer2_tpu_torch.io.wav import read_wav
    from mediastreamer2_tpu_torch.models.ring_stream import RingStreamBatch
    if args.file:
        sig, rate = read_wav(args.file)
    else:
        rate = 8000
        sig = ring_signal(rate)
    ring = RingStreamBatch(Factory(), batch=1, signal=sig, rate=rate, loop=True,
                           device=args.device)
    chunks = []
    ring.ticker.set_io(push=lambda t, o: chunks.append(o["spk"]))
    ring.start(args.seconds * 100)
    time.sleep(args.seconds)
    ring.stop()
    print(f"rang for {args.seconds}s ({len(chunks)} ticks)")
    return 0


def cmd_echo(args):
    """Audio loopback echo test (reference tools/echo.c: mic->speaker)."""
    from mediastreamer2_tpu_torch.core.block import Format, tick_samples
    from mediastreamer2_tpu_torch.core.factory import Factory
    from mediastreamer2_tpu_torch.core.graph import GraphBuilder
    from mediastreamer2_tpu_torch.core.ticker import Ticker
    g = GraphBuilder(Factory(), batch=1)
    src = g.add("ext_source", "mic", fmt=Format(rate=args.rate))
    vol = g.add("volume", "vol")
    g.link(src, 0, vol, 0)
    g.link(vol, 0, g.add("ext_sink", "spk"), 0)
    tk = Ticker(g.build(), device=args.device)
    S = tick_samples(args.rate)
    out = []
    tk.set_io(pull=lambda t: {"mic": np.zeros((1, S), np.float32)},
              push=lambda t, o: out.append(o["spk"]))
    tk.warm_up()
    tk.run(args.seconds * 100)
    print(f"echo loop ran {tk.stats.ticks} ticks, load "
          f"{tk.get_average_load():.3f}, late {tk.stats.late_ticks}")
    return 0


def cmd_play(args):
    from mediastreamer2_tpu_torch.core.factory import Factory
    from mediastreamer2_tpu_torch.models.media_player import MediaPlayer
    mp = MediaPlayer(Factory(), device=args.device)
    mp.open(args.file)
    done = []
    mp.on_eof = lambda: done.append(1)
    mp.start()
    print(f"playing {args.file} ({mp.duration_ms} ms)")
    while not done and mp.get_position_ms() < mp.duration_ms + 200:
        time.sleep(0.1)
        mp.ticker.event_queue.pump()
    mp.close()
    print("done")
    return 0


def tones(digits: str, rate: int = 8000, duration_ms: int = 100, device=None):
    """DTMF generate + detect (tools/tones.c: dtmfgen -> tonedetector):
    each digit for ``duration_ms`` then a 30 ms gap through one graph on
    ``device``. Returns (the digits detected, '?' for none; the generated
    audio [samples] float32)."""
    from mediastreamer2_tpu_torch.core.block import Format, tick_samples
    from mediastreamer2_tpu_torch.core.factory import Factory
    from mediastreamer2_tpu_torch.core.graph import GraphBuilder
    from mediastreamer2_tpu_torch.core.ticker import resolve_device
    from mediastreamer2_tpu_torch.ops.tones import classify_dtmf, dtmf_freqs

    dev = resolve_device(device)
    S = tick_samples(rate)
    g = GraphBuilder(Factory(), batch=1)
    src = g.add("void_source", "vs", fmt=Format(rate=rate))
    gen = g.add("dtmf_gen", "gen")
    det = g.add("tone_detector", "det")
    sink = g.add("ext_sink", "out")
    g.chain(src, gen, det, sink)
    cg = g.build()
    params, st = cg.init_params(dev), cg.init_state(dev)
    audio, detected = [], []
    ticks_per_digit = max(duration_ms // 10, 2)
    for digit in digits:
        f1, f2 = dtmf_freqs(digit)
        gp = params["gen"]
        gp["f1"] = torch.tensor([f1], dtype=torch.float32, device=dev)
        gp["f2"] = torch.tensor([f2], dtype=torch.float32, device=dev)
        gp["remaining"] = torch.tensor([S * (ticks_per_digit - 1)], dtype=torch.int32, device=dev)
        peak = np.zeros(8, np.float32)
        for _ in range(ticks_per_digit + 3):     # digit + inter-digit gap
            st, out, _ = cg.step(st, params, {})
            gp["remaining"] = torch.clamp(gp["remaining"] - S, min=0)
            audio.append(out["out"][0].cpu().numpy())
            peak = np.maximum(peak, st["det"]["power"][0].cpu().numpy())
        detected.append(classify_dtmf(peak) or "?")
    return "".join(detected), np.concatenate(audio)


def cmd_tones(args):
    """DTMF tone generate + detect loop (reference tools/tones.c:
    dtmfgen -> tonedetector -> filerec graph)."""
    got, audio = tones(args.digits, args.rate, args.duration_ms, args.device)
    print(f"generated '{args.digits}' -> detected '{got}'")
    if args.outfile:
        from mediastreamer2_tpu_torch.io.wav import write_wav
        write_wav(args.outfile, audio, args.rate)
        print(f"wrote {args.outfile}")
    return 0 if got == args.digits.upper() else 1


def cmd_audiocmp(args):
    """Similarity of two audio files (reference tools/msaudiocmp.c:
    ms_audio_diff with overlap percentage)."""
    from mediastreamer2_tpu_torch.io.wav import read_wav
    from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff
    a, ra = read_wav(args.file1)
    b, rb = read_wav(args.file2)
    if ra != rb:
        print(f"rate mismatch: {ra} vs {rb}")
        return 2
    max_shift = max(len(a), len(b)) * args.max_shift_percent // 100
    sim, shift = audio_diff(a, b, max_shift=max_shift)
    print(f"{args.file1} and {args.file2} are similar with a degree of "
          f"{sim:g} (shift {shift} samples).")
    return 0 if sim >= args.threshold else 1


def cmd_mtu(args):
    """Path-MTU discovery (reference tools/mtudiscover.c ->
    ms_discover_mtu)."""
    from mediastreamer2_tpu_torch.core.worker import discover_mtu
    mtu = discover_mtu(args.host, args.port)
    print(f"mtu to {args.host}: {mtu}")
    return 0


def pcap_decode(path: str, pt: int = 0, device=None):
    """Replay a pcap's RTP stream through a jitter buffer, a tick at a
    time at the capture's timing, and decode G.711 (PT 0 or 8) on
    ``device``. Returns (the RTP packets read, the decoded audio blocks,
    ticks run, the buffer's lost and late counts)."""
    from mediastreamer2_tpu_torch.core.ticker import resolve_device
    from mediastreamer2_tpu_torch.io.pcap import PcapRtpPlayer
    from mediastreamer2_tpu_torch.net.jitter import JBParams, JitterBuffer
    from mediastreamer2_tpu_torch.ops.g711 import alaw_decode, ulaw_decode

    dev = resolve_device(device)
    player = PcapRtpPlayer(path, payload_type=pt or None)
    jb = JitterBuffer(JBParams())
    dec_fn = {0: ulaw_decode, 8: alaw_decode}.get(pt)

    def decode(payload: bytes) -> np.ndarray:
        codes = torch.from_numpy(np.frombuffer(payload, np.uint8).astype(np.int32)).to(dev)
        return dec_fn(codes).cpu().numpy().astype(np.float32) / 32768.0

    out = []
    tick = 0
    while not player.finished or jb.buf:
        for pkt in player.due(tick * 0.01):
            jb.put(pkt, now=tick * 0.01)
        payload = jb.get_tick()
        if payload is not None and dec_fn is not None:
            out.append(decode(payload))
        tick += 1
        if tick > 100 * 3600:
            break
    return len(player.packets), out, tick, jb.lost, jb.late


def cmd_pcap_play(args):
    """Replay a pcap's RTP stream through the jitter buffer + decoder to a
    wav (reference tools/pcap_playback.c with MSPCAPFilePlayer)."""
    from mediastreamer2_tpu_torch.io.wav import write_wav
    n, out, tick, lost, late = pcap_decode(args.file, args.pt, args.device)
    print(f"{n} RTP packets in {args.file}")
    if out and args.outfile:
        write_wav(args.outfile, np.concatenate(out), args.rate)
        print(f"decoded {tick} ticks -> {args.outfile} (lost {lost}, late {late})")
    else:
        print(f"replayed {tick} ticks (lost {lost}, late {late})")
    return 0


def cmd_record(args):
    """Record capture (sound card or tone) to wav/mkv/smff (reference
    tools/recorder.c with MSMediaRecorder)."""
    from mediastreamer2_tpu_torch.core.block import tick_samples
    from mediastreamer2_tpu_torch.core.factory import Factory
    from mediastreamer2_tpu_torch.models.media_player import MediaRecorder

    if args.outfile.lower().endswith((".mkv", ".webm")):
        from mediastreamer2_tpu_torch.ops.host_codecs import opus_available
        if not opus_available():
            raise RuntimeError(f"record to {args.outfile} needs libopus (its Opus audio "
                               f"track), which is not available on this host")
    rate = args.rate
    S = tick_samples(rate)
    rec = MediaRecorder(Factory(), rate=rate, max_seconds=args.seconds + 1, device=args.device)
    card = None
    if args.card:
        from mediastreamer2_tpu_torch.core.devices import SndCardManager
        card = SndCardManager().get_card(args.card)
        print(f"capturing from {card}")
    if card is not None:
        rec.set_input(lambda t: np.asarray(card.pull(t, 1))[0])
    else:
        # no capture hardware: record a test tone (like recorder.c run
        # against the null card)
        tt = np.arange(S) / rate

        def tone(t):
            return (0.3 * np.sin(2 * np.pi * 440 * (tt + t * S / rate))).astype(np.float32)
        rec.set_input(tone)
    rec.run(args.seconds * 100)
    rec.stop_and_save(args.outfile)
    print(f"recorded {args.seconds}s -> {args.outfile}")
    return 0


def cmd_mkvstream(args):
    """Stream an MKV video track out over RTP (reference
    tools/mkvstream.c: H264 track -> RTP to destination)."""
    from mediastreamer2_tpu_torch.io.mkv import TRACK_TYPE_VIDEO, MkvReader
    from mediastreamer2_tpu_torch.models.media_player import _parse_avcc
    from mediastreamer2_tpu_torch.net.rtp import RtpSession, UdpTransport

    r = MkvReader(args.file)
    video = [t for t in r.tracks.values() if t.type == TRACK_TYPE_VIDEO]
    if not video:
        print("no video track")
        return 1
    track = video[0]
    host, port = args.dest.rsplit(":", 1)
    t = UdpTransport(local_port=args.local_port)
    t.set_remote(host, int(port))
    sess = RtpSession(t, payload_type=args.pt, clock_rate=90000)
    sent = 0
    t0 = time.perf_counter()

    def send(payloads):
        for k, p in enumerate(payloads):
            last = k == len(payloads) - 1
            sess.send_payload(p, ts_increment=90 * 33 if last else 0, marker=last)

    def paced(frames):
        for fr in frames:
            if fr.track != track.number:
                continue
            while time.perf_counter() - t0 < fr.ts_ms / 1000:
                time.sleep(0.001)
            yield fr

    if track.codec_id == "V_VP8":
        from mediastreamer2_tpu_torch.ops.vp8 import vp8_payload_pack
        for fr in paced(r.frames()):
            send(vp8_payload_pack([fr.data[i:i + args.mtu]
                                   for i in range(0, len(fr.data), args.mtu)],
                                  picture_id=sent & 0x7FFF))
            sent += 1
    elif track.codec_id.startswith("V_MPEG4/ISO/AVC"):
        from mediastreamer2_tpu_torch.net.h26x import packetize
        avcc = _parse_avcc(track.codec_private)
        if avcc is None:
            print("bad avcC codec private")
            return 1
        nal_len, param_sets = avcc
        first = True
        for fr in paced(r.frames()):
            nals = list(param_sets) if (first or fr.keyframe) else []
            first = False
            pos = 0
            while pos + nal_len <= len(fr.data):
                ln = int.from_bytes(fr.data[pos:pos + nal_len], "big")
                pos += nal_len
                nals.append(fr.data[pos:pos + ln])
                pos += ln
            send(packetize(nals, mtu=args.mtu))
            sent += 1
    else:
        print(f"unsupported codec {track.codec_id}")
        return 1
    t.close()
    print(f"streamed {sent} frames of {track.codec_id} to {args.dest}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    help_device = ("torch device for the streams and graphs (default: the CUDA card, "
                   "raising without one; 'cpu' runs the plain versions)")
    ap.add_argument("--device", default=None, help=help_device)
    # the same option after the subcommand; SUPPRESS keeps the one given
    # before it when it is not repeated
    after = argparse.ArgumentParser(add_help=False)
    after.add_argument("--device", default=argparse.SUPPRESS, help=help_device)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def command(name, fn, **kw):
        p = sub.add_parser(name, parents=[after], **kw)
        p.set_defaults(fn=fn)
        return p

    c = command("call", cmd_call)
    c.add_argument("--local-port", type=int, default=7078)
    c.add_argument("--remote", default="")
    c.add_argument("--codec", default="ulaw",
                   choices=["ulaw", "alaw", "l16", "opus", "gsm", "g722"])
    c.add_argument("--rate", type=int, default=8000)
    c.add_argument("--ec", action="store_true", help="echo canceller")
    c.add_argument("--agc", action="store_true")
    c.add_argument("--ng", action="store_true", help="noise gate")
    c.add_argument("--vad", action="store_true", help="VAD/DTX")
    c.add_argument("--srtp-key", default="", help="hex master key||salt")
    c.add_argument("--srtp-suite", default="AES_CM_128_HMAC_SHA1_80",
                   help="AES_CM_128_HMAC_SHA1_80 | AEAD_AES_128_GCM | ...")
    c.add_argument("--multicast", default="",
                   help="multicast group to join/send to (e.g. 224.1.2.3)")
    c.add_argument("--symmetric", action="store_true",
                   help="symmetric RTP: follow the peer's source address")
    c.add_argument("--dscp", type=int, default=0,
                   help="DSCP mark for media packets (e.g. 46 = EF)")
    c.add_argument("--infile", default="", help="wav to send instead of mic")
    c.add_argument("--card", default="",
                   help="sound card name (alsa:default, pulse:default, ...)")
    c.add_argument("--outfile", default="", help="record received audio")
    c.add_argument("--seconds", type=int, default=10)
    c.add_argument("--use-native-pump", action="store_true")

    b = command("bench", cmd_bench)
    b.add_argument("--legs", type=int, default=50)
    b.add_argument("--seconds", type=int, default=5)

    p = command("play", cmd_play)
    p.add_argument("file")

    r = command("ring", cmd_ring)
    r.add_argument("--file", default="")
    r.add_argument("--seconds", type=int, default=3)

    e = command("echo", cmd_echo)
    e.add_argument("--rate", type=int, default=8000)
    e.add_argument("--seconds", type=int, default=3)

    t = command("tones", cmd_tones, help="DTMF generate+detect (tools/tones.c)")
    t.add_argument("digits", help="e.g. 123A#")
    t.add_argument("--rate", type=int, default=8000)
    t.add_argument("--duration-ms", type=int, default=100)
    t.add_argument("--outfile", default="")

    a = command("audiocmp", cmd_audiocmp, help="wav similarity (tools/msaudiocmp.c)")
    a.add_argument("file1")
    a.add_argument("file2")
    a.add_argument("--max-shift-percent", type=int, default=10)
    a.add_argument("--threshold", type=float, default=0.0)

    m = command("mtu", cmd_mtu, help="path MTU (tools/mtudiscover.c)")
    m.add_argument("host")
    m.add_argument("--port", type=int, default=5060)

    pc = command("pcap-play", cmd_pcap_play, help="replay pcap RTP (tools/pcap_playback.c)")
    pc.add_argument("file")
    pc.add_argument("--pt", type=int, default=0)
    pc.add_argument("--rate", type=int, default=8000)
    pc.add_argument("--outfile", default="")

    rc = command("record", cmd_record, help="record to file (tools/recorder.c)")
    rc.add_argument("outfile", help=".wav / .mkv / .smff")
    rc.add_argument("--rate", type=int, default=8000)
    rc.add_argument("--seconds", type=int, default=5)
    rc.add_argument("--card", default="")

    mk = command("mkvstream", cmd_mkvstream,
                 help="stream MKV video over RTP (tools/mkvstream.c)")
    mk.add_argument("file")
    mk.add_argument("dest", help="host:port")
    mk.add_argument("--local-port", type=int, default=9078)
    mk.add_argument("--pt", type=int, default=102)
    mk.add_argument("--mtu", type=int, default=1400)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
