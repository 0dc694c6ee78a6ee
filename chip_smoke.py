#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mediastreamer2_tpu_torch) on one
NVIDIA GPU: builds its kernels and its native RTP edge from source, checks
each kernel against its plain PyTorch version on the card, drives the
flagship conference leg, the end-to-end G.711 leg over localhost UDP (in
clear and with SRTP), the session layer, the secured wideband call
(G.722, SRTP, RTCP and QoS), the gateway transcoder (G.711 <-> G.726-32,
the DVI4 and G.726 codec chains, Baudot TTY) and captured and recorded
calls (pcap replay into a G.722 stream, WAV / SMFF / MKV through
MediaPlayer and MediaRecorder), negotiated calls (ICE, DTLS-SRTP, ZRTP
and offer/answer through CallSetup, then the secured wideband session on
the keys they agreed) and the video call (VideoStreamBatch's pixel path at
1,024 VGA-to-QVGA legs, VideoE2EBench over UDP) and the SFU (1,024
participants through the native receive pump, ranked by levels computed
on the card, with the video router, FlexFEC, RFC 4103 text and UPnP beside
it) and the mixed fleet (1,024 + 256 e2e legs co-resident in one paced
loop and in per-member threads), the host-codec legs and the
quirk-configured session on sound cards, leg sharding, and the programs
around the package (the ``mediastream`` CLI and the four examples), and
compares the port on the card with the port on the CPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, g++ and nvidia-smi; imports nothing of JAX.
Phases, in order (any failure raises and the script exits non-zero):

1. card, versions, build times (one nvcc per kernel source and g++ for the
   edge and the receive pump, started together), the G.722, DVI4, G.726 and
   aec_decide kernels' registers
   and spill bytes from nvcc's ``-Xptxas -v`` report (a spill fails the
   run), the edge's AES path (``native.hw_crypto``) and which system codec,
   video, crypto and sound libraries the machine has (opus, gsm, speex,
   bcg729, bv16, avcodec, vpx, aom, X11, ssl, crypto, asound, pulse-simple:
   printed only), OpenSSL's version (``OpenSSL_version``), RLIMIT_NOFILE's
   soft and hard limits, whether cv2 imports, /dev/video* and DISPLAY;
2. each kernel against its plain version, at the flagship's shapes
   (fused_volume; mdf_apply with bf16 and with f32 shadow taps;
   mdf_update at cpos 0, 3, 7; mdf_update_fused, f32 and bf16 shadow,
   at cpos 0, 3, 7 and on four row slices with their lin0, timed on no
   flag set and on 30% of legs promoted, reseeded or hard-reset, each
   bound counting what its legs need; the element-by-element paths;
   the echo canceller's ``EC_KERNELS`` bit-exact and on four row
   slices: spectrum_planes with and without the alternating sign and
   planes_spectrum at F bins and at the suppressor's S/2 + 1,
   suppress_gain on legs from loud to silent; aec_decide on every kind
   of leg, with and without the suppressor: flags, counters and e_s
   equal, the rest within rtol 1e-5, row slices bit for bit; and on rows
   longer than its registers hold, 960 and 882 samples at 1,024 legs)
   at the session's (B = 1,024, S = 80, F = 81: the three kernels of
   its path) and the wideband call's (B = 1,024, S = 160, F = 161), and
   g722_encode / g722_decode bit-exact (codes or samples and every state
   leaf after every tick): the ITU vectors as one 1,600-slot tick on one
   leg and on 1,024 (even legs equal to the vectors' codes and samples),
   three ticks of random input and three of speech at B = 1,024, and
   ragged shapes (1, 33 and 1,000 legs x 1, 7 and 160 slots, two ticks
   each); each kernel with its device time per
   launch (the stream spins while the host enqueues, then one event pair
   around 50 launches, over input sets that spill the L2), its bound
   (bytes over 3.35 TB/s or operations over 67 TFLOP/s, the larger; for
   G.722 the serial chain of its 80 code slots instead of the throughput)
   and its share of the bound; dvi4_encode / dvi4_decode and g726_encode /
   g726_decode at 16, 24, 32 and 40 kbit/s at B = 1,024 over three ticks of
   speech, bit-exact (codes, decoded samples and every state leaf; G.726's
   differing codes are counted and printed) and on ragged shapes (1, 33, 77
   and 1,000 legs x 1, 7, 80 and 200 samples, two ticks each, G.726 at
   every rate; DVI4 also at 77 legs x 200 samples), DVI4 also on two clamp
   fixtures at B = 1,024 x 3 ticks that must reach pred -32768 and 32767
   and index 0 and 88 (a full-scale square wave then silence through the
   encoder, random codes through the decoder), each beside its
   serial-chain (dvi4_decode: the shorter of that and its scan depth) and
   bytes bounds; the launch floor, an empty kernel's launch timed the same
   way, on one block and on 1,024;
3. the flagship at 4,096 legs (1,024 four-party conferences) for 100
   ticks of echo-coupled input: fused_volume, mdf_apply and
   mdf_update_fused launched once per tick and mdf_update never,
   spectrum_planes 5, planes_spectrum 4, suppress_gain and aec_decide
   once a tick (``EC_KERNELS``: every launch bar wants them with
   mdf_apply), the
   echo canceller's 8 DFTs a tick all FFTs (``ops/rfft.calls``), all
   outputs finite, the AEC's shadow filter converged (Es < 0.5 * Dn) on
   >= 90% of legs; ms/tick;
4. the flagship on the CPU (plain versions) against the card (kernels) on
   the cross-backend fixture (256 legs, 100 ticks), held to the bar of
   tools/tpu_correctness.py: audio_diff >= 0.999 on legs 0, 37, 74, ...
   (the all-legs minimum is printed too), rms error <= 5e-3, and per-leg
   energy gap <= 1.5 dB;
5. the e2e leg (models/e2e_bench.py) in the AEC's megakernel mode
   (PALLAS_MDF=1): 1,024 legs paced over localhost UDP for 300 measured
   ticks inside paused_gc, with mdf_apply, mdf_update and fused_volume
   launched once per tick and mdf_update_fused never, finite graph
   outputs and state, loss < 0.02 and fidelity >= 0.9; the same with
   AES_CM_128_HMAC_SHA1_80 on every leg (srtp=True; no authentication
   failure); then 4,096 legs unpaced for 100 ticks, printed with no bar;
6. the e2e graph without the network in megakernel mode, the CPU against
   the card, 256 legs x 100 ticks fed the same mu-law codes, held to the
   bar of phase 4;
7. the session layer (AudioStreamBatch, Ticker, AudioConferenceControl):
   echo-cancelling (AEC + AGC) mu-law clients against a conference
   server, legs 4k..4k+3 in conference k, leg 4k talking. 7a: 1,024 +
   1,024 legs over the batch edge, 150 alternating do_ticks: fused_volume
   3 (the clients' two volumes, the server's receive volume: a conference
   stream has no send volume), mdf_apply 1 and mdf_update_fused 1
   launches per tick pair and mdf_update none, finite outputs and state, each leg's edge recv >=
   ticks/2, active_talkers names each talker and no listener; 7b: 64 +
   64 legs over LoopbackPair, each ticker start()ed paced on its own
   thread (late ticks and load printed, no bar); 7a and 7b hold each
   sampled listener's recording to audio_diff > 0.85 against its
   talker's speech as sent (the talker's codes on the wire; the talker's
   own AGC shapes it) and > 0.7 against its mic, and the talker's own
   recording to < 5% of a listener's energy (mix-minus); 7b, whose late
   tickers make the jitter buffers underrun or discard mid-run, holds the
   first two tick by tick along the path each listener's packets took
   (logged sequence numbers: each stretch between events at its own
   delay, the concealed ticks left out, at least half the ticks played)
   and prints each listener's line;
   7c: 8 + 8 legs
   on the CPU against the card, the listeners' recordings held to the
   bar of phase 4;
8. the secured wideband call: phase 7's clients and server with G.722 at
   16 kHz (AEC P = 8, F = 161). 8a: 1,024 + 1,024 legs over the batch
   edge with AES_CM_128_HMAC_SHA1_80 on every leg (keys from a seeded
   generator), 150 alternating do_ticks: launches per tick pair
   g722_encode 2, g722_decode 2, fused_volume 3, mdf_apply 1,
   mdf_update_fused 1, every leg >= ticks/2 packets, no authentication
   failure and no replay drop, phase 7a's listener, mix-minus and talker
   bars (the speech as sent decoded from the wire codes by the plain
   G.722 decode; from tick 40 on, after G.722's start transient), finite
   outputs and state; 8b: 64 + 64 legs over
   LoopbackPair with per-leg SRTP keyed by SDES, RTCP every 0.5 s, a
   quality indicator and a bitrate controller on every leg, alternating
   do_ticks with iterate() every 10 ticks for >= 3 s: every leg saw a
   remote report and has an RTT, every quality indicator >= 4.5, one leg
   given a wrong receive key receives nothing, the listener bars; 8c: 8 +
   8 legs of 8b's configuration on the CPU against the card, the bar of
   phase 4 on the listeners' recordings over 60 ticks;
9. the gateway transcoder. 9a: file_player -> X_enc -> X_dec ->
   file_recorder through a free-running Ticker at 1,024 legs x 100 ticks of
   speech for dvi4 and each G.726 rate: exactly one encode and one decode
   launch a tick and no other kernel, finite state, audio_diff of legs 0,
   37, ... against the signal above CHAIN_BARS at shift 0; 9b: four
   batches of 1,024 legs (mu-law talkers, TranscodeBatch ulaw -> g726_32,
   TranscodeBatch g726_32 -> ulaw, mu-law listeners) over a LoopbackPair
   per leg and hop, 150 rounds of do_tick in turn: launches a round
   g726_encode 1, g726_decode 1, fused_volume 4, the sampled listeners'
   recordings above 0.85 against the speech sent from round 40 on (the
   G.726 decoders play a transient on the jitter buffers' empty first
   ticks), every listener at least half of its packets, finite state; 9c:
   8 legs of 9b's gateway with Baudot on talkers and listeners, every
   talker typing "SOS 911", on the CPU against the card: the listeners'
   recordings to phase 4's audio_diff and energy bars and an rms error of
   2e-2 (the two G.726 codings differ by the codec's quantisation noise:
   CROSS_GATEWAY_RMS), and the text read exactly on both;
10. captured and recorded calls. 10a: 1,024 captures of 3 s of speech at
   16 kHz, G.722-encoded on the card (one g722_encode launch a tick),
   packed as RTP and written a pcap a leg (``io/pcap.write_pcap``), a
   seeded quarter of them with 2% of packets missing and 3 packets
   250-400 ms late; read back by ``PcapRtpPlayer`` and sent at their
   capture times over localhost UDP into a 1,024-leg recvonly G.722
   ``AudioStreamBatch(record_ticks=300)`` on the batch edge for 300
   ticks: launches g722_encode 1 a tick building the captures (a run of
   its own), then in the replay g722_encode 1 a tick (the stream's
   silent send path), g722_decode 1, fused_volume 2 (vol_recv and
   vol_send), finite outputs and state, every leg at least half of its
   capture's packets, every clean leg's recording above 0.85 audio_diff
   against its speech as encoded from tick 40 on (the lossy legs'
   received, lost, late and concealed counts printed); 10b: the
   recordings of legs 0, 37, ... as WAV, SMFF (pcm16) and MKV (A_PCM,
   A_MS/ACM mu-law), each played to EOF by ``MediaPlayer`` on the card
   equal to the file's content to the bit with one EOF event, those of
   legs 0 and 37 (every container and decode branch) through the 48 kHz
   resampler within 1e-5 of the CPU, pause / seek /
   loop on the paced player, ``MediaRecorder`` on the card for 200 ticks
   into .wav and .smff read back equal to its input, and .mkv: an Opus
   round trip above OPUS_RECORDER_BAR where the machine has libopus, else
   a RuntimeError naming libopus and no file; 10c: 8 captures built as
   10a's at 60 ticks (so that the lossy legs' lost and late packets fall
   inside the run: each lossy leg must count both, on both sides)
   replayed on the CPU and on the card, the recordings held to the bar of
   phase 4;
11. negotiated calls (``models/call_setup.CallSetup``; the soft
   RLIMIT_NOFILE raised to the hard one first, failing where that cannot
   hold the sockets). 11a: 1,024 calls, each a pair of CallSetups over
   localhost UDP (client controlling, server controlled, every socket its
   own receive buffer), calls 0-511 keyed by DTLS-SRTP (each side's
   a=fingerprint from the other's ``local_fingerprint()``), 512-1,023 by
   ZRTP; each client offers ``local_capabilities()`` with G722 first, each
   server answers with ``negotiate``; every pending call's ``iterate()``s
   driven round-robin with no sleep until every call is ready, within 60 s
   (the seconds and rounds to ICE completion and to the end, calls a
   second, the round times, the ICE checks sent and retransmitted and what
   the demux sorted printed; a call that stalls printed by its index and
   state). Bars: every answer leads with G722/8000 PT 9, every call ready
   with a nominated selected pair on both sides, the client's keys the
   mirror of its server's, one suite on both (a DTLS-SRTP profile's, or
   AES_CM_128_HMAC_SHA1_80 for ZRTP), equal SAS on every ZRTP call. Then
   phase 8a's session at 1,024 + 1,024 legs on those keys and suites,
   installed per leg and direction through the batch edge's own
   ``set_srtp`` (the edges own their sockets, so this media does not ride
   the nominated ones), 150 tick pairs, with 8a's bars; then 8 DTLS calls
   with a wrong expected fingerprint on one side, which must end with
   security_failed, no keys and ``media_transport()`` raising. 11b: 16 + 16
   legs of 8b's configuration whose transports are their calls'
   ``media_transport()`` (8 DTLS-SRTP, 8 ZRTP, the last by trickle ICE),
   every CallSetup iterated after every round: 8b's listener bars from
   tick 40 on, every leg a remote report and an RTT, no SRTP authentication
   failure, and no packet but RTP or RTCP handed to a jitter buffer (the
   demux's counts printed). Phase 11's seconds are printed;
12. the video call (``models/video_stream.VideoStreamBatch``; its pixel
   path is PyTorch ops, so no hand kernel launches: the kernels' line
   counts 0 for it). 12a: 1,024 legs, a 640x480 mire (leg i from frame i)
   sent at 320x240 (``size_conv``, antialiased as ``jax.image.resize``), no
   sessions, 100 unpaced do_ticks with each tick's rx block the previous
   tx block, frames crossing the boundary as u8 through the ticker's
   pinned slots: ms/tick and host phases, the device split of a tick
   (upload, step, readback by CUDA events over 20 ticks run back to back),
   the hand kernels' launches a tick (0), device bytes a tick
   (``video_tick_bytes``) and peak memory printed; bars: legs 0, 37, ... of
   the tx frames within one u8 code of the port on the CPU at ticks 0, 25,
   50, 75, 99 (the share of pixels that differ printed), every leg's
   ``frame_mean`` event within 1e-4 of numpy's mean of its rx luma. 12b:
   ``VideoE2EBench``, 4 legs of the dummy codec at 320x240 and 15 fps,
   each self-looped over localhost UDP, 1 s + 3 s paced: at the 10 ms tick
   (printed, no bar: 84 packets a frame a leg through per-leg Python
   outrun the tick on the card's host) and at a tick a frame with two
   ticks in flight, the RTP I/O on the ticker's publish worker (the JAX
   package's bench.py runs the bench so), whose bar is ``passes()`` (late
   ticks <= ticks / 50, every leg >= 90% of 15 fps, luma carries the
   mire); then its ``run_loss_recovery()`` must see FIR,
   keyframe and decoding after a burst; VideoStreamBatch(codec="vp8",
   "h264", "av1") must raise naming libvpx, libavcodec and libaom where
   phase 1 found no library, and be made where it found one. 12c: 4 + 4
   legs of 12a's shape over LoopbackPair, 60 tick pairs on the CPU and on
   the card: equal frames received, received frames within one u8 code,
   frame_mean within 1/255. Phase 12's seconds are printed;
13. the SFU and the call's side channels (``net/router``, ``net/fec``,
   ``net/rtt``, ``net/upnp``, ``native.NativeIoPump``). 13a: 1,024
   participants in 128 conferences of 8, an ``AudioPacketRouter(top_n=3)``
   each; every microphone carries room noise at -45 dBFS, members 0, 1, 2
   of each conference speak at -12, -15 and -18 dBFS (speech legs) and at
   tick 50 member 3 starts at -12 while member 2 stops; the senders' G.722
   is encoded on the card (one g722_encode a tick) and sent through the
   batch edge to 1,024 server ``UdpTransport``s on one ``NativeIoPump``;
   a server tick drains them through the pump, unpacks, stacks the
   payloads, runs ext_source -> g722_dec -> audio_levels -> ext_sink
   through a ``Ticker`` on the card (one g722_decode a tick) with the
   energies read back, gives them to the routers and routes every packet;
   the receivers' sockets drain through a second pump. 100 unpaced ticks.
   Bars: each member receives exactly the packets of members {0, 1, 2}
   from tick 10 to 49 and {0, 1, 3} from tick 70 on, itself left out (the
   fallen talker's smoothed level takes up to ~16 ticks to pass under a
   talker's pause: ``sfu_speakers``), and on every tick exactly the top 3
   by the energies the server read; payloads equal to the speaker's codes;
   no packet missing, undelivered or stray; the pumps' dropped and
   truncated counts 0; energies finite; launches a tick g722_encode 1,
   g722_decode 1. Printed: ms a tick split (encode and send, pump drain,
   unpack, device step with readback, route, sends, receive), the drain of
   the 1,024 server sockets through the pump against a Python ``recv``
   loop, and ``profile_nodes`` of the server graph. 13b: 8b's
   configuration (no wrong key) over two localhost ``UdpTransport``s a
   leg, with Python receive, then on one ``NativeIoPump``: 8b's bars both
   times, ms per tick pair both ways. 13c: 8 members of a
   ``VideoPacketRouter``, synthetic H.264 at 15 fps (an IDR every 30
   frames) packetized by ``net/h26x``, the focus moved every 2 s by 13a's
   first conference's ranks; each output FlexFEC-protected (2d, L = D = 5)
   through ``netsim`` with 5% random loss: switches only on an IDR's first
   packet, one key-frame request per focus change, contiguous output
   sequence numbers, recovered packets equal to the originals; loss before
   and after FEC printed. 13d: 64 ``TextStream`` pairs over
   ``SrtpTransport``, 600 characters each: every 7th packet lost reads
   exact, a burst of 3 reads one U+FFFD where the redundancy ran out;
   ``UpnpIgdClient`` discovers an in-process fake gateway (SSDP by unicast,
   then its description), reads the external address, adds a mapping,
   finds it in the gateway's table and deletes it. 13e: one conference of 8
   through 13a's path for 60 ticks on the CPU and on the card: energies
   within 1e-5 relative, routed sources equal on every tick. Phase 13's
   seconds are printed;
14. the mixed fleet, the host-codec legs and the device layer
   (``models/mixed_fleet``, ``E2EStepper``, ``core/quirks``,
   ``core/devices``). 14a: ``MixedFleetBench`` at its defaults, 1,024
   flagship and 256 SRTP e2e legs (PALLAS_MDF=1), 32 Opus legs where phase
   1 found libopus and 2 VP8 streams where it found libvpx, 8 s in one
   paced loop (``mode="loop"``): printed, each member's legs, ms/tick, late
   ticks, loss, fidelity and authentication failures, the loop's trace
   (each member's mean and max ms a tick, the sleep share, the first
   stalls), ``passes()`` and the launches; bars: no member error,
   flagship and SRTP fidelity >= 0.9 and loss < 0.02, no SRTP
   authentication failure, Opus delivery >= 0.95 where it ran, and
   fused_volume, mdf_apply and mdf_update launched once a tick of each e2e
   member (the ticks each dispatched; an Opus member's receive volume once
   a tick and once for its warm-up), mdf_update_fused never; no deadline
   is held. 14b: the same fleet in per-member threads with 14a's bars.
   14c: each of opus, gsm, speex, g729, bv16 and aac where phase 1 found
   its library as a 16 + 16 stream pair over LoopbackPair, the listeners
   above the JAX package's bar for that codec (``HOST_CODEC_BARS``), and
   where it did not, ``AudioStreamBatch(codec=...)`` raising RuntimeError
   naming the library before any graph is built; local_capabilities()
   offers mpeg4-generic iff aac_available(). 14d: phase 7a at its width
   with the clients built through the quirk DB ("generic", "usb headset":
   mic EQ, a 120 ms EC delay line ahead of the AEC's far pin, AEC, AGC)
   plus a speaker EQ, capturing from and playing to a ``FileSndCard``
   whose gains are set through the stream (the listeners' mics muted):
   7a's launches and bars, the graph holding mic_eq, ec_delay, ec and
   spk_eq, and the card's played blocks equal to the stream's spk output
   times the output gain, bit for bit; ms per tick pair beside 7a's. 14e:
   14d at 4 + 4 legs over LoopbackPair on the CPU against the card, the
   bar of phase 4 on the listeners' recordings. 14f: ALSA, Pulse, V4L2,
   screenshare and the QR reader's availability and what the card
   detectors registered (an absent backend registers nothing and raises
   naming its library), and a ``MireWebCam``'s frames through its graph
   source on the card within one u8 code of the CPU's. Phase 14's seconds
   are printed;
15. leg sharding (``parallel/sharding``: one process a shard, gloo on CUDA
   tensors, since NCCL puts no two ranks on one device; ``nvidia-smi``'s
   compute mode printed; every shard process runs with no cuBLAS
   workspace, as ``spawn_shards`` sets it). 15a: phase 3's flagship
   (4,096 legs x 100 ticks of the echo-coupled fixture) over four ranks,
   1,024 legs each, the groups of four aligned to the shards (no
   collective); 15b: the same with the segment-sum mixer and ``group_id =
   leg % 1024`` (a conference has a member on every rank: one exchange a
   tick), and the mixer alone on identical inputs, bit for bit its
   unsharded self on every rank. Both against the unsharded 4,096-leg run
   on rank 0 of the same world, bit for bit on every leg (phase 4's bar,
   the max abs error and the legs bit-equal printed); each rank's
   ms a tick (four ranks time-slice one card: not a scaling figure), the
   collective's host ms a tick and launches (fused_volume, mdf_apply,
   mdf_update_fused once a tick, nothing else). 15c:
   ``dryrun_multichip(4)`` on the card (8 legs, its four stages; every
   rank reports no JAX module loaded). 15d: 15b's graph at 1,024 legs on
   one NCCL rank, bit-equal to the unsharded run of the same batch. 15e:
   mdf_update_fused at 4,096 x 8 x 481 on rows [1024, 2048) with
   lin0 = 1024 * 8 * 481, bit-equal to those rows of the full call and to
   its plain twin (with lin0 = 0 it differs); and the bf16 taps of every
   shard after 15a's and 15b's 100 ticks against the unsharded run's rows
   (legs bit-equal and the most bf16 steps apart printed);
16. the programs around the package, each run in this process through its
   entry (the CLI's ``main(argv)``, an example's ``run`` or ``main``), so
   that its launches are counted (``phase16``). 16a: ``examples/
   conference_server`` at 1,024 legs in groups of 4 for 4 s paced on a
   thread, against phase 7a's 1,024 AEC + AGC clients on one batch edge at
   its ``--client`` address, following its ticks for 340 ticks:
   the server's ms a tick, late ticks and edge stats printed; bars from
   tick 40: listeners above 0.85 against the speech sent, mix-minus (a
   talker's own leg under 5% of its listeners' energy), the launches of
   each side, counted apart; then the same server once more as ``python
   -m`` from a fresh interpreter against the same clients, which follow
   its replies: it exits 0 and the same bars hold. 16b: ``mediastream
   bench --legs 1024 --seconds 2`` (its line and tx load). 16c: two
   ``mediastream call`` processes a pair (``python -m`` in fresh
   interpreters) over localhost UDP for 5 s, one pair with ``--ec --agc``
   and one with ``--srtp-key``, one pair after the other, both sides of a
   pair released together from their ``call leg up`` line: each side's
   recording of the other's speech above 0.8; then one ``call --ec --agc`` leg in this
   process, counted: which AEC update kernel B = 1 launches. 16d:
   ``examples/transcode_gateway`` at 1,024 legs for 2 s paced (2,048
   sockets; RLIMIT_NOFILE raised as in phase 11): mu-law speech sent to
   ``in_port + 2n`` a tick ahead of the gateway, G.722 received on
   ``out + 2n`` through a pump, decoded and held from tick 40 above 0.85
   against the speech sent; g722_encode once a tick. 16e:
   ``examples/ivr_server`` at 16 legs and ``examples/secure_call`` with
   DTLS-SRTP and ZRTP, each exit 0 by its own check. 16f: ``mediastream``
   tones, audiocmp, mtu, ring, echo, play, record (.wav, .smff), pcap-play
   (a seeded capture with a reordered and a missing packet), mkvstream
   (VP8 and H.264 of fixed bytes, parsed back) and ``record x.mkv``, which
   raises naming libopus where the machine has none. 16g: the IVR at 8
   legs and ``tones`` on the CPU against the card (same digits, callers'
   recordings >= 0.999, tones' rms <= 1e-6).

Each phase prints the seconds elapsed when it ends. The last two lines of
standard output are the kernels' JSON and the result's JSON; the card's
name and power limit come before them.
"""
import ast
import contextlib
import ctypes.util
import io
import json
import math
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "mediastreamer2_tpu_torch/csrc/ms2_kernels.cu"
G722_SOURCE = "mediastreamer2_tpu_torch/csrc/g722_kernels.cu"
ADPCM_SOURCE = "mediastreamer2_tpu_torch/csrc/adpcm_kernels.cu"
REPLACES = {  # the TPU kernel (or lax.scan) each CUDA kernel replaces
    "fused_volume": "mediastreamer2_tpu/ops/pallas_kernels.py:56",
    "mdf_apply": "mediastreamer2_tpu/ops/pallas_kernels.py:133",
    "mdf_update": "mediastreamer2_tpu/ops/pallas_kernels.py:178",
    "mdf_update_fused": "mediastreamer2_tpu/ops/pallas_kernels.py:278",
    "g722_encode": "mediastreamer2_tpu/ops/g722.py:213",
    "g722_decode": "mediastreamer2_tpu/ops/g722.py:221",
    "dvi4_encode": "mediastreamer2_tpu/ops/adpcm.py:78",
    "dvi4_decode": "mediastreamer2_tpu/ops/adpcm.py:84",
    "g726_encode": "mediastreamer2_tpu/ops/g726.py:172",
    "g726_decode": "mediastreamer2_tpu/ops/g726.py:180",
}
SOURCES = {"g722": G722_SOURCE, "dvi4": ADPCM_SOURCE, "g726": ADPCM_SOURCE}   # by name prefix
# the echo canceller's kernels that replace no TPU kernel, only the port's own
# PyTorch operations: what each replaces, and its launches an echo-canceller
# tick (the DFTs' FFT path: 5 spectra to planes, 4 planes to complex-to-real
# inputs; the suppressor's gain once; the time-domain passes and decisions
# once)
EC_KERNELS = {
    "spectrum_planes": ("mediastreamer2_tpu_torch/ops/rfft.py: a cuFFT spectrum split into "
                        "(re, im) planes", 5),
    "planes_spectrum": ("mediastreamer2_tpu_torch/ops/rfft.py: (re, im) planes interleaved "
                        "into a complex-to-real input", 4),
    "suppress_gain": ("mediastreamer2_tpu_torch/ops/aec.py: the suppressor's gain", 1),
    "aec_decide": ("mediastreamer2_tpu_torch/ops/aec.py: the error signals, the two-path "
                   "decisions, the output limiter and the leak tracker", 1),
}
SYSTEM_LIBRARIES = ("opus", "gsm", "speex", "bcg729", "bv16", "avcodec", "vpx", "aom", "X11",
                    "ssl", "crypto", "asound", "pulse-simple")
# kernels whose registers phase 1 prints and whose spills fail it, by a
# fragment of the mangled name (G.726 at 40 kbit/s: the most thresholds
# and candidates a lane; aec_decide with 32 lanes a leg: its longest rows in
# registers, and rows longer than that, read chunk by chunk)
SPILL_CHECKED = {"g722_encode": "g722_encode_kernel", "g722_decode": "g722_decode_kernel",
                 "dvi4_encode": "dvi4_encode_kernel", "dvi4_decode": "dvi4_decode_kernel",
                 "g726_encode (40 kbit/s)": "g726_encode_kernelILi5E",
                 "g726_decode (40 kbit/s)": "g726_decode_kernelILi5E",
                 "aec_decide (32 lanes, float4)": "aec_decide_kernelILi32ELb1ELb0E",
                 "aec_decide (32 lanes, by sample)": "aec_decide_kernelILi32ELb0ELb0E",
                 "aec_decide (long rows, float4)": "aec_decide_kernelILi32ELb1ELb1E",
                 "aec_decide (long rows, by sample)": "aec_decide_kernelILi32ELb0ELb1E"}
LEGS = 4096
TICKS = 100
DECIDE_LONG_S = (960, 882)    # aec_decide's rows past its registers (phase 2)
FLAGSHIP_DFTS = 8             # the echo canceller's DFT calls a tick (ops/rfft.py)
CROSS_LEGS = 256
CROSS_TICKS = 100
E2E_LEGS = 1024
E2E_TICKS = 300
E2E_BIG_LEGS = 4096
E2E_BIG_TICKS = 100
SESSION_LEGS = 1024           # phase 7a: clients and server, each
SESSION_TICKS = 150
PACED_LEGS = 64               # phase 7b
PACED_TICKS = 300
PACED_PLAYED_MIN = 0.5        # 7b: share of a listener's ticks its talker's packets reach
CROSS_SESSION_LEGS = 8        # phase 7c
CROSS_SESSION_TICKS = 150
WIDE_LEGS = 1024              # phase 8a: clients and server, each
WIDE_TICKS = 150
SECURE_LEGS = 64              # phase 8b
SECURE_MIN_S = 3.0            # 8b's least wall time: several RTCP intervals
SECURE_MIN_TICKS = 150
SECURE_MAX_TICKS = 600
RTCP_INTERVAL_S = 0.5
CROSS_WIDE_LEGS = 8           # phase 8c
CROSS_WIDE_TICKS = 60
CHAIN_LEGS = 1024             # phase 9a: each codec chain
CHAIN_TICKS = 100
# 9a's audio_diff floors on legs 0, 37, 74, ...: 0.90 as the JAX package's
# fixture test holds dvi4 and g726_32 to; the two low rates from the same
# graph on the CPU, which read 0.9948 (16 kbit/s) and 0.9958 (24 kbit/s) at
# least over these legs and signals
CHAIN_BARS = {"dvi4": 0.90, "g726_16": 0.98, "g726_24": 0.98, "g726_32": 0.90, "g726_40": 0.90}
GATEWAY_LEGS = 1024           # phase 9b: each of the four batches
GATEWAY_ROUNDS = 150
GATEWAY_SETTLE = 40           # the listener bar starts here
CROSS_GATEWAY_LEGS = 8        # phase 9c
CROSS_GATEWAY_ROUNDS = 240
# 9c's bar: phase 4's audio_diff (>= 0.999) and energy gap (<= 1.5 dB), and
# an rms error of 2e-2 in place of 5e-3. The two backends' FSK differs in
# the last float32 bits (the generator's phase is a cumsum, summed in
# another order on the card), a mu-law code flips where a sample sits on a
# decision level, and from there the two G.726-32 encoders code
# near-equal signals with different codes: the listeners' recordings then
# differ by the codec's own quantisation noise (~30 dB under the 0.4 tone:
# ~1.3e-2 rms for two independent codings; 6.4e-3 was measured), with
# bursts where the tone / transition detector fires on one side only.
CROSS_GATEWAY_RMS = 2e-2
TTY_TEXT = "SOS 911"
CAPTURE_LEGS = 1024           # phase 10a: a G.722 capture a leg, replayed into one stream
CAPTURE_TICKS = 300           # 3 s of speech a capture; the stream runs as many ticks
CAPTURE_SETTLE = 40           # 10a's bar starts here (G.722's start transient, as phase 8)
CAPTURE_SSRC = 0x7000         # leg i's capture carries SSRC CAPTURE_SSRC + i
CAPTURE_LOSS = 0.02           # the lossy quarter's missing packets
CAPTURE_LATE = 3              # and its packets 250-400 ms late
REPLAY_WAIT_S = 0.05          # the longest a tick waits for the edge to take its packets
RECORDER_TICKS = 200          # phase 10b's MediaRecorder run
# 10b's Opus round trip, where the machine has libopus: the recorder's .mkv
# (write_av_mkv: 32 kbit/s, 10 ms frames) played back, held to the JAX
# package's bar for that recorder (tests/test_mkv_player.py, 0.75);
# tests/test_mkv.py's 0.8 is for a 64 kbit/s, complexity-9 encoder
OPUS_RECORDER_BAR = 0.75
CROSS_CAPTURE_LEGS = 8        # phase 10c: captures of its own, a quarter of them lossy,
CROSS_CAPTURE_TICKS = 60      # long enough to hold their late packets (sent by tick 15)
SETUP_CALLS = 1024            # phase 11a: calls set up, then media on their keys (x 2 legs)
SETUP_TICKS = 150
SETUP_DEADLINE_S = 60.0       # the longest a phase 11 setup may take
REFUSED_CALLS = 8             # 11a: DTLS calls with a wrong expected fingerprint on one side
REFUSED_DEADLINE_S = 10.0
ONE_SOCKET_LEGS = 16          # phase 11b: calls whose media rides their nominated sockets
ONE_SOCKET_MAX_TICKS = 1200   # 8b's loop at a quarter of its legs runs more rounds in SECURE_MIN_S
VIDEO_LEGS = 1024             # phase 12a: the pixel path, no sessions
VIDEO_TICKS = 100
VIDEO_CAM = (640, 480)        # VGA camera (the mire) sent at QVGA: DEFAULT_LADDER's
VIDEO_OUT = (320, 240)        # step for 170 kbit/s
VIDEO_FPS = 25.0
VIDEO_TIMED_TICKS = 20        # 12a's device split: ticks timed back to back by CUDA events
VIDEO_SAMPLE_STEP = 37        # 12a: legs 0, 37, ... held to the CPU
VIDEO_CHECK_EVERY = 25        # 12a: ticks 0, 25, ... and the last held to the CPU
VIDEO_MEAN_TOL = 1e-4         # 12a: frame_mean against numpy's mean of the rx frames
VIDEO_E2E_LEGS = 4            # phase 12b: VideoE2EBench, the dummy codec over UDP
VIDEO_E2E_SIZE = (320, 240)
VIDEO_E2E_FPS = 15.0
VIDEO_E2E_WARMUP_S = 1.0
VIDEO_E2E_SECONDS = 3.0
VIDEO_E2E_DEPTH = 2            # the bar's run: bench.py's VideoE2EBench(pipeline_depth=2, frame_tick)
VIDEO_CODECS = (("vp8", "vpx", "libvpx"), ("h264", "avcodec", "libavcodec"),
                ("av1", "aom", "libaom"))        # (codec, find_library name, what the raise names)
CROSS_VIDEO_LEGS = 4          # phase 12c: 4 + 4 legs over LoopbackPair, CPU vs card
CROSS_VIDEO_TICKS = 60
TICK_S = 0.01
P, F, S = 8, 481, 480         # the flagship's AEC at 48 kHz
SP, SF, S8 = 8, 81, 80        # the session's AEC at 8 kHz
FLEET_FLAGSHIP = 1024         # phase 14a / 14b: MixedFleetBench's defaults
FLEET_SRTP = 256
FLEET_OPUS = 32               # where phase 1 found libopus, else 0
FLEET_VIDEO = 2               # where phase 1 found libvpx, else 0
FLEET_SECONDS = 8.0
HOST_CODEC_LEGS = 16          # phase 14c: a 16 + 16 stream pair a codec
HOST_CODEC_TICKS = 150
# (codec, rate, find_library name, what the raise names)
HOST_CODEC_LIBS = (("opus", 48000, "opus", "libopus"), ("gsm", 8000, "gsm", "libgsm"),
                   ("speex", 8000, "speex", "libspeex"), ("g729", 8000, "bcg729", "libbcg729"),
                   ("bv16", 8000, "bv16", "libbv16"), ("aac", 16000, "avcodec", "libavcodec"))
# 14c's listener bars against the speech sent, the JAX package's for each
# codec: gsm tests/test_audio_stream.py (0.85), aac tests/test_aac.py (0.8),
# bv16 tests/test_aac.py (0.7), g729 tests/test_speex.py's SNR > 6 dB after
# the best gain, which is a normalized correlation above
# sqrt(10**0.6 / (1 + 10**0.6)) = 0.894; opus and speex (a number: the
# codec's own offline round trip of the signal less that much) as
# tests/test_audio_stream.py's opus ptime case (0.05) and
# tests/test_speex.py's stream case (0.07) hold them: the two codecs keep
# less of a synthetic signal than the others, by how much depends on it
HOST_CODEC_BARS = {"gsm": 0.85, "aac": 0.8, "bv16": 0.7, "g729": 0.894}
HOST_CODEC_MARGINS = {"opus": 0.05, "speex": 0.07}
QUIRK_DEVICE = ("generic", "usb headset")     # phase 14d's quirk DB entry
QUIRK_SPK_EQ = [(1000.0, 0.9, 400.0)]         # and speaker EQ (tests/test_quirks_alsa.py's)
QUIRK_GAINS = (0.8, 1.25)                     # the card's input and output gains
QUIRK_LEGS = 1024             # phase 14d: phase 7a's width
QUIRK_TICKS = 150
CROSS_QUIRK_LEGS = 4          # phase 14e
CROSS_QUIRK_TICKS = 150
MIRE_LEGS = 4                 # phase 14f: MireWebCam frames, card against CPU
MIRE_TICKS = 5
PAIR_MS = {}                  # ms per tick pair of session_edge's phases
WF, S16 = 161, 160            # the wideband call's AEC at 16 kHz
SHARD_WORLD = 4               # phase 15: four gloo ranks time-slicing one card
SHARD_LEGS = 4096             # 15a / 15b: the flagship at full width, 1,024 legs a rank
SHARD_TICKS = 100
SHARD_CONFERENCES = 1024      # 15b: group_id = leg % 1024, one member on each rank
SHARD_TIMEOUT_S = 300.0       # a collective's timeout in phase 15's worlds
NCCL_LEGS = 1024              # 15d: 15b's graph on one NCCL rank
OFFSET_ROWS = (1024, 2048)    # 15e: the slice of the 4,096-leg update held to the full call
FIXTURES = {}                 # (legs, ticks) -> phase 3's echo-coupled (mic, far), made once


def ptxas_usage(log: str, fragment: str) -> dict:
    """Registers and spill bytes of the kernel whose mangled name holds
    ``fragment``, from nvcc's ``-Xptxas -v`` output: {"registers",
    "spill_stores", "spill_loads"}; raises if the log has no such kernel."""
    usage, current = {}, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = fragment in line
        elif current and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                         line)):
            usage["spill_stores"], usage["spill_loads"] = int(m[1]), int(m[2])
        elif current and (m := re.search(r"Used (\d+) registers", line)):
            usage["registers"] = int(m[1])
            current = False
    if set(usage) != {"registers", "spill_stores", "spill_loads"}:
        raise AssertionError(f"no -Xptxas -v report of {fragment} in the build log")
    return usage


def nvidia_smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def device_ms(fn, n: int = 50) -> float:
    """Device time of one call of ``fn(i)``, without the host's wrapper
    cost: after 3 warm-up calls, the host's enqueue time for ``n`` calls is
    measured; then the stream spins (``torch.cuda._sleep``) for longer than
    that before one event pair around ``n`` calls, so the device runs them
    back to back; the pair's time over ``n``. ``i`` counts the calls, for
    callers that rotate through input sets."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2.0e9) + 1_000_000)   # >= 2x at <= 2 GHz
    a.record()
    for i in range(n):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


# -- bounds: the least time the card could take for a kernel's work -----------
# Each input byte read once, each output byte written once; operations
# over the float32 rate outside the tensor cores (none of the four has a
# matrix product). H100 SXM at 700 W: 3.35 TB/s, 67 TFLOP/s float32.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
L2_BYTES = 50e6


def fused_volume_cost(B, S):
    """(bytes, operations): x read, y written ([B, S] f32), four [B] f32
    in, energy and mean out; ~10 operations a sample."""
    return 4 * B * S * 2 + 4 * B * (4 + 2), 10 * B * S


def mdf_apply_cost(B, P, F, ws_bytes):
    """Wm (bf16) and Ws read over P partitions; the history Xh (bf16)
    shifted in place: partitions 0..P-2 read (the last one drops out, the
    new block takes partition 0), all P written; the new block Xr/Xi in and
    Ym/Ys out ([B, F] f32); two complex multiply-adds per (leg, partition,
    bin) and filter."""
    return (B * F * (P * (2 * 2 + 2 * ws_bytes) + (P - 1) * 2 * 2 + P * 2 * 2)
            + 4 * B * F * (2 + 4),
            16 * B * P * F)


def mdf_update_cost(B, P, F):
    """Ws (f32) and Wm (bf16) read and written, Xh read; Er, Ei,
    inv_norm, gc_r, gc_i in ([B, F] f32); mu, promote, reseed ([B] f32)
    and cpos in."""
    return (B * P * F * (2 * 4 * 2 + 2 * 2 * 2 + 2 * 2) + 4 * B * F * 5 + 4 * B * 3 + 4,
            28 * B * P * F)


def mdf_update_fused_cost(B, P, F, ws_bytes, wm_read_legs=0, wm_write_legs=0,
                          update_legs=None):
    """(bytes, operations) that the data of the call needs: Ws written on
    every leg; Ws and Xh read, and the five [B, F] f32 operands (Er, Ei,
    inv_norm, gc_r, gc_i), only on the ``update_legs`` that compute the
    update (all ``B`` by default, the ordinary mix); Wm read on the legs
    that reseed (and are not hard-reset) and written on the legs promoted;
    the [B] flags, mu, cpos and srk in. ``update_mix`` counts the legs of
    each kind from the flags. ~40 operations an updated element."""
    upd = B if update_legs is None else update_legs
    return (B * P * F * 2 * ws_bytes + upd * (P * F * (2 * ws_bytes + 2 * 2) + 4 * F * 5)
            + P * F * 2 * 2 * (wm_read_legs + wm_write_legs) + B * (4 + 3) + 4 + 8,
            40 * upd * P * F)


def planes_cost(B, F):
    """spectrum_planes or planes_spectrum: a [B, F] complex64 spectrum read
    and two [B, F] f32 planes written, or the other way; one or two
    operations an element."""
    return 16 * B * F, 2 * B * F


def suppress_gain_cost(B, F):
    """Four [B, F] f32 planes (the error's and the echo estimate's) and
    leak [B] in, two planes out; ~20 operations a bin."""
    return 4 * B * (6 * F + 1), 20 * B * F


def aec_decide_cost(B, S, suppress=True):
    """near, y_m and y_s read, e_s, e and (with the suppressor) y written
    ([B, S] f32); the eight [B] state rows and enabled in, the rows and
    three flags out; ~25 operations a sample."""
    return 4 * B * S * (3 + (3 if suppress else 2)) + B * (8 * 4 + 1 + 8 * 4 + 3), 25 * B * S


def update_mix(promote, reseed, hard_reset, bf16_shadow=True):
    """(update legs, Wm-read legs, Wm-write legs) of mdf_update_fused's
    flags ([B] bool tensors): in the bf16 mode a leg that reseeds or
    hard-resets needs no update (Ws' is Wm or +0); in the f32 mode a
    promoted leg needs it all the same (Wm' = rne(up)). Wm is read where a
    leg reseeds and is not hard-reset, written where it is promoted."""
    quiet = reseed | hard_reset
    update = ~quiet if bf16_shadow else (~quiet | promote)
    return (int(update.sum()), int((reseed & ~hard_reset).sum()), int(promote.sum()))


# G.722: a leg's 80 code slots run one after another, whatever the
# mapping (csrc/g722_kernels.cu gives a leg 16 lanes of a warp): each
# slot's predictor needs the previous slot's. The least time is then the
# slots' chain of dependent integer operations, counted from the work and
# not from the mapping, so that the share stays comparable across designs
# (hand-counted: the longest path through one slot, each add, shift,
# compare, select, multiply or table load one step, sums as binary trees):
# encode 42 (the lower band: the quantizer needs the prediction s, el ->
# wd -> 29 thresholds summed -> ilow -> dlow -> block 4 -> s), decode 27
# (the codes arrive from the wire, so the chain runs det -> dlowt -> block
# 4 -> s). Each step waits for its operand: at least 4 cycles of a
# dependent integer operation, at the H100's 1.98 GHz boost clock.
G722_SLOTS = 80
G722_CHAIN_OPS = {"g722_encode": 42, "g722_decode": 27}
G722_STATE_INTS = 80          # two bands of 28 int32, the 24-sample QMF line
DEP_OP_CYCLES = 4
SM_CLOCK_HZ = 1.98e9


def g722_cost(B, name):
    """(bytes, dependent operations of one leg's serial chain): pcm [B, 160]
    and codes [B, 80] int32, one in and one out, and the codec state read
    and written; the chain is 80 slots of G722_CHAIN_OPS."""
    return (B * (4 * 2 * G722_SLOTS + 4 * G722_SLOTS + 2 * 4 * G722_STATE_INTS),
            G722_SLOTS * G722_CHAIN_OPS[name])


def chain_bound(nbytes, cycles):
    """(bound ms, what bounds it, bytes bound ms, chain bound ms): a serial
    chain of ``cycles`` at 1.98 GHz against the bytes over 3.35 TB/s."""
    t_bytes, t_chain = nbytes / HBM_BYTES_PER_S, cycles / SM_CLOCK_HZ
    return (1e3 * max(t_bytes, t_chain), "bytes" if t_bytes >= t_chain else "operations",
            1e3 * t_bytes, 1e3 * t_chain)


def g722_bound(cost):
    """``chain_bound`` of a (bytes, dependent operations) pair, each
    operation DEP_OP_CYCLES."""
    return chain_bound(cost[0], cost[1] * DEP_OP_CYCLES)


# DVI4 and G.726 (csrc/adpcm_kernels.cu): a leg's samples run one after
# another, as G.722's (the lanes of a warp share the leg's work, not its
# chain), except in dvi4_decode, below. The chains, hand-counted from the
# kernels as the longest loop from one sample's state to the next's, each
# add, multiply, compare, select, min, max or table load one step of
# DEP_OP_CYCLES, sums as binary trees:
# - dvi4_encode 13: pred -> diff -> |diff| -> three rounds against step,
#   step/2, step/4 (a compare, then the select of the subtracted rest, which
#   runs beside it; the last round's compare only: 5) -> the last round's
#   step/4 selected and added to vpdiff (2) -> pred +- vpdiff, both beside
#   each other, and the sign's select (2) -> clamp (2); the next step is
#   selected from five read ahead, beside it (a 9-step loop);
#   dvi4_decode 4: the codes come from the wire, so only index -> step load
#   -> add -> clamp (and pred -> +- -> clamp beside it) carries;
# - g726_encode 37 steps plus the threshold count's (1 compare and a tree
#   over 1, 3, 7 or 15 thresholds: 1, 3, 4, 5), one log2f and one exp2f:
#   se -> d -> |d| -> log2f -> dln -> count -> code -> mag -> dqln load ->
#   dql -> exp2f -> dq -> p0 -> sign -> a2's update and clamp -> a1's
#   clamp against a2 -> a1*sr1 -> se;
# - g726_decode 16 steps and one exp2f: the codes come from the wire, so
#   the loop is y -> dql -> exp2f -> dq -> |dq| > threshold (the
#   transition detector) -> ap -> al -> y.
# log2f and exp2f are the accurate library functions: assumed 26 cycles
# each on the chain (an operand-range step, the MUFU.LG2 / MUFU.EX2 special
# function at ~18 cycles, a rescale step). G.726 has no true division:
# every divisor is a power of two, which compiles to a multiply.
DVI4_CHAIN_OPS = {"dvi4_encode": 13, "dvi4_decode": 4}
G726_RATES = {2: 16, 3: 24, 4: 32, 5: 40}         # bits a sample -> kbit/s
G726_ENCODE_OPS = {2: 38, 3: 40, 4: 41, 5: 42}
G726_DECODE_OPS = 16
SPECIAL_FN_CYCLES = 26
DVI4_STATE_INTS = 2
G726_STATE_FLOATS = 24
# dvi4_decode need not run the serial recurrence: both its carries are
# clamped sums, which compose, so a tick of S samples decodes as two scans
# of ceil(log2 S) levels. Its least time is the shorter of the serial chain
# and that scan depth, the steps hand-counted from the kernel as above: a
# level is 5 (the shuffle, the add and the clamp's max and min, the select
# of the lanes below the offset); the index-table load (1) before the index
# scan; between the scans a sample's index applied (3), shuffled up (1) and
# selected on lane 0 (1), the step load (1), vpdiff (4: a shift, a select,
# two adds) and its sign (1); the pred scan's apply (3) after it: 14. The
# kernel's layout is longer: it scans chunks of DVI4_DECODE_LANES samples
# (a leg a warp) one after another, chunk 0's index scan before the loop,
# then a chunk's 14 steps, the carry's shuffle (1) and its pred scan, the
# next chunk's index scan beside that one, off the chain.
DVI4_DECODE_LANES = 32
SCAN_LEVEL_OPS = 5
DVI4_SAMPLE_OPS = 14
DVI4_CHUNK_OPS = DVI4_SAMPLE_OPS + 1


def adpcm_cost(B, S, name, bits=None):
    """(bytes, cycles of one leg's serial chain) of a DVI4 or G.726 kernel:
    samples [B, S] and codes [B, S], 4 bytes each, one in and one out, and
    the codec state read and written; the chain is S samples of the counts
    above."""
    if name in DVI4_CHAIN_OPS:
        words, cycles = DVI4_STATE_INTS, DVI4_CHAIN_OPS[name] * DEP_OP_CYCLES
    elif name == "g726_encode":
        words = G726_STATE_FLOATS
        cycles = G726_ENCODE_OPS[bits] * DEP_OP_CYCLES + 2 * SPECIAL_FN_CYCLES
    else:
        words, cycles = G726_STATE_FLOATS, G726_DECODE_OPS * DEP_OP_CYCLES + SPECIAL_FN_CYCLES
    return B * (2 * 4 * S + 2 * 4 * words), S * cycles


def dvi4_scan_cycles(S, lanes=None):
    """Cycles of dvi4_decode's scan depth on S samples a leg (the counts
    above). With no ``lanes``, the function's least: one scan over all S
    samples, the table load, two scans of ceil(log2 S) levels and
    DVI4_SAMPLE_OPS steps. With ``lanes``, the kernel's layout: chunk 0's
    index scan, then ceil(S / lanes) chunks of DVI4_CHUNK_OPS steps and a
    scan of log2(lanes) levels."""
    if S == 0:
        return 0
    if lanes is None:
        levels = (S - 1).bit_length()
        return DEP_OP_CYCLES * (1 + 2 * SCAN_LEVEL_OPS * levels + DVI4_SAMPLE_OPS)
    scan = SCAN_LEVEL_OPS * int(math.log2(lanes))
    return DEP_OP_CYCLES * (1 + scan + math.ceil(S / lanes) * (DVI4_CHUNK_OPS + scan))


def adpcm_bound(B, S, name, bits=None):
    """The bound of a DVI4 or G.726 kernel: ``chain_bound``'s (bound ms,
    what bounds it, bytes bound ms, depth bound ms) and the depth's kind,
    "serial chain" or (dvi4_decode, where it is shorter) "scan depth"."""
    nbytes, cycles = adpcm_cost(B, S, name, bits)
    depth = "serial chain"
    if name == "dvi4_decode" and dvi4_scan_cycles(S) < cycles:
        cycles, depth = dvi4_scan_cycles(S), "scan depth"
    return (*chain_bound(nbytes, cycles), depth)


def bound(cost):
    """(bound ms, what bounds it) of a (bytes, operations) pair."""
    nbytes, ops = cost
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rotation(nbytes) -> int:
    """Input sets to cycle through so that back-to-back launches read
    device memory and not the 50 MB L2 (a real tick runs other work
    between two launches): enough sets for 2.5x the L2."""
    return max(1, min(64, math.ceil(2.5 * L2_BYTES / nbytes)))


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _require_equal(name, got, want):
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs err {_max_err(got, want)})")


def _timed(entry, cost, make_args, kernel_fn, plain_fn):
    """Device times of the kernel and its plain version on ``rotation``
    fresh input sets from ``make_args()``, beside the bound."""
    sets = [make_args() for _ in range(rotation(cost[0]))]
    entry["ms"] = device_ms(lambda i: kernel_fn(*sets[i % len(sets)]))
    entry["plain_ms"] = device_ms(lambda i: plain_fn(*sets[i % len(sets)]), n=10)
    entry["bound_ms"], entry["bound_by"] = bound(cost)
    entry["bytes"] = cost[0]
    return entry


def _slices_equal(name, fn, args, parts=4, row_kwargs=None):
    """``fn`` on the whole batch against ``fn`` on ``parts`` row slices of
    it, each a view of a second copy of ``args`` (a kernel that works in
    place works on the views): every output and every argument after the
    calls, bit for bit. A leg's result may not depend on the batch around
    it, as a shard's rows must equal the whole batch's (phase 15).
    ``row_kwargs(lo)``: the keyword arguments of a call on the rows from
    ``lo`` on (mdf_update_fused's ``lin0``), the whole batch's at 0."""
    whole = [a.clone() for a in args]
    cut = [a.clone() for a in args]
    kw = row_kwargs or (lambda lo: {})
    got = fn(*whole, **kw(0))
    B = args[0].shape[0]
    edges = [B * k // parts for k in range(parts + 1)]
    outs = [fn(*[a[lo:hi] for a in cut], **kw(lo)) for lo, hi in zip(edges, edges[1:])]
    for i, g in enumerate(got):
        _require_equal(f"{name} output {i}, whole batch against {parts} row slices",
                       torch.cat([o[i] for o in outs]), g)
    for i, (a, w) in enumerate(zip(cut, whole)):
        _require_equal(f"{name} argument {i}, whole batch against {parts} row slices", a, w)


def volume_args(rnd, B, S):
    """fused_volume's inputs: x [B, S] f32, the gains at the tick's two
    ends, the DC estimate and its enable flag (half the legs) [B]."""
    return (rnd(B, S, s=0.5), rnd(B).abs() + 0.1, rnd(B).abs() + 0.1, rnd(B, s=0.05),
            (rnd(B) > 0).float())


def apply_args(rnd, B, P, F, sdt):
    """mdf_apply's inputs: Wm (bf16), Ws (``sdt``) and the history Xh
    (bf16) [B, P, F], the new block (Xr, Xi) [B, F] f32."""
    return ([rnd(B, P, F, s=0.1).to(torch.bfloat16) for _ in range(2)]
            + [rnd(B, P, F, s=0.1).to(sdt) for _ in range(2)]
            + [rnd(B, P, F).to(torch.bfloat16) for _ in range(2)]
            + [rnd(B, F) for _ in range(2)])


def check_volume(kernels, name, args):
    """fused_volume against its plain version (its sums run in another
    order: rtol 1e-5, atol 1e-6) and against itself on row slices; returns
    the largest absolute error."""
    err = 0.0
    for a, b in zip(kernels.fused_volume(*args), kernels.fused_volume_reference(*args)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        err = max(err, _max_err(a, b))
    _slices_equal(name, kernels.fused_volume, args)
    return err


def check_apply(kernels, name, args):
    """mdf_apply against its plain version, bit for bit (no FMA
    contraction): the four sums and the shifted history; then against
    itself on row slices."""
    a_k = [t.clone() for t in args]
    a_p = [t.clone() for t in args]
    got = kernels.mdf_apply(*a_k)
    want = kernels.mdf_apply_reference(*a_p)
    for i, (a, b) in enumerate(zip(got + tuple(a_k[4:6]), want + tuple(a_p[4:6]))):
        _require_equal(f"{name} output {i}", a, b)
    _slices_equal(name, kernels.mdf_apply, args)


UPDATE_MIXES = ("ordinary", "30% mix")
UNALIGNED_UPDATE = (16, 8, 81)  # mdf_update_fused on planes one element off 16-byte alignment


def update_flags(rnd, B, mix):
    """mdf_update_fused's promote, reseed and hard_reset ([B] bool): none
    set (``ordinary``, a real tick's: nearly every leg an ordinary
    update); ``30% mix``: each on 30% of the legs (a normal draw under
    -0.5244), a hard-reset leg never promoted; ``every kind``: leg b takes
    the bits of b % 8 (hard reset 1, reseed 2, promote 4), so that a leg
    that updates (rounds by its index) sits in every quarter of 16 legs,
    and in the last of RAGGED_APPLY's 5."""
    dev = rnd(1).device
    if mix == "ordinary":
        return [torch.zeros(B, dtype=torch.bool, device=dev) for _ in range(3)]
    if mix == "every kind":
        b = torch.arange(B, device=dev) % 8
        return [(b & bit) > 0 for bit in (4, 2, 1)]
    flags = [rnd(B) < -0.5244 for _ in range(3)]
    flags[0] &= ~flags[2]
    return flags


def update_args(rnd, B, P, F, sdt, unaligned=False):
    """mdf_update_fused's per-leg inputs but the flags: Ws (``sdt``), Wm,
    Xh (bf16) [B, P, F], the five [B, F] f32 operands and mu [B].
    ``unaligned``: the [B, P, F] planes one element past a 16-byte
    boundary (contiguous views), which the kernel takes element by
    element."""
    def plane(s, dt):
        x = rnd(B, P, F, s=s).to(torch.bfloat16).to(dt)
        if not unaligned:
            return x
        view = torch.empty(x.numel() + 1, dtype=dt, device=x.device)[1:].view(B, P, F)
        return view.copy_(x)
    return ([plane(0.1, sdt) for _ in range(2)] + [plane(0.1, torch.bfloat16) for _ in range(2)]
            + [plane(1.0, torch.bfloat16) for _ in range(2)]
            + [rnd(B, F, s=0.3), rnd(B, F, s=0.3), rnd(B, F).abs(), rnd(B, F, s=0.05),
               rnd(B, F, s=0.05), rnd(B).abs() * 0.6])


def check_update(kernels, name, cpos, args, flags, srk):
    """mdf_update_fused against its plain version, bit for bit (Ws and Wm
    after the call), then against itself on four row slices, each with its
    own ``lin0 = lo * P * F``, as a shard's rows are updated (phase 15e)."""
    a_k = [t.clone() for t in args]
    a_p = [t.clone() for t in args]
    kernels.mdf_update_fused(cpos, *a_k, *flags, srk)
    kernels.mdf_update_fused_reference(cpos, *a_p, *flags, srk)
    for label, a, b in zip(("Ws_r", "Ws_i", "Wm_r", "Wm_i"), a_k, a_p):
        _require_equal(f"{name} {label}", a, b)
    _, P, F = args[0].shape
    _slices_equal(name, lambda *rows, lin0=0: kernels.mdf_update_fused(cpos, *rows, srk,
                                                                     lin0=lin0),
                  list(args) + list(flags), row_kwargs=lambda lo: {"lin0": lo * P * F})


RAGGED_VOLUME = (5, 441)      # fused_volume rows not 16-byte aligned (44.1 kHz ticks)
RAGGED_APPLY = (5, 5, 81)     # mdf_apply planes of P * F % 8 != 0 (a 50 ms tail at 8 kHz)


def ragged_checks(kernels, card, rnd):
    """The kernels' element-by-element paths, which the shapes of the main
    paths never take: fused_volume on rows that are not 16-byte aligned,
    mdf_apply on planes that are not (both shadow types), mdf_update_fused
    on such planes and on aligned shapes at an unaligned base (both shadow
    types, every kind of leg), each against its plain version and against
    itself on row slices."""
    check_volume(kernels, "fused_volume (unaligned rows)", volume_args(rnd, *RAGGED_VOLUME))
    for sdt in (torch.bfloat16, torch.float32):
        check_apply(kernels, f"mdf_apply (unaligned planes, {sdt})",
                    apply_args(rnd, *RAGGED_APPLY, sdt))
    srk = torch.tensor(987654321, dtype=torch.int64, device=rnd(1).device)
    for (B, P, F), unaligned in ((RAGGED_APPLY, False), (UNALIGNED_UPDATE, True)):
        for sdt in (torch.bfloat16, torch.float32):
            cpos = torch.tensor(P // 2, dtype=torch.int32, device=srk.device)
            check_update(kernels, f"mdf_update_fused ({B} x {P} x {F}, unaligned base "
                         f"{unaligned}, {sdt})", cpos, update_args(rnd, B, P, F, sdt, unaligned),
                         update_flags(rnd, B, "every kind"), srk)
    print(f"kernel scalar paths: fused_volume x {list(RAGGED_VOLUME)} (rtol 1e-5, atol 1e-6), "
          f"mdf_apply {' x '.join(map(str, RAGGED_APPLY))} (bf16 and f32 Ws, bit-exact) and "
          f"mdf_update_fused {' x '.join(map(str, RAGGED_APPLY))} and "
          f"{' x '.join(map(str, UNALIGNED_UPDATE))} at an unaligned base (bf16 and f32 Ws, every "
          f"kind of leg, bit-exact, row slices with their lin0) match plain and their row slices "
          f"[{card}]", flush=True)


def ec_kernel_checks(kernels, g, B, S, F):
    """Phase 2's checks of ``EC_KERNELS`` at one set of shapes: each kernel
    against its plain version on the card, bit for bit and on four row
    slices, then timed beside its bound. The layout passes at the
    overlap-save transforms' F bins (n = 2S) and at the suppressor's
    S/2 + 1 (n = S), spectra to planes with and without the alternating
    sign, the DC and Nyquist imaginary parts far from zero; the
    suppressor's gain, on legs from loud to silent."""
    from mediastreamer2_tpu_torch.ops import aec
    dev = g.device
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    exact = lambda: {"max_abs_err": 0.0, "tolerance": "bit-exact", "row_slices": 4}
    results = {}

    def check(name, fn, plain, args):
        got, want = fn(*args), plain(*args)
        for i, (a, b) in enumerate(zip(got, want)):
            _require_equal(f"{name} output {i}", a, b)
        _slices_equal(name, fn, args)

    def spectrum(f):
        z = torch.complex(rnd(B, f), rnd(B, f))
        z[:, 0] += 3j
        z[:, -1] -= 2j
        return (z,)

    def planes(f):
        z = spectrum(f)[0]
        return z.real.contiguous(), z.imag.contiguous()

    half = S // 2 + 1
    for f, n, tag in ((F, 2 * S, ""), (half, S, f" ({half} bins)")):
        for alt in (False, True):
            check(f"spectrum_planes{' alternate' if alt else ''}{tag}",
                  lambda z, alt=alt: kernels.spectrum_planes(z, alt),
                  lambda z, alt=alt: kernels.spectrum_planes_reference(z, alt), spectrum(f))
        results[f"spectrum_planes{tag}"] = _timed(
            exact(), planes_cost(B, f), lambda f=f: spectrum(f), kernels.spectrum_planes,
            kernels.spectrum_planes_reference)
        fn = lambda re, im, n=n: (kernels.planes_spectrum(re, im, n),)
        plain = lambda re, im, n=n: (kernels.planes_spectrum_reference(re, im, n),)
        check(f"planes_spectrum{tag}", fn, plain, planes(f))
        results[f"planes_spectrum{tag}"] = _timed(exact(), planes_cost(B, f),
                                                  lambda f=f: planes(f), fn, plain)

    sup = (aec.SUPPRESS_BETA, aec.SUPPRESS_FLOOR)

    def gain_args():
        scale = torch.exp(-6 * torch.rand((B, 1), generator=g, device=dev))
        er, ei, yr, yi = (scale * rnd(B, half) for _ in range(4))
        er[::7], ei[::7] = 0.0, 0.0         # silent error spectra
        return er, ei, yr, yi, torch.rand(B, generator=g, device=dev).clamp(0.01, 1.0)
    fn = lambda *a: kernels.suppress_gain(*a, *sup)
    plain = lambda *a: kernels.suppress_gain_reference(*a, *sup)
    check("suppress_gain", fn, plain, gain_args())
    results["suppress_gain"] = _timed(exact(), suppress_gain_cost(B, half), gain_args, fn, plain)

    results["aec_decide"] = _timed(
        {"max_abs_err": decide_checks(kernels, g, B, S),
         "tolerance": "flags, counters and e_s equal; rtol 1e-5", "row_slices": 4},
        aec_decide_cost(B, S), lambda: decide_args(g, B, S),
        lambda *a: kernels.aec_decide(*a, aec.DECIDE),
        lambda *a: kernels.aec_decide_reference(*a, aec.DECIDE))
    return results


def decide_checks(kernels, g, B, S):
    """aec_decide at [B, S] against its plain version (``check_decide``)
    over three fresh ticks with and without the suppressor, and the whole
    batch against four row slices, bit for bit. Returns the largest
    absolute difference."""
    from mediastreamer2_tpu_torch.ops import aec
    err = 0.0
    for suppress in (True, False):
        for t in range(3):
            err = max(err, check_decide(kernels, f"aec_decide [{B}, {S}] (suppress {suppress}) "
                                        f"tick {t}", decide_args(g, B, S), suppress)[0])
    _slices_equal(f"aec_decide [{B}, {S}]", lambda *a: kernels.aec_decide(*a, aec.DECIDE),
                  decide_args(g, B, S))
    return err


def decide_args(g, B, S):
    """aec_decide's inputs on the card, a kind of leg by b % 5 at a level
    drawn a leg: a converged shadow beside a half-converged main, a good
    main beside a thrown-off shadow, two filters far off, a silent leg, two
    filters alike; y_m and y_s the last halves of [B, 2S] rows (the
    overlap-save output); the state rows with counters near their
    thresholds (so that flags rise), 10% of the legs disabled."""
    from mediastreamer2_tpu_torch.ops import kernels
    dev = g.device
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    level = torch.exp(-4 * torch.rand((B, 1), generator=g, device=dev))
    kind = torch.arange(B, device=dev)[:, None] % 5
    echo = 0.2 * level * rnd(B, S)
    near = echo + 0.005 * level * rnd(B, S)
    y_m = torch.where(kind == 0, 0.5 * echo, echo + 0.01 * echo * rnd(B, S))
    y_s = torch.where(kind == 0, echo + 0.01 * echo * rnd(B, S),
                      torch.where(kind == 1, echo + 0.5 * level * rnd(B, S), y_m))
    off = torch.where(kind == 2, 3.0 * level * rnd(B, S), 0.0)
    silent = kind == 3
    rows = torch.zeros((2, B, 2 * S), device=dev)
    rows[0, :, S:] = torch.where(silent, 0.0, y_m + off)
    rows[1, :, S:] = torch.where(silent, 0.0, y_s + off)
    cnt = lambda lo, hi: torch.randint(lo, hi, (B,), generator=g, device=dev, dtype=torch.int32)
    level = level[:, 0] ** 2
    state = {"Em": 0.01 * level, "Es": torch.where(kind[:, 0] == 0, 1e-5, 0.01) * level,
             "Dn": 0.008 * level, "Nf": level,
             "leak": torch.rand(B, generator=g, device=dev).clamp(0.01, 1.0),
             "promote_cnt": cnt(6, 8), "reseed_cnt": cnt(6, 8), "diverge_cnt": cnt(14, 16)}
    return (torch.where(silent, 0.0, near), rows[0, :, S:], rows[1, :, S:],
            *(state[k] for k in kernels.DECIDE_ROWS),
            torch.rand(B, generator=g, device=dev) > 0.1)


def check_decide(kernels, name, args, suppress):
    """aec_decide against its plain version on the card: flags, counters and
    e_s (one subtraction) equal on every leg, the float rows, e and y
    within rtol 1e-5 (a leg's mean squares summed in another order than
    PyTorch's: a few ulp). Returns (the largest absolute difference, the
    plain version's outputs)."""
    from mediastreamer2_tpu_torch.ops import aec
    got = kernels.aec_decide(*args, aec.DECIDE, suppress)
    want = kernels.aec_decide_reference(*args, aec.DECIDE, suppress)
    names = ("e_s", "e", "y", *kernels.DECIDE_ROWS, "promote", "reseed", "hard_reset")
    err = 0.0
    for label, a, b in zip(names, got, want):
        if b is None or a is None:
            if (a is None) != (b is None):
                raise AssertionError(f"{name} {label}: {a} against {b}")
            continue
        if label == "e_s" or label in ("promote", "reseed", "hard_reset") or \
                not b.is_floating_point():
            _require_equal(f"{name} {label}", a, b)
            continue
        d = float((a - b).abs().max())
        lim = (1e-5 * b.abs() + 1e-7)
        if not bool(((a - b).abs() <= lim).all()):
            raise AssertionError(f"{name} {label}: kernel differs from its plain version "
                                 f"beyond rtol 1e-5 (max abs err {d})")
        err = max(err, d)
    return err, want


def kernel_checks(kernels, dev, card, B, S, P, F, full=True):
    """Phase 2 at one set of shapes: each kernel against its plain version
    on the card, timed (device time, ``device_ms``) beside its bound.
    ``full`` adds the f32-shadow modes and mdf_update (the flagship's and
    the e2e leg's); the session's path runs the bf16-shadow kernels only."""
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, s=1.0: s * torch.randn(shape, generator=g, device=dev)
    results = {}

    # fused_volume: [B, S] f32; sums run in another order (rtol 1e-5)
    err = check_volume(kernels, "fused_volume", volume_args(rnd, B, S))
    results["fused_volume"] = _timed(
        {"max_abs_err": err, "tolerance": "rtol 1e-5, atol 1e-6", "row_slices": 4},
        fused_volume_cost(B, S), lambda: volume_args(rnd, B, S),
        kernels.fused_volume, kernels.fused_volume_reference)
    if full:
        ragged_checks(kernels, card, rnd)

    # mdf_apply: [B, P, F], bit-exact (no FMA contraction); shadow taps bf16
    # (the default) and f32 (the megakernel and f32-shadow modes)
    modes = [("mdf_apply (f32 Ws)", torch.float32)] if full else []
    for name, sdt in modes + [("mdf_apply", torch.bfloat16)]:
        check_apply(kernels, name, apply_args(rnd, B, P, F, sdt))
        results[name] = _timed(
            {"max_abs_err": 0.0, "tolerance": "bit-exact", "row_slices": 4},
            mdf_apply_cost(B, P, F, torch.finfo(sdt).bits // 8),
            lambda sdt=sdt: apply_args(rnd, B, P, F, sdt),
            kernels.mdf_apply, kernels.mdf_apply_reference)

    # mdf_update_fused: bit-exact at cpos 0, 3, 7, bf16 shadow (the default)
    # and f32 shadow, on 30% of legs promoted, reseeded or hard-reset, and
    # on four row slices with their lin0; timed on the ordinary mix (no
    # flag, a real tick's: the headline) and on the 30% mix, whose quiet
    # legs read less
    srk = torch.tensor(123456789, dtype=torch.int64, device=dev)
    mixes = {mix: update_flags(rnd, B, mix) for mix in UPDATE_MIXES}
    for sdt in (torch.bfloat16, torch.float32):
        for cpos_v in (0, 3, 7):
            cpos = torch.tensor(cpos_v, dtype=torch.int32, device=dev)
            check_update(kernels, f"mdf_update_fused cpos={cpos_v} {sdt}", cpos,
                         update_args(rnd, B, P, F, sdt), mixes["30% mix"], srk)
    timed = [(torch.bfloat16, mix) for mix in UPDATE_MIXES]
    timed += [(torch.float32, "ordinary")] if full else []
    for sdt, mix in timed:
        bf16_shadow = sdt == torch.bfloat16
        name = "mdf_update_fused" + ("" if bf16_shadow else " (f32 Ws)") + (
            "" if mix == "ordinary" else f" ({mix})")
        flags = mixes[mix]
        upd, wm_read, wm_write = update_mix(*flags, bf16_shadow)
        results[name] = _timed(
            {"max_abs_err": 0.0, "tolerance": "bit-exact", "row_slices": 4, "mix": mix},
            mdf_update_fused_cost(B, P, F, torch.finfo(sdt).bits // 8, wm_read, wm_write, upd),
            lambda sdt=sdt: update_args(rnd, B, P, F, sdt),
            lambda *a, flags=flags: kernels.mdf_update_fused(cpos, *a, *flags, srk),
            lambda *a, flags=flags: kernels.mdf_update_fused_reference(cpos, *a, *flags, srk))
    if full:
        # mdf_update: f32 Ws, bf16 Wm [B, P, F], bit-exact at cpos 0, 3, 7;
        # promote and reseed 0/1 floats on 30% of legs each, never both
        hist = [rnd(B, P, F).to(torch.bfloat16) for _ in range(2)]
        spec = [rnd(B, F, s=0.3), rnd(B, F, s=0.3), rnd(B, F).abs(),
                rnd(B, F, s=0.05), rnd(B, F, s=0.05)]
        mu = rnd(B).abs() * 0.6
        flags = mixes["30% mix"]
        pr_f, rs_f = flags[0].float(), (flags[1] & ~flags[0]).float()
        for cpos_v in (0, 3, 7):
            cpos = torch.tensor(cpos_v, dtype=torch.int32, device=dev)
            ws = [rnd(B, P, F, s=0.1) for _ in range(2)]
            wm = [rnd(B, P, F, s=0.1).to(torch.bfloat16) for _ in range(2)]
            st_k = [t.clone() for t in ws + wm]
            st_p = [t.clone() for t in ws + wm]
            kernels.mdf_update(cpos, *st_k, *hist, *spec, mu, pr_f, rs_f)
            kernels.mdf_update_reference(cpos, *st_p, *hist, *spec, mu, pr_f, rs_f)
            for name, a, b in zip(("Ws_r", "Ws_i", "Wm_r", "Wm_i"), st_k, st_p):
                _require_equal(f"mdf_update {name} cpos={cpos_v}", a, b)

        def megakernel_args():
            return ([rnd(B, P, F, s=0.1) for _ in range(2)]
                    + [rnd(B, P, F, s=0.1).to(torch.bfloat16) for _ in range(4)]
                    + [t.clone() for t in spec])
        results["mdf_update"] = _timed(
            {"max_abs_err": 0.0, "tolerance": "bit-exact"}, mdf_update_cost(B, P, F),
            megakernel_args, lambda *a: kernels.mdf_update(cpos, *a, mu, pr_f, rs_f),
            lambda *a: kernels.mdf_update_reference(cpos, *a, mu, pr_f, rs_f))
    results.update(ec_kernel_checks(kernels, g, B, S, F))
    for name, r in results.items():
        sliced = (f"; whole batch = {r['row_slices']} row slices, bit for bit"
                  if "row_slices" in r else "")
        print(f"kernel {name} [B={B} S={S} P={P} F={F}]: matches plain ({r['tolerance']}, "
              f"max abs err {r['max_abs_err']}{sliced}); device {r['ms']:.4f} ms per launch, bound "
              f"{r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.1f} MB, {r['bound_by']}), "
              f"{100 * r['bound_ms'] / r['ms']:.0f}% of bound; plain {r['plain_ms']:.4f} ms "
              f"[{card}]", flush=True)
    return results


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


G722_VECTORS = "tests/data/g722_vectors.npz"   # the ITU vectors: pcm, code, dec
G722_RAGGED = ((1, 33, 1000), (1, 7, 160))    # legs x code slots a tick, 2 ticks each


def _g722_run(kernels, name, blocks, dev):
    """Ticks ``blocks`` (int32 [B, n] each) through a G.722 kernel and its
    plain version, each from a fresh state carried across the ticks: the
    outputs and every state leaf bit for bit after each tick. Returns the
    plain outputs and both final states."""
    from mediastreamer2_tpu_torch.ops.g722 import g722_state
    kfn, pfn = getattr(kernels, name), getattr(kernels, f"{name}_reference")
    B = blocks[0].shape[0]
    st_k, st_p = g722_state(B, dev), g722_state(B, dev)
    outs = []
    for t, x in enumerate(blocks):
        got, want = kfn(x, st_k)[0], pfn(x, st_p)[0]
        _require_equal(f"{name} [B={B}, {x.shape[1]}] tick {t}", got, want)
        for i, (a, b) in enumerate(zip(kernels.g722_state_leaves(st_k),
                                       kernels.g722_state_leaves(st_p))):
            _require_equal(f"{name} [B={B}, {x.shape[1]}] state leaf {i} after tick {t}", a, b)
        outs.append(want)
    return outs, st_k, st_p


def g722_checks(kernels, dev, card, B):
    """Phase 2 for G.722, each kernel bit for bit against its plain version
    on the card (outputs and every state leaf after every tick): the ITU
    vectors (3,200 samples as one tick of 1,600 slots) on one leg and on B
    legs (even legs the vectors, equal to their codes and decoded samples;
    odd legs speech), three ticks of random samples or codes and three of
    speech (decoded from the plain encoder's codes) at B legs, and ragged
    shapes (G722_RAGGED, two ticks each). Then each kernel is timed beside
    its bounds (the serial chain and the bytes)."""
    vec = np.load(os.path.join(REPO, G722_VECTORS))
    n = vec["pcm"].shape[0]
    speech = speech_fixture(B, n, seed=5)
    for legs in (1, B):
        pcm = np.where((np.arange(legs) % 2 == 0)[:, None], vec["pcm"][None], speech[:legs])
        (enc,), _, _ = _g722_run(kernels, "g722_encode",
                                 [torch.from_numpy(pcm.astype(np.int32)).to(dev)], dev)
        if not (enc[0::2].cpu() == torch.from_numpy(vec["code"].astype(np.int32))).all():
            raise AssertionError(f"g722_encode [B={legs}]: the ITU vector's codes differ")
        c = np.where((np.arange(legs) % 2 == 0)[:, None], vec["code"][None], enc.cpu().numpy())
        (pcm_out,), _, _ = _g722_run(kernels, "g722_decode",
                                     [torch.from_numpy(c.astype(np.int32)).to(dev)], dev)
        if not (pcm_out[0::2].cpu() == torch.from_numpy(vec["dec"].astype(np.int32))).all():
            raise AssertionError(f"g722_decode [B={legs}]: the ITU vector's samples differ")
    print(f"g722 ITU vectors ({n} samples, one tick of {n // 2} slots) on 1 and {B} legs: "
          f"codes and decoded samples equal to the vectors, kernels equal to plain", flush=True)

    g = torch.Generator(device=dev).manual_seed(1)
    pcm = lambda: torch.randint(-32768, 32768, (B, S16), generator=g, device=dev,  # noqa: E731
                                dtype=torch.int32)
    codes = lambda: torch.randint(0, 256, (B, G722_SLOTS), generator=g, device=dev,  # noqa: E731
                                  dtype=torch.int32)
    speech = torch.from_numpy(speech_fixture(B, S16 * 3, seed=4)).to(dev)
    speech_codes, _, _ = _g722_run(
        kernels, "g722_encode",
        [speech[:, t * S16:(t + 1) * S16].contiguous() for t in range(3)], dev)
    _g722_run(kernels, "g722_decode", speech_codes, dev)
    for legs in G722_RAGGED[0]:
        for slots in G722_RAGGED[1]:
            _g722_run(kernels, "g722_encode", [torch.randint(
                -32768, 32768, (legs, 2 * slots), generator=g, device=dev, dtype=torch.int32)
                for _ in range(2)], dev)
            _g722_run(kernels, "g722_decode", [torch.randint(
                0, 256, (legs, slots), generator=g, device=dev, dtype=torch.int32)
                for _ in range(2)], dev)
    print(f"g722 speech ({B} legs, 3 ticks) and ragged shapes (legs {G722_RAGGED[0]} x slots "
          f"{G722_RAGGED[1]}, 2 ticks): kernels equal to plain", flush=True)

    results = {}
    for name, make in (("g722_encode", pcm), ("g722_decode", codes)):
        kfn, pfn = getattr(kernels, name), getattr(kernels, f"{name}_reference")
        _, st_k, _ = _g722_run(kernels, name, [make() for _ in range(3)], dev)
        cost = g722_cost(B, name)
        sets = [(make(), _clone_tree(st_k)) for _ in range(rotation(cost[0]))]
        r = {"max_abs_err": 0.0, "tolerance": "bit-exact",
             "ms": device_ms(lambda i: kfn(*sets[i % len(sets)])),
             "plain_ms": device_ms(lambda i: pfn(*sets[i % len(sets)]), n=3), "bytes": cost[0]}
        r["bound_ms"], r["bound_by"], r["bound_bytes_ms"], r["bound_chain_ms"] = g722_bound(cost)
        results[name] = r
        print(f"kernel {name} [B={B}, 80 slots]: matches plain (bit-exact: output and every "
              f"state leaf, 3 ticks); device {r['ms']:.4f} ms per launch, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}: serial chain "
              f"{G722_SLOTS} x {G722_CHAIN_OPS[name]} ops = {r['bound_chain_ms']:.4f} ms, "
              f"bytes {r['bytes'] / 1e6:.2f} MB = {r['bound_bytes_ms']:.4f} ms), "
              f"{100 * r['bound_ms'] / r['ms']:.0f}% of bound; plain {r['plain_ms']:.4f} ms "
              f"[{card}]", flush=True)
    return results


# G.726 on the card, kernel against plain version (float32 through log2f and
# exp2f, in the same association order, no contracted multiply-add): to the
# bit. No code may differ, and neither may a decoded sample or any of the 14
# state leaves (the measurement this check prints, PERF.md §5, has found no
# difference since the kernels were written).
G726_CODES_DIFFERING_MAX = 0
G726_PCM_ATOL = 0.0
G726_STATE_RTOL = 0.0
ADPCM_CHECK_TICKS = 3
# legs x samples a tick, two ticks each, at every rate: warps partly past B
# and ticks that are not a multiple of the lanes a leg
G726_RAGGED = ((1, 33, 77, 1000), (1, 7, 80, 200))


def speech_fixture(legs, n, seed=0) -> np.ndarray:
    """int32 [legs, n] at 8 kHz: two tones and filtered noise (the fixture
    of the G.726 tests), the first tone, the level and the noise varied
    per leg."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 8000
    tone = rng.uniform(200.0, 1800.0, (legs, 1))
    level = rng.uniform(0.05, 1.5, (legs, 1))
    noise = rng.standard_normal((legs, n + 5))
    noise = sum(noise[:, k:k + n] for k in range(6)) / 6
    sig = 7000 * np.sin(2 * np.pi * tone * t) + 2500 * np.sin(2 * np.pi * 1100 * t) + 800 * noise
    return np.clip(sig * level, -32000, 32000).astype(np.int32)


def g726_compare(kernels, blocks, bits, dev):
    """Run ``blocks`` (int32 [B, S] ticks of samples) through the G.726
    kernels and their plain versions on ``dev``, the state carried. Returns
    ``measured`` = (codes that differ between the encoders, the decoders'
    largest sample difference when both are fed the plain encoder's codes,
    the largest state difference of the encoders and of the decoders, each
    leaf's over its largest magnitude), the codes' largest difference, the
    plain codes per tick, and the kernels' final encoder and decoder
    states."""
    from mediastreamer2_tpu_torch.ops.g726 import g726_state
    B = blocks[0].shape[0]

    def state_err(a, b):
        return max(float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp(min=1e-3))
                   for k in kernels.G726_KEYS)

    ek, ep, dk, dp = (g726_state(B, dev) for _ in range(4))
    differing, pcm_err, e_err, d_err, code_err, codes = 0, 0.0, 0.0, 0.0, 0.0, []
    for x in blocks:
        got = kernels.g726_encode(x, ek, bits)[0]
        want = kernels.g726_encode_reference(x, ep, bits)[0]
        differing += int((got != want).sum())
        code_err = max(code_err, _max_err(got, want))
        e_err = max(e_err, state_err(ek, ep))
        codes.append(want)
        pcm_err = max(pcm_err, _max_err(kernels.g726_decode(want, dk, bits)[0],
                                        kernels.g726_decode_reference(want, dp, bits)[0]))
        d_err = max(d_err, state_err(dk, dp))
    return (differing, pcm_err, e_err, d_err), code_err, codes, ek, dk


def g726_bar_met(differing, pcm_err, e_err, d_err) -> bool:
    return (differing <= G726_CODES_DIFFERING_MAX and pcm_err <= G726_PCM_ATOL
            and max(e_err, d_err) <= G726_STATE_RTOL)


def g726_exact(kernels, blocks, bits, dev, what):
    """``g726_compare`` of ``blocks`` at ``bits``, held to the bar."""
    measured = g726_compare(kernels, blocks, bits, dev)[0]
    if not g726_bar_met(*measured):
        raise AssertionError(f"g726 at {G726_RATES[bits]} kbit/s, {what}: codes differing, "
                             f"sample and state errors {measured}")


def g726_ragged_checks(kernels, dev):
    """Every rate on every G726_RAGGED shape, two ticks of speech each, the
    state carried: the kernels equal to their plain versions."""
    for legs in G726_RAGGED[0]:
        for n in G726_RAGGED[1]:
            x = torch.from_numpy(speech_fixture(legs, 2 * n, seed=legs + n)).to(dev)
            blocks = [x[:, :n].contiguous(), x[:, n:].contiguous()]
            for bits in G726_RATES:
                g726_exact(kernels, blocks, bits, dev, f"{legs} legs x {n} samples")


def _adpcm_row(name, label, B, bits, kfn, pfn, make_set, err, tolerance, card, what):
    """Time one DVI4 / G.726 kernel and its plain version over input sets
    that spill the L2, beside its bounds; print the row."""
    cost = adpcm_cost(B, S8, name, bits)
    sets = [make_set() for _ in range(rotation(cost[0]))]
    r = {"max_abs_err": err, "tolerance": tolerance,
         "ms": device_ms(lambda i: kfn(*sets[i % len(sets)])),
         "plain_ms": device_ms(lambda i: pfn(*sets[i % len(sets)]), n=3), "bytes": cost[0]}
    (r["bound_ms"], r["bound_by"], r["bound_bytes_ms"], r["bound_chain_ms"],
     r["bound_depth"]) = adpcm_bound(B, S8, name, bits)
    depth = f"serial chain {cost[1]} cycles"
    if r["bound_depth"] == "scan depth":
        depth = (f"scan depth {dvi4_scan_cycles(S8)} cycles (one scan over {S8} samples, "
                 f"{(S8 - 1).bit_length()} levels; the kernel's {DVI4_DECODE_LANES}-lane "
                 f"chunks {dvi4_scan_cycles(S8, DVI4_DECODE_LANES)}; {depth})")
    print(f"kernel {label} [B={B}, {S8} samples]: {what}; device {r['ms']:.4f} ms per launch, "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {depth} = "
          f"{r['bound_chain_ms']:.4f} ms, bytes {r['bytes'] / 1e6:.2f} MB = "
          f"{r['bound_bytes_ms']:.4f} ms), {100 * r['bound_ms'] / r['ms']:.0f}% of bound; plain "
          f"{r['plain_ms']:.4f} ms [{card}]", flush=True)
    return r


# DVI4's clamps: pred at -32768 and 32767, index at 0 and 88. A clamp is
# reached where the sum it clamps passes its limit.
DVI4_CLAMPS = ("pred -32768", "pred 32767", "index 0", "index 88")


def dvi4_clamp_codes(legs, n, seed=0) -> np.ndarray:
    """int32 [legs, n]: uniform random DVI4 codes 0..15. Decoded from the
    zero state, the index climbs to 88 and pred swings into both limits."""
    return np.random.default_rng(seed).integers(0, 16, (legs, n)).astype(np.int32)


def dvi4_square_fixture(legs, n) -> np.ndarray:
    """int32 [legs, n]: a full-scale square wave (32767 / -32768, a half
    period of 1 + leg % 40 samples) over the first n // 2 samples, then
    silence. Encoded from the zero state, it drives pred into both limits
    and the index to 88, and the silence brings the index down to 0."""
    half = 1 + np.arange(legs)[:, None] % 40
    t = np.arange(n)[None]
    sq = np.where((t // half) % 2 == 0, 32767, -32768)
    return np.where(t < n // 2, sq, 0).astype(np.int32)


def dvi4_clamp_hits(codes, pred, index) -> dict:
    """How many times each of DVI4_CLAMPS is reached along ``codes`` (int32
    [B, n]) decoded from the state ``pred``, ``index`` (int32 [B]): the
    decoder's path, and the encoder's that made those codes."""
    from mediastreamer2_tpu_torch.ops.adpcm import dvi4_tables
    step_tab, idx_tab = dvi4_tables("cpu")
    codes, p, ix = codes.cpu(), pred.cpu().clone(), index.cpu().clone()
    hits = dict.fromkeys(DVI4_CLAMPS, 0)
    for j in range(codes.shape[1]):
        code, step = codes[:, j], step_tab[ix]
        delta = code & 7
        vpdiff = ((step >> 3) + torch.where((delta & 4) != 0, step, 0)
                  + torch.where((delta & 2) != 0, step >> 1, 0)
                  + torch.where((delta & 1) != 0, step >> 2, 0))
        u, w = torch.where((code & 8) != 0, p - vpdiff, p + vpdiff), ix + idx_tab[delta]
        for key, reached in zip(DVI4_CLAMPS, (u < -32768, u > 32767, w < 0, w > 88)):
            hits[key] += int(reached.sum())
        p, ix = u.clamp(-32768, 32767), w.clamp(0, 88)
    return hits


def dvi4_run(kernels, name, blocks, dev, what):
    """Ticks ``blocks`` (int32 [B, n] each) through a DVI4 kernel and its
    plain version, each from the zero state carried across the ticks: the
    output, pred and index bit for bit after each tick, and a tick of no
    samples leaves the state as it was. Returns the plain outputs and the
    kernel's final (pred, index)."""
    B = blocks[0].shape[0]
    zeros = lambda: torch.zeros((B,), dtype=torch.int32, device=dev)    # noqa: E731
    kfn, pfn = getattr(kernels, name), getattr(kernels, f"{name}_reference")
    ks, ps = (zeros(), zeros()), (zeros(), zeros())
    outs = []
    for t, x in enumerate(blocks):
        before = [s.clone() for s in ks]
        got, want = kfn(x, *ks)[0], pfn(x, *ps)[0]
        _require_equal(f"{name} {what} tick {t}", got, want)
        for leaf, a, b, a0 in zip(("pred", "index"), ks, ps, before):
            _require_equal(f"{name} {what} {leaf} after tick {t}", a, b)
            if x.shape[1] == 0:
                _require_equal(f"{name} {what} {leaf} after an empty tick {t}", a, a0)
        outs.append(want)
    return outs, ks


def dvi4_checks(kernels, dev, B):
    """Phase 2 for DVI4, both kernels bit for bit against their plain
    versions (output, pred and index after every tick), each tick's
    decoder fed the plain encoder's codes: G726_RAGGED's shapes (two
    ticks of speech each), a block of 77 legs x 200 samples (one tick), 33
    legs x 80, 0 and 80 samples (an empty tick between two carried ones)
    and no legs at all (0 x 80, two ticks); then the clamp fixtures at B
    legs x 3 ticks, which must reach every clamp: a square wave then
    silence through the encoder, random codes through the decoder. Returns
    the clamps' hits."""
    def both(blocks, what):
        dvi4_run(kernels, "dvi4_decode", dvi4_run(kernels, "dvi4_encode", blocks, dev, what)[0],
                 dev, what)

    def speech(legs, n, seed):
        return torch.from_numpy(speech_fixture(legs, n, seed=seed)).to(dev)
    for legs in G726_RAGGED[0]:
        for n in G726_RAGGED[1]:
            x = speech(legs, 2 * n, legs + n)
            both([x[:, :n].contiguous(), x[:, n:].contiguous()], f"{legs} legs x {n} samples")
    both([speech(77, 200, 3)], "77 legs x 200 samples")
    x = speech(33, 2 * S8, 5)
    both([x[:, :S8].contiguous(), x[:, :0].contiguous(), x[:, S8:].contiguous()],
         f"33 legs x {S8}, 0 and {S8} samples")
    x = torch.zeros((0, S8), dtype=torch.int32, device=dev)
    both([x, x], f"0 legs x {S8} samples")
    zeros = torch.zeros((B,), dtype=torch.int32)
    square = torch.from_numpy(dvi4_square_fixture(B, 3 * S8)).to(dev)
    codes = dvi4_run(kernels, "dvi4_encode", [square[:, t * S8:(t + 1) * S8].contiguous()
                                              for t in range(3)], dev, "square wave")[0]
    rand = torch.from_numpy(dvi4_clamp_codes(B, 3 * S8, seed=7)).to(dev)
    dvi4_run(kernels, "dvi4_decode", [rand[:, t * S8:(t + 1) * S8].contiguous()
                                      for t in range(3)], dev, "random codes")
    hits = {"encoder": dvi4_clamp_hits(torch.cat(codes, dim=1), zeros, zeros),
            "decoder": dvi4_clamp_hits(rand, zeros, zeros)}
    for side, h in hits.items():
        if not all(h.values()):
            raise AssertionError(f"dvi4 {side} clamp fixture misses a clamp: {h}")
    return hits


def launch_floor(kernels, dev, card, blocks):
    """Print the device time of an empty kernel's launch, timed as the
    kernels are, on one block and on ``blocks`` blocks of one warp."""
    ms = {n: device_ms(lambda i, n=n: kernels.empty_launch(dev, n)) for n in (1, blocks)}
    print(f"launch floor: an empty kernel of csrc/adpcm_kernels.cu, {ms[1]:.4f} ms per launch "
          f"on 1 block, {ms[blocks]:.4f} ms on {blocks} blocks of 32 threads [{card}]",
          flush=True)


def adpcm_checks(kernels, dev, card, B):
    """Phase 2 for DVI4 and G.726 at B legs, ADPCM_CHECK_TICKS ticks of the
    speech fixture with the state carried, each kernel against its plain
    version on the card. DVI4: codes, samples and both state leaves bit for
    bit. G.726, per rate: the codes that differ are counted, the decoder
    (fed the plain encoder's codes) and every state leaf are held to the
    bar above. Then each is timed beside its bounds. Returns the rows:
    dvi4_encode, dvi4_decode, and g726_encode / g726_decode keyed
    ``"g726_encode@32"`` by kbit/s."""
    ticks = ADPCM_CHECK_TICKS
    pcm = torch.from_numpy(speech_fixture(B, S8 * ticks, seed=2)).to(dev)
    tick = lambda a, t: a[:, t * S8:(t + 1) * S8].contiguous()          # noqa: E731
    results = {}

    # DVI4: bit-exact
    codes, enc_state = dvi4_run(kernels, "dvi4_encode", [tick(pcm, t) for t in range(ticks)],
                                dev, "speech")
    _, dec_state = dvi4_run(kernels, "dvi4_decode", codes, dev, "speech")
    what = f"matches plain (bit-exact: output, pred and index, {ticks} ticks)"
    results["dvi4_encode"] = _adpcm_row(
        "dvi4_encode", "dvi4_encode", B, None, kernels.dvi4_encode,
        kernels.dvi4_encode_reference,
        lambda: (tick(pcm, ticks - 1), *(s.clone() for s in enc_state)), 0.0, "bit-exact",
        card, what)
    results["dvi4_decode"] = _adpcm_row(
        "dvi4_decode", "dvi4_decode", B, None, kernels.dvi4_decode,
        kernels.dvi4_decode_reference,
        lambda: (codes[-1], *(s.clone() for s in dec_state)), 0.0, "bit-exact", card, what)
    hits = dvi4_checks(kernels, dev, B)
    print(f"dvi4 ragged shapes (legs {G726_RAGGED[0]} x samples {G726_RAGGED[1]}, 2 ticks; 77 "
          f"legs x 200 samples; 33 legs x 80, 0 and 80 samples; 0 legs) and clamp fixtures "
          f"({B} legs x 3 ticks; clamps reached: square wave then silence through the encoder "
          f"{hits['encoder']}, random codes through the decoder {hits['decoder']}): kernels "
          f"equal to plain in output, pred and index", flush=True)
    launch_floor(kernels, dev, card, B)

    # G.726 at every rate on G726_RAGGED's shapes
    g726_ragged_checks(kernels, dev)
    print(f"g726 ragged shapes (legs {G726_RAGGED[0]} x samples {G726_RAGGED[1]}, 2 ticks, "
          f"every rate): kernels equal to plain in codes, samples and every state leaf",
          flush=True)

    # G.726 at each rate: measure, then hold to the bar
    for bits, kbps in G726_RATES.items():
        measured, code_err, codes, ek, dk = g726_compare(
            kernels, [tick(pcm, t) for t in range(ticks)], bits, dev)
        differing, pcm_err, e_err, d_err = measured
        total = B * S8 * ticks
        what = (f"against plain over {ticks} ticks of speech: codes differing {differing} of "
                f"{total} (bar {G726_CODES_DIFFERING_MAX}), decoded samples max abs err "
                f"{pcm_err:.3e} (bar {G726_PCM_ATOL}), state max rel err encoder {e_err:.3e} "
                f"decoder {d_err:.3e} (bar {G726_STATE_RTOL})")
        if not g726_bar_met(*measured):
            raise AssertionError(f"g726 at {kbps} kbit/s {what}")
        tol = "bit-exact: codes, samples and every state leaf"
        results[f"g726_encode@{kbps}"] = _adpcm_row(
            "g726_encode", f"g726_encode ({kbps} kbit/s)", B, bits,
            lambda x, st, bits=bits: kernels.g726_encode(x, st, bits),
            lambda x, st, bits=bits: kernels.g726_encode_reference(x, st, bits),
            lambda: (tick(pcm, ticks - 1), _clone_tree(ek)), code_err, tol,
            card, what)
        results[f"g726_decode@{kbps}"] = _adpcm_row(
            "g726_decode", f"g726_decode ({kbps} kbit/s)", B, bits,
            lambda x, st, bits=bits: kernels.g726_decode(x, st, bits),
            lambda x, st, bits=bits: kernels.g726_decode_reference(x, st, bits),
            lambda: (codes[-1], _clone_tree(dk)), pcm_err, tol, card, what)
    return results


def _device_ticks(a: np.ndarray, ticks: int, dev) -> torch.Tensor:
    """[legs, ticks*S] numpy -> [ticks, legs, S] contiguous on ``dev``."""
    legs = a.shape[0]
    return torch.from_numpy(a).to(dev).view(legs, ticks, S).permute(1, 0, 2).contiguous()


def run_flagship(legs, ticks, dev, mic, far, group_id=None):
    """Drive the flagship graph for ``ticks`` ticks (``group_id``: the
    segment-sum mixer over those conferences, as ``build_flagship``'s).
    Returns (state, output [legs, ticks*samples] on ``dev``, all-finite
    flag, host seconds per tick over ticks 1.. (the first tick, which pays
    one-time set-up, is left out))."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.models.flagship import build_flagship
    cg, params = build_flagship(Factory(), legs, dev, group_id=group_id)
    state = cg.init_state(dev)
    mic_t, far_t = _device_ticks(mic, ticks, dev), _device_ticks(far, ticks, dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    outs = []
    for t in range(ticks):
        if t == 1:
            sync()
            t0 = time.perf_counter()
        state, out, _ = cg.step(state, params, {"mic": mic_t[t], "spk_ref": far_t[t]})
        finite &= torch.isfinite(out["out"]).all()
        outs.append(out["out"])
    sync()
    per_tick = (time.perf_counter() - t0) / (ticks - 1)
    return state, torch.cat(outs, dim=1), bool(finite), per_tick


@contextlib.contextmanager
def environ(**env):
    """Set environment variables for the block, restore them after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _require_counts(path, launches, want, what="kernel launches"):
    """Every kernel's launches (or every count of ``what``) equal
    ``want``'s (0 where it names none). An echo canceller's tick launches
    mdf_apply once and each kernel of ``EC_KERNELS`` as often as that
    names: where ``want`` does not name one, it is wanted that many times
    ``want``'s mdf_apply."""
    want = {**{k: n * want.get("mdf_apply", 0) for k, (_, n) in EC_KERNELS.items()}, **want}
    want = {k: want.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{path}: {what} {launches}, expected {want}")


def run_e2e(kernels, dev, card, legs, ticks, paced, srtp=False):
    """Phase 5: the e2e bench in megakernel mode (``srtp``: every leg
    protected on the edge); returns (result, the launches of its run, the
    ticks it dispatched)."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.core.rtgc import paused_gc
    from mediastreamer2_tpu_torch.models.e2e_bench import (WARMUP_TICKS,
                                                           E2EConferenceBench)
    b = E2EConferenceBench(Factory(), legs, dev, srtp=srtp)
    try:
        b.warm()                    # first launches outside the counted run
        t0 = b._t
        kernels.reset_launch_counts()
        with paused_gc():
            res = b.run(ticks + WARMUP_TICKS, paced=paced, trace=True)
        launches = kernels.launch_counts()
        dispatched = b._t - t0
        ws_dtype = str(b.state["ec"]["Ws_r"].dtype).replace("torch.", "")
        state_finite = all(bool(torch.isfinite(v).all()) for entry in b.state.values()
                           for v in entry.values() if v.is_floating_point())
    finally:
        b.close()
    ph = " ".join(f"{k} {v:.3f}" for k, v in res.phases_ms.items() if not k.endswith("_max"))
    print(f"e2e {'paced' if paced else 'unpaced'}{' SRTP' if srtp else ''}: {legs} legs x "
          f"{res.ticks} measured ticks "
          f"({dispatched} dispatched), K=1 D=2, megakernel AEC (Ws {ws_dtype}), "
          f"{res.ms_per_tick:.3f} ms/tick, late ticks {res.late_ticks}, loss "
          f"{res.loss_rate:.5f}, fidelity {res.fidelity:.5f}, mouth-to-ear "
          f"{res.mouth_to_ear_ms:.0f} ms, edge threads {b.edge_threads}, UDP GSO {b.gso}, "
          f"out finite {res.out_finite}, state finite {state_finite}, launches {launches}, "
          f"SRTP auth failures {res.auth_failures}; "
          f"host ms/tick by phase: {ph} [{card}]", flush=True)
    want = {"fused_volume": dispatched, "mdf_apply": dispatched,
            "mdf_update": dispatched, "mdf_update_fused": 0}
    _require_counts(f"e2e {legs} legs", launches, want)
    if ws_dtype != "float32":
        raise AssertionError(f"megakernel mode needs an f32 shadow, got {ws_dtype}")
    if not (res.out_finite and state_finite):
        raise AssertionError("e2e graph output or state holds non-finite values")
    if res.auth_failures:
        raise AssertionError(f"e2e SRTP: {res.auth_failures} authentication failures")
    return res, launches, dispatched


def e2e_cross(dev, legs, ticks):
    """Phase 6: the e2e graph on the CPU and on the card, megakernel mode,
    fed the same mu-law codes. Returns (outputs cpu, outputs card, both
    finite, cpu ms/tick)."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.models.e2e_bench import (build_e2e_graph, e2e_tick,
                                                           echo_coupled_codes)
    codes, mic = echo_coupled_codes(legs, ticks, seed=9)
    outs, finite, cpu_tick = [], True, 0.0
    for d in (torch.device("cpu"), dev):
        cg, params = build_e2e_graph(Factory(), legs, d)
        state = cg.init_state(d)
        codes_d, mic_d = torch.from_numpy(codes).to(d), torch.from_numpy(mic).to(d)
        out = []
        t0 = time.perf_counter()
        for t in range(ticks):
            state, _, _, o = e2e_tick(cg, state, params, codes_d[:, t * 80:(t + 1) * 80],
                                      mic_d[:, t * S:(t + 1) * S].contiguous())
            out.append(o)
        out = torch.cat(out, dim=1).cpu()
        if d.type == "cpu":
            cpu_tick = (time.perf_counter() - t0) / ticks
        finite &= bool(torch.isfinite(out).all()) and state["ec"]["Ws_r"].dtype == torch.float32
        outs.append(out.numpy())
    return outs[0], outs[1], finite, cpu_tick


# -- phase 7: the session layer ----------------------------------------------
def _tree_finite(tree):
    return all(_tree_finite(v) if isinstance(v, dict) else
               (not v.is_floating_point() or bool(torch.isfinite(v).all()))
               for v in tree.values())


class Session:
    """Echo-cancelling clients (AEC + AGC) against a conference server, both
    ``AudioStreamBatch`` on ``dev``, G.711 mu-law at 8 kHz or G.722 at
    16 kHz: legs 4k..4k+3 form conference k (``AudioConferenceControl``; the
    last one may have fewer), leg 4k talks. The clients' push is tapped for
    the talkers' sent codes and for finite speakers."""

    def __init__(self, dev, legs, ticks, seed=3, codec="ulaw", rate=8000, sound_card=False,
                 with_server=True):
        """``with_server=False`` builds the clients alone (phase 16a's
        server is the conference example). G.722 is stateful: its decoders start on the jitter buffers'
        empty ticks (code 0, as in the JAX package) and play a loud
        transient until the first packets have re-synchronised their
        predictors (~10 ticks), which the clients' echo cancellers and
        AGC then take ~30 more ticks to shed; ``settle`` = 40 ticks are left
        out of the bars (``bars``) and of the talker samples.

        ``sound_card`` (phase 14d): the clients are the quirk-configured
        session (``quirk_features``: mic EQ, the EC delay line, AEC, AGC,
        speaker EQ) on a ``FileSndCard`` that captures one speech signal
        for every leg and collects the playback, its gains set through
        the stream (``QUIRK_GAINS``); the listeners' microphones are muted
        (``enable_mic``), so that leg 4k alone talks in conference k. The
        send volume ramps a muted leg down (its gain x 0.88 a tick: -44 dB
        by tick 40), so ``settle`` is 40 ticks here too."""
        from mediastreamer2_tpu_torch import Factory, tick_samples
        from mediastreamer2_tpu_torch.core.devices import FileSndCard
        from mediastreamer2_tpu_torch.models.audio_stream import (AudioStreamBatch,
                                                                  AudioStreamFeatures)
        from mediastreamer2_tpu_torch.models.conference import AudioConferenceControl
        from mediastreamer2_tpu_torch.utils.signals import make_speechlike
        self.legs, self.ticks, self.codec, self.rate = legs, ticks, codec, rate
        self.conferences = -(-legs // 4)
        self.S = tick_samples(rate)
        self.settle = 40 if codec == "g722" or sound_card else 0
        n = self.S * (ticks + 60)
        f = Factory()
        self.card = None
        if sound_card:
            gain_in, gain_out = QUIRK_GAINS
            self.card = FileSndCard(signal=make_speechlike(n, rate, seed=seed), rate=rate)
            # every leg captures the card's signal; the talkers send it
            self.mic = np.broadcast_to(self.card.signal * np.float32(gain_in), (legs, n))
            self.clients = AudioStreamBatch(
                f, legs, codec=codec, rate=rate, snd_card=self.card, record_ticks=ticks + 60,
                device=dev, features=quirk_features())
            self.clients.set_sound_card_input_gain(gain_in)
            self.clients.set_sound_card_output_gain(gain_out)
            for leg in range(legs):
                if leg % 4:
                    self.clients.enable_mic(leg, False)
            delay = self.clients.features.ec_delay_ms // 10
            self.clients.ticker.mutate(
                lambda tk: tk.params["ec_delay"]["delay_ticks"].fill_(delay))
        else:
            self.mic = np.zeros((legs, n), np.float32)
            for k in range(self.conferences):
                self.mic[4 * k] = make_speechlike(n, rate, seed=seed + k)
            self.clients = AudioStreamBatch(
                f, legs, codec=codec, rate=rate, mic_signal=self.mic, record_ticks=ticks + 60,
                device=dev, features=AudioStreamFeatures(echo_canceller=True, agc=True))
        self.sent, self.finite, self.spk = [], [True], []
        sides = [(self.clients, True)]
        if with_server:
            self.server = AudioStreamBatch(f, legs, codec=codec, rate=rate, conference=True,
                                           device=dev)
            self.ctl = AudioConferenceControl(self.server.ticker)
            for leg in range(legs):
                self.ctl.add_member(leg, leg // 4)
            sides.append((self.server, False))
        for s, keep in sides:
            s.ticker.realtime = False
            self._tap(s, keep)

    def _tap(self, stream, keep):
        push = stream.ticker._io_push

        def tapped(tick, out):
            if keep:
                self.sent.append(out["rtp_tx"][::4].copy())
                if self.card is not None:
                    self.spk.append(out["spk"].copy())
            self.finite[0] &= bool(np.isfinite(out["spk"]).all())
            push(tick, out)
        stream.ticker.set_io(pull=stream.ticker._io_pull, push=tapped)

    def card_played_ok(self):
        """(the card played every tick's ``spk`` block times the output
        gain, bit for bit; the ticks compared)."""
        played, spk = self.card.played, self.spk
        gain = np.float32(self.clients.get_sound_card_output_gain())
        ok = len(played) == len(spk) > 0 and all(
            np.array_equal(p, s * gain) for p, s in zip(played, spk))
        return ok, len(spk)

    def loopback(self):
        from mediastreamer2_tpu_torch.net.rtp import LoopbackPair
        for leg in range(self.legs):
            pair = LoopbackPair()
            self.clients.set_transport(leg, pair.endpoint(0))
            self.server.set_transport(leg, pair.endpoint(1))

    def udp(self, pump=None):
        """Each leg over two localhost ``UdpTransport``s, one a side, each
        the other's remote; on ``pump`` (a ``NativeIoPump``) when given,
        else received by Python. They are kept in ``udp_transports`` for
        the caller to close."""
        from mediastreamer2_tpu_torch.net.rtp import UdpTransport
        self.udp_transports = []
        for leg in range(self.legs):
            a, b = UdpTransport(), UdpTransport()
            self.udp_transports += [a, b]
            a.set_remote("127.0.0.1", b.local_port)
            b.set_remote("127.0.0.1", a.local_port)
            if pump is not None:
                a.attach_pump(pump)
                b.attach_pump(pump)
            self.clients.set_transport(leg, a)
            self.server.set_transport(leg, b)

    def alternate(self, ticks, sample_every=0, iterate_every=0, between=None):
        """``ticks`` rounds of clients.do_tick() then server.do_tick();
        returns host ms per round and the active talkers sampled every
        ``sample_every`` rounds. ``iterate_every``: each side's iterate()
        once in that many rounds, the server's half a period after the
        clients' (so each side's report answers the other's latest SR).
        ``between()`` runs after every round."""
        samples = []
        t0 = time.perf_counter()
        for t in range(ticks):
            self.clients.ticker.do_tick()
            self.server.ticker.do_tick()
            if sample_every and t % sample_every == sample_every - 1 and t >= self.settle:
                samples.append(self.ctl.active_talkers())
            if iterate_every and t % iterate_every == iterate_every // 2 - 1:
                self.clients.iterate()
            if iterate_every and t % iterate_every == iterate_every - 1:
                self.server.iterate()
            if between is not None:
                between()
        return 1e3 * (time.perf_counter() - t0) / ticks, samples

    def state_finite(self):
        for s in (self.clients, self.server):
            s.ticker.sync()
        return all(_tree_finite(entry) for s in (self.clients, self.server)
                   for entry in s.ticker.state.values() if entry)

    def said(self, conferences):
        """Each sampled talker's speech as sent: its wire codes decoded by
        the plain codec on the CPU ([len(conferences), ticks * S])."""
        sent = np.stack(self.sent)[:self.ticks][:, conferences]       # [ticks, n, 80]
        codes = torch.from_numpy(np.ascontiguousarray(
            sent.transpose(1, 0, 2).reshape(len(conferences), -1).astype(np.int32)))
        from mediastreamer2_tpu_torch.ops.g711 import pcm16_to_float, ulaw_decode
        if self.codec == "g722":
            from mediastreamer2_tpu_torch.ops.g722 import g722_state
            from mediastreamer2_tpu_torch.ops.kernels import g722_decode_reference
            pcm, _ = g722_decode_reference(codes, g722_state(len(conferences), "cpu"))
        else:
            pcm = ulaw_decode(codes)
        return pcm16_to_float(pcm).numpy()

    def bars(self, conf_step, skip=()):
        """Every ``conf_step``-th conference: each listener's recording
        against its talker's speech as sent (the talker's codes on the
        wire, decoded: the talker's own AEC and AGC shape it) and as
        spoken (its mic signal), and the talker's own energy against its
        listeners' (mix-minus). Legs in ``skip`` are left out. With a
        ``settle`` window, a listener's recording from that tick on is held
        to the part of the speech it plays, found by the lag over the whole
        signals. Each listener's audio_diff against the speech sent and its
        lag are kept in ``self.leg_sims`` (leg -> (audio_diff, lag))."""
        n = self.S * self.ticks
        start = self.S * self.settle
        rec = self.clients.get_recording()[:, :n]
        confs = list(range(0, self.conferences, conf_step))
        said = self.said(confs)
        pairs = [(j, leg) for j, k in enumerate(confs)
                 for leg in range(4 * k + 1, min(4 * k + 4, self.legs)) if leg not in skip]
        rows = [j for j, _ in pairs]
        listeners = [leg for _, leg in pairs]
        talkers = [4 * confs[j] for j in rows]
        sim_sent, lags = settled_sims(said[rows], rec[listeners], start)
        sim_mic = settled_sims(self.mic[talkers, :n], rec[listeners], start)[0]
        self.leg_sims = {leg: (float(got), int(lag))
                         for leg, got, lag in zip(listeners, sim_sent, lags)}
        ratio = ((rec[talkers, start:].astype(np.float64) ** 2).mean(axis=1)
                 / ((rec[listeners, start:].astype(np.float64) ** 2).mean(axis=1) + 1e-20))
        return float(sim_sent.min()), float(sim_mic.min()), float(ratio.max()), rec

    def heard(self):
        """{listener leg: int [ticks]}: for each tick of the listener's
        recording, the tick of its talker's speech that it played, followed
        through the listener's jitter buffer (the server's packet played),
        the server's mix and the talker's jitter buffer on the server (the
        talker's packet mixed); -1 where either buffer concealed the tick.
        Needs ``Playout`` on both streams (``self.playout``) from the first
        tick."""
        clients, server = self.playout
        out = {}
        for k in range(self.legs // 4):
            talker = clients.ticks_by_seq(4 * k)
            for leg in range(4 * k + 1, 4 * k + 4):
                mixed = server.ticks_by_seq(leg)
                got = np.full(self.ticks, -1)
                for t in range(self.ticks):
                    u = mixed.get(clients.played[t][leg])
                    v = talker.get(server.played[u][4 * k]) if u in server.played else None
                    got[t] = -1 if v is None else v
                out[leg] = got
        return out

    def check(self, conf_step, skip=()):
        """(bars met, a line that states them)."""
        sim_sent, sim_mic, ratio, _ = self.bars(conf_step, skip)
        ok = sim_sent > 0.85 and sim_mic > 0.7 and ratio < 0.05 and self.finite[0]
        return ok, (f"listeners vs talkers (every {conf_step}th conference): audio_diff min "
                    f"{sim_sent:.4f} against the speech sent, {sim_mic:.4f} against the "
                    f"mic; talker/listener energy max {ratio:.2e}; outputs finite "
                    f"{self.finite[0]}, bars met {ok}")


class Playout:
    """One stream's RTP sequence numbers by tick and leg: ``sent[tick]``
    the packet each leg sent that tick, ``played[tick]`` the packet each
    leg's jitter buffer played (None: the tick was concealed). Installed
    around the ticker's pull and push and each leg's jitter buffer's
    ``get_tick``, which the stream's pull calls once a leg."""

    def __init__(self, stream):
        self.sent, self.played = {}, {}
        sessions = stream.sessions
        now = [None] * len(sessions)
        for i, sess in enumerate(sessions):
            jb = sess.jitter_buffer

            def get_tick(i=i, jb=jb, get=jb.get_tick):
                seq, payload = jb.next_seq, get()
                now[i] = None if payload is None else seq
                return payload
            jb.get_tick = get_tick
        pull, push = stream.ticker._io_pull, stream.ticker._io_push

        def pulled(tick):
            now[:] = [None] * len(now)
            ext_in = pull(tick)
            self.played[tick] = list(now)
            return ext_in

        def pushed(tick, out):
            self.sent[tick] = [sess.seq for sess in sessions]    # this tick's packets
            push(tick, out)
        stream.ticker.set_io(pull=pulled, push=pushed)

    def ticks_by_seq(self, leg):
        """{sequence number: the tick that sent it} for ``leg``."""
        return {seqs[leg]: t for t, seqs in self.sent.items()}


def mapped_sim(ref, rec, S, heard):
    """The normalized correlation of ``rec``'s ticks with the ticks of
    ``ref`` they played (``heard[t]``, -1 for none), and the share of
    rec's ticks compared."""
    t = np.flatnonzero((heard >= 0) & (heard < len(ref) // S))
    a = rec[:len(heard) * S].astype(np.float64).reshape(-1, S)[t]
    b = ref[:len(ref) // S * S].astype(np.float64).reshape(-1, S)[heard[t]]
    den = np.sqrt((a * a).sum() * (b * b).sum())
    return (float((a * b).sum() / den) if den > 0 else 0.0), len(t) / max(len(heard), 1)


def session_launches(codec, ticks):
    """The kernel launches of ``ticks`` session tick pairs (clients then
    server): fused_volume 3 a pair (the clients' vol_send and vol_recv, the
    server's vol_recv: a conference=True stream has no send volume, in the
    JAX package too), the clients' AEC once (mdf_apply, mdf_update_fused),
    and with G.722 each side's encode and decode once; no other."""
    want = {"fused_volume": 3 * ticks, "mdf_apply": ticks, "mdf_update_fused": ticks}
    if codec == "g722":
        want.update(g722_encode=2 * ticks, g722_decode=2 * ticks)
    return want


def batch_edge(sess, srtp=False, calls=None):
    """The session pair's batch edges over two localhost UDP sockets (UDP
    GSO only where the kernel takes it); returns the sockets (server,
    clients). ``srtp``: AES_CM_128_HMAC_SHA1_80 on every leg, keys from a
    seeded generator; ``calls`` (phase 11a): each leg's keys and suite as
    its call's setup agreed them, installed per leg and direction through
    the edge's own ``set_srtp`` after ``enable_batch_edge``. The edges own
    their sockets: the media of 11a does not ride the sockets that ICE
    nominated (11b holds that one-socket path)."""
    socks = []
    for _ in range(2):
        sk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sk.bind(("127.0.0.1", 0))
        sk.setblocking(False)
        for opt in (socket.SO_RCVBUF, socket.SO_SNDBUF):
            with contextlib.suppress(OSError):
                sk.setsockopt(socket.SOL_SOCKET, opt, 1 << 24)
        socks.append(sk)
    srv, cli = socks
    keys = None
    if srtp:
        rng = np.random.default_rng(8)
        keys = [(rng.bytes(16), rng.bytes(14)) for _ in range(sess.legs)]
    try:
        sess.clients.enable_batch_edge(rx_sock=cli, tx_sock=cli, remote=srv.getsockname(),
                                       ssrc_base=0x6000, srtp_keys=keys)
        sess.server.enable_batch_edge(rx_sock=srv, tx_sock=srv, remote=cli.getsockname(),
                                      ssrc_base=0x6000, srtp_keys=keys)
        if calls is not None:
            for leg, pair in enumerate(calls.pairs):
                for stream, setup in zip((sess.clients, sess.server), pair):
                    tk, ts, rk, rs = setup.srtp_keys
                    stream.edge_tx.set_srtp(leg, tk, ts, setup.srtp_suite)
                    stream.edge_rx.set_srtp(leg, rk, rs, setup.srtp_suite)
    except BaseException:
        srv.close()
        cli.close()
        raise
    return srv, cli


def session_edge(kernels, dev, card, legs, ticks, phase="7a", codec="ulaw", rate=8000,
                 srtp=False, calls=None, sound_card=False):
    """Phases 7a, 8a, 11a and 14d: the session pair at full width over
    localhost UDP through the native batched edge (``batch_edge``: ``srtp``
    keys from a seeded generator, or ``calls``' negotiated ones;
    ``sound_card``: the quirk-configured clients on a FileSndCard, 14d).
    Returns the launches of the counted run; its ms per tick pair goes
    into ``PAIR_MS[phase]``."""
    from mediastreamer2_tpu_torch import native
    sess = Session(dev, legs, ticks, codec=codec, rate=rate, sound_card=sound_card)
    srv, cli = batch_edge(sess, srtp, calls)
    try:
        sess.clients.ticker.warm_up()
        sess.server.ticker.warm_up()
        kernels.reset_launch_counts()
        ms, samples = sess.alternate(ticks, sample_every=10)
        launches = kernels.launch_counts()
        sides = (sess.server, sess.clients)
        recv = [min(s.edge_rx.stats(i)["recv"] for i in range(legs)) for s in sides]
        auth = sum(s.edge_rx.auth_failures(i) for s in sides for i in range(legs))
        replay = sum(s.edge_rx.replay_drops(i) for s in sides for i in range(legs))
    finally:
        srv.close()
        cli.close()
    ph = {f"{who} {k}": v / ticks for who, s in (("clients", sess.clients),
                                                 ("server", sess.server))
          for k, v in s.ticker.phase_ms.items() if not k.endswith("_max")}
    ok, line = sess.check(conf_step=4)
    named = {k: set() for k in range(legs // 4)}
    stray = set()
    for sample in samples:
        for conf, who in sample.items():
            named[conf].update(who)
            stray.update(leg for leg in who if leg % 4)
    missing = [k for k, who in named.items() if 4 * k not in who]
    state_finite = sess.state_finite()
    what = f"{codec} at {rate // 1000} kHz"
    if srtp:
        what += ", AES_CM_128_HMAC_SHA1_80 on every leg"
    if calls is not None:
        suites = {}
        for pair in calls.pairs:
            suites[pair[0].srtp_suite] = suites.get(pair[0].srtp_suite, 0) + 1
        what += ", the keys and suites the calls agreed (legs a suite: " + ", ".join(
            f"{k} {v}" for k, v in suites.items()) + ")"
    if srtp or calls is not None:
        what += f" (edge AES-NI {native.hw_crypto()})"
    card_ok = True
    if sound_card:
        card_ok, played = sess.card_played_ok()
        nodes = [k for k in ("mic_eq", "ec_delay", "ec", "spk_eq") if k in sess.clients.ticker.state]
        card_ok &= nodes == ["mic_eq", "ec_delay", "ec", "spk_eq"]
        what += (f", the quirk session ({QUIRK_DEVICE}: nodes {nodes}, EC delay "
                 f"{sess.clients.features.ec_delay_ms} ms) on a FileSndCard, gains in / out "
                 f"{sess.clients.get_sound_card_input_gain()} / "
                 f"{sess.clients.get_sound_card_output_gain()}, the card's {played} played "
                 f"blocks equal to spk x the output gain: {card_ok}")
        if "7a" in PAIR_MS:
            what += f"; 7a read {PAIR_MS['7a']:.3f} ms per tick pair"
    PAIR_MS[phase] = ms
    print(f"session {phase}: {legs} + {legs} legs (AEC+AGC clients, conference server, "
          f"{legs // 4} four-party conferences, {what}) x {ticks} ticks over the batch edge, "
          f"UDP GSO {sess.server.gso}: {ms:.3f} ms per tick pair (host clock); host ms/tick by "
          f"phase: " + " ".join(f"{k} {v:.3f}" for k, v in ph.items())
          + f"; launches {launches}; edge recv min server {recv[0]} clients {recv[1]}, SRTP "
          f"auth failures {auth}, replay drops {replay}; {line}; state finite "
          f"{state_finite}; conferences whose talker was never named {len(missing)}, "
          f"listeners named {len(stray)} [{card}]", flush=True)
    if torch.device(dev).type == "cuda":      # the plain versions launch nothing
        _require_counts(f"session {phase}", launches, session_launches(codec, ticks))
    if not card_ok:
        raise AssertionError(f"session {phase}: the sound card's playback or the quirk "
                             f"nodes are wrong: {what}")
    if min(recv) < ticks // 2:
        raise AssertionError(f"session {phase}: a leg received only {min(recv)} packets")
    if auth or replay:
        raise AssertionError(f"session {phase}: {auth} SRTP authentication failures, "
                             f"{replay} replay drops")
    if missing or stray or not (state_finite and ok):
        raise AssertionError(f"session {phase}: talkers not named in conferences {missing[:8]}, "
                             f"listeners named {sorted(stray)[:8]}, state finite "
                             f"{state_finite}, bars met {ok}")
    return launches


def session_paced(dev, card, legs, ticks):
    """Phase 7b: the session pair over LoopbackPair (the per-leg RtpSession
    path), both tickers warmed, then start()ed paced on their own threads:
    the clients for ``ticks`` ticks, the server until 20 ticks after them.
    Both tickers run late (their host time exceeds a tick), so the jitter
    buffers' fill drifts and they underrun or discard mid-run, as the JAX
    package's do: each such event conceals a tick or skips one, and moves
    the playout's delay by a tick, which one audio_diff lag over the whole
    run cannot follow. So each listener's recording is held to its
    talker's speech tick by tick along the path its packets took
    (``Playout``, ``Session.heard``): every stretch between events at its
    own delay, the concealed ticks left out. The fixed-lag audio_diff is
    printed beside it. Returns the Session."""
    sess = Session(dev, legs, ticks, seed=40)
    sess.loopback()
    sess.playout = (Playout(sess.clients), Playout(sess.server))
    for s in (sess.server, sess.clients):
        s.ticker.realtime = True
        s.ticker.warm_up()
    sess.server.ticker.start()
    sess.clients.ticker.start(ticks)
    sess.clients.ticker._run_thread.join(timeout=30 + ticks * 0.05)
    alive = sess.clients.ticker._run_thread.is_alive()
    time.sleep(0.2)
    for s in (sess.clients, sess.server):
        s.stop()
    if alive:
        raise AssertionError("session 7b: the paced clients did not finish")
    st = [(s.ticker.stats.ticks, s.ticker.stats.late_ticks, s.ticker.get_average_load(),
           s.ticker.stats.mean_step_ms) for s in (sess.clients, sess.server)]
    fixed_sent, fixed_mic, ratio, rec = sess.bars(conf_step=1)
    said = sess.said(list(range(legs // 4)))
    sess.heard_sims = {}
    for leg, heard in sess.heard().items():
        sent, played = mapped_sim(said[leg // 4], rec[leg], sess.S, heard)
        mic = mapped_sim(sess.mic[leg - leg % 4], rec[leg], sess.S, heard)[0]
        sess.heard_sims[leg] = (sent, mic, played)
    sent, mic, played = (min(v[i] for v in sess.heard_sims.values()) for i in range(3))
    ok = (sent > 0.85 and mic > 0.7 and played >= PACED_PLAYED_MIN and ratio < 0.05
          and sess.finite[0])

    def jb(stream, leg):
        b = stream.sessions[leg].jitter_buffer
        return (f"{b.underruns}/{b.resyncs}/{b.lost}/{b.discarded}/{b.stretched}")
    legs_line = "; ".join(
        f"{leg} {got:.4f} lag {lag} along the path {sess.heard_sims[leg][0]:.4f} / "
        f"{sess.heard_sims[leg][1]:.4f} played {sess.heard_sims[leg][2]:.3f} jb "
        f"{jb(sess.clients, leg)} talker jb {jb(sess.server, leg - leg % 4)}"
        for leg, (got, lag) in sess.leg_sims.items())
    line = (f"listeners along their packets' path: min {sent:.4f} against the speech sent "
            f"(bar 0.85), {mic:.4f} against the mic (bar 0.7), ticks played from the "
            f"talker's packets min {played:.3f} (bar {PACED_PLAYED_MIN}); at one fixed lag: "
            f"audio_diff min {fixed_sent:.4f} against the speech sent, {fixed_mic:.4f} "
            f"against the mic; talker/listener energy max {ratio:.2e}; outputs finite "
            f"{sess.finite[0]}, bars met {ok}")
    print(f"session 7b: {legs} + {legs} legs x {ticks} ticks paced over LoopbackPair, "
          + ", ".join(f"{who} {n} ticks, late {late}, load {load:.3f}, mean {mean:.3f} ms"
                      for who, (n, late, load, mean) in zip(("clients", "server"), st))
          + "; host ms/tick by phase: " + " ".join(
              f"{who} {k} {v / s.ticker.stats.ticks:.3f}"
              for who, s in (("clients", sess.clients), ("server", sess.server))
              for k, v in s.ticker.phase_ms.items() if not k.endswith("_max"))
          + f"; {line}; every listener: leg, audio_diff against the speech sent at one lag, "
          f"that lag, against the speech sent / the mic along its packets' path, the share "
          f"of its ticks played from its talker's packets, its jitter buffer's and its "
          f"talker's (on the server) underruns/resyncs/lost/discarded/stretched: "
          f"{legs_line} [{card}]", flush=True)
    if not ok:
        raise AssertionError("session 7b: bars not met")
    return sess


def session_cross(dev, legs, ticks, sound_card=False):
    """Phases 7c and 14e: the same session on the CPU (plain versions) and
    on the card (kernels), over LoopbackPair with alternating do_tick
    (``sound_card``: 14d's quirk session on its card, whose playback must
    equal spk times the output gain on both); returns the clients'
    recordings of the listeners, CPU then card."""
    recs = []
    phase = "14e" if sound_card else "7c"
    for d in (torch.device("cpu"), dev):
        sess = Session(d, legs, ticks, seed=70, sound_card=sound_card)
        sess.loopback()
        sess.alternate(ticks)
        ok, line = sess.check(conf_step=1)
        if sound_card:
            ok &= sess.card_played_ok()[0]
        if not ok:
            raise AssertionError(f"session {phase} on {d.type}: {line}")
        rec = sess.clients.get_recording()[:, :S8 * ticks]
        recs.append(rec[[leg for leg in range(legs) if leg % 4]])
    return recs


# -- phase 8: the secured wideband call ---------------------------------------
def secure_session(dev, legs, max_ticks, wrong_key_leg=None, seed=90, calls=None,
                   connect=None):
    """Phase 8b's configuration: the G.722 session pair over LoopbackPair
    (or what ``connect(session)`` sets: phase 13b's ``Session.udp``) with
    per-leg SRTP keyed by SDES (each side generates its key line, the
    other parses it), RTCP every RTCP_INTERVAL_S, and on every leg a
    quality indicator (counting the reports it was fed) and a bitrate
    controller (whose ptime ladder drives ``set_ptime``). The clients'
    ``wrong_key_leg`` gets a receive key that is not the server's. With
    ``calls`` (phase 11b), each leg's transport is its call's
    ``CallSetup.media_transport()`` instead (the nominated socket, SRTP
    keyed by the call's DTLS or ZRTP).
    Returns (session, {(side, leg): quality indicator})."""
    from mediastreamer2_tpu_torch.models import qos
    from mediastreamer2_tpu_torch.net.srtp import sdes_generate, sdes_parse

    class Indicator(qos.QualityIndicator):
        reports = 0

        def update(self, stats):
            self.reports += 1
            return super().update(stats)

    sess = Session(dev, legs, max_ticks, seed=seed, codec="g722", rate=16000)
    if calls is not None:
        for leg, (client, server) in enumerate(calls.pairs):
            sess.clients.set_transport(leg, client.media_transport())
            sess.server.set_transport(leg, server.media_transport())
    else:
        (connect or Session.loopback)(sess)
        for leg in range(legs):
            offer, kc, sc = sdes_generate()
            answer, ks, ss = sdes_generate()
            _, rkc, rsc = sdes_parse("1 " + offer)       # the server reads the offer
            _, rks, rss = sdes_parse("1 " + answer)      # the clients read the answer
            if leg == wrong_key_leg:
                rks = bytes(16)
            sess.clients.enable_srtp(leg, kc, sc, rks, rss)
            sess.server.enable_srtp(leg, ks, ss, rkc, rsc)
    qis = {}
    for side, stream in (("clients", sess.clients), ("server", sess.server)):
        stream.enable_rtcp(interval_s=RTCP_INTERVAL_S)
        for leg in range(legs):
            qis[(side, leg)] = qi = Indicator()
            stream.attach_quality_indicator(leg, qi)
            stream.attach_bitrate_controller(leg, qos.BitrateController(
                qos.SimpleQosAnalyzer(), qos.AudioBitrateDriver(
                    lambda bps: None, lambda ms, st=stream, leg=leg: st.set_ptime(leg, ms))))
    for stream in (sess.clients, sess.server):
        stream.ticker.warm_up()
    return sess, qis


def secure_rounds(sess, phase, max_ticks, between=None):
    """Alternating do_ticks with iterate() every 10 rounds until
    SECURE_MIN_S of wall time and SECURE_MIN_TICKS rounds have passed
    (``between()`` after every round); sets ``sess.ticks`` to the rounds
    run and returns (rounds, seconds, ms per tick pair)."""
    t0, ran, ms = time.perf_counter(), 0, []
    while ran < SECURE_MIN_TICKS or time.perf_counter() - t0 < SECURE_MIN_S:
        ms.append(sess.alternate(10, iterate_every=10, between=between)[0])
        ran += 10
        if ran >= max_ticks:
            raise AssertionError(f"session {phase}: {ran} rounds in "
                                 f"{time.perf_counter() - t0:.1f} s")
    sess.ticks = ran
    return ran, time.perf_counter() - t0, sum(ms) / len(ms)


def secure_report(sess, qis, skip=()):
    """8b's and 11b's per-leg readings, the legs in ``skip`` left out: the
    legs without a remote report and without an RTT, the RTT line, the
    least quality indicator rating and the SRTP authentication failures."""
    legs_ok = [(side, leg) for side in ("clients", "server") for leg in range(sess.legs)
               if leg not in skip]
    unreported = [k for k in legs_ok if qis[k].reports == 0]
    stream = {"clients": sess.clients, "server": sess.server}
    rtts = {k: stream[k[0]].sessions[k[1]].rtcp.last_rtt_ms for k in legs_ok}
    no_rtt = [k for k, v in rtts.items() if v is None]
    known = sorted(v for v in rtts.values() if v is not None)
    auth = sum(stream[side].sessions[leg].transport.auth_failures for side, leg in legs_ok)
    rating = min(qis[k].rating for k in legs_ok)
    line = (f"legs without a remote report {len(unreported)}, without an RTT {len(no_rtt)}, "
            "RTT ms min/median/max "
            + (f"{known[0]:.3f}/{known[len(known) // 2]:.3f}/{known[-1]:.3f}" if known else "-")
            + f", quality indicator min {rating:.3f}, SRTP auth failures {auth}")
    return SimpleNamespace(unreported=unreported, no_rtt=no_rtt, auth=auth, line=line,
                           rating=rating)


def session_secure(dev, card, legs):
    """Phase 8b: 8b's configuration, alternating do_ticks with iterate()
    every 10 rounds until SECURE_MIN_S of wall time and SECURE_MIN_TICKS
    rounds have passed."""
    wrong = 5                                             # a listener of conference 1
    sess, qis = secure_session(dev, legs, SECURE_MAX_TICKS, wrong_key_leg=wrong)
    ran, wall, ms = secure_rounds(sess, "8b", SECURE_MAX_TICKS)
    ok, line = sess.check(conf_step=1, skip=(wrong,))
    rep = secure_report(sess, qis, skip=(wrong,))
    bad = sess.clients.sessions[wrong]
    print(f"session 8b: {legs} + {legs} legs, G.722 at 16 kHz, per-leg SRTP (SDES), RTCP every "
          f"{RTCP_INTERVAL_S} s, quality indicator and bitrate controller on every leg, "
          f"{ran} rounds in {wall:.2f} s ({ms:.3f} ms per tick pair, host clock), iterate() "
          f"every 10: {rep.line} (the wrong-key leg: received {bad.stats.recv_packets} "
          f"packets, auth failures {bad.transport.auth_failures}); {line} [{card}]", flush=True)
    if rep.unreported or rep.no_rtt or rep.rating < 4.5 or rep.auth:
        raise AssertionError(f"session 8b: unreported {rep.unreported[:4]}, no RTT "
                             f"{rep.no_rtt[:4]}, quality indicator min {rep.rating}, auth "
                             f"failures {rep.auth}")
    if bad.stats.recv_packets or not bad.transport.auth_failures:
        raise AssertionError("session 8b: the leg with the wrong key received media")
    if not ok:
        raise AssertionError("session 8b: listener bars not met")


def session_secure_cross(dev, legs, ticks):
    """Phase 8c: 8b's configuration on the CPU (plain versions) and on the
    card (kernels), ``ticks`` rounds each; returns the clients'
    recordings of the listeners, CPU then card. (8b holds the listener
    bars of this configuration on the card; 8c holds the two backends to
    each other.)"""
    recs = []
    for d in (torch.device("cpu"), dev):
        sess, _ = secure_session(d, legs, ticks, seed=110)
        sess.alternate(ticks, iterate_every=10)
        rec = sess.clients.get_recording()[:, :sess.S * ticks]
        recs.append(rec[[leg for leg in range(legs) if leg % 4]])
    return recs


# -- phase 9: the gateway transcoder ------------------------------------------
def speech_legs(legs, n, seed, rate=8000):
    """float32 [legs, n]: leg i's row is ``utils/signals.make_speechlike(n,
    rate, seed=seed + i)``."""
    from mediastreamer2_tpu_torch.utils.signals import make_speechlike
    return make_speechlike(n, rate, seed=range(seed, seed + legs))


def codec_chain(kernels, dev, card, codec, sig, ticks):
    """Phase 9a, one codec: file_player -> enc -> dec -> file_recorder
    through a free-running Ticker, every leg playing its row of ``sig``.
    Returns the launches of the run."""
    from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder
    from mediastreamer2_tpu_torch.core.ticker import Ticker
    from mediastreamer2_tpu_torch.ops.fileio import recorder_get_audio
    from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff
    legs = sig.shape[0]
    g = GraphBuilder(Factory(), batch=legs)
    p = g.add("file_player", "play", fmt=Format(rate=8000), signal=sig)
    g.chain(p, g.add(f"{codec}_enc", "enc"), g.add(f"{codec}_dec", "dec"),
            g.add("file_recorder", "rec", max_ticks=ticks))
    tk = Ticker(g.build(), device=dev, name=f"chain[{codec}]", realtime=False)
    tk.warm_up()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tk.run(ticks)
    tk.sync()
    ms = 1e3 * (time.perf_counter() - t0) / ticks
    launches = kernels.launch_counts()
    rec = recorder_get_audio(tk.state["rec"], ticks, S8)
    sims = [audio_diff(sig[leg, :ticks * S8], rec[leg]) for leg in range(0, legs, 37)]
    sim, shifts = min(s for s, _ in sims), {k for _, k in sims}
    finite = all(_tree_finite(entry) for entry in tk.state.values() if entry)
    kind = codec.split("_")[0]
    print(f"chain 9a {codec}: {legs} legs x {ticks} ticks, file_player -> {codec}_enc -> "
          f"{codec}_dec -> file_recorder through Ticker: {ms:.3f} ms/tick (host clock), "
          f"launches {launches}, audio_diff min {sim:.4f} over legs 0, 37, ... (bar "
          f"{CHAIN_BARS[codec]}), shifts {sorted(shifts)}, state finite {finite} [{card}]",
          flush=True)
    _require_counts(f"chain {codec}", launches, {f"{kind}_encode": ticks, f"{kind}_decode": ticks})
    if not (sim > CHAIN_BARS[codec] and shifts == {0} and finite
            and bool(np.isfinite(rec).all())):
        raise AssertionError(f"chain {codec}: audio_diff {sim}, shifts {shifts}, finite {finite}")
    return launches


class Gateway:
    """Phase 9b's path: mu-law talkers -> TranscodeBatch(ulaw -> g726_32) ->
    TranscodeBatch(g726_32 -> ulaw) -> mu-law listeners, ``legs`` legs in
    each of the four batches on ``dev``, every hop a LoopbackPair per leg
    (the per-leg RtpSession path: TranscodeBatch has no batch edge, in the
    JAX package neither). The listeners only receive. ``tty`` builds
    talkers and listeners with the Baudot feature and a silent mic, and
    every talker types ``tty``."""

    def __init__(self, dev, legs, rounds, seed, tty=None):
        from mediastreamer2_tpu_torch import Factory, TranscodeBatch
        from mediastreamer2_tpu_torch.models.audio_stream import (AudioStreamBatch,
                                                                  AudioStreamFeatures)
        from mediastreamer2_tpu_torch.net.rtp import LoopbackPair
        self.legs, self.rounds = legs, rounds
        n = S8 * rounds
        self.mic = (np.zeros((legs, n), np.float32) if tty else speech_legs(legs, n, seed))
        f = Factory()
        feats = AudioStreamFeatures(baudot=bool(tty))
        self.talkers = AudioStreamBatch(f, legs, codec="ulaw", mic_signal=self.mic,
                                        features=feats, device=dev)
        self.up = TranscodeBatch(f, legs, codec_in="ulaw", rate_in=8000,
                                 codec_out="g726_32", rate_out=8000, device=dev)
        self.down = TranscodeBatch(f, legs, codec_in="g726_32", rate_in=8000,
                                   codec_out="ulaw", rate_out=8000, device=dev)
        self.listeners = AudioStreamBatch(f, legs, codec="ulaw", record_ticks=rounds,
                                          features=feats, device=dev)
        self.batches = (self.talkers, self.up, self.down, self.listeners)
        for leg in range(legs):
            a, m, b = LoopbackPair(), LoopbackPair(), LoopbackPair()
            self.talkers.set_transport(leg, a.endpoint(0))
            self.up.set_transports(leg, rx=a.endpoint(1), tx=m.endpoint(0))
            self.down.set_transports(leg, rx=m.endpoint(1), tx=b.endpoint(0))
            self.listeners.set_transport(leg, b.endpoint(1))
            self.listeners.set_direction(leg, "recvonly")
            if tty:
                self.talkers.send_baudot_string(leg, tty)
        self.sent = []                       # the sampled talkers' codes on the wire
        push = self.talkers.ticker._io_push

        def tapped(tick, out):
            self.sent.append(out["rtp_tx"][::37].copy())
            push(tick, out)
        self.talkers.ticker.set_io(pull=self.talkers.ticker._io_pull, push=tapped)
        for s in self.batches:
            s.ticker.realtime = False
            s.ticker.warm_up()

    def run(self):
        """``rounds`` rounds of one do_tick of each batch in turn (the
        listeners pump their events each round); host ms per round."""
        t0 = time.perf_counter()
        for _ in range(self.rounds):
            for s in self.batches:
                s.ticker.do_tick()
            if self.talkers.features.baudot:
                self.listeners.iterate()
        for s in self.batches:
            s.ticker.sync()
        return 1e3 * (time.perf_counter() - t0) / self.rounds

    def heard(self, settle):
        """The sampled listeners' recordings (legs 0, 37, ...) against their
        talkers' speech as sent (the wire codes decoded), from round
        ``settle`` on, aligned by the lag over the whole signals: the least
        audio_diff, and the lags."""
        from mediastreamer2_tpu_torch.ops.g711 import pcm16_to_float, ulaw_decode
        n, start = S8 * self.rounds, S8 * settle
        rec = self.listeners.get_recording()[::37, :n]
        sent = np.stack(self.sent)[:self.rounds]                       # [rounds, k, 80]
        said = pcm16_to_float(ulaw_decode(torch.from_numpy(np.ascontiguousarray(
            sent.transpose(1, 0, 2).reshape(rec.shape[0], -1).astype(np.int32))))).numpy()
        sims, lags = settled_sims(said, rec, start)
        return float(sims.min()), sorted(set(lags.tolist()))

    def state_finite(self):
        return all(_tree_finite(entry) for s in self.batches
                   for entry in s.ticker.state.values() if entry)


def gateway_launches(rounds):
    """The kernel launches of ``rounds`` gateway rounds: the two G.726
    launches (the transcoders' encode and decode) and the four volumes of
    the talkers and the listeners (each stream's vol_send and vol_recv)."""
    return {"g726_encode": rounds, "g726_decode": rounds, "fused_volume": 4 * rounds}


def gateway_full(kernels, dev, card, legs, rounds):
    """Phase 9b. Returns the launches of the counted run."""
    t0 = time.perf_counter()
    gw = Gateway(dev, legs, rounds, seed=200)
    setup_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    ms = gw.run()
    launches = kernels.launch_counts()
    sim, lags = gw.heard(GATEWAY_SETTLE)
    recv = min(s.stats.recv_packets for s in gw.listeners.sessions)
    finite = gw.state_finite()
    ph = " ".join(f"{who} {k} {v / rounds:.3f}" for who, s in (("up", gw.up), ("down", gw.down))
                  for k, v in s.ticker.phase_ms.items() if not k.endswith("_max"))
    print(f"gateway 9b: 4 x {legs} legs (mu-law talkers -> ulaw->g726_32 -> g726_32->ulaw -> "
          f"mu-law listeners, a LoopbackPair per leg and hop) x {rounds} rounds: {ms:.3f} ms "
          f"per round (host clock; set-up {setup_s:.1f} s); transcoders' host ms/tick by "
          f"phase: {ph}; launches {launches}; listeners vs the speech sent from round "
          f"{GATEWAY_SETTLE} on (legs 0, 37, ...): audio_diff min {sim:.4f} (bar 0.85), lags "
          f"{lags} samples; packets received min {recv} of {rounds}; state finite {finite} "
          f"[{card}]", flush=True)
    _require_counts("gateway 9b", launches, gateway_launches(rounds))
    if not (sim > 0.85 and recv >= rounds // 2 and finite):
        raise AssertionError(f"gateway 9b: audio_diff {sim}, received {recv}, finite {finite}")
    return launches


def gateway_cross(dev, legs, rounds):
    """Phase 9c: the gateway with Baudot on talkers and listeners, every
    talker typing TTY_TEXT, on the CPU (plain versions) and on the card
    (kernels); returns the listeners' recordings, CPU then card, and the
    texts read on each."""
    recs, texts = [], []
    for d in (torch.device("cpu"), dev):
        gw = Gateway(d, legs, rounds, seed=300, tty=TTY_TEXT)
        gw.run()
        recs.append(gw.listeners.get_recording()[:, :S8 * rounds])
        texts.append([gw.listeners.get_baudot_text(leg) for leg in range(legs)])
    return recs, texts


# -- phase 10: captured and recorded calls ------------------------------------
def g722_captures(dev, legs, ticks, seed, directory):
    """``ticks`` ticks of speech a leg at 16 kHz, G.722-encoded on ``dev``
    (``kernels.g722_encode``, one launch a tick for every leg), packed as
    RTP (payload type 9, SSRC CAPTURE_SSRC + leg, a seeded first sequence
    number and timestamp a leg, a packet a tick at the capture time of its
    tick) and written a pcap a leg by ``io/pcap.write_pcap``. A seeded
    quarter of the legs gets the JAX package's tests/test_pcap_bundle.py
    pathology: CAPTURE_LOSS of its packets missing and CAPTURE_LATE packets
    250-400 ms late (never among the first ten), the capture sorted by
    time. Returns a namespace: ``speech`` float32 [legs, n] at 16 kHz, its
    ``codes`` uint8 [legs, n / 2], ``paths``, the ``lossy`` legs and the
    ``packets`` each capture holds."""
    from mediastreamer2_tpu_torch.io.pcap import CapturedPacket, write_pcap
    from mediastreamer2_tpu_torch.models.audio_stream import PAYLOAD_TYPES
    from mediastreamer2_tpu_torch.net.rtp import RtpPacket
    from mediastreamer2_tpu_torch.ops import kernels
    from mediastreamer2_tpu_torch.ops.g711 import float_to_pcm16
    from mediastreamer2_tpu_torch.ops.g722 import g722_state
    speech = speech_legs(legs, S16 * ticks, seed, rate=16000)
    pcm = float_to_pcm16(torch.from_numpy(speech).to(dev))
    state, codes = g722_state(legs, dev), []
    for t in range(ticks):
        c, state = kernels.g722_encode(pcm[:, t * S16:(t + 1) * S16].contiguous(), state)
        codes.append(c)
    codes = torch.cat(codes, dim=1).to(torch.uint8).cpu().numpy()
    rng = np.random.default_rng(seed)
    lossy = sorted(int(k) for k in rng.choice(legs, size=max(1, legs // 4), replace=False))
    per, pt = S16 // 2, PAYLOAD_TYPES["g722"]
    paths, packets = [], []
    for leg in range(legs):
        seq0, ts0 = int(rng.integers(0, 1 << 16)), int(rng.integers(0, 1 << 32))
        lost, late = set(), {}
        if leg in lossy:
            lost = {int(k) for k in rng.choice(np.arange(10, ticks),
                                               size=max(1, round(CAPTURE_LOSS * ticks)),
                                               replace=False)}
            # late packets still arrive inside the run: at most 40 ticks late
            spots = sorted(set(range(10, ticks - 45)) - lost)
            late = {int(k): float(rng.uniform(0.25, 0.4))
                    for k in rng.choice(spots, size=CAPTURE_LATE, replace=False)}
        pkts = [CapturedPacket(ts=k * TICK_S + late.get(k, 0.0), udp_payload=RtpPacket(
            pt, seq0 + k, ts0 + per * k, CAPTURE_SSRC + leg,
            codes[leg, k * per:(k + 1) * per].tobytes(), marker=k == 0).pack())
            for k in range(ticks) if k not in lost]
        pkts.sort(key=lambda p: p.ts)
        paths.append(os.path.join(directory, f"leg{leg:04d}.pcap"))
        write_pcap(paths[-1], pkts)
        packets.append(len(pkts))
    return SimpleNamespace(speech=speech, codes=codes, paths=paths, lossy=lossy,
                           packets=np.array(packets))


def replay_captures(dev, caps, legs, ticks, ready=None):
    """The first ``legs`` captures, each read back by ``PcapRtpPlayer``, sent
    at their capture times over localhost UDP into a ``legs``-leg G.722
    ``AudioStreamBatch(record_ticks=ticks)`` on ``dev`` through its batch
    edge (recvonly: its silent send path encodes but sends nothing), for
    ``ticks`` do_ticks. Each tick's packets are sent before the tick (from
    one thread: four senders on the card's machine were slower), and the
    edge is polled until it has taken as many packets as were sent (at
    most REPLAY_WAIT_S): what the socket dropped or delayed past the wait is
    counted, not hidden. ``ready()`` runs after the stream's warm-up, just
    before the first tick. Returns a namespace: the recording ``rec``
    [legs, ticks * 160] (the stream's speaker output); per leg the packets
    ``sent`` and the edge's own counts: ``recv``, ``lost`` (playout found
    no packet), ``late`` (arrived after its playout) and ``concealed`` (the
    ticks that played no packet, the start's prefill included); the run's
    figures."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.io.pcap import PcapRtpPlayer
    from mediastreamer2_tpu_torch.models.audio_stream import PAYLOAD_TYPES, AudioStreamBatch
    t0 = time.perf_counter()
    players = [PcapRtpPlayer(p, payload_type=PAYLOAD_TYPES["g722"]) for p in caps.paths[:legs]]
    read_s = time.perf_counter() - t0
    stream = AudioStreamBatch(Factory(), legs, codec="g722", rate=16000, record_ticks=ticks,
                              device=dev)
    stream.ticker.realtime = False
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    # the sender, and the stream's own send socket, addressed to itself
    # (recvonly: it sends nothing; with GSO the edge connects it, so it is
    # not rx)
    tx, sink = (socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(2))
    try:
        rx.bind(("127.0.0.1", 0))
        rx.setblocking(False)
        with contextlib.suppress(OSError):
            rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 24)
        rcvbuf = rx.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
        for sk in (tx, sink):
            sk.bind(("127.0.0.1", 0))
        tx.connect(rx.getsockname())        # no address to resolve a packet
        stream.enable_batch_edge(rx_sock=rx, tx_sock=sink, remote=sink.getsockname(),
                                 ssrc_base=CAPTURE_SSRC)
        for leg in range(legs):
            stream.set_direction(leg, "recvonly")
        edge = stream.edge_rx
        stream.ticker.warm_up()
        if ready:
            ready()
        sent, taken, waits, send_s = np.zeros(legs, np.int64), 0, 0, 0.0
        t0 = time.perf_counter()
        for t in range(ticks):
            t1 = time.perf_counter()
            for leg, player in enumerate(players):
                for pkt in player.due(t * TICK_S):
                    tx.send(pkt.pack())
                    sent[leg] += 1
            send_s += time.perf_counter() - t1
            deadline = time.perf_counter() + REPLAY_WAIT_S
            while taken < sent.sum() and time.perf_counter() < deadline:
                taken += edge.poll()
            waits += taken < sent.sum()
            stream.ticker.do_tick()
            if taken < sent.sum():          # the stream's own poll took the rest
                taken = sum(edge.stats(i)["recv"] for i in range(legs))
        stream.ticker.sync()
        ms = 1e3 * (time.perf_counter() - t0) / ticks
        stats = [edge.stats(i) for i in range(legs)]
        state_finite = all(_tree_finite(e) for e in stream.ticker.state.values() if e)
        rec = stream.get_recording()
    finally:
        for sk in (rx, tx, sink):
            sk.close()
    return SimpleNamespace(rec=rec, sent=sent, ms=ms, send_ms=1e3 * send_s / ticks,
                           read_s=read_s, waits=waits, rcvbuf=rcvbuf,
                           finite=bool(np.isfinite(rec).all()), state_finite=state_finite,
                           recv=np.array([s["recv"] for s in stats]),
                           lost=np.array([s["lost"] for s in stats]),
                           late=np.array([s["late"] for s in stats]),
                           concealed=ticks - np.array([s["got"] for s in stats]))


def capture_launches(ticks):
    """The launches of phase 10a's replay: the receiving stream's decode,
    its silent send path's encode, and its two volumes (vol_recv and
    vol_send: a stream that is not a conference server has both), once a
    tick each. (The captures' own encode, once a tick, is a run of its
    own.)"""
    return {"g722_encode": ticks, "g722_decode": ticks, "fused_volume": 2 * ticks}


def settled_sims(ref, rec, settle_samples, dev="cpu"):
    """``utils/audiodiff.audio_diff`` of each row of ``rec`` against the same
    row of ``ref`` on ``dev``; with ``settle_samples``, ``rec`` from there on
    against the part of ``ref`` it plays, found by the lag over the whole
    rows clamped to [0, settle_samples]: (audio_diff [rows], lags [rows])."""
    from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff
    sims, lags = audio_diff(ref, rec, device=dev)
    if not settle_samples:
        return sims, lags
    n = rec.shape[1]
    lags = np.clip(lags, 0, settle_samples)
    idx = np.arange(n - settle_samples)[None, :] + (settle_samples - lags)[:, None]
    return audio_diff(np.take_along_axis(ref[:, :n], idx, axis=1), rec[:, settle_samples:],
                      device=dev)[0], lags


def decode_captures(dev, codes, ticks):
    """The captures' speech as encoded: ``codes`` decoded from the start by
    ``kernels.g722_decode`` on ``dev`` (the plain version on the CPU), a tick
    a launch: float32 [legs, ticks * 160]."""
    from mediastreamer2_tpu_torch.ops import kernels
    from mediastreamer2_tpu_torch.ops.g711 import pcm16_to_float
    from mediastreamer2_tpu_torch.ops.g722 import g722_state
    c = torch.from_numpy(codes[:, :ticks * S8].astype(np.int32)).to(dev)
    state, out = g722_state(c.shape[0], dev), []
    for t in range(ticks):
        pcm, state = kernels.g722_decode(c[:, t * S8:(t + 1) * S8].contiguous(), state)
        out.append(pcm)
    return pcm16_to_float(torch.cat(out, dim=1)).cpu().numpy()


def captured_calls(kernels, dev, card, legs, ticks, directory):
    """Phase 10a. Returns (the launches of the captures' build, those of
    the replay, the captures, the replay)."""
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    caps = g722_captures(dev, legs, ticks, seed=500, directory=directory)
    built = kernels.launch_counts()
    build_s = time.perf_counter() - t0
    res = replay_captures(dev, caps, legs, ticks, ready=kernels.reset_launch_counts)
    launches = kernels.launch_counts()
    said = decode_captures(dev, caps.codes, ticks)
    start = S16 * CAPTURE_SETTLE
    sims, lags = settled_sims(said, res.rec, start, dev)
    clean = np.array([leg for leg in range(legs) if leg not in caps.lossy])
    lossy = np.array(caps.lossy)
    half = res.recv >= caps.packets[:legs] // 2
    worst = clean[np.argmin(sims[clean])]
    print(f"captured 10a: {legs} G.722 captures of {ticks} ticks (3 s of speech a leg at 16 kHz "
          f"encoded on the card, {len(lossy)} legs lossy: {CAPTURE_LOSS:.0%} lost and "
          f"{CAPTURE_LATE} packets 250-400 ms late), {int(caps.packets.sum())} packets in "
          f"{legs} pcaps built and written in {build_s:.1f} s, read back by PcapRtpPlayer in "
          f"{res.read_s:.1f} s, replayed at their capture times over localhost UDP into a "
          f"{legs}-leg recvonly G.722 AudioStreamBatch on the batch edge: {res.ms:.3f} ms a tick "
          f"(host clock), of which the sends {res.send_ms:.3f} ms; SO_RCVBUF {res.rcvbuf} bytes, "
          f"packets sent {int(res.sent.sum())}, taken by the edge {int(res.recv.sum())} (dropped "
          f"{int(res.sent.sum() - res.recv.sum())}), ticks that waited past "
          f"{REPLAY_WAIT_S * 1e3:.0f} ms for the edge {res.waits}; launches: the build "
          f"{built}, the replay {launches}; "
          f"clean legs vs the speech as encoded from tick {CAPTURE_SETTLE} on: audio_diff min "
          f"{sims[clean].min():.4f} (leg {worst}, bar 0.85), median {np.median(sims[clean]):.4f}, "
          f"lags {sorted(set(lags[clean].tolist()))[:6]} samples; lossy legs: audio_diff min "
          f"{sims[lossy].min():.4f}, received / lost / late / concealed ticks, sum "
          f"{int(res.recv[lossy].sum())} / {int(res.lost[lossy].sum())} / "
          f"{int(res.late[lossy].sum())} / {int(res.concealed[lossy].sum())}, per leg (first 8) "
          + ", ".join(f"{leg}: {res.recv[leg]}/{res.lost[leg]}/{res.late[leg]}/"
                      f"{res.concealed[leg]} of {caps.packets[leg]}" for leg in lossy[:8])
          + f"; clean legs lost {int(res.lost[clean].sum())}, late {int(res.late[clean].sum())}; "
          f"a leg received min {(res.recv / caps.packets[:legs]).min():.3f} of its capture; "
          f"outputs finite {res.finite}, state finite {res.state_finite} [{card}]", flush=True)
    _require_counts("captured 10a, the build", built, {"g722_encode": ticks})
    _require_counts("captured 10a, the replay", launches, capture_launches(ticks))
    if not (half.all() and res.finite and res.state_finite and sims[clean].min() > 0.85):
        raise AssertionError(f"captured 10a: legs below half their packets "
                             f"{np.flatnonzero(~half)[:8]}, finite {res.finite} / "
                             f"{res.state_finite}, clean audio_diff min {sims[clean].min()}")
    return built, launches, caps, res


def play_to_eof(dev, path, out_rate=None):
    """``MediaPlayer`` on ``dev`` over ``path``, set playing and ticked by
    hand from open to 3 ticks past its end: (the played samples, the EOF
    events)."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.models.media_player import MediaPlayer
    mp = MediaPlayer(Factory(), out_rate=out_rate, device=dev)
    got, eofs = [], []
    mp.set_output(got.append)
    mp.on_eof = lambda: eofs.append(1)
    mp.open(path)
    mp.ticker.realtime = False
    mp.ticker.mutate(lambda tk: tk.params["play"]["playing"].fill_(True))
    for _ in range(-(-mp.duration_ms // 10) + 3):
        mp.ticker.do_tick()
    mp.ticker.event_queue.pump()
    mp.close()
    return np.concatenate(got), len(eofs)


def player_controls(dev, path):
    """``start`` (the ticker's paced thread), ``pause``, ``seek_ms`` and
    ``set_loop`` on ``dev``, read by ``get_position_ms``: (positions held
    over 100 ms of pause, the position 50 ms after a seek to 1,000 ms while
    paused, the position after looping from 25 ms before the end, the EOF
    events of the loop)."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.models.media_player import MediaPlayer
    mp = MediaPlayer(Factory(), device=dev)
    eofs = []
    mp.on_eof = lambda: eofs.append(1)
    mp.open(path)
    try:
        mp.start()
        time.sleep(0.3)
        mp.pause()
        time.sleep(0.05)                 # the pause lands at the next tick boundary
        held = [mp.get_position_ms()]
        time.sleep(0.1)
        held.append(mp.get_position_ms())
        mp.seek_ms(1000)
        time.sleep(0.05)
        sought = mp.get_position_ms()
        mp.set_loop(True)
        mp.seek_ms(mp.duration_ms - 25)
        mp.ticker.event_queue.pump()
        mp.start()
        time.sleep(0.1)
        mp.pause()
        time.sleep(0.05)
        mp.ticker.event_queue.pump()
        looped = mp.get_position_ms()
    finally:
        mp.close()
    return held, sought, looped, len(eofs), mp.duration_ms


def recorded_files(dev, card, rec, legs, directory):
    """Phase 10b: the recordings of ``legs`` as WAV, SMFF (pcm16) and MKV
    (A_PCM on even entries, A_MS/ACM µ-law on odd), each played to EOF by
    ``MediaPlayer`` on the card and held to the file's content; six of
    them resampled to 48 kHz, the card against the CPU; pause, seek and
    loop on one; ``MediaRecorder`` on the card into .wav, .smff and .mkv.
    The 48 kHz comparison takes the files of the first two legs: their
    WAV, SMFF, A_PCM MKV and mu-law ACM MKV are every branch the player
    decodes, and all 28 legs' would add ~20 s to phase 10 for the same
    resampler."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.io import mkv, smff
    from mediastreamer2_tpu_torch.io.wav import read_wav, write_wav
    from mediastreamer2_tpu_torch.models import media_player as mpm
    from mediastreamer2_tpu_torch.ops import host_codecs
    from mediastreamer2_tpu_torch.ops.g711 import float_to_pcm16, ulaw_encode
    from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff
    t0 = time.perf_counter()
    files = []
    for j, leg in enumerate(legs):
        x = rec[leg]
        base = os.path.join(directory, f"rec{leg:04d}")
        write_wav(base + ".wav", x, 16000)
        w = smff.SmffWriter(base + ".smff", [smff.SmffTrack(smff.KIND_AUDIO, "pcm16", 16000, 1)])
        pcm = np.clip(x * 32768.0, -32768, 32767).astype("<i2")
        for k in range(0, len(pcm), S16):
            w.write_frame(0, k // 16, pcm[k:k + S16].tobytes())
        w.close()
        if j % 2:
            codes = ulaw_encode(float_to_pcm16(torch.from_numpy(x))).to(torch.uint8).numpy()
            track = mkv.MkvTrack(1, mkv.TRACK_TYPE_AUDIO, "A_MS/ACM", sampling_rate=16000,
                                 channels=1, codec_private=struct.pack(
                                     "<HHIIHHH", 7, 1, 16000, 16000, 1, 8, 0))
            data, step = codes.tobytes(), S16
        else:
            track = mkv.MkvTrack(1, mkv.TRACK_TYPE_AUDIO, "A_PCM/INT/LIT", sampling_rate=16000,
                                 channels=1)
            data, step = pcm.tobytes(), 2 * S16
        w = mkv.MkvWriter(base + ".mkv", [track])
        for k in range(0, len(data), step):
            w.write_frame(1, 10 * k // step, data[k:k + step])
        w.close()
        files += [base + ".wav", base + ".smff", base + ".mkv"]
    content = {}
    for path in files:                      # the files' content, read on the host
        if path.endswith(".wav"):
            content[path] = read_wav(path)[0]
        elif path.endswith(".smff"):
            content[path] = mpm._read_smff_audio(path)[0]
        else:
            content[path] = mpm._read_mkv_audio(path, "cpu")[0]
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bad, eof_counts = [], set()
    for path in files:
        out, eofs = play_to_eof(dev, path)
        want = content[path]
        eof_counts.add(eofs)
        if not (np.array_equal(out[:len(want)], want) and not out[len(want):].any()
                and eofs == 1):
            bad.append(os.path.basename(path))
    play_s = time.perf_counter() - t0
    # through the resampler: the card against the CPU
    resampled = 0.0
    for path in files[:6]:
        outs = [play_to_eof(d, path, out_rate=48000)[0] for d in ("cpu", dev)]
        resampled = max(resampled, float(np.abs(outs[0] - outs[1]).max()))
    # pause holds the position, seek moves it, loop wraps
    held, sought, looped, loop_eofs, duration = player_controls(dev, files[0])
    controls_ok = (held[0] == held[1] and 100 <= held[0] < duration and sought == 1000
                   and loop_eofs >= 1 and 0 <= looped < 200)
    # MediaRecorder on the card: 200 ticks of int16-grid speech
    sig = np.round(speech_legs(1, S16 * RECORDER_TICKS, seed=600, rate=16000)[0] * 32767) / 32768
    recorder = mpm.MediaRecorder(Factory(), rate=16000, max_seconds=3, device=dev)
    recorder.set_input(lambda t: sig[t * S16:(t + 1) * S16])
    recorder.ticker.realtime = False
    recorder.run(RECORDER_TICKS)
    back = {}
    for ext in (".wav", ".smff"):
        path = recorder.stop_and_save(os.path.join(directory, "recorder" + ext))
        back[ext] = read_wav(path)[0] if ext == ".wav" else mpm._read_smff_audio(path)[0]
    rec_ok = all(np.array_equal(v, sig.astype(np.float32)) for v in back.values())
    mkv_path = os.path.join(directory, "recorder.mkv")
    if host_codecs.opus_available():
        recorder.stop_and_save(mkv_path)
        opus = audio_diff(sig, play_to_eof(dev, mkv_path)[0])[0]
        mkv_line = f"Opus round trip audio_diff {opus:.4f} (bar {OPUS_RECORDER_BAR})"
        mkv_ok = opus > OPUS_RECORDER_BAR
    else:
        try:
            recorder.stop_and_save(mkv_path)
            err = None
        except RuntimeError as e:
            err = str(e)
        mkv_ok = err is not None and "libopus" in err and not os.path.exists(mkv_path)
        mkv_line = (f"no libopus: .mkv raised RuntimeError({err!r}), file written "
                    f"{os.path.exists(mkv_path)}")
    print(f"files 10b: {len(legs)} recordings of 10a (legs {legs[:3]} ...) as WAV, SMFF pcm16 and "
          f"MKV (A_PCM / A_MS/ACM mu-law) written and read in {write_s:.1f} s; {len(files)} "
          f"files played to EOF by MediaPlayer on the card in {play_s:.1f} s: not equal to the "
          f"file's content {bad}, EOF events a file {sorted(eof_counts)}; 48 kHz through the "
          f"resampler (legs {legs[:2]}'s 6 files), card vs CPU max abs err {resampled:.2e} "
          f"(bar 1e-5); paced: pause held "
          f"{held} ms, seek to 1000 ms while paused -> {sought} ms, loop from {duration - 25} "
          f"ms -> {looped} ms after 100 ms (EOF events {loop_eofs}); MediaRecorder on "
          f"the card, {RECORDER_TICKS} ticks: .wav and .smff read back equal {rec_ok}; "
          f"{mkv_line} [{card}]", flush=True)
    if bad or eof_counts != {1} or resampled > 1e-5 or not (controls_ok and rec_ok and mkv_ok):
        raise AssertionError(f"files 10b: unequal {bad}, EOF counts {eof_counts}, resampled "
                             f"{resampled}, controls {held} {sought} {looped} {loop_eofs}, "
                             f"recorder {rec_ok}, mkv {mkv_ok}")


def captured_cross(dev, legs, ticks, directory):
    """Phase 10c: ``legs`` captures of ``ticks`` ticks built as 10a's (their
    own, short enough that the lossy legs' lost and late packets fall inside
    the run) and replayed on the CPU (plain versions) and on the card
    (kernels): (the captures, [the replay on the CPU, on the card])."""
    caps = g722_captures(dev, legs, ticks, seed=500, directory=directory)
    return caps, [replay_captures(d, caps, legs, ticks) for d in (torch.device("cpu"), dev)]


# -- phase 11: negotiated calls -----------------------------------------------
def raise_nofile(need, phase="11"):
    """Raise the soft RLIMIT_NOFILE to the hard one (11a opens 2,048
    CallSetup sockets and the edges' beside what the process holds, 13a
    2,048 UDP sockets and four for its pumps); prints both and fails when
    the hard limit cannot hold ``need`` descriptors."""
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    target = hard if hard != resource.RLIM_INFINITY else max(soft, 1 << 20)
    with contextlib.suppress(ValueError, OSError):
        resource.setrlimit(resource.RLIMIT_NOFILE, (target, hard))
    now = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    print(f"RLIMIT_NOFILE: soft {soft} -> {now}, hard {hard}; phase {phase} needs about "
          f"{need}", flush=True)
    if now < need:
        raise AssertionError(f"phase {phase}: the file-descriptor limit ({now}, hard {hard}) "
                             f"cannot hold the {need} descriptors it opens")


def open_calls(n, dtls_calls, trickle=(), wrong_fingerprint=False):
    """``n`` calls, each a pair of ``CallSetup`` over localhost UDP, the
    client controlling and the server controlled, every socket with its own
    1 MiB receive buffer: calls below ``dtls_calls`` agree their keys by
    DTLS-SRTP (each side's a=fingerprint from the other's
    ``local_fingerprint()``), the rest by ZRTP. Each client offers
    ``local_capabilities()`` with G722 first and each server answers with
    ``negotiate(offer, local_capabilities())``. The calls in ``trickle``
    start with no remote candidate (trickle ICE; ``drive_setup`` adds them).
    ``wrong_fingerprint``: one side of every call (the client on even calls,
    the server on odd ones) expects a fingerprint that is not its peer's."""
    from mediastreamer2_tpu_torch.models.call_setup import CallSetup
    from mediastreamer2_tpu_torch.models.offer_answer import local_capabilities, negotiate
    calls = SimpleNamespace(pairs=[], answers=[], trickle=set(trickle), offer=None)
    try:
        for i in range(n):
            ka = "dtls" if i < dtls_calls else "zrtp"
            pair = (CallSetup(controlling=True, key_agreement=ka),
                    CallSetup(controlling=False, key_agreement=ka))
            calls.pairs.append(pair)
            for setup in pair:
                setup.sock.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
            client, server = pair
            offer = sorted(local_capabilities(), key=lambda pt: pt.mime != "G722")
            calls.offer = offer
            calls.answers.append(negotiate(offer, local_capabilities()))
            if i < dtls_calls:
                wrong = ":".join(["00"] * 32)
                client.set_remote_fingerprint(wrong if wrong_fingerprint and i % 2 == 0
                                              else server.local_fingerprint())
                server.set_remote_fingerprint(wrong if wrong_fingerprint and i % 2
                                              else client.local_fingerprint())
            for me, peer in (pair, pair[::-1]):
                me.set_remote(*peer.local_credentials(),
                              [] if i in calls.trickle else [("127.0.0.1", peer.sock.local_port)],
                              trickle=i in calls.trickle)
    except BaseException:
        close_calls(calls)
        raise
    return calls


def close_calls(calls):
    for pair in calls.pairs:
        for setup in pair:
            setup.close()


def call_state(i, pair):
    """One line of a call's state, for a call that stalls."""
    out = []
    for who, setup in zip(("client", "server"), pair):
        sec = ("dtls established" if setup.dtls.is_established else "dtls handshaking") \
            if setup.dtls is not None else f"zrtp {setup.zrtp.state}"
        out.append(f"{who} ice {setup.ice.state}, {sec}, keys {setup.srtp_keys is not None}, "
                   f"demuxed {setup.demuxed}")
        if setup.security_failed:
            out[-1] += ", security failed"
    return f"call {i}: " + "; ".join(out)


def drive_setup(calls, deadline_s, done=lambda pair: pair[0].ready and pair[1].ready):
    """Each pending call's two ``iterate()``s in turn, round after round with
    no sleep, until ``done`` holds for every call; the trickled calls'
    candidates (and their end-of-candidates) arrive after the third
    round. Returns the seconds and rounds to every check list's ICE
    completion and to the end, the round times (ms) and the seconds spent
    in the iterate()s of the DTLS-SRTP and of the ZRTP calls; a call not
    done within ``deadline_s`` is printed by its index and state, and the
    run fails."""
    from mediastreamer2_tpu_torch.net.ice import IS_COMPLETED
    pending = list(range(len(calls.pairs)))
    spent = {"dtls": 0.0, "zrtp": 0.0}
    t0 = time.perf_counter()
    rounds, ice, round_ms = 0, None, []
    while pending and time.perf_counter() - t0 < deadline_s:
        t = time.perf_counter()
        for i in pending:
            kind = "dtls" if calls.pairs[i][0].dtls is not None else "zrtp"
            u = time.perf_counter()
            for setup in calls.pairs[i]:
                setup.iterate()
            spent[kind] += time.perf_counter() - u
        rounds += 1
        round_ms.append(1e3 * (time.perf_counter() - t))
        if rounds == 3:
            for i in calls.trickle:
                for me, peer in (calls.pairs[i], calls.pairs[i][::-1]):
                    me.add_candidate("127.0.0.1", peer.sock.local_port)
                    me.end_of_candidates()
        if ice is None and all(setup.ice.state == IS_COMPLETED
                               for pair in calls.pairs for setup in pair):
            ice = (time.perf_counter() - t0, rounds)
        pending = [i for i in pending if not done(calls.pairs[i])]
    seconds = time.perf_counter() - t0
    if pending:
        for i in pending[:16]:
            print(call_state(i, calls.pairs[i]), flush=True)
        raise AssertionError(f"call setup: {len(pending)} of {len(calls.pairs)} calls not done "
                             f"after {seconds:.1f} s and {rounds} rounds")
    return SimpleNamespace(seconds=seconds, rounds=rounds, ice=ice, round_ms=round_ms,
                           spent=spent)


def check_setup(calls):
    """11a's and 11b's setup bars: every answer leads with G722/8000 PT 9,
    every call ready with a nominated selected pair on both check lists,
    each client's keys the mirror of its server's, both naming one suite
    (a DTLS-SRTP profile's for DTLS, AES_CM_128_HMAC_SHA1_80 for ZRTP),
    equal SAS strings on every ZRTP call. Returns the suites a call."""
    from mediastreamer2_tpu_torch.net.dtls import PROFILE_SUITES
    from mediastreamer2_tpu_torch.models.audio_stream import PAYLOAD_TYPES
    dtls_suites = {suite for suite, _, _ in PROFILE_SUITES.values()}
    bad = []
    for i, ((client, server), answer) in enumerate(zip(calls.pairs, calls.answers)):
        first = answer[0] if answer else None
        if first is None or (first.mime, first.clock_rate, first.number) != (
                "G722", 8000, PAYLOAD_TYPES["g722"]):
            bad.append(f"call {i}: answer leads with {first}")
        if not (client.ready and server.ready):
            bad.append(call_state(i, (client, server)))
            continue
        for setup in (client, server):
            sel = setup.check_list.selected
            if sel is None or not sel.nominated:
                bad.append(f"call {i}: no nominated selected pair")
        ck, sk = client.srtp_keys, server.srtp_keys
        if ck[:2] != sk[2:] or ck[2:] != sk[:2]:
            bad.append(f"call {i}: the client's keys do not mirror the server's")
        want = dtls_suites if client.dtls is not None else {"AES_CM_128_HMAC_SHA1_80"}
        if client.srtp_suite != server.srtp_suite or client.srtp_suite not in want:
            bad.append(f"call {i}: suites {client.srtp_suite} / {server.srtp_suite}")
        if client.zrtp is not None and (client.sas is None or client.sas != server.sas):
            bad.append(f"call {i}: SAS {client.sas} / {server.sas}")
    if bad:
        raise AssertionError(f"call setup: {len(bad)} faults: " + "; ".join(bad[:8]))


def setup_line(calls, st):
    """The setup's timings and counts, for 11a's and 11b's lines."""
    n = len(calls.pairs)
    ms = sorted(st.round_ms)
    ice = (f"{st.ice[0]:.3f} s, {st.ice[1]} rounds, the last handshake done "
           f"{st.seconds - st.ice[0]:.3f} s and {st.rounds - st.ice[1]} rounds after it"
           if st.ice else "not reached")
    setups = [setup for pair in calls.pairs for setup in pair]
    demux = {k: sum(setup.demuxed[k] for setup in setups) for k in ("stun", "dtls", "zrtp", "media")}
    checks = sum(setup.check_list.checks_sent for setup in setups)
    resent = sum(setup.check_list.retransmits for setup in setups)
    crc = sum(setup.zrtp.crc_seconds for setup in setups if setup.zrtp is not None)
    return (f"ICE completed on every check list in {ice}; every call ready in "
            f"{st.seconds:.3f} s, {st.rounds} rounds ({n / st.seconds:.1f} calls a second; a "
            f"round {ms[len(ms) // 2]:.3f} ms median, {ms[-1]:.3f} ms max); ICE checks sent "
            f"{checks}, retransmitted {resent}; iterate() seconds: DTLS-SRTP calls "
            f"{st.spent['dtls']:.3f}, ZRTP calls {st.spent['zrtp']:.3f} (ZRTP's framing, nearly "
            f"all its per-byte CRC-32C, {crc:.3f}); packets demuxed {demux}")


def negotiated_calls(kernels, dev, card, n, ticks):
    """Phase 11a: ``n`` calls set up over localhost UDP (the first half
    DTLS-SRTP, the second ZRTP), then the secured wideband session (8a) at
    ``n`` + ``n`` legs on their negotiated keys and suites for ``ticks``
    tick pairs, then REFUSED_CALLS DTLS calls with a wrong fingerprint.
    Returns the launches of the counted media run."""
    t0 = time.perf_counter()
    calls = open_calls(n, dtls_calls=n // 2)
    try:
        opened = time.perf_counter() - t0
        print("capabilities offered (G722 first): " + ", ".join(
            f"{pt.mime}/{pt.clock_rate} PT {pt.number}" for pt in calls.offer), flush=True)
        st = drive_setup(calls, SETUP_DEADLINE_S)
        check_setup(calls)
        n_dtls = sum(client.dtls is not None for client, _ in calls.pairs)
        print(f"call setup 11a: {n} calls over localhost UDP ({n_dtls} DTLS-SRTP, "
              f"{n - n_dtls} ZRTP; opened, offered and answered in {opened:.3f} s): "
              f"{setup_line(calls, st)}; every answer G722/8000 PT 9, keys mirrored, suites "
              f"agreed, ZRTP SAS equal [{card}]", flush=True)
        launches = session_edge(kernels, dev, card, n, ticks, phase="11a", codec="g722",
                                rate=16000, calls=calls)
    finally:
        close_calls(calls)
    refused_calls(REFUSED_CALLS, card)
    return launches


def refused_calls(n, card):
    """11a's refused calls: ``n`` DTLS calls, one side of each expecting a
    wrong fingerprint, driven until that side has finished its handshake:
    it must end with security_failed, no srtp_keys and media_transport()
    raising."""
    calls = open_calls(n, dtls_calls=n, wrong_fingerprint=True)
    try:
        wrong = [pair[i % 2] for i, pair in enumerate(calls.pairs)]
        st = drive_setup(calls, REFUSED_DEADLINE_S,
                         done=lambda pair: any(s.security_failed for s in pair))
        bad = []
        for i, setup in enumerate(wrong):
            try:
                setup.media_transport()
                refused = False
            except AssertionError:
                refused = True
            if not (setup.security_failed and setup.srtp_keys is None and refused
                    and not setup.ready):
                bad.append(call_state(i, calls.pairs[i]))
        print(f"call setup 11a, refused: {n} DTLS calls, each with a wrong expected fingerprint "
              f"on one side, handshakes done in {st.seconds:.3f} s: security failed on "
              f"{sum(s.security_failed for s in wrong)}, keys on {sum(s.srtp_keys is not None for s in wrong)}, "
              f"media_transport() refused on {n - len(bad)} [{card}]", flush=True)
        if bad:
            raise AssertionError("refused calls: " + "; ".join(bad))
    finally:
        close_calls(calls)


def one_socket_session(dev, legs, max_ticks):
    """11b's configuration: ``legs`` calls set up (the first half DTLS-SRTP,
    the rest ZRTP, the last by trickle ICE), then 8b's session with each
    leg's transport its call's ``media_transport()``; every packet the
    media views hand on is checked to be RTP or RTCP (``leaked`` counts
    any other). Returns (session, quality indicators, calls, setup
    timings, leaked)."""
    from mediastreamer2_tpu_torch.net import dtls, stun, zrtp
    calls = open_calls(legs, dtls_calls=legs // 2, trickle=(legs - 1,))
    try:
        st = drive_setup(calls, SETUP_DEADLINE_S)
        check_setup(calls)
        sess, qis = secure_session(dev, legs, max_ticks, seed=130, calls=calls)
    except BaseException:
        close_calls(calls)
        raise
    leaked = [0]
    for stream in (sess.clients, sess.server):
        for rtp in stream.sessions:
            view = rtp.transport.inner
            recv = view.recv_all

            def checked(recv=recv):
                pkts = recv()
                leaked[0] += sum(stun.is_stun(p) or dtls.is_dtls(p) or zrtp.is_zrtp(p)
                                 or len(p) < 12 or p[0] >> 6 != 2 for p in pkts)
                return pkts
            view.recv_all = checked
    return sess, qis, calls, st, leaked


def one_socket_calls(dev, card, legs):
    """Phase 11b: 11b's configuration, alternating do_ticks with iterate()
    every 10 rounds as 8b, every CallSetup's iterate() after every round
    (ICE keepalives and late handshake records are demuxed on the port the
    media rides), until SECURE_MIN_S and SECURE_MIN_TICKS."""
    sess, qis, calls, st, leaked = one_socket_session(dev, legs, ONE_SOCKET_MAX_TICKS)
    try:
        def between():
            for pair in calls.pairs:
                for setup in pair:
                    setup.iterate()
        ran, wall, ms = secure_rounds(sess, "11b", ONE_SOCKET_MAX_TICKS, between)
        ok, line = sess.check(conf_step=1)
        rep = secure_report(sess, qis)
        print(f"session 11b: {legs} + {legs} legs, G.722 at 16 kHz over each call's nominated "
              f"socket ({legs // 2} DTLS-SRTP, {legs - legs // 2} ZRTP, call {legs - 1} by "
              f"trickle ICE): setup {setup_line(calls, st)}; RTCP every {RTCP_INTERVAL_S} s, "
              f"quality indicator and bitrate controller on every leg, {ran} rounds in "
              f"{wall:.2f} s ({ms:.3f} ms per tick pair, host clock): {rep.line}; packets "
              f"other than RTP or RTCP handed to a jitter buffer {leaked[0]}; {line} [{card}]",
              flush=True)
    finally:
        close_calls(calls)
    if rep.unreported or rep.no_rtt or rep.auth or leaked[0]:
        raise AssertionError(f"session 11b: unreported {rep.unreported[:4]}, no RTT "
                             f"{rep.no_rtt[:4]}, auth failures {rep.auth}, non-media packets "
                             f"on the media path {leaked[0]}")
    if not ok:
        raise AssertionError("session 11b: listener bars not met")


# -- phase 12: the video call ------------------------------------------------
def video_formats(cam, out, fps):
    from mediastreamer2_tpu_torch import Format
    return (Format(kind="yuv420", width=cam[0], height=cam[1], fps=fps),
            Format(kind="yuv420", width=out[0], height=out[1], fps=fps))


def video_tick_bytes(legs, cam, out):
    """(device bytes, bytes each way over PCIe) of one 12a tick, each tensor
    of the pixel path written once and read once: the mire's f32 frame
    (written, read by size_conv), the QVGA f32 frame (written, read by the
    u8 conversion), the u8 tx block (written), the u8 rx block (read), its
    f32 conversion (written) and luma (read by analyse_display)."""
    cam_f32 = legs * cam[1] * 3 // 2 * cam[0] * 4
    out_u8 = legs * out[1] * 3 // 2 * out[0]
    out_f32 = 4 * out_u8
    luma = legs * out[1] * out[0] * 4
    return 2 * cam_f32 + 3 * out_f32 + 2 * out_u8 + luma, out_u8


def video_stream(dev, legs, cam, out, fps, **kw):
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.models.video_stream import VideoStreamBatch
    fmt, ofmt = video_formats(cam, out, fps)
    vs = VideoStreamBatch(Factory(), legs, fmt=fmt, out_fmt=ofmt, fps=fps, device=dev, **kw)
    vs.ticker.realtime = False
    return vs


def video_split(vs, dev, n):
    """12a's device split of a tick (ms): ``n`` ticks' upload (the rx u8
    block from the ticker's pinned slot), step (the stream's u8 step) and
    readback (the tx u8 block into its pinned slot), enqueued behind a
    spin so the device runs them back to back, each bracketed by CUDA
    events on the ticker's stream; the mean of each over ``n``."""
    tk = vs.ticker
    rx_host, tx_host = tk._slots[0]["in:rx_frames"], tk._slots[0]["out:tx_frames"]
    evs = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(n)]
    tk.sync()
    with tk.on_stream():
        torch.cuda._sleep(200_000_000)                       # ~0.1 s: the host enqueues ahead
        for e in evs:
            e[0].record()
            rx = rx_host.to(dev, non_blocking=True)
            e[1].record()
            _, o, _ = tk._step(tk.state, tk.params, {"rx_frames": rx})
            e[2].record()
            tx_host.copy_(o["tx_frames"], non_blocking=True)
            e[3].record()
    tk.sync()
    return {name: sum(e[i].elapsed_time(e[i + 1]) for e in evs) / n
            for i, name in enumerate(("upload", "step", "readback"))}


def video_pixel_path(kernels, dev, card, legs, ticks, cam=VIDEO_CAM, out=VIDEO_OUT,
                     fps=VIDEO_FPS):
    """12a: ``legs`` legs of VideoStreamBatch (a ``cam`` mire sent at
    ``out``, no sessions; leg i's mire starts at frame i, as cameras
    started apart), ``ticks`` unpaced do_ticks, each tick's rx block the
    previous tick's tx block. Bars: legs 0, 37, ... of the tx frames within
    one u8 code of the port on the CPU at ticks 0, 25, ... and the last
    (the CPU's stream set to the same frame indices and stepped once for
    each: the mire's frame is a function of its index); every leg's
    ``frame_mean`` event within VIDEO_MEAN_TOL of numpy's mean of the luma
    it was fed. Prints ms/tick, the device split, the hand kernels'
    launches a tick, bytes a tick and peak memory. Returns the launches."""
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)               # the context exists before its stats reset
        torch.cuda.reset_peak_memory_stats(dev)
    vs = video_stream(dev, legs, cam, out, fps)
    tk = vs.ticker
    sampled = list(range(0, legs, VIDEO_SAMPLE_STEP))
    checked = set(range(0, ticks, VIDEO_CHECK_EVERY)) | {ticks - 1}
    fed = [vs._last_rx_u8]
    tx_kept, want_mean, got_mean = {}, {}, {}

    def pull(tick):
        ext = vs._pull(tick)
        ext["rx_frames"] = fed[0]
        if tick in checked:
            want_mean[tick] = fed[0][:, :out[1]].mean(axis=(1, 2)) / 255.0
        return ext

    def push(tick, ext_out):
        vs._push(tick, ext_out)
        fed[0] = ext_out["tx_frames"]
        if tick in checked:
            tx_kept[tick] = ext_out["tx_frames"][sampled].copy()

    def on_mean(ev):                  # a leg whose mean is 0 posts no event
        got_mean.setdefault(ev.tick, np.zeros(legs))[ev.leg] = ev.value

    tk.event_queue.set_handler("display.frame_mean", on_mean)
    tk.set_io(pull=pull, push=push)
    start = torch.arange(legs, dtype=torch.int32)
    tk.mutate(lambda t: t.state["cam"]["frame_idx"].copy_(start))
    tk.warm_up()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(ticks):
        tk.do_tick()
        tk.event_queue.pump()
    tk.drain()
    tk.sync()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    split = video_split(vs, dev, VIDEO_TIMED_TICKS) if cuda else None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    phases = {k: round(tk.phase_ms[k] / ticks, 3) for k in ("pull", "dispatch", "publish")}
    del vs, tk, fed
    # the port on the CPU at the sampled legs' frame indices of each tick
    ref = video_stream("cpu", len(sampled), cam, out, fps)
    ref_tx = {}
    for t in sorted(checked):
        ref.ticker.state["cam"]["frame_idx"].copy_(start[sampled] + t)
        ref.ticker.set_io(pull=ref._pull, push=lambda tick, ext, t=t: ref_tx.__setitem__(
            t, ext["tx_frames"]))
        ref.ticker.do_tick()
    diff = np.stack([np.abs(tx_kept[t].astype(np.int16) - ref_tx[t].astype(np.int16))
                     for t in sorted(checked)])
    mean_err = max(float(np.abs(got_mean.get(t, np.zeros(legs)) - want_mean[t]).max())
                   for t in checked)
    nbytes, pcie = video_tick_bytes(legs, cam, out)
    split_line = ("not measured (CPU)" if split is None else
                  f"upload {split['upload']:.3f}, step {split['step']:.3f} "
                  f"({nbytes / split['step'] / 1e6:.1f} GB/s of the bytes below), readback "
                  f"{split['readback']:.3f} ms")
    print(f"video 12a: {legs} legs, a {cam[0]}x{cam[1]} mire sent at {out[0]}x{out[1]}, "
          f"{ticks} unpaced ticks through Ticker.do_tick, each tick's rx the previous tx: "
          f"{1e3 * wall / ticks:.3f} ms/tick (host clock; host phases ms/tick {phases}); "
          f"device split a tick ({VIDEO_TIMED_TICKS} ticks back to back, CUDA events): "
          f"{split_line}; launches a tick "
          f"{ {k: v / ticks for k, v in launches.items()} } (the pixel path is PyTorch "
          f"ops, no hand kernel); device bytes a tick {nbytes / 1e6:.1f} MB, PCIe "
          f"{pcie / 1e6:.1f} MB each way; peak memory "
          f"{'not measured (CPU)' if peak is None else f'{peak / 1e9:.2f} GB'}; tx frames of "
          f"legs 0, {VIDEO_SAMPLE_STEP}, ... against the CPU at ticks {sorted(checked)}: max "
          f"diff {int(diff.max())} code, {100 * float((diff > 0).mean()):.4f}% of pixels "
          f"differ; frame_mean max error {mean_err:.2e} [{card}]", flush=True)
    if diff.max() > 1:
        raise AssertionError(f"video 12a: tx frames differ from the CPU by {int(diff.max())} codes")
    if mean_err > VIDEO_MEAN_TOL:
        raise AssertionError(f"video 12a: frame_mean off numpy's mean by {mean_err:.3e}")
    if any(launches.values()):
        raise AssertionError(f"video 12a: hand kernels launched on the pixel path: {launches}")
    return launches


def video_e2e_run(dev, card, legs, seconds, warmup, size, fps, paced, frame_tick, depth=0):
    """One VideoE2EBench run: ``legs`` legs of the dummy codec, each
    self-looped over its own localhost UDP socket, ``warmup`` s then
    ``seconds`` s; with ``frame_tick`` the ticker beats once a frame
    (1000 / fps ms) instead of every 10 ms; with a ``depth`` the ticker
    keeps that many ticks in flight and publishes them (the RTP sends and
    receives) on its publish worker. Returns (result, bench); the caller
    closes the bench."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.models.video_e2e_bench import VideoE2EBench
    b = VideoE2EBench(Factory(), legs, codec=None, width=size[0], height=size[1], fps=fps,
                      pipeline_depth=depth, frame_tick=frame_tick, device=dev)
    count = lambda: sum(s.stats.sent_packets + s.stats.recv_packets     # noqa: E731
                        for s in b.vs.sessions)
    t0, n0 = time.perf_counter(), count()
    res = b.run(seconds=seconds, paced=paced, warmup_seconds=warmup)
    pps = (count() - n0) / (time.perf_counter() - t0)
    ph = b.vs.ticker.phase_ms
    n = b.vs.ticker.stats.ticks
    print(f"video 12b: {legs} legs of the dummy codec at {size[0]}x{size[1]}, {fps:g} fps, "
          f"self-looped over localhost UDP, a tick every {b.vs.ticker.interval_ms:.2f} ms, "
          f"pipeline depth {depth}, {threading.active_count()} threads, {warmup:g} s + {seconds:g} s {'paced' if paced else 'unpaced'}: "
          f"{res.ms_per_tick:.3f} ms/tick, late ticks {res.late_ticks} of {res.ticks}, fps "
          f"received min {res.fps_received_min:.3f} / mean {res.fps_received_mean:.3f} of "
          f"{res.fps_nominal:g}, luma {res.luma_ok}, packets sent + received {pps:.0f} a "
          f"second, host ms/tick pull {ph['pull'] / n:.3f} (max {ph['pull_max']:.3f}), "
          f"dispatch {ph['dispatch'] / n:.3f}, publish {ph['publish'] / n:.3f} (max "
          f"{ph['publish_max']:.3f}), passes {res.passes()} [{card}]", flush=True)
    return res, b


def video_e2e(dev, card, legs, seconds=VIDEO_E2E_SECONDS, warmup=VIDEO_E2E_WARMUP_S,
              size=VIDEO_E2E_SIZE, fps=VIDEO_E2E_FPS, paced=True):
    """12b: ``video_e2e_run`` at the reference's 10 ms tick (printed, no
    bar: every frame is 84 packets a leg through per-leg Python, more than
    a 10 ms tick holds on the card's host), then a tick a frame at
    pipeline depth ``VIDEO_E2E_DEPTH`` (the JAX package's bench.py runs
    the bench so: the packet I/O on the publish worker, off the ticker's
    beat), whose bar is ``passes()``; then that bench's
    ``run_loss_recovery()`` (a burst on leg 0, FIR, keyframe, decoding
    again), which must return True."""
    _, b = video_e2e_run(dev, card, legs, seconds, warmup, size, fps, paced, frame_tick=False)
    b.close()
    res, b = video_e2e_run(dev, card, legs, seconds, warmup, size, fps, paced, frame_tick=True,
                           depth=VIDEO_E2E_DEPTH)
    try:
        st = b.vs.stats[0]
        fir0, kf0 = st.fir_sent, st.keyframes_sent
        t1 = time.perf_counter()
        recovered = b.run_loss_recovery()
        print(f"video 12b, loss recovery (a tick a frame): {recovered} in "
              f"{time.perf_counter() - t1:.2f} s (FIR {st.fir_sent - fir0}, keyframes "
              f"{st.keyframes_sent - kf0}) [{card}]", flush=True)
    finally:
        b.close()
    if not res.passes():
        raise AssertionError(f"video 12b: {res}")
    if not recovered:
        raise AssertionError("video 12b: no FIR, keyframe and decoding after the loss burst")


def refusal(make):
    """The message of the RuntimeError ``make()`` raises, or None."""
    try:
        make()
    except RuntimeError as e:
        return str(e)
    return None


def video_codec_refusals(dev, card):
    """12b: a VideoStreamBatch of each library codec: where phase 1's
    ``find_library`` finds no library it must raise naming it (no fallback
    to the dummy codec); where it finds one, the stream is made."""
    lines, bad = [], []
    for codec, so, lib in VIDEO_CODECS:
        found = ctypes.util.find_library(so)
        err = refusal(lambda: video_stream(dev, 1, (64, 48), (64, 48), 25.0, codec=codec))
        lines.append(f"{codec}: {so} {found}, " + (f"raised {err!r}" if err else "made"))
        if (found is None) != (err is not None) or (err is not None and lib not in err):
            bad.append(lines[-1])
    print(f"video 12b, library codecs: {'; '.join(lines)} [{card}]", flush=True)
    if bad:
        raise AssertionError(f"video 12b: codec legs {bad}")


def video_call(dev, legs, ticks, cam, out, fps):
    """``legs`` + ``legs`` legs (tx, rx) over LoopbackPair, ``ticks`` tick
    pairs: (frames received, rx u8 frames a tick [ticks, legs, ...],
    frame_mean events [(tick, leg, value)])."""
    from mediastreamer2_tpu_torch.net.rtp import LoopbackPair
    tx, rx = (video_stream(dev, legs, cam, out, fps) for _ in range(2))
    for leg in range(legs):
        pair = LoopbackPair()
        tx.set_transport(leg, pair.endpoint(0))
        rx.set_transport(leg, pair.endpoint(1))
    tx.bind_assemblers()
    rx.bind_assemblers()
    means, frames = [], []
    rx.ticker.event_queue.set_handler("display.frame_mean",
                                      lambda ev: means.append((ev.tick, ev.leg, ev.value)))
    for s in (tx, rx):
        s.ticker.warm_up()
    for _ in range(ticks):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
        rx.ticker.event_queue.pump()
        frames.append(rx._last_rx_u8.copy())
    return [s.frames_received for s in rx.stats], np.stack(frames), means


def video_cross(dev, card, legs=CROSS_VIDEO_LEGS, ticks=CROSS_VIDEO_TICKS, cam=VIDEO_CAM,
                out=VIDEO_OUT, fps=VIDEO_FPS):
    """12c: ``video_call`` on the CPU and on the card. Bars: equal frames
    received, received frames within one u8 code, frame_mean within
    1/255 on the same ticks and legs."""
    (c_rx, c_frames, c_means), (g_rx, g_frames, g_means) = (
        video_call(d, legs, ticks, cam, out, fps) for d in ("cpu", dev))
    diff = np.abs(c_frames.astype(np.int16) - g_frames.astype(np.int16))
    same_events = [m[:2] for m in c_means] == [m[:2] for m in g_means]
    mean_err = (max(abs(a[2] - b[2]) for a, b in zip(c_means, g_means))
                if same_events and c_means else float("inf"))
    print(f"video 12c: {legs} + {legs} legs, a {cam[0]}x{cam[1]} mire sent at "
          f"{out[0]}x{out[1]} over LoopbackPair, {ticks} tick pairs on the CPU and on the "
          f"card: frames received {c_rx} / {g_rx}, received frames max diff {int(diff.max())} "
          f"code ({100 * float((diff > 0).mean()):.4f}% of pixels), frame_mean events "
          f"{len(c_means)} / {len(g_means)}, max error {mean_err:.2e} [{card}]", flush=True)
    if c_rx != g_rx or min(g_rx) == 0:
        raise AssertionError(f"video 12c: frames received {c_rx} on the CPU, {g_rx} on the card")
    if diff.max() > 1 or mean_err > 1 / 255:
        raise AssertionError(f"video 12c: frames differ by {int(diff.max())} codes, frame_mean "
                             f"by {mean_err:.3e}")


# -- phase 13: the SFU and the call's side channels ---------------------------
SFU_CONFERENCES = 128         # phase 13a: 1,024 participants in conferences of 8
SFU_MEMBERS = 8
SFU_TOP_N = 3                 # AudioPacketRouter's default
SFU_TICKS = 100
SFU_SWITCH = 50               # member 3 rises, member 2 falls
SFU_GRACE = 10                # ticks the smoothed levels get to settle at the start
SFU_SETTLE = 20               # and after the switch (see sfu_speakers)
SFU_TALKERS = ((0, -12.0), (1, -15.0), (2, -18.0))     # (member, dBFS) before the switch
SFU_RISER = (3, -12.0)        # from SFU_SWITCH on; member 2 is then quiet
SFU_ROOM_DBFS = -45.0         # room noise on every member's microphone
SFU_SSRC = 0x9000             # participant i sends with SSRC SFU_SSRC + i
SFU_PT = 9                    # G.722
SFU_WAIT_S = 2.0              # the longest a tick waits for its datagrams
G722_SILENCE = 0xFA           # the G.722 code of digital silence from a fresh encoder
SFU_DRAIN_ROUNDS = 5          # 13a's drain comparison, each way
CROSS_SFU_TICKS = 60          # phase 13e
PUMP_SESSION_LEGS = 64        # phase 13b: 8b's configuration over UDP
VIDEO_ROUTER_MEMBERS = 8      # phase 13c
VIDEO_ROUTER_FPS = 15
VIDEO_ROUTER_GOP = 30         # an IDR every 30 frames
VIDEO_ROUTER_FOCUS_S = 2.0
VIDEO_ROUTER_SECONDS = 8.0
VIDEO_ROUTER_LOSS = 5.0       # percent, netsim's random loss
FEC_L, FEC_D = 5, 5
TEXT_PAIRS = 64               # phase 13d
TEXT_CHARS = 600
TEXT_PER_FLUSH = 3            # characters typed a 310 ms flush
TEXT_BURST = (10, 11, 12)     # the packets a burst of 3 loses


def sfu_mics(conferences, ticks, seed):
    """float32 [conferences * 8, ticks * 160] at 16 kHz: every member's
    microphone carries room noise at SFU_ROOM_DBFS (RMS); the talkers of
    SFU_TALKERS add speech (``utils/signals`` speech legs, each scaled to
    its level over the whole leg) until SFU_SWITCH, members 0 and 1 to the
    end and SFU_RISER's member from SFU_SWITCH on. The speech generator's
    1.3 Hz envelope reaches zero; with the room noise under every talker,
    no trough of a talker at -18 dBFS or louder falls below a silent
    member's level."""
    legs, n, cut = conferences * SFU_MEMBERS, ticks * S16, SFU_SWITCH * S16
    rng = np.random.default_rng(seed)
    mic = (rng.standard_normal((legs, n)) * 10 ** (SFU_ROOM_DBFS / 20)).astype(np.float32)
    speech = speech_legs(legs, n, seed=seed + 1, rate=16000)
    for member, db, span in ((*SFU_TALKERS[0], slice(None)), (*SFU_TALKERS[1], slice(None)),
                             (*SFU_TALKERS[2], slice(0, cut)), (*SFU_RISER, slice(cut, None))):
        rows = speech[member::SFU_MEMBERS]
        gain = 10 ** (db / 20) / np.sqrt((rows.astype(np.float64) ** 2).mean(axis=1))
        mic[member::SFU_MEMBERS, span] += (rows * gain[:, None].astype(np.float32))[:, span]
    return mic


def sfu_speakers(tick):
    """The members (within a conference) whose packets every other member
    must receive at ``tick`` by design, or None while the smoothed levels
    settle: SFU_GRACE ticks at the start, SFU_SETTLE after the switch.
    ``audio_levels`` smooths a member's energy by 0.7 a tick, so the talker
    who falls silent at the switch loses 1.55 dB a tick, from up to ~5 dB
    over its mean; a talker who goes on speaking pauses up to ~25 dB under
    its mean (the speech's 1.3 Hz envelope reaches zero), and from a -18
    dBFS talker to a -12 dBFS one's pause that decay takes up to ~16 ticks.
    Until then the router rightly ranks the fallen talker over the paused
    one; ``Sfu.level_failures`` holds every tick, these included, to the
    levels the server read."""
    if SFU_GRACE <= tick < SFU_SWITCH:
        return {member for member, _ in SFU_TALKERS}
    if tick >= SFU_SWITCH + SFU_SETTLE:
        return {SFU_TALKERS[0][0], SFU_TALKERS[1][0], SFU_RISER[0]}
    return None


class Sfu:
    """Phase 13a's audio SFU on ``dev``: ``conferences`` x 8 participants,
    an ``AudioPacketRouter(top_n=3)`` a conference.

    * Senders: a ``Ticker`` on ``dev`` runs ext_source (16 kHz) ->
      g722_enc -> ext_sink, one g722_encode launch a tick; the codes go out
      through the native batch edge (``BatchRtpTx``), participant i with
      SSRC SFU_SSRC + i, sequence number and tick equal, to the server's
      socket i.
    * Server: a ``UdpTransport`` a participant, all on one
      ``NativeIoPump``; a tick drains every socket through the pump, unpacks
      the packets, stacks the payloads into one [legs, 80] block (a missing
      one filled with G722_SILENCE), runs the server graph (ext_source codes
      -> g722_dec -> audio_levels -> ext_sink, a ``Ticker`` on ``dev``,
      the levels' energies read back with the tick), hands the energies to
      every router and routes every packet to its conference's others;
      the routers' sends are queued and sent after the routing, each from
      the server socket of the member it goes to.
    * Receivers: a ``UdpTransport`` a participant on a second pump; a tick
      drains them until each has what the server sent it, recording the
      sources it received and holding each payload to the speaker's codes.
    """

    def __init__(self, dev, conferences, ticks, seed=1300):
        from mediastreamer2_tpu_torch import Factory, Format, GraphBuilder
        from mediastreamer2_tpu_torch.core.ticker import Ticker
        from mediastreamer2_tpu_torch.native import BatchRtpTx, NativeIoPump
        from mediastreamer2_tpu_torch.net.router import AudioPacketRouter
        from mediastreamer2_tpu_torch.net.rtp import UdpTransport
        self.dev, self.conferences, self.ticks = dev, conferences, ticks
        self.legs = legs = conferences * SFU_MEMBERS
        self.mic = sfu_mics(conferences, ticks, seed)
        f = Factory()
        g = GraphBuilder(f, batch=legs)
        g.chain(g.add("ext_source", "pcm", fmt=Format(rate=16000)), g.add("g722_enc", "enc"),
                g.add("ext_sink", "codes"))
        self.sender = Ticker(g.build(), device=dev, realtime=False)
        self.sender.set_io(pull=lambda t: {"pcm": self.mic[:, t * S16:(t + 1) * S16]})
        g = GraphBuilder(f, batch=legs)
        g.chain(g.add("ext_source", "codes", fmt=Format(kind="g722", rate=8000)),
                g.add("g722_dec", "dec"), g.add("audio_levels", "levels"),
                g.add("ext_sink", "out"))
        self.graph = g.build()
        self.server = Ticker(self.graph, device=dev, realtime=False)
        self.server.readback_state = [("levels", "energy")]
        self.block = np.full((legs, S8), G722_SILENCE, np.uint8)
        self.server.set_io(pull=lambda t: {"codes": self.block})
        self.server_pump, self.client_pump = NativeIoPump(), NativeIoPump()
        self.srv, self.rcv, self.tx_sock, self.tx = [], [], None, None
        try:
            for _ in range(legs):
                self.srv.append(UdpTransport())
                self.rcv.append(UdpTransport())
            for s, r in zip(self.srv, self.rcv):
                s.attach_pump(self.server_pump)
                r.attach_pump(self.client_pump)
                s.set_remote("127.0.0.1", r.local_port)
            self.tx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self.tx_sock.bind(("127.0.0.1", 0))
            self.tx = BatchRtpTx(self.tx_sock, legs, S8)
            for i, s in enumerate(self.srv):
                self.tx.config(i, "127.0.0.1", s.local_port, SFU_SSRC + i, 0, 0, SFU_PT)
        except BaseException:
            self.close()
            raise
        self.outbox = []
        self.routers = []
        for c in range(conferences):
            r = AudioPacketRouter(top_n=SFU_TOP_N)
            for i in range(c * SFU_MEMBERS, (c + 1) * SFU_MEMBERS):
                r.add_member(i, lambda data, i=i: self.outbox.append((i, data)))
            self.routers.append(r)
        self.sent = np.zeros((ticks, legs, S8), np.uint8)      # every speaker's codes
        self.energies = np.zeros((ticks, legs), np.float32)
        self.routed = []          # [tick] -> [receiver] -> frozenset of source legs
        self.mismatched = 0       # forwarded payloads unequal to what was sent
        self.missing = 0          # server packets filled with silence
        self.undelivered = 0      # forwarded packets a receiver did not get in time
        self.stray = 0            # datagrams of another tick than the one drained
        self.ms = {k: [] for k in ("encode_send", "drain", "unpack", "step", "route",
                                   "sends", "receive")}
        for tk in (self.sender, self.server):
            tk.warm_up()

    def _drain(self, transports, want, tick):
        """Each transport's datagrams of ``tick`` until transport i has
        ``want[i]`` of them or SFU_WAIT_S passed: {i: [RtpPacket]} and the
        unpack time; datagrams of other ticks are counted as stray."""
        from mediastreamer2_tpu_torch.net.rtp import RtpPacket
        got = {i: [] for i in range(len(transports)) if want[i]}
        pending, unpack_s = list(got), 0.0
        end = time.perf_counter() + SFU_WAIT_S
        while pending:
            left = []
            for i in pending:
                data = transports[i].recv_all()
                if data:
                    t0 = time.perf_counter()
                    for d in data:
                        p = RtpPacket.unpack(d)
                        if p.seq == tick & 0xFFFF:
                            got[i].append(p)
                        else:
                            self.stray += 1
                    unpack_s += time.perf_counter() - t0
                if len(got[i]) < want[i]:
                    left.append(i)
            pending = left
            if pending and time.perf_counter() > end:
                break
        return got, unpack_s

    def tick(self, t):
        ms = self.ms
        t0 = time.perf_counter()
        codes = self.sender.do_tick()["codes"].astype(np.uint8)
        self.sent[t] = codes
        self.tx.send(codes, S8)
        t1 = time.perf_counter()
        got, unpack_s = self._drain(self.srv, [1] * self.legs, t)
        t2 = time.perf_counter()
        self.block[:] = G722_SILENCE
        pkts = {}
        for i, ps in got.items():
            if ps:
                pkts[i] = ps[0]
                self.block[i] = np.frombuffer(ps[0].payload, np.uint8)
        self.missing += self.legs - len(pkts)
        t3 = time.perf_counter()
        energy = self.server.do_tick()["levels.energy"]
        self.energies[t] = energy
        t4 = time.perf_counter()
        self.outbox.clear()
        for c, r in enumerate(self.routers):
            r.update_volumes(energy)
            for i in range(c * SFU_MEMBERS, (c + 1) * SFU_MEMBERS):
                if i in pkts:
                    r.route(i, pkts[i])
        t5 = time.perf_counter()
        want = [0] * self.legs
        for to, data in self.outbox:
            self.srv[to].send(data)
            want[to] += 1
        t6 = time.perf_counter()
        recv, recv_unpack_s = self._drain(self.rcv, want, t)
        heard = [frozenset()] * self.legs
        for i, ps in recv.items():
            self.undelivered += want[i] - len(ps)
            heard[i] = frozenset(p.ssrc - SFU_SSRC for p in ps)
            for p in ps:
                src = p.ssrc - SFU_SSRC
                if not (0 <= src < self.legs and p.payload == self.sent[t, src].tobytes()
                        and p.payload_type == SFU_PT):
                    self.mismatched += 1
        self.routed.append(heard)
        t7 = time.perf_counter()
        for k, d in (("encode_send", t1 - t0), ("drain", t2 - t1 - unpack_s),
                     ("unpack", t3 - t2 + unpack_s), ("step", t4 - t3), ("route", t5 - t4),
                     ("sends", t6 - t5), ("receive", t7 - t6)):
            ms[k].append(1e3 * d)

    def run(self):
        for t in range(self.ticks):
            self.tick(t)

    def route_failures(self, speakers_at=sfu_speakers):
        """[(tick, receiver, heard, expected)] for every tick where
        ``speakers_at(tick)`` names the speakers (None: no bar) and a member
        did not receive exactly their packets, itself left out."""
        bad = []
        for t, heard in enumerate(self.routed):
            speakers = speakers_at(t)
            if speakers is None:
                continue
            for i in range(self.legs):
                base = i - i % SFU_MEMBERS
                want = {base + m for m in speakers} - {i}
                if heard[i] != want:
                    bad.append((t, i, sorted(heard[i]), sorted(want)))
        return bad

    def level_failures(self):
        """[(tick, receiver, heard, expected)] for every tick where a member
        did not receive exactly the packets of its conference's SFU_TOP_N
        loudest by the energies the server read that tick (ties to the
        lower member, as the router's stable sort), itself left out."""
        bad = []
        for t, heard in enumerate(self.routed):
            for c in range(self.conferences):
                base = c * SFU_MEMBERS
                e = self.energies[t, base:base + SFU_MEMBERS]
                top = {base + int(m) for m in np.argsort(-e, kind="stable")[:SFU_TOP_N]}
                for i in range(base, base + SFU_MEMBERS):
                    if heard[i] != top - {i}:
                        bad.append((t, i, sorted(heard[i]), sorted(top - {i})))
        return bad

    def pump_counts(self):
        """(dropped, truncated) summed over every socket of both pumps."""
        pairs = [(pump, tr.sock) for pump, trs in ((self.server_pump, self.srv),
                                                   (self.client_pump, self.rcv)) for tr in trs]
        return (sum(pump.dropped(s) for pump, s in pairs),
                sum(pump.truncated(s) for pump, s in pairs))

    def drain_compare(self, rounds=SFU_DRAIN_ROUNDS):
        """The drain of every server socket, timed ``rounds`` times through
        the pump, then (the sockets taken off the pump) ``rounds`` times by
        a Python ``recv`` loop on the same sockets; each round drains one
        tick's datagrams, sent before and given 0.1 s to land. Returns the
        ms of each way's rounds and the datagrams each way read."""
        codes = self.sent[-1]
        out = {}
        for way in ("pump", "python"):
            if way == "python":
                for s in self.srv:
                    self.server_pump.remove_socket(s.sock)
            times, n = [], 0
            for _ in range(rounds):
                self.tx.send(codes, S8)
                time.sleep(0.1)
                t0 = time.perf_counter()
                if way == "pump":
                    for s in self.srv:
                        n += len(self.server_pump.read(s.sock))
                else:
                    for s in self.srv:
                        recv = s.sock.recv
                        while True:
                            try:
                                recv(65536)
                            except BlockingIOError:
                                break
                            n += 1
                times.append(1e3 * (time.perf_counter() - t0))
            out[way] = (times, n)
        return out

    def profile(self, iters=20):
        """``profile_nodes`` of the server graph on its own state and the
        last tick's codes (ms a node)."""
        tk = self.server
        tk.sync()
        with tk.on_stream():
            codes = torch.from_numpy(self.block.astype(np.int32)).to(tk.device)
            return self.graph.profile_nodes(tk.state, tk.params, {"codes": codes}, iters=iters)

    def close(self):
        for tr in (*self.srv, *self.rcv):
            tr.close()
        if self.tx is not None:
            self.tx.close()
        if self.tx_sock is not None:
            self.tx_sock.close()
        self.server_pump.close()
        self.client_pump.close()


def audio_sfu(kernels, dev, card, conferences, ticks):
    """Phase 13a: ``Sfu`` at ``conferences`` x 8 for ``ticks`` unpaced
    ticks, the launch counts set to 0 just before the run and read just
    after. Bars: the routed sources outside the grace windows, every
    forwarded payload equal to what its speaker sent, no packet missing,
    late or stray, the pumps' dropped and truncated counts 0, every energy
    finite, one g722_encode and one g722_decode launch a tick. Prints the
    tick's split, the drain through the pump against a Python loop and the
    server graph's ``profile_nodes``. Returns (launches, first conference's
    ranks at the last tick, the Sfu's energies)."""
    raise_nofile(2 * conferences * SFU_MEMBERS + 256, phase="13a")
    t_build = time.perf_counter()
    sfu = Sfu(dev, conferences, ticks)
    try:
        build_s = time.perf_counter() - t_build
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        sfu.run()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        bad = sfu.route_failures()
        off_levels = sfu.level_failures()
        settling = sfu.route_failures(   # the design's ticks in SFU_SETTLE, no bar
            lambda t: sfu_speakers(SFU_SWITCH + SFU_SETTLE)
            if SFU_SWITCH + SFU_GRACE <= t < SFU_SWITCH + SFU_SETTLE else None)
        dropped, truncated = sfu.pump_counts()
        drains = sfu.drain_compare()
        prof = sfu.profile()
    finally:
        sfu.close()
    legs = sfu.legs
    finite = bool(np.isfinite(sfu.energies).all())
    fwd = sum(len(h) for heard in sfu.routed for h in heard)
    levels = 10 * np.log10(sfu.energies[-1, :SFU_MEMBERS].astype(np.float64) + 1e-20)
    ranks = [int(i) for i in np.argsort(-sfu.energies[-1, :SFU_MEMBERS], kind="stable")]
    per_tick = {k: launches[k] / ticks for k in ("g722_encode", "g722_decode")}
    drain_line = "; ".join(f"{way} median {np.median(ts):.3f} ms (min {min(ts):.3f}, max "
                           f"{max(ts):.3f}, {n} datagrams)" for way, (ts, n) in drains.items())
    print(f"sfu 13a: {conferences} conferences x {SFU_MEMBERS} = {legs} participants, "
          f"AudioPacketRouter(top_n={SFU_TOP_N}), {ticks} unpaced ticks in {wall:.2f} s "
          f"({1e3 * wall / ticks:.3f} ms a tick; built in {build_s:.2f} s): ms a tick "
          f"{', '.join(f'{k} {np.mean(v):.3f}' for k, v in sfu.ms.items())}; launches a tick g722_encode {per_tick['g722_encode']:g}, "
          f"g722_decode {per_tick['g722_decode']:g}; forwarded {fwd} packets "
          f"({fwd / ticks:.1f} a tick), payloads unequal {sfu.mismatched}, missing "
          f"{sfu.missing}, undelivered {sfu.undelivered}, stray {sfu.stray}; pumps dropped "
          f"{dropped}, truncated {truncated}; routes off the levels {len(off_levels)} "
          f"{off_levels[:3]}, off the design (ticks {SFU_GRACE}-{SFU_SWITCH - 1} and "
          f"{SFU_SWITCH + SFU_SETTLE} on) {len(bad)} {bad[:3]} (ticks {SFU_SWITCH + SFU_GRACE}-"
          f"{SFU_SWITCH + SFU_SETTLE - 1}, no bar: {len(settling)} member-ticks off the design, "
          f"at ticks {sorted({b[0] for b in settling})}); energies "
          f"finite {finite}; conference 0 at the last tick: dB {np.round(levels, 1).tolist()}, "
          f"ranks {ranks} [{card}]", flush=True)
    print(f"sfu 13a drain of {legs} server sockets, one datagram each: {drain_line} [{card}]",
          flush=True)
    print("sfu 13a profile_nodes (server graph, ms a call): "
          + ", ".join(f"{k} {v:.4f}" for k, v in prof.items()) + f" [{card}]", flush=True)
    if torch.device(dev).type == "cuda":
        _require_counts("sfu 13a", launches, {"g722_encode": ticks, "g722_decode": ticks})
    if bad or off_levels or sfu.mismatched or sfu.missing or sfu.undelivered or sfu.stray:
        raise AssertionError(f"sfu 13a: routes off the design {bad[:5]}, off the levels "
                             f"{off_levels[:5]}, unequal payloads "
                             f"{sfu.mismatched}, missing {sfu.missing}, undelivered "
                             f"{sfu.undelivered}, stray {sfu.stray}")
    if dropped or truncated or not finite:
        raise AssertionError(f"sfu 13a: pumps dropped {dropped}, truncated {truncated}, "
                             f"energies finite {finite}")
    if set(prof) != {"dec", "levels"}:
        raise AssertionError(f"sfu 13a: profile_nodes timed {sorted(prof)}")
    if drains["pump"][1] != drains["python"][1] or drains["pump"][1] != SFU_DRAIN_ROUNDS * legs:
        raise AssertionError(f"sfu 13a: the drains read {drains['pump'][1]} and "
                             f"{drains['python'][1]} datagrams")
    return launches, ranks, sfu.energies


def sfu_cross(dev, card, ticks=CROSS_SFU_TICKS):
    """Phase 13e: one conference of 8 through 13a's path on the CPU and on
    ``dev``: energies within 1e-5 relative, the routed sources equal on
    every tick."""
    runs = []
    for d in ("cpu", dev):
        sfu = Sfu(d, 1, ticks)
        try:
            sfu.run()
        finally:
            sfu.close()
        runs.append(sfu)
    c, g = runs
    rel = float(np.max(np.abs(c.energies - g.energies) / np.abs(c.energies)))
    same = c.routed == g.routed
    print(f"sfu 13e: 1 conference of {SFU_MEMBERS} x {ticks} ticks on the CPU and on the card: "
          f"energies max relative error {rel:.3e}, routed sources equal on every tick {same}, "
          f"route failures {len(c.route_failures())} / {len(g.route_failures())} [{card}]",
          flush=True)
    if rel > 1e-5 or not same:
        raise AssertionError(f"sfu 13e: energies {rel:.3e} apart, routes equal {same}")


def pump_session(dev, card, legs, pumped):
    """Phase 13b: 8b's configuration (no wrong-key leg) with each leg over
    two localhost ``UdpTransport``s, received by Python or, ``pumped``,
    with every transport on one ``NativeIoPump``; 8b's rounds and bars.
    Returns ms per tick pair."""
    from mediastreamer2_tpu_torch.native import NativeIoPump
    pump = NativeIoPump() if pumped else None
    sess, qis = secure_session(dev, legs, SECURE_MAX_TICKS, seed=150,
                               connect=lambda s: s.udp(pump))
    try:
        ran, wall, ms = secure_rounds(sess, "13b", SECURE_MAX_TICKS)
        ok, line = sess.check(conf_step=1)
        rep = secure_report(sess, qis)
        counts = ([(pump.dropped(tr.sock), pump.truncated(tr.sock))
                   for tr in sess.udp_transports] if pumped else [])
    finally:
        for tr in sess.udp_transports:
            tr.close()
        if pump is not None:
            pump.close()
    dropped = sum(d for d, _ in counts)
    truncated = sum(x for _, x in counts)
    print(f"session 13b ({'NativeIoPump' if pumped else 'Python receive'}): {legs} + {legs} "
          f"legs of 8b over localhost UDP, {ran} rounds in {wall:.2f} s ({ms:.3f} ms per tick "
          f"pair, host clock): {rep.line}; pump dropped {dropped}, truncated {truncated}; "
          f"{line} [{card}]", flush=True)
    if rep.unreported or rep.no_rtt or rep.auth or not ok or dropped or truncated:
        raise AssertionError(f"session 13b: unreported {rep.unreported[:4]}, no RTT "
                             f"{rep.no_rtt[:4]}, auth failures {rep.auth}, listener bars {ok}, "
                             f"pump dropped {dropped}, truncated {truncated}")
    return ms


def h264_access_unit(rng, idr):
    """A synthetic H.264 access unit: SPS, PPS and an IDR slice of 3,000 to
    6,000 bytes, or one non-IDR slice of 400 to 1,600 bytes; the slices'
    bytes random."""
    if idr:
        return [b"\x67" + rng.bytes(11), b"\x68" + rng.bytes(5),
                b"\x65" + rng.bytes(int(rng.integers(3000, 6000)))]
    return [b"\x41" + rng.bytes(int(rng.integers(400, 1600)))]


def video_router_fec(card, ranks, seconds=VIDEO_ROUTER_SECONDS, seed=1330):
    """Phase 13c: VIDEO_ROUTER_MEMBERS members, one ``VideoPacketRouter``.
    Each member sends synthetic H.264 at VIDEO_ROUTER_FPS (an IDR every
    VIDEO_ROUTER_GOP frames, and at once after a key-frame request),
    packetized by ``net/h26x.packetize``; the focus moves every
    VIDEO_ROUTER_FOCUS_S to the next of ``ranks``. Each member's output is
    protected by ``FecEncoder(scheme="2d", L=5, D=5)`` and reaches its
    receiver through ``NetworkSimulator`` with VIDEO_ROUTER_LOSS % random
    loss; a ``FecDecoder`` a receiver. Bars: an output changes source only
    on the first packet of an IDR; one key-frame request per focus change,
    for the new focus; output sequence numbers contiguous per member; every
    recovered packet equal to what the router sent. Prints the loss before
    and after FEC."""
    from mediastreamer2_tpu_torch.net import h26x
    from mediastreamer2_tpu_torch.net.fec import FEC_PT, FecDecoder, FecEncoder
    from mediastreamer2_tpu_torch.net.netsim import NetSimParams, NetworkSimulator
    from mediastreamer2_tpu_torch.net.router import VideoPacketRouter
    from mediastreamer2_tpu_torch.net.rtp import RtpPacket
    n = VIDEO_ROUTER_MEMBERS
    rngs = [np.random.default_rng(seed + m) for m in range(n)]
    requests, want_idr = [], set()

    def request(m):
        requests.append(m)
        want_idr.add(m)
    router = VideoPacketRouter(request_keyframe=request)
    starts = set()                      # (ssrc, timestamp) of every IDR's first packet
    out = [dict(sent={}, last_seq=None, source=None, switches=0, bad_switch=0, gaps=0,
                delivered=set(), recovered=[], enc=FecEncoder(L=FEC_L, D=FEC_D, scheme="2d",
                                                             ssrc=0xFEC00000 + m),
                dec=FecDecoder(),
                net=NetworkSimulator(NetSimParams(loss_rate=VIDEO_ROUTER_LOSS, seed=seed + m)))
           for m in range(n)]
    now = [0.0]

    def deliver(m, data):
        o = out[m]
        pkt = RtpPacket.unpack(data)
        if o["last_seq"] is not None and pkt.seq != (o["last_seq"] + 1) & 0xFFFF:
            o["gaps"] += 1
        o["last_seq"] = pkt.seq
        src = pkt.ssrc - 0x5EED0000
        if src != o["source"]:
            o["switches"] += 1
            o["bad_switch"] += (pkt.ssrc, pkt.timestamp, pkt.payload) not in starts
            o["source"] = src
        o["sent"][pkt.seq] = pkt
        for p in [pkt] + o["enc"].push(pkt):
            if not o["net"].shape(now[0], p.pack()):
                continue
            if p.payload_type == FEC_PT:
                for r in o["dec"].push_repair(RtpPacket.unpack(p.pack())):
                    o["recovered"].append(r)
            else:
                o["delivered"].add(p.seq)
                o["dec"].push_media(RtpPacket.unpack(p.pack()))
    for m in range(n):
        router.add_member(m, lambda data, m=m: deliver(m, data))
    frames = int(seconds * VIDEO_ROUTER_FPS)
    per_focus = int(VIDEO_ROUTER_FOCUS_S * VIDEO_ROUTER_FPS)
    seqs, focus, changes = [0] * n, None, 0
    for f in range(frames):
        now[0] = f / VIDEO_ROUTER_FPS
        if f % per_focus == 0:
            new = ranks[(f // per_focus) % len(ranks)]
            if new != focus:
                router.set_focus(new)
                focus, changes = new, changes + 1
        for m in range(n):
            idr = f % VIDEO_ROUTER_GOP == 0 or m in want_idr
            want_idr.discard(m)
            ts = f * 90000 // VIDEO_ROUTER_FPS
            payloads = h26x.packetize(h264_access_unit(rngs[m], idr), mtu=1200)
            for k, pl in enumerate(payloads):
                pkt = RtpPacket(96, seqs[m], ts, 0x5EED0000 + m, pl,
                                marker=k == len(payloads) - 1)
                seqs[m] = (seqs[m] + 1) & 0xFFFF
                if idr and k == 0:
                    starts.add((pkt.ssrc, ts, pl))
                router.route(m, pkt, is_keyframe_start=idr and k == 0)
    sent = sum(len(o["sent"]) for o in out)
    lost = sum(len(o["sent"]) - len(o["delivered"]) for o in out)
    recovered = sum(len({r.seq for r in o["recovered"]} - o["delivered"]) for o in out)
    unequal = sum(1 for o in out for r in o["recovered"]
                  if (r.seq not in o["sent"] or r.payload != o["sent"][r.seq].payload
                      or r.timestamp != o["sent"][r.seq].timestamp))
    residual = lost - recovered
    switches = sum(o["switches"] for o in out)
    bad_switch = sum(o["bad_switch"] for o in out)
    gaps = sum(o["gaps"] for o in out)
    print(f"video router 13c: {n} members, synthetic H.264 at {VIDEO_ROUTER_FPS} fps (IDR every "
          f"{VIDEO_ROUTER_GOP} frames), {frames} frames, focus every {VIDEO_ROUTER_FOCUS_S} s by "
          f"the ranks {ranks}: {changes} focus changes, key-frame requests {requests}, output "
          f"source switches {switches} (not on an IDR's first packet: {bad_switch}), sequence "
          f"gaps {gaps}; FlexFEC 2d L={FEC_L} D={FEC_D} over {VIDEO_ROUTER_LOSS}% random loss: "
          f"{sent} media packets routed, {lost} lost ({100 * lost / sent:.2f}%), {recovered} "
          f"recovered ({unequal} unequal), residual loss {residual} "
          f"({100 * residual / sent:.2f}%) [{card}]", flush=True)
    if bad_switch or gaps or unequal or switches < changes:
        raise AssertionError(f"video router 13c: {bad_switch} switches off an IDR start, "
                             f"{gaps} sequence gaps, {unequal} unequal recoveries, {switches} "
                             f"switches for {changes} focus changes")
    if requests != [ranks[k % len(ranks)] for k in range(changes)]:
        raise AssertionError(f"video router 13c: key-frame requests {requests} for "
                             f"{changes} focus changes")
    return lost, residual


class _EveryNth:
    """A netsim stand-in that loses every ``n``-th packet, or the packets
    whose 0-based index is in ``lose``."""

    def __init__(self, n=0, lose=()):
        self.n, self.lose, self.count = n, set(lose), 0

    def shape(self, now, data):
        k = self.count
        self.count += 1
        if (self.n and k % self.n == self.n - 1) or k in self.lose:
            return []
        return [(now, data)]


def text_streams(card, pairs=TEXT_PAIRS, chars=TEXT_CHARS, seed=1340):
    """Phase 13d's text: ``pairs`` ``TextStream`` pairs over
    ``SrtpTransport`` on ``LoopbackPair``s (keys from a seeded generator),
    ``chars`` characters typed on each, TEXT_PER_FLUSH a 310 ms flush (a
    virtual clock). With every 7th packet lost each leg must read its text
    exactly; with a burst of 3 (TEXT_BURST) each must read it with one
    U+FFFD in place of the burst's first packet, whose text the two RED
    generations no longer hold."""
    from mediastreamer2_tpu_torch.net.rtp import LoopbackPair, RtpSession
    from mediastreamer2_tpu_torch.net.rtt import LOSS_CHAR, TextStream
    from mediastreamer2_tpu_torch.net.srtp import SrtpContext, SrtpTransport
    rng = np.random.default_rng(seed)
    first = TEXT_BURST[0] * TEXT_PER_FLUSH
    results = {}
    for name, loss in (("every 7th lost", lambda: _EveryNth(n=7)),
                       ("burst of 3", lambda: _EveryNth(lose=TEXT_BURST))):
        texts, streams = [], []
        for _ in range(pairs):
            key, salt = rng.bytes(16), rng.bytes(14)
            pair = LoopbackPair(netsim=loss())
            ta = SrtpTransport(pair.endpoint(0), tx=SrtpContext(key, salt),
                               rx=SrtpContext(key, salt))
            tb = SrtpTransport(pair.endpoint(1), tx=SrtpContext(key, salt),
                               rx=SrtpContext(key, salt))
            streams.append((TextStream(RtpSession(ta, payload_type=98)),
                            TextStream(RtpSession(tb, payload_type=98)), ta, tb))
            texts.append("".join(chr(c) for c in rng.integers(0x21, 0x7F, chars)))
        t0 = time.perf_counter()
        now, flushes = 0, -(-chars // TEXT_PER_FLUSH) + 4
        for k in range(flushes):
            now += 310
            for (a, b, _, _), text in zip(streams, texts):
                a.source.put_text(text[k * TEXT_PER_FLUSH:(k + 1) * TEXT_PER_FLUSH])
                a.iterate(now_ms=now)
                b.iterate(now_ms=now)
        wall = time.perf_counter() - t0
        got = [b.get_received_text() for _, b, _, _ in streams]
        auth = sum(ta.auth_failures + tb.auth_failures for _, _, ta, tb in streams)
        if name == "burst of 3":
            want = [t[:first] + LOSS_CHAR + t[first + TEXT_PER_FLUSH:] for t in texts]
        else:
            want = texts
        wrong = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        results[name] = wrong
        print(f"text 13d ({name}): {pairs} TextStream pairs over SRTP, {chars} characters "
              f"typed each, {flushes} flushes in {wall:.2f} s; legs reading other text than "
              f"expected {len(wrong)} {wrong[:4]}, U+FFFD read {sum(g.count(LOSS_CHAR) for g in got)}, "
              f"SRTP auth failures {auth} [{card}]", flush=True)
        if wrong or auth:
            raise AssertionError(f"text 13d ({name}): legs {wrong[:8]} read other text, "
                                 f"auth failures {auth}")
    return results


class _FakeIgd:
    """An in-process UPnP Internet Gateway Device on localhost: an HTTP
    server with the root description (/desc.xml) and WANIPConnection's
    control URL (/ctl: AddPortMapping, DeletePortMapping,
    GetExternalIPAddress), and an SSDP responder on a unicast UDP socket
    that answers one M-SEARCH with the description's LOCATION."""
    EXTERNAL_IP = "198.51.100.77"

    def __init__(self):
        import http.server
        from mediastreamer2_tpu_torch.net import upnp
        igd = self
        self.mappings = {}

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, body):
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path != "/desc.xml":
                    self.send_error(404)
                    return
                self._reply(f"<root><device><serviceList><service><serviceType>"
                            f"{upnp.SERVICE_WANIP}</serviceType><controlURL>/ctl</controlURL>"
                            f"</service></serviceList></device></root>".encode())

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"])).decode()
                action = self.headers.get("SOAPAction", "")
                field = lambda name: re.search(f"<{name}>(.*?)</{name}>", body).group(1)
                if "AddPortMapping" in action:
                    igd.mappings[(field("NewExternalPort"), field("NewProtocol"))] = (
                        field("NewInternalClient"), field("NewInternalPort"))
                    resp = "<u:AddPortMappingResponse/>"
                elif "DeletePortMapping" in action:
                    igd.mappings.pop((field("NewExternalPort"), field("NewProtocol")), None)
                    resp = "<u:DeletePortMappingResponse/>"
                elif "GetExternalIPAddress" in action:
                    resp = (f"<u:GetExternalIPAddressResponse><NewExternalIPAddress>"
                            f"{igd.EXTERNAL_IP}</NewExternalIPAddress>"
                            f"</u:GetExternalIPAddressResponse>")
                else:
                    self.send_error(500)
                    return
                self._reply(f"<s:Envelope><s:Body>{resp}</s:Body></s:Envelope>".encode())

        self.http = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.http.server_port}"
        self.ssdp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.ssdp.bind(("127.0.0.1", 0))
        self.ssdp.settimeout(5.0)
        self.threads = [threading.Thread(target=self.http.serve_forever, daemon=True),
                        threading.Thread(target=self._answer, args=(upnp.ST_IGD,), daemon=True)]
        for t in self.threads:
            t.start()

    def _answer(self, st):
        try:
            data, addr = self.ssdp.recvfrom(4096)
        except OSError:
            return
        if b"M-SEARCH" in data:
            self.ssdp.sendto(f"HTTP/1.1 200 OK\r\nST: {st}\r\nLOCATION: {self.url}/desc.xml"
                             f"\r\n\r\n".encode(), addr)

    def close(self):
        self.http.shutdown()
        self.http.server_close()
        self.ssdp.close()
        for t in self.threads:
            t.join(timeout=10)
            if t.is_alive():
                raise AssertionError("upnp 13d: the fake gateway's thread did not end")


def upnp_mapping(card):
    """Phase 13d's UPnP: ``UpnpIgdClient.discover`` against ``_FakeIgd``
    (SSDP by unicast to its responder, then the root description), then
    the external address read, a UDP mapping added, read back from the
    gateway's table and deleted."""
    from mediastreamer2_tpu_torch.net.upnp import UpnpIgdClient
    igd = _FakeIgd()
    try:
        t0 = time.perf_counter()
        client = UpnpIgdClient.discover(timeout_s=0.5, addr=igd.ssdp.getsockname())
        if client is None or client.control_url != igd.url + "/ctl":
            raise AssertionError(f"upnp 13d: discovered {client and client.control_url}")
        ip = client.get_external_ip()
        client.add_port_mapping(7078, 7078, "192.168.1.50")
        added = dict(igd.mappings)
        client.delete_port_mapping(7078)
        wall = time.perf_counter() - t0
    finally:
        igd.close()
    print(f"upnp 13d: discovered {client.control_url} through SSDP and the description, "
          f"external address {ip}, mapping added {added}, after delete {igd.mappings}, client "
          f"mappings {client.mappings} in {wall:.2f} s [{card}]", flush=True)
    if (ip != _FakeIgd.EXTERNAL_IP or added != {("7078", "UDP"): ("192.168.1.50", "7078")}
            or igd.mappings or client.mappings):
        raise AssertionError(f"upnp 13d: ip {ip}, added {added}, left {igd.mappings}")


# -- phase 14: the mixed fleet, the host-codec legs and the device layer ------
def quirk_features():
    """14d's client features: AEC + AGC through the quirk DB's entry for
    ``QUIRK_DEVICE`` (mic EQ, a 120 ms EC delay), plus ``QUIRK_SPK_EQ``."""
    from mediastreamer2_tpu_torch.core.quirks import apply_quirks, lookup_quirks
    from mediastreamer2_tpu_torch.models.audio_stream import AudioStreamFeatures
    ft = apply_quirks(AudioStreamFeatures(echo_canceller=True, agc=True),
                      lookup_quirks(*QUIRK_DEVICE))
    ft.spk_eq_gains = list(QUIRK_SPK_EQ)
    return ft


def fleet_sizes():
    """14a's members (flagship, srtp, opus, video): MixedFleetBench's
    defaults, Opus and VP8 only where phase 1 finds libopus and libvpx."""
    return (FLEET_FLAGSHIP, FLEET_SRTP, FLEET_OPUS if ctypes.util.find_library("opus") else 0,
            FLEET_VIDEO if ctypes.util.find_library("vpx") else 0)


def fleet_launches(e2e_ticks, opus_ticks=None):
    """The launches a fleet run must show: fused_volume, mdf_apply and
    mdf_update once a tick of each e2e member (megakernel mode, as phase
    5 counts them: the ticks each bench dispatched), mdf_update_fused
    never; an Opus member adds its conference's receive volume once a tick
    and once for its warm-up."""
    n = sum(e2e_ticks.values())
    want = {"fused_volume": n, "mdf_apply": n, "mdf_update": n}
    if opus_ticks is not None:
        want["fused_volume"] += opus_ticks + 1
    return want


def fleet_bars(res):
    """14a / 14b's correctness bars (the deadline is printed, not held):
    the failures, empty when met."""
    bad = [f"errors {res.errors}"] if res.errors else []
    for name in ("flagship", "srtp"):
        r = getattr(res, name)
        if r is None:
            bad.append(f"{name}: no result")
        elif not (r.fidelity >= 0.9 and r.loss_rate < 0.02 and r.out_finite):
            bad.append(f"{name}: fidelity {r.fidelity}, loss {r.loss_rate}, finite "
                       f"{r.out_finite}")
    if res.srtp is not None and res.srtp.auth_failures:
        bad.append(f"srtp: {res.srtp.auth_failures} authentication failures")
    if res.opus is not None and res.opus["delivery"] < 0.95:
        bad.append(f"opus: delivery {res.opus['delivery']}")
    return bad


def fleet_run(kernels, dev, card, mode, seconds=FLEET_SECONDS, sizes=None, phase=None):
    """Phases 14a (``mode="loop"``) and 14b (``"threads"``): the mixed
    fleet at ``sizes`` (``fleet_sizes()``) for ``seconds`` in megakernel
    mode, launches counted over the run. Returns (result, launches, the
    flagship member's dispatched ticks)."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.models.mixed_fleet import MixedFleetBench
    phase = phase or {"loop": "14a", "threads": "14b"}[mode]
    nf, ns, no, nv = sizes or fleet_sizes()
    with environ(PALLAS_MDF="1"):
        fleet = MixedFleetBench(Factory, n_flagship=nf, n_srtp=ns, n_opus=no, n_video=nv,
                                device=dev)
        try:
            e2e = {k: fleet.members[k] for k in ("flagship", "srtp") if k in fleet.members}
            for b in e2e.values():
                b.warm()                  # first launches outside the counted run
            t0 = {k: b._t for k, b in e2e.items()}
            opus = fleet.members.get("opus")
            o0 = opus.ticker.stats.ticks if opus is not None else 0
            kernels.reset_launch_counts()
            t_run = time.perf_counter()
            res = fleet.run(seconds=seconds, mode=mode)
            wall = time.perf_counter() - t_run
            launches = kernels.launch_counts()
            ticks = {k: b._t - t0[k] for k, b in e2e.items()}
            opus_ticks = opus.ticker.stats.ticks - o0 if opus is not None else None
        finally:
            fleet.close()
    summary = res.summary()
    trace = summary.pop("trace")
    line = f"fleet {phase} ({mode}): {nf} flagship + {ns} SRTP e2e legs, {no} Opus legs, " \
           f"{nv} VP8 streams, {seconds} s paced ({wall:.1f} s with the warm-up and the " \
           f"drain), megakernel AEC: {json.dumps(summary)}; passes() {res.passes()}; " \
           f"ticks dispatched {ticks}, Opus ticks {opus_ticks}; launches {launches}"
    if trace is not None:
        line += (f"; loop trace: ms a tick by member mean {trace['per_member_ms_mean']} max "
                 f"{trace['per_member_ms_max']}, sleep share "
                 f"{trace['sleep_s'] / max(trace['wall_s'], 1e-9):.3f} of {trace['wall_s']} s, "
                 f"other host time {trace['busy_other_s']} s, workers "
                 f"{json.dumps(trace['per_member_worker'])}, first stalls "
                 f"{trace['stalls'][:8]}")
    print(line + f" [{card}]", flush=True)
    bad = fleet_bars(res)
    if bad:
        raise AssertionError(f"fleet {phase}: " + "; ".join(bad))
    if torch.device(dev).type == "cuda":      # the plain versions launch nothing
        _require_counts(f"fleet {phase}", launches, fleet_launches(ticks, opus_ticks))
    return res, launches, ticks.get("flagship", 0)


def host_codec_bar(codec, rate, sig):
    """A codec's listener bar: ``HOST_CODEC_BARS``, or for opus and speex
    the codec's own offline round trip of ``sig`` (its default frames)
    less ``HOST_CODEC_MARGINS``."""
    if codec in HOST_CODEC_BARS:
        return HOST_CODEC_BARS[codec]
    from mediastreamer2_tpu_torch.ops import host_codecs as hc
    from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff
    if codec == "opus":
        enc, dec, F = hc.OpusEncoder(rate=rate), hc.OpusDecoder(rate=rate), rate // 100
        trip = lambda x: dec.decode(enc.encode(x), F)          # noqa: E731
    else:
        c = hc.SpeexCodec(rate=rate)
        F, trip = c.frame_samples, lambda x: c.decode(c.encode(x))   # noqa: E731
    ref = np.concatenate([trip(sig[k * F:(k + 1) * F]) for k in range(len(sig) // F)])
    return audio_diff(sig[:len(ref)], ref)[0] - HOST_CODEC_MARGINS[codec]


def host_codec_pair(dev, codec, rate, legs, ticks, seed=1400):
    """``legs`` talkers -> ``legs`` listeners of ``codec`` over a
    LoopbackPair a leg, ``ticks`` + 40 alternating do_ticks; returns (each
    listener's audio_diff against its talker's speech, each one's bar,
    payloads sent)."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.models.audio_stream import AudioStreamBatch
    from mediastreamer2_tpu_torch.net.rtp import LoopbackPair
    from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff
    from mediastreamer2_tpu_torch.utils.signals import make_speechlike
    n = rate // 100 * ticks
    sig = make_speechlike(n, rate, seed=[seed + i for i in range(legs)])
    f = Factory()
    tx = AudioStreamBatch(f, legs, codec=codec, rate=rate, mic_signal=sig, device=dev)
    rx = AudioStreamBatch(f, legs, codec=codec, rate=rate, record_ticks=ticks + 40, device=dev)
    for leg in range(legs):
        pair = LoopbackPair()
        tx.set_transport(leg, pair.endpoint(0))
        rx.set_transport(leg, pair.endpoint(1))
    for s in (tx, rx):
        s.ticker.realtime = False
        s.ticker.warm_up()
    for _ in range(ticks + 40):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
    sims, _ = audio_diff(sig, rx.get_recording(), device=dev)
    sent = sum(s.stats.sent_packets for s in tx.sessions)
    return np.asarray(sims), np.array([host_codec_bar(codec, rate, row) for row in sig]), sent


def host_codec_legs(dev, card, legs=HOST_CODEC_LEGS, ticks=HOST_CODEC_TICKS):
    """Phase 14c: each host codec where phase 1's ``find_library`` finds
    its library (AAC: and ``aac_available()``) as a ``legs`` + ``legs``
    stream pair on ``dev``, its listeners above the JAX package's bar;
    where it does not, ``AudioStreamBatch(codec=...)`` must raise
    RuntimeError naming the library before any graph is built. Then
    ``local_capabilities()`` offers mpeg4-generic iff ``aac_available()``.
    Returns {codec: line}."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.models import audio_stream
    from mediastreamer2_tpu_torch.models.offer_answer import local_capabilities
    from mediastreamer2_tpu_torch.ops.aac import aac_available
    lines, bad = {}, []
    for codec, rate, so, lib in HOST_CODEC_LIBS:
        found = ctypes.util.find_library(so)
        if codec == "aac" and found and not aac_available():
            found = None
        if found:
            sims, bar, sent = host_codec_pair(dev, codec, rate, legs, ticks)
            worst = int(np.argmin(sims - bar))
            lines[codec] = (f"{codec}: {so} {found}, {legs} + {legs} legs x {ticks} ticks, "
                            f"{sent} packets sent, listeners audio_diff min {sims.min():.4f}, "
                            f"closest to its bar: leg {worst} {sims[worst]:.4f} (bar "
                            f"{bar[worst]:.4f})")
            if not (sims > bar).all():
                bad.append(lines[codec])
            continue
        builder, built = audio_stream.GraphBuilder, []
        audio_stream.GraphBuilder = lambda *a, **k: built.append(a) or builder(*a, **k)
        try:
            err = refusal(lambda: audio_stream.AudioStreamBatch(Factory(), legs, codec=codec,
                                                                rate=rate, device=dev))
        finally:
            audio_stream.GraphBuilder = builder
        lines[codec] = (f"{codec}: {so} {found}, raised {err!r}, graphs built before the "
                        f"raise {len(built)}")
        if err is None or lib not in err or built:
            bad.append(lines[codec])
    for line in lines.values():
        print(f"host codecs 14c: {line} [{card}]", flush=True)
    offered = "mpeg4-generic" in {c.mime for c in local_capabilities()}
    print(f"host codecs 14c: local_capabilities() offers mpeg4-generic {offered}, "
          f"aac_available() {aac_available()}", flush=True)
    if offered != aac_available():
        bad.append(f"mpeg4-generic offered {offered}, aac_available() {aac_available()}")
    if bad:
        raise AssertionError(f"host codecs 14c: {bad}")
    return lines


def mire_frames(dev, legs=MIRE_LEGS, ticks=MIRE_TICKS):
    """The default ``MireWebCam``'s frames through its graph source (the
    port's ``mire`` filter) on ``dev``: u8 codes [ticks, legs, h*3/2, w]."""
    from mediastreamer2_tpu_torch import Factory, GraphBuilder
    from mediastreamer2_tpu_torch.core.devices import WebCamManager
    name, params = WebCamManager().get_cam("mire").graph_source()
    g = GraphBuilder(Factory(), batch=legs)
    g.chain(g.add(name, "cam", **params), g.add("ext_sink", "out"))
    cg = g.build()
    st, pr = cg.init_state(dev), cg.init_params(dev)
    frames = []
    for _ in range(ticks):
        st, out, _ = cg.step(st, pr, {})
        frames.append(torch.round(out["out"].clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
    return np.stack(frames)


def device_gating(dev, card):
    """Phase 14f: what the device layer finds on this machine (ALSA, Pulse,
    V4L2, screenshare, the QR reader) and what the card detectors
    registered; an absent backend registers nothing and raises naming its
    library. A MireWebCam's frames on ``dev`` within one u8 code of the
    CPU's."""
    from mediastreamer2_tpu_torch.core import alsa, devices, pulse, v4l2
    from mediastreamer2_tpu_torch.ops import qrcode, screenshare
    mgr = devices.SndCardManager()
    drivers = [c.driver for c in mgr.cards]
    bad = []
    for ok, driver, make, lib in ((alsa.alsa_available(), "alsa", alsa.AlsaSndCard, "libasound"),
                                  (pulse.pulse_available(), "pulse", pulse.PulseSndCard,
                                   "libpulse-simple")):
        if not ok:
            err = refusal(make)
            if driver in drivers or err is None or lib not in err:
                bad.append(f"{driver}: registered {driver in drivers}, raised {err!r}")
    got, want = mire_frames(dev), mire_frames(torch.device("cpu"))
    apart = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())
    print(f"devices 14f: ALSA {alsa.alsa_available()}, Pulse {pulse.pulse_available()}, V4L2 "
          f"{v4l2.v4l2_available()} ({v4l2.list_devices()}), screenshare "
          f"{screenshare.screenshare_available()}, QR reader {qrcode.qrcode_available()}; "
          f"the card detectors registered {[repr(c) for c in mgr.cards]}; webcams "
          f"{[c.name for c in devices.WebCamManager().cams]}; the mire's {got.shape} frames on "
          f"the card at most {apart} u8 codes from the CPU's [{card}]", flush=True)
    if apart > 1:
        bad.append(f"mire frames {apart} codes apart")
    if bad:
        raise AssertionError(f"devices 14f: {bad}")


# -- phase 15: leg sharding --------------------------------------------------------
def bf16_steps(a, b) -> np.ndarray:
    """How many bf16 steps apart two arrays of bf16 bits (int16) are,
    elementwise: the bits mapped onto one monotonic integer line."""
    def line(x):
        x = x.astype(np.int32)
        return np.where(x < 0, -(x & 0x7FFF), x)
    return np.abs(line(a) - line(b))


def tap_report(ref_taps, reports, legs) -> tuple:
    """(legs whose four bf16 tap tensors equal the unsharded run's rows
    bit for bit, the most bf16 steps any tap is apart); ``ref_taps``: the
    unsharded run's taps as bits (``parallel.checks.bits``)."""
    from mediastreamer2_tpu_torch.parallel.checks import TAP_KEYS
    equal, steps = np.ones(legs, bool), 0
    for k in TAP_KEYS:
        full = ref_taps[k]
        shard = np.concatenate([r["taps"][k] for r in reports])
        equal &= (full == shard).reshape(legs, -1).all(axis=1)
        steps = max(steps, int(bf16_steps(full, shard).max()))
    return int(equal.sum()), steps


def shard_bars(phase, ref_out, reports, ticks, collectives_a_tick, card, dev="cpu"):
    """Phase 15a / 15b's bars on a sharded flagship run against the
    unsharded one: each rank's line (ms a tick, the collective's, the
    launches: fused_volume, mdf_apply and mdf_update_fused once a tick and
    nothing else, on the card; ``collectives_a_tick`` exchanges a tick;
    finite output), then the cross-backend bar of phase 4 on the gathered
    output, the max abs error and the legs bit-equal, which must be every
    leg. Returns (bar, bit-equal legs)."""
    from mediastreamer2_tpu_torch.utils.audiodiff import quality_bar
    out = np.concatenate([r["out"] for r in reports])
    ref = ref_out.cpu().numpy() if isinstance(ref_out, torch.Tensor) else ref_out
    legs = ref.shape[0]
    for r in reports:
        print(f"{phase} rank {r['rank']}: {r['out'].shape[0]} legs x {ticks} ticks, "
              f"{r['ms_tick']:.3f} ms/tick (host clock, ticks 1..{ticks - 1}; ranks share the "
              f"card), collectives {r['collectives']} ({r['collective_ms_tick']:.3f} ms a tick "
              f"over the same ticks), launches {r['launches']}, finite {r['finite']}, the job "
              f"{r['seconds']:.1f} s with its set-up [{card}]", flush=True)
        n = ticks if torch.device(dev).type == "cuda" else 0    # the plain versions launch nothing
        _require_counts(f"{phase} rank {r['rank']}", r["launches"],
                        {"fused_volume": n, "mdf_apply": n, "mdf_update_fused": n})
        if r["collectives"] != collectives_a_tick * ticks:
            raise AssertionError(f"{phase} rank {r['rank']}: {r['collectives']} collectives in "
                                 f"{ticks} ticks, expected {collectives_a_tick} a tick")
        if not r["finite"]:
            raise AssertionError(f"{phase} rank {r['rank']}: non-finite output")
    bar = quality_bar(ref, out, device=dev)
    bit_legs = int((out.view(np.int32) == ref.view(np.int32)).all(axis=1).sum())
    print(f"{phase}: {len(reports)} shards against the unsharded {legs}-leg run: audio_diff_min "
          f"{bar['audio_diff_min']:.6f} (legs 0, 37, ...; all legs "
          f"{bar['audio_diff_min_all_legs']:.6f}), rms_err {bar['rms_err']:.3e}, max_abs_err "
          f"{bar['max_abs_err']:.3e}, energy_gap_db_max {bar['energy_gap_db_max']:.4f}, pass "
          f"{bar['pass']}; legs bit-equal {bit_legs} of {legs}", flush=True)
    if not bar["pass"]:
        raise AssertionError(f"{phase}: sharded vs unsharded quality bar failed: {bar}")
    if bit_legs != legs:
        raise AssertionError(f"{phase}: {legs - bit_legs} legs differ from the unsharded run")
    return bar, bit_legs


def mixer_bars(phase, reports, card):
    """The mixer alone, sharded, bit for bit its unsharded self on each
    rank (the same inputs); prints the collective's ms a call."""
    for r in reports:
        equal = np.array_equal(r["out"], r["ref"])
        print(f"{phase} mixer rank {r['rank']}: bit-equal {equal}, "
              f"collectives a call {r['collectives']:.0f}, {r['collective_ms']:.3f} ms a "
              f"collective (host clock) [{card}]", flush=True)
        if not equal:
            raise AssertionError(f"{phase}: the sharded mixer differs from the unsharded one")


def flagship_fixture(legs, ticks):
    """Phase 3's echo-coupled fixture (seed 11) of ``legs`` x ``ticks``,
    made once: phase 15 drives the same legs sharded."""
    from mediastreamer2_tpu_torch.models.flagship import echo_coupled_inputs
    if (legs, ticks) not in FIXTURES:
        FIXTURES[legs, ticks] = echo_coupled_inputs(legs, ticks, seed=11)
    return FIXTURES[legs, ticks]


def leg_sharding(dev, card, legs=SHARD_LEGS, ticks=SHARD_TICKS, world=SHARD_WORLD,
                 conferences=SHARD_CONFERENCES):
    """Phases 15a and 15b (and 15e's taps) in one world of ``world`` gloo
    ranks, one process a shard (on the card: all on it, since NCCL does
    not put two ranks on one device): rank 0 first runs the unsharded
    graphs (the references, in the shards' process settings: no cuBLAS
    workspace, ``sharding.spawn_shards``), then every rank runs the mixer
    alone on identical inputs and the flagship sharded, 15a with aligned
    groups of four (no collective), 15b with ``group_id = leg %
    conferences`` through the segment-sum mixer (one exchange a tick).
    The shards must equal the references bit for bit. Returns (launches
    summed over the ranks of both runs, ticks x ranks)."""
    from mediastreamer2_tpu_torch.parallel import checks, sharding
    shard_dev = None if dev.type == "cuda" else "cpu"
    gid = (np.arange(legs) % conferences).astype(np.int32)
    x = (0.1 * np.random.default_rng(150).standard_normal((legs, 160))).astype(np.float32)
    with tempfile.TemporaryDirectory(prefix="ms2_shard_") as tmp:
        paths = [os.path.join(tmp, f"{n}.npy") for n in ("mic", "far")]
        for path, a in zip(paths, flagship_fixture(legs, ticks)):
            np.save(path, a)
        fixture = dict(mic=paths[0], far=paths[1], ticks=ticks, taps=True)
        jobs = [("flagship", dict(fixture, unsharded=True)),
                ("flagship", dict(fixture, unsharded=True, group_id=gid)),
                ("barrier", {}), ("mixer", dict(x=x, group_id=gid)), ("flagship", fixture),
                ("flagship", dict(fixture, group_id=gid))]
        t0 = time.perf_counter()
        reports = sharding.spawn_shards(checks.run_jobs, world, device=shard_dev,
                                        timeout_s=SHARD_TIMEOUT_S, args=(jobs,))
        print(f"phase 15a/15b world: {world} gloo ranks, {time.perf_counter() - t0:.1f} s "
              f"with start-up", flush=True)
    refs = reports[0][:2]
    for name, r in zip(("15a", "15b"), refs):
        print(f"{name} unsharded: {legs} legs x {ticks} ticks on rank 0 (the other ranks "
              f"waiting), {r['ms_tick']:.3f} ms/tick, finite {r['finite']}, the job "
              f"{r['seconds']:.1f} s with its set-up [{card}]", flush=True)
    mixer_bars("15b", [dict(r[3], rank=i) for i, r in enumerate(reports)], card)
    launches = {}
    for name, i in (("15a", 4), ("15b", 5)):
        runs = [r[i] for r in reports]
        ref = refs[i - 4]
        shard_bars(name, ref["out"], runs, ticks, 0 if name == "15a" else 1, card, dev)
        equal, steps = tap_report(ref["taps"], runs, legs)
        print(f"15e taps after {name}: Ws_r, Ws_i, Wm_r, Wm_i of {equal} of {legs} legs "
              f"bit-equal to the unsharded run's rows; at most {steps} bf16 steps apart",
              flush=True)
        if equal != legs:
            raise AssertionError(f"15e: the taps of {legs - equal} legs differ after {name}")
        for r in runs:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
    return launches, 2 * ticks * world


def nccl_one_rank(dev, card, fixture, legs=NCCL_LEGS, ticks=SHARD_TICKS,
                  conferences=NCCL_LEGS // 4):
    """Phase 15d: 15b's graph on one NCCL rank (its init and the mixer's
    all_reduce on the card), bit for bit the unsharded run of the same
    batch in the same process, on the first ``legs`` legs of ``fixture``
    (mic, far). Returns (launches, ticks)."""
    from mediastreamer2_tpu_torch.parallel import checks, sharding
    with tempfile.TemporaryDirectory(prefix="ms2_nccl_") as tmp:
        paths = [os.path.join(tmp, f"{n}.npy") for n in ("mic", "far")]
        for path, a in zip(paths, fixture):
            np.save(path, a[:legs])
        run = dict(mic=paths[0], far=paths[1], ticks=ticks,
                   group_id=(np.arange(legs) % conferences).astype(np.int32))
        t0 = time.perf_counter()
        [[ref, r]] = sharding.spawn_shards(
            checks.run_jobs, 1, backend="nccl", timeout_s=SHARD_TIMEOUT_S,
            args=([("flagship", dict(run, unsharded=True)), ("flagship", run)],))
    print(f"15d: one NCCL rank, {time.perf_counter() - t0:.1f} s with start-up; unsharded "
          f"{ref['ms_tick']:.3f} ms/tick [{card}]", flush=True)
    shard_bars("15d", ref["out"], [r], ticks, 1, card, dev)
    return r["launches"], ticks


def offset_kernel(kernels, dev, card, legs=SHARD_LEGS, rows=OFFSET_ROWS, P=P, F=F):
    """Phase 15e: mdf_update_fused (bf16 shadow) on rows [lo, hi) with
    lin0 = lo * P * F equals rows [lo, hi) of the full call bit for bit,
    and its plain twin on the same slice; with lin0 = 0 it must not (the
    fault a shard would have)."""
    g = torch.Generator(device=dev).manual_seed(15)
    rnd = lambda *shape, s=1.0: s * torch.randn(shape, generator=g, device=dev)
    flag = lambda: torch.rand((legs,), generator=g, device=dev) < 0.3
    taps = [rnd(legs, P, F, s=0.1).to(torch.bfloat16) for _ in range(4)]
    rest = ([rnd(legs, P, F).to(torch.bfloat16) for _ in range(2)]
            + [rnd(legs, F, s=0.3), rnd(legs, F, s=0.3), rnd(legs, F).abs(),
               rnd(legs, F, s=0.05), rnd(legs, F, s=0.05), rnd(legs).abs() * 0.6,
               flag(), flag(), flag()])
    cpos = torch.tensor(3, dtype=torch.int32, device=dev)
    srk = torch.tensor(987654321, dtype=torch.int64, device=dev)
    lo, hi = rows
    full = [t.clone() for t in taps]
    kernels.mdf_update_fused(cpos, *full, *rest, srk)
    cut = lambda ts: [t[lo:hi].clone() for t in ts]
    lin0 = lo * P * F
    part, plain, zero = cut(taps), cut(taps), cut(taps)
    kernels.mdf_update_fused(cpos, *part, *cut(rest), srk, lin0)
    kernels.mdf_update_fused_reference(cpos, *plain, *cut(rest), srk, lin0)
    kernels.mdf_update_fused(cpos, *zero, *cut(rest), srk)
    to_full = all(torch.equal(a.view(torch.int16), b[lo:hi].view(torch.int16))
                  for a, b in zip(part, full))
    to_plain = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                   for a, b in zip(part, plain))
    moved = int(sum((a.view(torch.int16) != b[lo:hi].view(torch.int16)).sum()
                    for a, b in zip(zero[:2], full[:2])))
    print(f"15e kernel: mdf_update_fused on rows [{lo}, {hi}) of {legs} x {P} x {F} with lin0 = "
          f"{lin0}: bit-equal to the full call's rows {to_full}, to its plain twin {to_plain}; "
          f"with lin0 = 0, {moved} shadow taps differ from the full call's rows [{card}]",
          flush=True)
    if not (to_full and to_plain):
        raise AssertionError(f"15e: the offset update differs (from the full call's rows: "
                             f"{not to_full}, from its plain twin: {not to_plain})")
    if moved == 0:
        raise AssertionError("15e: lin0 = 0 rounds the slice as the full call does: "
                             "the fixture shows no fault")


def phase15(kernels, dev, card, phase_done=lambda n: None, legs=SHARD_LEGS, ticks=SHARD_TICKS,
            world=SHARD_WORLD, conferences=SHARD_CONFERENCES, nccl_legs=NCCL_LEGS,
            offset_rows=OFFSET_ROWS):
    """Phase 15 (15a-15e). Returns (launches summed over every rank of
    15a, 15b and 15d, their ticks x ranks). On the CPU (a rehearsal) 15c
    runs its shards on the CPU and 15d, which needs a card, is left out."""
    from mediastreamer2_tpu_torch.parallel.dryrun import dryrun_multichip
    t15 = time.perf_counter()
    if dev.type == "cuda":
        print(f"compute mode: {nvidia_smi('compute_mode')} [{card}]", flush=True)
    launches, n = leg_sharding(dev, card, legs, ticks, world, conferences)
    phase_done("15b")
    for r in dryrun_multichip(world, device=None if dev.type == "cuda" else "cpu"):
        print(f"15c rank {r['rank']} on {r['device']}: out {r['out_shape']}, max abs err "
              f"{r['max_abs_err']:.3e}, G.711 err {r['g711_err']:.4f}, edge packets "
              f"{r['edge_packets']}, foreign modules {r['foreign_modules']} [{card}]", flush=True)
        if r["foreign_modules"]:
            raise AssertionError(f"15c: a shard loaded {r['foreign_modules']}")
    phase_done("15c")
    if dev.type == "cuda":
        nccl, nccl_ticks = nccl_one_rank(dev, card, flagship_fixture(legs, ticks), nccl_legs,
                                         ticks, nccl_legs // 4)
        launches = {k: v + nccl[k] for k, v in launches.items()}
        n += nccl_ticks
    else:
        print("15d: left out on the CPU (NCCL needs a card)", flush=True)
    phase_done("15d")
    offset_kernel(kernels, dev, card, legs, offset_rows)
    FIXTURES.clear()
    print(f"phase 15 took {time.perf_counter() - t15:.1f} s [{card}]", flush=True)
    return launches, n


# -- phase 16: the programs around the package --------------------------------
CONF_EXAMPLE_LEGS = 1024      # 16a: examples/conference_server, groups of 4
CONF_EXAMPLE_SIZE = 4
CONF_EXAMPLE_SECONDS = 4      # the server's paced run (400 ticks)
CONF_EXAMPLE_CLIENT_TICKS = 340   # the clients' paced run, inside the server's
CONF_EXAMPLE_SETTLE = 40      # 16a's listener bar starts here (the clients' AGC)
CONF_EXAMPLE_SSRC = 0xA000    # leg i sends and is answered with SSRC 0xA000 + i
CONF_EXAMPLE_LEAD = 6         # ticks the clients may run ahead of the server
CONF_EXAMPLE_PREFILL = 16     # the clients' jitter ring: packets primed before playout
CLI_BENCH_LEGS = 1024         # 16b: mediastream bench
CLI_BENCH_SECONDS = 2
CLI_CALL_SECONDS = 5          # 16c: two mediastream call processes, twice
CLI_CALL_TIMEOUT_S = 150.0
CLI_CALL_BAR = 0.8            # tests/test_cli_tools.py:119's bar
CLI_CALL_COUNTED_SECONDS = 1  # 16c's leg in this process, counted
GW_EXAMPLE_LEGS = 1024        # 16d: examples/transcode_gateway (2,048 sockets)
GW_EXAMPLE_SECONDS = 2           # per-leg Python over 2,048 sockets: ~137 ms a tick
GW_EXAMPLE_SETTLE = 40        # 16d's listener bar starts here (G.722's start transient)
GW_EXAMPLE_LEAD = 2           # ticks the sender's packets run ahead of the gateway's
GW_EXAMPLE_SSRC = 0xB000
GW_EXAMPLE_DRAIN_S = 1.0      # how long the receivers wait for the gateway's last packets
EXAMPLE_BAR = 0.85            # 16a and 16d: listeners against the speech sent
IVR_LEGS = 16                 # 16e: examples/ivr_server, not paced
IVR_SECONDS = 3               # the callers press their digits at tick 150
CROSS_IVR_LEGS = 8            # 16g: the IVR on the CPU against the card
CROSS_IVR_BAR = 0.999
TONES_DIGITS = "123A#"        # 16f / 16g: mediastream tones
CROSS_TONES_RMS = 1e-6
PCAP_PACKETS = 150            # 16f: a mu-law capture, one packet a tick
PCAP_SWAPPED = 40             # packets 40 and 41 captured in the other order
PCAP_MISSING = 90             # packet 90 is not in the capture
MKV_FRAMES = 10               # 16f: fixed VP8 and H.264 bytes, 33 ms apart


def device_args(dev) -> list:
    """The programs' ``--device`` for ``dev`` (none: their default, the card)."""
    return ["--device", "cpu"] if torch.device(dev).type == "cpu" else []


def free_ports(count, host="0.0.0.0", start=2000, stop=16000) -> int:
    """The first port p from ``start`` such that UDP ports p .. p + count - 1
    all bind on ``host`` (each is released again). The range lies under
    the kernel's ephemeral ports (Linux's from 32,768, gVisor's from
    16,000), so that no socket bound to port 0 meanwhile takes one of them."""
    p = start
    while p + count <= stop:
        held = []
        q = p
        try:
            for q in range(p, p + count):
                sk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                held.append(sk)
                sk.bind((host, q))
            return p
        except OSError:
            p = q + 1
        finally:
            for sk in held:
                sk.close()
    raise AssertionError(f"no {count} free UDP ports in {start}..{stop}")


def cli(argv):
    """``mediastream.main(argv)`` in this process: (its exit code, what it
    printed). What it prints is printed here too."""
    from mediastreamer2_tpu_torch.tools import mediastream
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = mediastream.main(argv)
    finally:
        print(buf.getvalue(), end="", flush=True)
    return rc, buf.getvalue()


def udp_socket(port=0, host="127.0.0.1"):
    """A non-blocking UDP socket bound to (host, port), 16 MB buffers where
    the kernel takes them."""
    sk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for opt in (socket.SO_RCVBUF, socket.SO_SNDBUF):
        with contextlib.suppress(OSError):
            sk.setsockopt(socket.SOL_SOCKET, opt, 1 << 24)
    sk.bind((host, port))
    sk.setblocking(False)
    return sk


class _Thread(threading.Thread):
    """A thread that keeps its target's result or exception."""

    def __init__(self, fn, name):
        super().__init__(name=name, daemon=True)
        self.fn, self.result, self.error = fn, None, None

    def run(self):
        try:
            self.result = self.fn()
        except BaseException as e:     # handed to the caller by join_result
            self.error = e

    def join_result(self, timeout):
        self.join(timeout)
        if self.is_alive():
            raise AssertionError(f"{self.name} did not end within {timeout:.0f} s")
        if self.error is not None:
            raise self.error
        return self.result


def conference_clients(dev, legs, client_ticks, server_port, client_port):
    """16a's clients: phase 7a's (mu-law, AEC + AGC, leg 4k talking in
    conference k), ``client_ticks`` long, on one batch edge bound to
    ``client_port`` and sending to ``server_port``, answered with SSRCs
    from ``CONF_EXAMPLE_SSRC``, their ring primed with
    ``CONF_EXAMPLE_PREFILL`` replies; warmed up. Returns (the Session, its
    socket, which the caller closes)."""
    sess = Session(dev, legs, client_ticks, seed=160, with_server=False)
    sess.settle = CONF_EXAMPLE_SETTLE
    sock = udp_socket(client_port)
    try:
        sess.clients.enable_batch_edge(rx_sock=sock, tx_sock=sock,
                                       remote=("127.0.0.1", server_port),
                                       ssrc_base=CONF_EXAMPLE_SSRC,
                                       prefill=CONF_EXAMPLE_PREFILL)
        sess.clients.ticker.warm_up()
    except BaseException:
        sock.close()
        raise
    return sess, sock


def conference_argv(dev, legs, conf_size, seconds, server_port, client_port) -> list:
    """The conference example's arguments for 16a."""
    return ["--legs", str(legs), "--port", str(server_port), "--client",
            f"127.0.0.1:{client_port}", "--conf-size", str(conf_size), "--ssrc-base",
            hex(CONF_EXAMPLE_SSRC), "--seconds", str(seconds)] + device_args(dev)


def count_sections(kernels, ticker, owner, marks):
    """Wrap ``ticker``'s pull and its warm-up so that each appends
    (``owner``, the launch counts) to ``marks`` first. A tick's pull and
    launches run inside ``core/ticker.DISPATCH``, which tickers on several
    threads take in turn, and the wrapped warm-up takes it too, so each
    section's launches are those between its mark and the next one
    (``split_counts``)."""
    from mediastreamer2_tpu_torch.core.ticker import DISPATCH
    pull, push, warm_up = ticker._io_pull, ticker._io_push, ticker.warm_up

    def marked(tick):
        marks.append((owner, kernels.launch_counts()))
        return pull(tick)

    def marked_warm_up():
        with DISPATCH:
            marks.append((owner, kernels.launch_counts()))
            warm_up()
    ticker.set_io(pull=marked, push=push)
    ticker.warm_up = marked_warm_up


def split_counts(marks, final, first_owner) -> dict:
    """{owner: launches} from ``count_sections``' marks: each section's
    launches (its mark to the next, the last to ``final``) go to its owner,
    those before the first mark to ``first_owner``."""
    names = list(final)
    out = {o: dict.fromkeys(names, 0) for o in {first_owner, *(o for o, _ in marks)}}
    bounds = [(first_owner, dict.fromkeys(names, 0))] + marks + [(None, final)]
    for (owner, a), (_, b) in zip(bounds, bounds[1:]):
        for k in names:
            out[owner][k] += b[k] - a[k]
    return out


def conference_bars(sess, recv, srv_recv, client_ticks, label):
    """16a's bars on the clients' recordings (``Session.check``: listeners
    above 0.85 against the speech sent, 0.7 against the mic, mix-minus,
    finite outputs), finite state, and every leg at least half its packets
    both ways (``recv``: the clients' edge, ``srv_recv``: the server's
    least). Returns the line that states them."""
    ok, line = sess.check(conf_step=1)
    state_finite = all(_tree_finite(e) for e in sess.clients.ticker.state.values() if e)
    if min(min(recv), srv_recv) < client_ticks // 2:
        raise AssertionError(f"{label}: a leg received only {min(min(recv), srv_recv)} packets")
    if not (ok and state_finite):
        raise AssertionError(f"{label}: bars not met: {line}; state finite {state_finite}")
    return f"{line}; state finite {state_finite}"


def conference_example(kernels, dev, card, legs=CONF_EXAMPLE_LEGS, seconds=CONF_EXAMPLE_SECONDS,
                       client_ticks=CONF_EXAMPLE_CLIENT_TICKS, conf_size=CONF_EXAMPLE_SIZE):
    """Phase 16a: ``examples/conference_server`` (``--legs legs --conf-size
    4``) on a thread, paced for ``seconds``, against ``conference_clients``.
    Once its socket is bound (``run``'s ``on_ready``, where it waits) the
    clients send ``CONF_EXAMPLE_LEAD`` ticks; then it warms up and runs,
    and they follow its paced ticks, at most that many ahead and never
    held back, for ``client_ticks`` ticks inside its run,
    where a paced ticker that slips a tick never makes it up: the server's
    sequence-keyed ring (4 packets primed) then holds the clients' packets
    before it plays them, and the clients' (``CONF_EXAMPLE_PREFILL``
    primed) the server's replies. Both take turns for their host side
    (``core/ticker.DISPATCH``), so each side's launches are counted apart
    (``count_sections``). Bars from tick 40: ``conference_bars``; on the
    card each side's launches (the clients' fused_volume 2, mdf_apply 1,
    mdf_update_fused 1 a tick; the server's fused_volume once a tick and
    once for each of its two warm-ups). Returns {"conference_server":
    (its launches, its ticks), "conference_clients": (theirs, theirs)}."""
    from mediastreamer2_tpu_torch.examples import conference_server
    base = free_ports(2)
    server_port, client_port = base, base + 1
    sess, sock = conference_clients(dev, legs, client_ticks, server_port, client_port)
    marks = []
    try:
        count_sections(kernels, sess.clients.ticker, "clients", marks)
        argv = conference_argv(dev, legs, conf_size, seconds, server_port, client_port)

        def ready(server):                  # the server waits here, its socket bound
            count_sections(kernels, server.ticker, "server", marks)
            started.append(server)
            go.wait(60)
        started, go = [], threading.Event()
        kernels.reset_launch_counts()
        server = _Thread(lambda: conference_server.run(
            conference_server.build_parser().parse_args(argv), on_ready=ready),
            "16a conference server")
        server.start()
        while not started and server.is_alive():
            time.sleep(0.001)
        if not started:
            server.join_result(0)
        stk = started[0].ticker
        t1 = time.perf_counter()
        try:
            for k in range(client_ticks):
                if k == CONF_EXAMPLE_LEAD:      # their first packets wait on its socket
                    go.set()
                while stk.stats.ticks < k - CONF_EXAMPLE_LEAD and server.is_alive():
                    time.sleep(0.0005)
                sess.clients.ticker.do_tick()
        finally:
            go.set()
        client_s = time.perf_counter() - t1
        res = server.join_result(timeout=60 + 20 * seconds)
        side = split_counts(marks, kernels.launch_counts(), "server")
        cst = [sess.clients.edge_rx.stats(i) for i in range(legs)]
        recv = [c["recv"] for c in cst]
    finally:
        sock.close()
    srv = res["edge_stats"]
    srv_recv = min(s["recv"] for s in srv)
    ck = sess.clients.ticker.stats
    line = conference_bars(sess, recv, srv_recv, client_ticks, "16a")
    print(f"16a conference example: {legs} legs in groups of {conf_size} on the batch edge, "
          f"the server {res['ticks']} ticks paced ({seconds} s), {res['mean_step_ms']:.3f} ms a "
          f"tick (host), late {res['late_ticks']}, load {res['load']:.3f}; the clients {ck.ticks} "
          f"ticks following it in {client_s:.2f} s, {ck.mean_step_ms:.3f} ms a tick; the server's "
          f"edge: leg 0 {srv[0]}, recv min {srv_recv}, lost {sum(s['lost'] for s in srv)}, late "
          f"{sum(s['late'] for s in srv)}; the clients' edge: recv min {min(recv)}, lost "
          f"{sum(c['lost'] for c in cst)}, late {sum(c['late'] for c in cst)}; launches: the "
          f"server {side['server']}, the clients {side['clients']}; {line} [{card}]", flush=True)
    if torch.device(dev).type == "cuda":
        _require_counts("16a server", side["server"], {"fused_volume": res["ticks"] + 2})
        _require_counts("16a clients", side["clients"], {
            "fused_volume": 2 * ck.ticks, "mdf_apply": ck.ticks, "mdf_update_fused": ck.ticks})
    return {"conference_server": (side["server"], res["ticks"]),
            "conference_clients": (side["clients"], ck.ticks)}


def conference_example_process(dev, card, legs=CONF_EXAMPLE_LEGS, seconds=CONF_EXAMPLE_SECONDS,
                               client_ticks=CONF_EXAMPLE_CLIENT_TICKS,
                               conf_size=CONF_EXAMPLE_SIZE):
    """Phase 16a from a fresh interpreter: ``python -m
    mediastreamer2_tpu_torch.examples.conference_server`` with 16a's
    arguments. Its clients are the native edge in this process
    (``BatchRtpTx`` / ``BatchRtpRx`` on one socket, SSRCs from
    ``CONF_EXAMPLE_SSRC``): leg 4k sends mu-law speech, the others
    silence, and every leg's replies are decoded on the CPU. 16a's AEC +
    AGC clients tick at 25-45 ms at 1,024 legs and fall behind a server
    that has its process to itself (listeners 0.5963 against them on an
    H100); the edge sends a tick in a few ms. The clients start at
    the server's first line (printed once it has warmed up) and follow
    its replies: tick k waits until leg 0 has received k -
    ``CONF_EXAMPLE_LEAD`` of them. The server must exit 0 and print its
    ticker's and leg 0's statistics; from tick 40 every listener above
    0.85 against its talker's speech as sent, each talker's own stream
    under 5% of its listeners' energy (mix-minus), every leg at least half
    its replies. Returns the line's numbers as a dict."""
    from mediastreamer2_tpu_torch.native import BatchRtpRx, BatchRtpTx
    from mediastreamer2_tpu_torch.ops.g711 import (float_to_pcm16, pcm16_to_float, ulaw_decode,
                                                   ulaw_encode)
    from mediastreamer2_tpu_torch.utils.signals import make_speechlike
    S = 80
    base = free_ports(2)
    server_port, client_port = base, base + 1
    speech = np.zeros((legs, S * client_ticks), np.float32)
    for k in range(-(-legs // 4)):
        speech[4 * k] = make_speechlike(S * client_ticks, 8000, seed=160 + k)
    codes = ulaw_encode(float_to_pcm16(torch.from_numpy(speech))).numpy().astype(np.uint8)
    said = pcm16_to_float(ulaw_decode(torch.from_numpy(codes.astype(np.int32)))).numpy()
    got = np.full((client_ticks, legs, S), 0xFF, np.uint8)      # mu-law's zero
    sock = udp_socket(client_port)
    tx, rx = BatchRtpTx(sock, legs, S), BatchRtpRx(legs, S, ring_depth=64)
    rx.add_socket(sock)
    for i in range(legs):
        tx.config(i, "127.0.0.1", server_port, ssrc=CONF_EXAMPLE_SSRC + i)
        rx.map_ssrc(CONF_EXAMPLE_SSRC + i, i)
        rx.set_prefill(i, CONF_EXAMPLE_PREFILL)
    lines = []
    cmd = [sys.executable, "-m", "mediastreamer2_tpu_torch.examples.conference_server",
           *conference_argv(dev, legs, conf_size, seconds, server_port, client_port)]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        t0 = time.perf_counter()
        while not any(ln.startswith("conference server:") for ln in lines):
            if proc.poll() is not None or time.perf_counter() - t0 > 120:
                raise AssertionError(f"16a process: no server line: {''.join(lines)[-1500:]}")
            time.sleep(0.005)
        t1 = time.perf_counter()
        for k in range(client_ticks):
            while rx.stats(0)["recv"] < k - CONF_EXAMPLE_LEAD and proc.poll() is None:
                rx.poll()
                time.sleep(0.0005)
            tx.send(codes[:, k * S:(k + 1) * S], S)
            rx.poll()
            out, flags = rx.read_tick()
            got[k][flags.astype(bool)] = out[flags.astype(bool)]
        client_s = time.perf_counter() - t1
        rc = proc.wait(timeout=60 + 20 * seconds)
        reader.join(10)
        recv = [rx.stats(i)["recv"] for i in range(legs)]
    finally:
        sock.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines)
    leg0 = re.search(r"stats leg0: (\{.*\})", out)
    tk = re.search(r"ticker: TickerStats\(ticks=(\d+), late_ticks=(\d+).*total_step_ms=([0-9.e+-]+)\)",
                   out)
    if rc != 0 or leg0 is None or tk is None:
        raise AssertionError(f"16a process: the server exited {rc}: {out[-1500:]}")
    srv0 = ast.literal_eval(leg0.group(1))
    ticks, late = int(tk.group(1)), int(tk.group(2))
    rec = pcm16_to_float(ulaw_decode(torch.from_numpy(
        got.transpose(1, 0, 2).reshape(legs, -1).astype(np.int32)))).numpy()
    talkers = [leg - leg % 4 for leg in range(legs) if leg % 4]
    listeners = [leg for leg in range(legs) if leg % 4]
    start = S * CONF_EXAMPLE_SETTLE
    sims, _ = settled_sims(said[talkers], rec[listeners], start)
    own = (rec[talkers, start:].astype(np.float64) ** 2).mean(axis=1)
    heard = (rec[listeners, start:].astype(np.float64) ** 2).mean(axis=1) + 1e-20
    ratio = float((own / heard).max())
    res = {"ticks": ticks, "late_ticks": late, "ms_per_tick": float(tk.group(3)) / max(ticks, 1),
           "leg0": srv0, "recv_min": min(recv), "client_s": client_s,
           "listeners_min": float(sims.min()), "energy_ratio_max": ratio}
    print(f"16a conference example from a fresh interpreter (python -m): {legs} legs, the "
          f"server {ticks} ticks paced ({seconds} s), {res['ms_per_tick']:.3f} ms a tick "
          f"(host), late {late}, its leg 0 {srv0}; the clients (the native edge) "
          f"{client_ticks} ticks following its replies in {client_s:.2f} s, recv min "
          f"{min(recv)}; listeners vs talkers from tick {CONF_EXAMPLE_SETTLE}: audio_diff min "
          f"{sims.min():.4f} against the speech sent; talker/listener energy max {ratio:.2e} "
          f"[{card}]", flush=True)
    if min(min(recv), srv0["recv"]) < client_ticks // 2:
        raise AssertionError(f"16a process: a leg received only {min(min(recv), srv0['recv'])} "
                             f"packets")
    if not (sims.min() > EXAMPLE_BAR and ratio < 0.05 and np.isfinite(rec).all()):
        raise AssertionError(f"16a process: bars not met: listeners {sims.min():.4f}, "
                             f"energy ratio {ratio:.2e}")
    return res


def cli_bench(kernels, dev, card, legs=CLI_BENCH_LEGS, seconds=CLI_BENCH_SECONDS):
    """Phase 16b: ``mediastream bench --legs legs --seconds seconds``, its
    line and the tx load printed; it must exit 0 and, on the card, launch
    fused_volume (the two streams' volumes). Returns (launches, ticks)."""
    kernels.reset_launch_counts()
    rc, out = cli(device_args(dev) + ["bench", "--legs", str(legs), "--seconds", str(seconds)])
    launches = kernels.launch_counts()
    m = re.search(r"in ([0-9.]+)s \(tx load ([0-9.]+), late (\d+)\)", out)
    print(f"16b mediastream bench: {legs} legs x {seconds * 100} ticks, exit {rc}, "
          f"{m.group(1) if m else None} s, tx load {m.group(2) if m else None}, late "
          f"{m.group(3) if m else None}, launches {launches} [{card}]", flush=True)
    if rc != 0 or m is None or f"{legs} duplex legs x {seconds * 100} ticks" not in out:
        raise AssertionError(f"16b: bench exited {rc}: {out!r}")
    if torch.device(dev).type == "cuda" and not launches["fused_volume"]:
        raise AssertionError(f"16b: no fused_volume launch: {launches}")
    return launches, seconds * 100


CALL_PAIRS = ("ec_agc", "srtp")


def call_pair_args(name):
    """``mediastream call``'s options for 16c's pair ``name``: ``--ec --agc``,
    or ``--srtp-key`` (a seeded 30-byte master key and salt, the default
    suite AES_CM_128_HMAC_SHA1_80)."""
    if name == "ec_agc":
        return ["--ec", "--agc"]
    return ["--srtp-key", np.random.default_rng(163).bytes(30).hex()]


def start_together(cmds, ready_prefix, timeout):
    """Start ``cmds`` (unbuffered, in the repo), stop each with SIGSTOP as
    soon as it prints a line starting with ``ready_prefix`` and resume them
    all at once with SIGCONT. Returns (the processes, a list of each one's
    output lines, the reader threads that fill them until each exits)."""
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}
    procs = [subprocess.Popen(c, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for c in cmds]
    lines = [[] for _ in procs]
    held = [threading.Event() for _ in procs]

    def read(i):
        for ln in procs[i].stdout:
            if ln.startswith(ready_prefix) and not held[i].is_set():
                procs[i].send_signal(signal.SIGSTOP)
                held[i].set()
            lines[i].append(ln)
        held[i].set()                               # exited before its line
    readers = [threading.Thread(target=read, args=(i,), daemon=True) for i in range(len(procs))]
    for r in readers:
        r.start()
    t0 = time.perf_counter()
    try:
        for h in held:
            if not h.wait(max(timeout - (time.perf_counter() - t0), 1.0)):
                raise AssertionError(f"no {ready_prefix!r} line within {timeout:.0f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGCONT)
    return procs, lines, readers


def cli_calls(dev, card, directory, seconds=CLI_CALL_SECONDS, pairs=CALL_PAIRS):
    """Phase 16c: two ``mediastream call`` processes (fresh interpreters,
    ``python -m``) a pair over localhost UDP for ``seconds``, each sending
    a WAV of speech and recording what it receives; the pairs of
    ``call_pair_args`` one after the other (four paced processes at once
    ran late on a loaded host). Each side binds its socket, prints ``call
    leg up`` and then warms up and ticks: both are held at that line and
    released together (``start_together``), since a side that starts
    ticking after its socket has queued the other's packets plays them
    late, in the JAX package as in the port (0.2624 with one side 21 ticks
    late, ``tests/test_torch_cli_tools.py``). Each side's recording of the
    other's speech must be above 0.8 audio_diff. Returns {(pair, side):
    similarity}."""
    from mediastreamer2_tpu_torch.io.wav import read_wav, write_wav
    from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff
    from mediastreamer2_tpu_torch.utils.signals import make_speechlike
    base = free_ports(2, host="127.0.0.1")
    sims = {}
    for k, name in enumerate(pairs):
        cmds, files = [], {}
        for side in (0, 1):
            sig = make_speechlike(8000 * (seconds - 1), 8000, seed=71 + 2 * k + side)
            fin = os.path.join(directory, f"{name}_{side}_in.wav")
            fout = os.path.join(directory, f"{name}_{side}_out.wav")
            write_wav(fin, sig, 8000)
            files[side] = (sig, fout)
            cmds.append([sys.executable, "-m", "mediastreamer2_tpu_torch.tools.mediastream",
                         *device_args(dev), "call", "--seconds", str(seconds), "--local-port",
                         str(base + side), "--remote", f"127.0.0.1:{base + 1 - side}",
                         "--infile", fin, "--outfile", fout, *call_pair_args(name)])
        t0 = time.perf_counter()
        procs, lines, readers = start_together(cmds, "call leg up", CLI_CALL_TIMEOUT_S)
        outs = {}
        try:
            for side, p in enumerate(procs):
                left = CLI_CALL_TIMEOUT_S - (time.perf_counter() - t0)
                rc = p.wait(timeout=max(left, 1.0))
                readers[side].join(10)
                outs[side] = ("".join(lines[side]), rc)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for side in (0, 1):
            out, rc = outs[side]
            if rc != 0:
                raise AssertionError(f"16c {name} side {side} exited {rc}: {out[-1500:]}")
            rec, _ = read_wav(files[side][1])
            sims[(name, side)] = audio_diff(files[1 - side][0], rec)[0]
        sent = [next((ln.strip() for ln in outs[side][0].splitlines() if ln.startswith("sent=")),
                     "") for side in (0, 1)]
        opts = " ".join(a for a in call_pair_args(name) if a.startswith("--"))
        print(f"16c mediastream call pair {name}: {seconds} s over localhost UDP, two processes "
              f"released together ({opts}); each side's recording of the other's speech: "
              f"audio_diff {sims[(name, 0)]:.4f} / {sims[(name, 1)]:.4f} (bar {CLI_CALL_BAR}); "
              f"their lines {sent[0]!r} / {sent[1]!r}; the pair took "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    low = {k: v for k, v in sims.items() if not v > CLI_CALL_BAR}
    if low:
        raise AssertionError(f"16c: recordings at or under {CLI_CALL_BAR}: {low}")
    return sims


def cli_call(kernels, dev, card, seconds=CLI_CALL_COUNTED_SECONDS):
    """16c's leg in this process: ``mediastream call --ec --agc`` for
    ``seconds``, its speech sent to a port nobody reads, the counts set to 0
    just before it: which AEC update kernel a leg at B = 1 launches (the
    bf16 shadow's ``mdf_update_fused`` unless the environment picks the f32
    shadow's ``mdf_update``). On the card: mdf_apply and one of the two
    updates once a tick, fused_volume twice (the mic's and the speaker's
    volumes), each once more in the stream's warm-up. Returns (launches,
    ticks)."""
    port = free_ports(2, host="127.0.0.1")
    kernels.reset_launch_counts()
    rc, out = cli(device_args(dev) + ["call", "--seconds", str(seconds), "--local-port",
                                      str(port), "--remote", f"127.0.0.1:{port + 1}",
                                      "--ec", "--agc"])
    launches = kernels.launch_counts()
    ticks = 100 * seconds
    update = max(("mdf_update", "mdf_update_fused"), key=launches.get)
    print(f"16c mediastream call in this process (--ec --agc, B = 1): {ticks} ticks, exit "
          f"{rc}, the update kernel {update if launches[update] else None}, launches "
          f"{launches} [{card}]", flush=True)
    if rc != 0 or "sent=" not in out:
        raise AssertionError(f"16c call: exited {rc}: {out[-1500:]}")
    if torch.device(dev).type == "cuda":      # each a tick and once in the warm-up
        _require_counts("16c call", launches, {"mdf_apply": ticks + 1, update: ticks + 1,
                                               "fused_volume": 2 * (ticks + 1)})
    return launches, ticks


def drain_pump(pump, receivers, want, wait_s=GW_EXAMPLE_DRAIN_S):
    """Each receiver's datagrams from ``pump``, read until every receiver
    holds ``want`` or ``wait_s`` has passed. A sender's last datagrams can
    still sit in their sockets, not yet taken by the pump's thread, when
    the sender's thread has been joined: on a loaded host 16d read 99 of
    100 a leg, and the 100th a moment later."""
    got = [[] for _ in receivers]
    deadline = time.perf_counter() + wait_s
    while True:
        for g, r in zip(got, receivers):
            g.extend(d for _, d in pump.read(r.sock))
        if all(len(g) >= want for g in got) or time.perf_counter() >= deadline:
            return got
        time.sleep(0.005)


def gateway_example(kernels, dev, card, legs=GW_EXAMPLE_LEGS, seconds=GW_EXAMPLE_SECONDS):
    """Phase 16d: ``examples/transcode_gateway`` (mu-law at 8 kHz in, G.722
    at 16 kHz out, a receive and a send socket a leg) on a thread, paced
    for ``seconds``. This process sends each leg's mu-law speech to
    ``--in-port + 2n`` through a batch edge's sender, a tick's packets
    once the gateway has run up to ``GW_EXAMPLE_LEAD`` ticks behind them,
    and receives the G.722 on ``out + 2n`` through a ``NativeIoPump``; the
    streams received are decoded from their first packet by
    ``kernels.g722_decode`` (after the counted run) and, halved to 8 kHz
    (the mean of each pair of samples), held from tick 40 to above 0.85
    audio_diff against the speech as sent. On the card the gateway
    launches g722_encode once a tick and once for its warm-up, and nothing
    else. Returns (launches, the gateway's ticks)."""
    from mediastreamer2_tpu_torch.examples import transcode_gateway
    from mediastreamer2_tpu_torch.native import BatchRtpTx, NativeIoPump
    from mediastreamer2_tpu_torch.net.rtp import RtpPacket, UdpTransport
    from mediastreamer2_tpu_torch.ops.g711 import (float_to_pcm16, pcm16_to_float, ulaw_decode,
                                                   ulaw_encode)
    ticks = seconds * 100
    raise_nofile(3 * legs + 512, phase="16d")
    base = free_ports(2 * legs, host="127.0.0.1")
    in_port, out_port = base, base + 1
    speech = speech_legs(legs, S8 * ticks, seed=161)
    codes = ulaw_encode(float_to_pcm16(torch.from_numpy(speech))).numpy().astype(np.uint8)
    said = pcm16_to_float(ulaw_decode(torch.from_numpy(codes.astype(np.int32)))).numpy()
    pump = NativeIoPump()
    receivers, tx_sock, tx = [], None, None
    try:
        for n in range(legs):
            r = UdpTransport(local_port=out_port + 2 * n)
            r.attach_pump(pump)
            receivers.append(r)
        tx_sock = udp_socket()
        tx = BatchRtpTx(tx_sock, legs, S8)
        for n in range(legs):
            tx.config(n, "127.0.0.1", in_port + 2 * n, ssrc=GW_EXAMPLE_SSRC + n, pt=0)
        argv = ["--legs", str(legs), "--in-port", str(in_port), "--out",
                f"127.0.0.1:{out_port}", "--seconds", str(seconds)] + device_args(dev)
        ready = []
        kernels.reset_launch_counts()
        gw = _Thread(lambda: transcode_gateway.run(
            transcode_gateway.build_parser().parse_args(argv), on_ready=ready.append),
            "16d gateway")
        t0 = time.perf_counter()
        gw.start()
        while not ready and gw.is_alive():
            time.sleep(0.001)
        tk = ready[0].ticker if ready else None
        for k in range(ticks):
            while tk is not None and tk.stats.ticks < k - GW_EXAMPLE_LEAD and gw.is_alive():
                time.sleep(0.0005)
            tx.send(np.ascontiguousarray(codes[:, k * S8:(k + 1) * S8]), ts_inc=S8)
        res = gw.join_result(timeout=60 + 20 * seconds)
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        got = [[RtpPacket.unpack(d) for d in g] for g in drain_pump(pump, receivers, res["ticks"])]
        dropped = sum(pump.dropped(r.sock) for r in receivers)
    finally:
        for r in receivers:
            r.close()
        pump.close()
        if tx is not None:
            tx.close()
        if tx_sock is not None:
            tx_sock.close()
    # each leg's G.722 stream in sequence order from its first packet
    rx = np.zeros((legs, ticks * S8), np.uint8)
    n_recv, missing = ticks, 0
    for n, pkts in enumerate(got):
        seq0 = pkts[0].seq if pkts else 0
        at = {(p.seq - seq0) & 0xFFFF: p.payload for p in pkts}
        for k, payload in at.items():
            if k < ticks:
                rx[n, k * S8:(k + 1) * S8] = np.frombuffer(payload, np.uint8)
        n_recv = min(n_recv, len(pkts))
        missing += ticks - len([k for k in at if k < ticks])
    out16 = decode_captures(dev, rx, ticks)
    out8 = out16.reshape(legs, -1, 2).mean(axis=2)
    sims, lags = settled_sims(said, out8, S8 * GW_EXAMPLE_SETTLE, dev=dev)
    print(f"16d gateway example: {legs} legs, mu-law at 8 kHz in on :{in_port}+2n, G.722 at "
          f"16 kHz out to :{out_port}+2n ({2 * legs} gateway sockets, {legs} receivers on a "
          f"pump), {res['ticks']} ticks paced ({seconds} s) in {wall:.1f} s, "
          f"{res['mean_step_ms']:.3f} ms a tick (host), late {res['late_ticks']}, load "
          f"{res['load']:.3f}; packets received a leg min {n_recv} of {res['ticks']}, missing "
          f"{missing}, pump drops {dropped}; listeners from tick {GW_EXAMPLE_SETTLE} against the "
          f"speech sent: audio_diff min {sims.min():.4f} (median {np.median(sims):.4f}, lags "
          f"{lags.min()}-{lags.max()} samples at 8 kHz); launches {launches} [{card}]", flush=True)
    if torch.device(dev).type == "cuda":
        _require_counts("16d", launches, {"g722_encode": res["ticks"] + 1})
    if n_recv < ticks // 2 or dropped:
        raise AssertionError(f"16d: a leg received {n_recv} packets, pump drops {dropped}")
    if not sims.min() > EXAMPLE_BAR:
        raise AssertionError(f"16d: listeners at or under {EXAMPLE_BAR}: legs "
                             f"{np.flatnonzero(sims <= EXAMPLE_BAR)[:8]}, min {sims.min():.4f}")
    return launches, res["ticks"]


def ivr_and_secure_calls(dev, card, legs=IVR_LEGS, seconds=IVR_SECONDS):
    """Phase 16e: ``examples/ivr_server`` at ``legs`` legs for ``seconds``
    (not paced) and ``examples/secure_call`` with DTLS-SRTP and with
    ``--zrtp``, each through its ``main``, which must return 0 by the
    example's own check (every digit received right and the callers heard
    audio; the call secured and its audio above 0.9)."""
    from mediastreamer2_tpu_torch.examples import ivr_server, secure_call
    t0 = time.perf_counter()
    rc = {"ivr": ivr_server.main(["--legs", str(legs), "--seconds", str(seconds)]
                                 + device_args(dev))}
    for name, extra in (("dtls", []), ("zrtp", ["--zrtp"])):
        rc[name] = secure_call.main(extra + device_args(dev))
    print(f"16e examples: ivr_server at {legs} legs x {seconds * 100} ticks, secure_call with "
          f"DTLS-SRTP and with ZRTP: exit codes {rc} in {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    if any(rc.values()):
        raise AssertionError(f"16e: an example failed its own check: {rc}")
    return rc


def pcap_fixture(path, seed=164, packets=PCAP_PACKETS):
    """A mu-law RTP capture written by ``io/pcap.write_pcap``: seeded
    speech, one 80-sample packet a 10 ms tick (sequence numbers across the
    16-bit wrap), packets ``PCAP_SWAPPED`` and ``PCAP_SWAPPED + 1``
    captured in the other order (both before the playout reaches them) and
    packet ``PCAP_MISSING`` left out. Returns the codes [packets, 80] in
    sequence order."""
    from mediastreamer2_tpu_torch.io.pcap import CapturedPacket, write_pcap
    from mediastreamer2_tpu_torch.net.rtp import RtpPacket
    from mediastreamer2_tpu_torch.ops.g711 import float_to_pcm16, ulaw_encode
    sig = speech_legs(1, S8 * packets, seed=seed)[0]
    codes = ulaw_encode(float_to_pcm16(torch.from_numpy(sig))).numpy().astype(np.uint8)
    codes = codes.reshape(packets, S8)
    caps = [CapturedPacket(ts=1000.0 + 0.01 * k, udp_payload=RtpPacket(
        payload_type=0, seq=(65500 + k) & 0xFFFF, timestamp=S8 * k, ssrc=0x1234,
        payload=codes[k].tobytes()).pack()) for k in range(packets)]
    a = PCAP_SWAPPED
    caps[a], caps[a + 1] = caps[a + 1], caps[a]
    caps[a].ts, caps[a + 1].ts = caps[a + 1].ts, caps[a].ts
    del caps[PCAP_MISSING]
    write_pcap(path, caps)
    return codes


def mkv_fixture(path, codec, frames=MKV_FRAMES, seed=165):
    """An MKV of one video track of fixed bytes (no encoder): ``codec``
    "vp8" (frames of 300-3,000 random bytes) or "h264" (an avcC with one
    SPS and one PPS, 4-byte NAL lengths; each frame an IDR or a non-IDR
    slice, often longer than an MTU, and an SEI). Frames are 33 ms apart,
    every 5th a keyframe. Returns ([(keyframe, frame bytes or [NAL,
    ...])], the H.264 parameter sets)."""
    from mediastreamer2_tpu_torch.io.mkv import TRACK_TYPE_VIDEO, MkvTrack, MkvWriter
    rng = np.random.default_rng(seed)
    rnd = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    want, params = [], []
    if codec == "vp8":
        track = MkvTrack(1, TRACK_TYPE_VIDEO, "V_VP8", width=64, height=64)
    else:
        params = [b"\x67" + rnd(11), b"\x68" + rnd(4)]
        avcc = (bytes([1, 0x42, 0xC0, 0x1E, 0xFF, 0xE1]) + len(params[0]).to_bytes(2, "big")
                + params[0] + b"\x01" + len(params[1]).to_bytes(2, "big") + params[1])
        track = MkvTrack(1, TRACK_TYPE_VIDEO, "V_MPEG4/ISO/AVC", width=64, height=64,
                         codec_private=avcc)
    w = MkvWriter(path, [track])
    for k in range(frames):
        key = k % 5 == 0
        if codec == "vp8":
            data = rnd(int(rng.integers(300, 3000)))
            want.append((key, data))
        else:
            nals = [bytes([0x65 if key else 0x41]) + rnd(int(rng.integers(200, 2500))),
                    b"\x06" + rnd(20)]
            data = b"".join(len(n).to_bytes(4, "big") + n for n in nals)
            want.append((key, nals))
        w.write_frame(1, 33 * k, data, keyframe=key)
    w.close()
    return want, params


def mkv_received(datagrams, codec):
    """The frames that ``mkvstream``'s RTP packets carry, in sequence order:
    VP8 payloads joined up to each marker; H.264's NAL units through
    ``net/h26x.H264Unpacker``, a list a marker."""
    from mediastreamer2_tpu_torch.net.h26x import H264Unpacker
    from mediastreamer2_tpu_torch.net.rtp import RtpPacket
    from mediastreamer2_tpu_torch.ops.vp8 import vp8_payload_unpack
    pkts = sorted((RtpPacket.unpack(d) for d in datagrams), key=lambda p: p.seq)
    frames, cur, unpacker = [], [], H264Unpacker()
    for p in pkts:
        if codec == "vp8":
            cur.append(vp8_payload_unpack(p.payload)[0])
        else:
            cur.extend(unpacker.push(p.payload))
        if p.marker:
            frames.append(b"".join(cur) if codec == "vp8" else cur)
            cur = []
    return frames


def mkvstream_check(directory, codec, dev):
    """``mediastream mkvstream`` of ``mkv_fixture`` to a local socket: the
    frames must parse back from its packets (H.264 with the parameter sets
    before the first frame and every keyframe). Returns (packets, frames)
    received."""
    path = os.path.join(directory, f"stream_{codec}.mkv")
    want, params = mkv_fixture(path, codec)
    rcv = udp_socket()
    try:
        rc, out = cli(device_args(dev) + ["mkvstream", path,
                                          f"127.0.0.1:{rcv.getsockname()[1]}",
                                          "--local-port", "0"])
        datagrams = []
        deadline = time.perf_counter() + 2.0
        while time.perf_counter() < deadline:
            try:
                datagrams.append(rcv.recv(65536))
            except BlockingIOError:
                if datagrams and len(mkv_received(datagrams, codec)) == len(want):
                    break
                time.sleep(0.01)
    finally:
        rcv.close()
    got = mkv_received(datagrams, codec)
    expect = [data for _, data in want] if codec == "vp8" else [
        (list(params) if (k == 0 or key) else []) + nals for k, (key, nals) in enumerate(want)]
    if rc != 0 or got != expect or f"streamed {len(want)} frames" not in out:
        raise AssertionError(f"16f mkvstream {codec}: exit {rc}, {len(got)} of {len(want)} "
                             f"frames back, equal {got == expect}: {out!r}")
    return len(datagrams), len(got)


def other_subcommands(dev, card, directory):
    """Phase 16f: the rest of ``mediastream`` on ``dev``: ``tones 123A#``
    (the digits detected equal the input), ``audiocmp`` of that WAV against
    itself delayed and halved (shift found, above 0.9), ``mtu 127.0.0.1``,
    ``ring`` and ``echo`` for a second (100 ticks), ``play`` of the tones
    WAV to its end, ``record`` to .wav and .smff (the tone, equal in both),
    ``pcap-play`` of ``pcap_fixture`` (the sequence order's decode, one
    packet lost, none late), ``mkvstream`` of VP8 and H.264
    (``mkvstream_check``), and ``record x.mkv``: where the machine has no
    libopus it must raise naming libopus and write nothing, else write the
    file. Returns {check: passed}."""
    from mediastreamer2_tpu_torch.io.wav import read_wav, write_wav
    from mediastreamer2_tpu_torch.models.media_player import _read_smff_audio
    from mediastreamer2_tpu_torch.ops.g711 import pcm16_to_float, ulaw_decode
    from mediastreamer2_tpu_torch.ops.host_codecs import opus_available
    t0 = time.perf_counter()
    d = device_args(dev)
    j = lambda name: os.path.join(directory, name)
    checks = {}
    rc, out = cli(d + ["tones", TONES_DIGITS, "--outfile", j("tones.wav")])
    checks["tones"] = rc == 0 and f"detected '{TONES_DIGITS}'" in out
    sig, rate = read_wav(j("tones.wav"))
    write_wav(j("tones_late.wav"), 0.5 * np.roll(sig, 123), rate)
    rc, out = cli(d + ["audiocmp", j("tones.wav"), j("tones_late.wav"), "--threshold", "0.9"])
    checks["audiocmp"] = rc == 0 and "(shift 123 samples)" in out
    rc, out = cli(d + ["mtu", "127.0.0.1"])
    # -1 where the kernel refuses the path-MTU options (gVisor)
    checks["mtu"] = rc == 0 and re.search(r"mtu to 127\.0\.0\.1: (-1|\d+)\n", out) is not None
    rc, out = cli(d + ["ring", "--seconds", "1"])
    checks["ring"] = rc == 0 and "rang for 1s (" in out
    rc, out = cli(d + ["echo", "--seconds", "1"])
    checks["echo"] = rc == 0 and "echo loop ran 100 ticks" in out
    rc, out = cli(d + ["play", j("tones.wav")])
    checks["play"] = rc == 0 and out.rstrip().endswith("done")
    for ext in ("wav", "smff"):
        rc, out = cli(d + ["record", j(f"rec.{ext}"), "--seconds", "1"])
        checks[f"record .{ext}"] = rc == 0 and os.path.exists(j(f"rec.{ext}"))
    wav, _ = read_wav(j("rec.wav"))
    smff, _ = _read_smff_audio(j("rec.smff"))
    n = min(len(wav), len(smff))
    checks["record equal"] = (n >= 7000 and float(np.abs(wav).max()) > 0.1
                              and float(np.abs(wav[:n] - smff[:n]).max()) <= 1 / 32768)
    codes = pcap_fixture(j("call.pcap"))
    rc, out = cli(d + ["pcap-play", j("call.pcap"), "--outfile", j("pcap.wav")])
    played, _ = read_wav(j("pcap.wav"))
    keep = [k for k in range(len(codes)) if k != PCAP_MISSING]
    want = pcm16_to_float(ulaw_decode(torch.from_numpy(codes[keep].reshape(-1).astype(np.int32))))
    checks["pcap-play"] = (rc == 0 and "(lost 1, late 0)" in out
                           and f"{PCAP_PACKETS - 1} RTP packets" in out
                           and played.shape == tuple(want.shape)
                           and float(np.abs(played - want.numpy()).max()) <= 1 / 32768)
    for codec in ("vp8", "h264"):
        mkvstream_check(directory, codec, dev)
        checks[f"mkvstream {codec}"] = True
    try:
        cli(d + ["record", j("rec.mkv"), "--seconds", "1"])
        refusal = None
    except RuntimeError as e:
        refusal = str(e)
    if opus_available():
        checks["record .mkv"] = refusal is None and os.path.exists(j("rec.mkv"))
    else:
        checks["record .mkv raises"] = (refusal is not None and "libopus" in refusal
                                        and not os.path.exists(j("rec.mkv")))
    print(f"16f mediastream subcommands: {checks}; record x.mkv: "
          f"{refusal or 'written (libopus found)'}; {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"16f: failed {bad}")
    return checks


def programs_cross(dev, card, legs=CROSS_IVR_LEGS, seconds=IVR_SECONDS):
    """Phase 16g: ``examples/ivr_server`` at ``legs`` legs and ``mediastream
    tones`` on the CPU and on ``dev``: the same digits received (and
    detected), every caller's recording at or above 0.999 audio_diff
    between the two, the tones' audio within 1e-6 rms. Returns (the
    recordings' audio_diff [legs], the tones' rms)."""
    from mediastreamer2_tpu_torch.examples import ivr_server
    from mediastreamer2_tpu_torch.tools.mediastream import tones
    from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff
    runs = [ivr_server.run(ivr_server.build_parser().parse_args(
        ["--legs", str(legs), "--seconds", str(seconds)] + device_args(d)))
        for d in ("cpu", dev)]
    sims = audio_diff(runs[0]["recording"], runs[1]["recording"])[0]
    digits = [sorted(r["received"]) for r in runs]
    tone = [tones(TONES_DIGITS, device=d) for d in ("cpu", dev)]
    rms = float(np.sqrt(np.mean((tone[0][1].astype(np.float64) - tone[1][1]) ** 2)))
    ok = (digits[0] == digits[1] and runs[0]["correct"] == legs and sims.min() >= CROSS_IVR_BAR
          and tone[0][0] == tone[1][0] == TONES_DIGITS and rms <= CROSS_TONES_RMS)
    print(f"16g programs, the CPU against the card: ivr_server at {legs} legs, digits received "
          f"equal {digits[0] == digits[1]} ({runs[0]['correct']} / {runs[1]['correct']} right), "
          f"the callers' recordings audio_diff min {sims.min():.6f} (bar {CROSS_IVR_BAR}); tones "
          f"detected {tone[0][0]!r} / {tone[1][0]!r}, audio rms {rms:.3e} (bar "
          f"{CROSS_TONES_RMS}); bars met {ok} [{card}]", flush=True)
    if not ok:
        raise AssertionError("16g: the programs differ between the CPU and the card")
    return sims, rms


def phase16(kernels, dev, card, phase_done=lambda n: None, conf_legs=CONF_EXAMPLE_LEGS,
            bench_legs=CLI_BENCH_LEGS, gw_legs=GW_EXAMPLE_LEGS, ivr_legs=IVR_LEGS,
            cross_legs=CROSS_IVR_LEGS, call_seconds=CLI_CALL_SECONDS):
    """Phase 16 (16a-16g). Returns {run: (launches, ticks)} of its counted
    runs: the conference example's server and its clients, the bench, the
    call in this process, the gateway example."""
    t16 = time.perf_counter()
    runs = conference_example(kernels, dev, card, conf_legs)
    conference_example_process(dev, card, conf_legs)
    phase_done("16a")
    runs["cli_bench"] = cli_bench(kernels, dev, card, bench_legs)
    phase_done("16b")
    with tempfile.TemporaryDirectory(prefix="ms2_programs_") as tmp:
        cli_calls(dev, card, tmp, call_seconds)
        runs["cli_call"] = cli_call(kernels, dev, card)
        phase_done("16c")
        runs["gateway_example"] = gateway_example(kernels, dev, card, gw_legs)
        phase_done("16d")
        ivr_and_secure_calls(dev, card, ivr_legs)
        phase_done("16e")
        other_subcommands(dev, card, tmp)
        phase_done("16f")
    programs_cross(dev, card, cross_legs)
    print(f"phase 16 took {time.perf_counter() - t16:.1f} s [{card}]", flush=True)
    return runs


def kernel_entries(results, adpcm_results, session_results, wide_results, runs) -> list:
    """The ``kernels`` JSON line's entries: each kernel of ``REPLACES`` with
    phase 2's measurements (``results``, ``adpcm_results``; the session's
    and the wideband call's shapes beside them), its launches summed over
    the counted ``runs`` ({path: (launches, ticks)}) and its launches a
    tick of each path."""
    total = {name: sum(c[name] for c, _ in runs.values()) for name in REPLACES}
    entries = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    results = dict(results)
    results.update({k: v for k, v in adpcm_results.items() if "@" not in k})
    for name in ("g726_encode", "g726_decode"):      # the gateway's rate leads the entry
        results[name] = adpcm_results[f"{name}@32"]
    for name in REPLACES:
        r = results[name]
        entry = {"name": name, "route": "cuda",
                 "source": SOURCES.get(name.split("_")[0], KERNEL_SOURCE),
                 "replaces": REPLACES[name], "launches": total[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                 "launches_per_tick": {path: c[name] / n for path, (c, n) in runs.items()}}
        if "bound_chain_ms" in r:
            entry.update(bound_bytes_ms=r["bound_bytes_ms"], bound_chain_ms=r["bound_chain_ms"])
        if "bound_depth" in r:
            entry["bound_depth"] = r["bound_depth"]
        if name.startswith("g726"):
            entry["rates_kbps"] = {kbps: {k: adpcm_results[f"{name}@{kbps}"][k] for k in keys}
                                   for kbps in G726_RATES.values()}
        for label, res_at in (("session_shapes", session_results),
                              ("wideband_shapes", wide_results)):
            if name in res_at:
                entry[label] = {k: res_at[name][k] for k in keys}
        entries.append(entry)
    return entries


def ec_kernel_entries(results, session_results, wide_results, runs) -> list:
    """The ``kernels`` JSON line's entries of ``EC_KERNELS``, as
    ``kernel_entries`` makes them, ``replaces`` naming the port's PyTorch
    operations each kernel replaces: phase 2's measurements at the
    flagship's shapes (a layout pass at its F bins), the session's and the
    wideband call's beside them, and the launches of the counted ``runs``."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    entries = []
    for name, (replaces, _) in EC_KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
                 "launches": sum(c[name] for c, _ in runs.values()),
                 **{k: results[name][k] for k in keys}, "library_ms": None,
                 "launches_per_tick": {path: c[name] / n for path, (c, n) in runs.items()}}
        for label, res_at in (("session_shapes", session_results),
                              ("wideband_shapes", wide_results)):
            entry[label] = {k: res_at[name][k] for k in keys}
        entries.append(entry)
    return entries


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false); this script runs only on the card")
    sys.path.insert(0, REPO)
    from mediastreamer2_tpu_torch import native
    from mediastreamer2_tpu_torch.models.flagship import echo_coupled_inputs
    from mediastreamer2_tpu_torch.ops import kernels, rfft
    from mediastreamer2_tpu_torch.utils.audiodiff import quality_bar

    dev = torch.device("cuda", 0)
    card = card_line()
    start = time.perf_counter()

    def phase_done(n):
        print(f"phase {n} done at {time.perf_counter() - start:.1f} s", flush=True)

    # phase 1: environment and build
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:     # nvcc (one per source) and g++ side by side
        k_build = pool.submit(kernels.build)
        e_build = pool.submit(native.build)
        p_build = pool.submit(native.build_pump)
        libs, log = k_build.result()
        edge, pump = e_build.result(), p_build.result()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          + ", ".join(os.path.relpath(p, REPO) for p in (*libs, edge, pump)), flush=True)
    if log.strip():
        print(log.strip(), flush=True)
    for name, fragment in SPILL_CHECKED.items():
        u = ptxas_usage(log, fragment)
        print(f"{name}: {u['registers']} registers, spill stores {u['spill_stores']} bytes, "
              f"spill loads {u['spill_loads']} bytes", flush=True)
        if u["spill_stores"] or u["spill_loads"]:
            raise AssertionError(f"{name} spills registers: {u}")
    print(f"edge AES: {'AES-NI/SHA-NI/PCLMUL' if native.hw_crypto() else 'libcrypto EVP'} "
          f"(hw_crypto {native.hw_crypto()})", flush=True)
    # which system libraries the host codecs would load (ctypes, as the JAX
    # package's ops/host_codecs.py and ops/h264.py look them up)
    print("system libraries: " + ", ".join(f"{name} {ctypes.util.find_library(name)}"
                                           for name in SYSTEM_LIBRARIES), flush=True)
    import resource
    from mediastreamer2_tpu_torch.net import openssl
    print(f"OpenSSL: {openssl.openssl_version()}; RLIMIT_NOFILE soft / hard: "
          + " / ".join(map(str, resource.getrlimit(resource.RLIMIT_NOFILE))), flush=True)
    import glob
    import importlib.util
    print(f"cv2 importable {importlib.util.find_spec('cv2') is not None}; /dev/video* "
          f"{sorted(glob.glob('/dev/video*'))}; DISPLAY {os.environ.get('DISPLAY')!r}",
          flush=True)

    phase_done(1)

    # phase 2: kernels against their plain versions on the card, at the
    # flagship's, the session's and the wideband call's shapes; G.722
    results = kernel_checks(kernels, dev, card, LEGS, S, P, F)
    session_results = kernel_checks(kernels, dev, card, SESSION_LEGS, S8, SP, SF, full=False)
    wide_results = kernel_checks(kernels, dev, card, WIDE_LEGS, S16, SP, WF, full=False)
    results.update(g722_checks(kernels, dev, card, WIDE_LEGS))
    # aec_decide on rows longer than its registers hold (96 kHz mono or 48
    # kHz stereo, float4; 44.1 kHz stereo, sample by sample)
    g = torch.Generator(device=dev).manual_seed(960)
    for s_long in DECIDE_LONG_S:
        err = decide_checks(kernels, g, SESSION_LEGS, s_long)
        print(f"kernel aec_decide [B={SESSION_LEGS} S={s_long}]: matches plain (flags, "
              f"counters and e_s equal; rtol 1e-5, max abs err {err}; whole batch = 4 row "
              f"slices, bit for bit) [{card}]", flush=True)
    adpcm_results = adpcm_checks(kernels, dev, card, GATEWAY_LEGS)

    phase_done(2)

    # phase 3: the flagship at 4,096 legs, counted launches
    mic, far = flagship_fixture(LEGS, TICKS)
    kernels.reset_launch_counts()
    dft0 = dict(rfft.calls)
    state, out, finite, per_tick = run_flagship(LEGS, TICKS, dev, mic, far)
    launches = kernels.launch_counts()
    dfts = {k: v - dft0[k] for k, v in rfft.calls.items()}
    del mic, far
    ec = state["ec"]
    conv = float((ec["Es"] < 0.5 * ec["Dn"]).float().mean())
    tap_mb = sum(ec[k].numel() * ec[k].element_size()
                 for k in ("Wm_r", "Wm_i", "Ws_r", "Ws_i", "Xh_r", "Xh_i")) / 1e6
    print(f"flagship: {LEGS} legs x {TICKS} ticks, {1e3 * per_tick:.3f} ms/tick "
          f"(host clock, ticks 1..{TICKS - 1}), AEC taps+history {tap_mb:.1f} MB, "
          f"launches {launches}, DFT calls by path {dfts}, finite {finite}, shadow converged "
          f"on {100 * conv:.1f}% of legs, out {tuple(out.shape)} [{card}]", flush=True)
    _require_counts("flagship", launches, {"fused_volume": TICKS, "mdf_apply": TICKS,
                                           "mdf_update": 0, "mdf_update_fused": TICKS})
    _require_counts("flagship", dfts, {"fft": FLAGSHIP_DFTS * TICKS}, "DFT calls by path")
    if not finite:
        raise AssertionError("flagship output holds non-finite values")
    if tuple(out.shape) != (LEGS, TICKS * 160):
        raise AssertionError(f"flagship output shape {tuple(out.shape)}")
    if conv < 0.9:
        raise AssertionError(f"shadow filter converged on only {100 * conv:.1f}% of legs")
    del state, out

    phase_done(3)

    # phase 4: the port on the CPU against the port on the card
    mic, far = echo_coupled_inputs(CROSS_LEGS, CROSS_TICKS, seed=7)
    _, out_cpu, fin_cpu, cpu_tick = run_flagship(CROSS_LEGS, CROSS_TICKS,
                                              torch.device("cpu"), mic, far)
    _, out_gpu, fin_gpu, _ = run_flagship(CROSS_LEGS, CROSS_TICKS, dev, mic, far)
    bar = quality_bar(out_cpu.numpy(), out_gpu.cpu().numpy())
    print(f"cpu vs gpu: {CROSS_LEGS} legs x {CROSS_TICKS} ticks, "
          f"audio_diff_min {bar['audio_diff_min']:.6f} (legs 0, 37, ...; all legs "
          f"{bar['audio_diff_min_all_legs']:.6f}, {bar['legs_below_0.999']} below "
          f"0.999), rms_err {bar['rms_err']:.3e}, max_abs_err {bar['max_abs_err']:.3e}, "
          f"energy_gap_db_max {bar['energy_gap_db_max']:.4f}, pass {bar['pass']} "
          f"(cpu {1e3 * cpu_tick:.1f} ms/tick)", flush=True)
    if not (bar["pass"] and fin_cpu and fin_gpu):
        raise AssertionError(f"cpu vs gpu quality bar failed: {bar}")

    phase_done(4)

    # phase 5: the e2e leg over localhost UDP, megakernel AEC
    with environ(PALLAS_MDF="1"):
        res, e2e_launches, e2e_ticks = run_e2e(kernels, dev, card, E2E_LEGS, E2E_TICKS,
                                               paced=True)
        if not (res.loss_rate < 0.02 and res.fidelity >= 0.9):
            raise AssertionError(f"e2e bar failed: {res}")
        res, srtp_launches, srtp_ticks = run_e2e(kernels, dev, card, E2E_LEGS, E2E_TICKS,
                                                 paced=True, srtp=True)
        if not (res.loss_rate < 0.02 and res.fidelity >= 0.9):
            raise AssertionError(f"e2e SRTP bar failed: {res}")
        _, big_launches, big_ticks = run_e2e(kernels, dev, card, E2E_BIG_LEGS,
                                             E2E_BIG_TICKS, paced=False)

    phase_done(5)

    # phase 6: the e2e graph without the network, the CPU against the card
    with environ(PALLAS_MDF="1"):
        out_cpu, out_gpu, fin, cpu_tick = e2e_cross(dev, CROSS_LEGS, CROSS_TICKS)
    bar = quality_bar(out_cpu, out_gpu)
    print(f"e2e cpu vs gpu: {CROSS_LEGS} legs x {CROSS_TICKS} ticks, megakernel AEC, "
          f"audio_diff_min {bar['audio_diff_min']:.6f} (legs 0, 37, ...; all legs "
          f"{bar['audio_diff_min_all_legs']:.6f}, {bar['legs_below_0.999']} below "
          f"0.999), rms_err {bar['rms_err']:.3e}, max_abs_err {bar['max_abs_err']:.3e}, "
          f"energy_gap_db_max {bar['energy_gap_db_max']:.4f}, pass {bar['pass']} "
          f"(cpu {1e3 * cpu_tick:.1f} ms/tick)", flush=True)
    if not (bar["pass"] and fin):
        raise AssertionError(f"e2e cpu vs gpu quality bar failed: {bar}")

    phase_done(6)

    # phase 7: the session layer (AudioStreamBatch, Ticker, conference
    # control): 7a full width over the batch edge, 7b paced threads over
    # loopback RTP, 7c the CPU against the card
    session_launches = session_edge(kernels, dev, card, SESSION_LEGS, SESSION_TICKS)
    session_paced(dev, card, PACED_LEGS, PACED_TICKS)
    rec_cpu, rec_gpu = session_cross(dev, CROSS_SESSION_LEGS, CROSS_SESSION_TICKS)
    bar = quality_bar(rec_cpu, rec_gpu, leg_step=1)
    print(f"session cpu vs gpu: {CROSS_SESSION_LEGS} + {CROSS_SESSION_LEGS} legs x "
          f"{CROSS_SESSION_TICKS} ticks over LoopbackPair, the clients' recordings of "
          f"every listener: audio_diff_min {bar['audio_diff_min']:.6f}, rms_err "
          f"{bar['rms_err']:.3e}, max_abs_err {bar['max_abs_err']:.3e}, energy_gap_db_max "
          f"{bar['energy_gap_db_max']:.4f}, pass {bar['pass']}", flush=True)
    if not bar["pass"]:
        raise AssertionError(f"session cpu vs gpu quality bar failed: {bar}")

    phase_done(7)

    # phase 8: the secured wideband call: 8a full width over the batch edge
    # with SRTP on every leg, 8b per-leg SRTP + RTCP + QoS, 8c CPU vs card
    wide_launches = session_edge(kernels, dev, card, WIDE_LEGS, WIDE_TICKS, phase="8a",
                                 codec="g722", rate=16000, srtp=True)
    phase_done("8a")
    session_secure(dev, card, SECURE_LEGS)
    phase_done("8b")
    rec_cpu, rec_gpu = session_secure_cross(dev, CROSS_WIDE_LEGS, CROSS_WIDE_TICKS)
    bar = quality_bar(rec_cpu, rec_gpu, leg_step=1)
    print(f"session 8c: {CROSS_WIDE_LEGS} + {CROSS_WIDE_LEGS} legs x {CROSS_WIDE_TICKS} ticks, "
          f"G.722 with per-leg SRTP and RTCP over LoopbackPair, the CPU against the card, the "
          f"clients' recordings of every listener: audio_diff_min {bar['audio_diff_min']:.6f}, "
          f"rms_err {bar['rms_err']:.3e}, max_abs_err {bar['max_abs_err']:.3e}, "
          f"energy_gap_db_max {bar['energy_gap_db_max']:.4f}, pass {bar['pass']}", flush=True)
    if not bar["pass"]:
        raise AssertionError(f"session 8c cpu vs gpu quality bar failed: {bar}")

    phase_done(8)

    # phase 9: the gateway transcoder: 9a the five codec chains at full
    # width, 9b the G.711 <-> G.726-32 gateway, 9c its TTY legs CPU vs card
    sig = speech_legs(CHAIN_LEGS, S8 * CHAIN_TICKS, seed=100)
    chain_launches = {codec: codec_chain(kernels, dev, card, codec, sig, CHAIN_TICKS)
                      for codec in CHAIN_BARS}
    del sig
    phase_done("9a")
    gw_launches = gateway_full(kernels, dev, card, GATEWAY_LEGS, GATEWAY_ROUNDS)
    phase_done("9b")
    (rec_cpu, rec_gpu), texts = gateway_cross(dev, CROSS_GATEWAY_LEGS, CROSS_GATEWAY_ROUNDS)
    bar = quality_bar(rec_cpu, rec_gpu, leg_step=1)
    print(f"gateway 9c: 4 x {CROSS_GATEWAY_LEGS} legs x {CROSS_GATEWAY_ROUNDS} rounds, every "
          f"talker typing {TTY_TEXT!r} as Baudot FSK through G.711 and G.726-32, the CPU "
          f"against the card, the listeners' recordings: audio_diff_min "
          f"{bar['audio_diff_min']:.6f}, rms_err {bar['rms_err']:.3e}, max_abs_err "
          f"{bar['max_abs_err']:.3e}, energy_gap_db_max {bar['energy_gap_db_max']:.4f} (bars: "
          f"audio_diff >= 0.999, rms_err <= {CROSS_GATEWAY_RMS}, energy gap <= 1.5 dB); text "
          f"read on the CPU {sorted(set(texts[0]))}, on the card "
          f"{sorted(set(texts[1]))}", flush=True)
    if not (bar["audio_diff_min"] >= 0.999 and bar["energy_gap_db_max"] <= 1.5
            and bar["rms_err"] <= CROSS_GATEWAY_RMS):
        raise AssertionError(f"gateway 9c cpu vs gpu bar failed: {bar}")
    if any(t != TTY_TEXT for side in texts for t in side):
        raise AssertionError(f"gateway 9c: Baudot text read {texts}, expected {TTY_TEXT!r}")

    phase_done(9)

    # phase 10: captured and recorded calls: 10a G.722 captures replayed into
    # a stream at full width, 10b its recordings through the containers, the
    # player and the recorder, 10c the replay on the CPU against the card
    t10 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ms2_captures_") as tmp:
        built_launches, cap_launches, caps, replay = captured_calls(
            kernels, dev, card, CAPTURE_LEGS, CAPTURE_TICKS, tmp)
        phase_done("10a")
        recorded_files(dev, card, replay.rec, list(range(0, CAPTURE_LEGS, 37)), tmp)
        phase_done("10b")
        os.mkdir(os.path.join(tmp, "cross"))
        cross, replays = captured_cross(dev, CROSS_CAPTURE_LEGS, CROSS_CAPTURE_TICKS,
                                        os.path.join(tmp, "cross"))
    bar = quality_bar(replays[0].rec, replays[1].rec, leg_step=1)
    counts = ["; ".join(f"leg {leg}: {r.recv[leg]}/{r.lost[leg]}/{r.late[leg]}/"
                        f"{r.concealed[leg]} of {cross.packets[leg]}" for leg in cross.lossy)
              for r in replays]
    events = all((r.lost[cross.lossy] > 0).all() and (r.late[cross.lossy] > 0).all()
                 for r in replays)
    print(f"captured 10c: {CROSS_CAPTURE_LEGS} captures of {CROSS_CAPTURE_TICKS} ticks built as "
          f"10a's (lossy legs {cross.lossy}) replayed over localhost UDP into the stream on the "
          f"CPU and on the card; the lossy legs' received / lost / late / concealed ticks: on the "
          f"CPU {counts[0]}, on the card {counts[1]}; the recordings: audio_diff_min "
          f"{bar['audio_diff_min']:.6f}, rms_err {bar['rms_err']:.3e}, max_abs_err "
          f"{bar['max_abs_err']:.3e}, energy_gap_db_max {bar['energy_gap_db_max']:.4f}, pass "
          f"{bar['pass']}; phase 10 took {time.perf_counter() - t10:.1f} s", flush=True)
    if not bar["pass"]:
        raise AssertionError(f"captured 10c cpu vs gpu quality bar failed: {bar}")
    if not events:
        raise AssertionError(f"captured 10c: a lossy leg counted no lost or no late packet: "
                             f"{counts}")

    phase_done(10)

    # phase 11: negotiated calls: 11a 1,024 calls set up over localhost UDP,
    # then the secured wideband session on their keys, and refused calls;
    # 11b calls whose media rides the sockets that ICE nominated
    t11 = time.perf_counter()
    raise_nofile(2 * SETUP_CALLS + 512)
    setup_launches = negotiated_calls(kernels, dev, card, SETUP_CALLS, SETUP_TICKS)
    phase_done("11a")
    one_socket_calls(dev, card, ONE_SOCKET_LEGS)
    print(f"phase 11 took {time.perf_counter() - t11:.1f} s", flush=True)

    phase_done(11)

    # phase 12: the video call: 12a the pixel path at 1,024 legs, 12b the
    # e2e bench over UDP and the library codecs' refusals, 12c CPU vs card
    t12 = time.perf_counter()
    video_launches = video_pixel_path(kernels, dev, card, VIDEO_LEGS, VIDEO_TICKS)
    phase_done("12a")
    video_e2e(dev, card, VIDEO_E2E_LEGS)
    video_codec_refusals(dev, card)
    phase_done("12b")
    video_cross(dev, card)
    print(f"phase 12 took {time.perf_counter() - t12:.1f} s", flush=True)

    phase_done(12)

    # phase 13: the SFU and the call's side channels: 13a the audio SFU at
    # 1,024 participants through the pump, 13b 8b's session over UDP without
    # and with the pump, 13c the video router with FlexFEC, 13d text and
    # UPnP, 13e the SFU's path on the CPU against the card
    t13 = time.perf_counter()
    sfu_launches, ranks, _ = audio_sfu(kernels, dev, card, SFU_CONFERENCES, SFU_TICKS)
    phase_done("13a")
    ms_python = pump_session(dev, card, PUMP_SESSION_LEGS, pumped=False)
    ms_pump = pump_session(dev, card, PUMP_SESSION_LEGS, pumped=True)
    print(f"session 13b: {PUMP_SESSION_LEGS} + {PUMP_SESSION_LEGS} legs of 8b over localhost UDP, "
          f"ms per tick pair: Python receive {ms_python:.3f}, NativeIoPump {ms_pump:.3f} "
          f"[{card}]", flush=True)
    phase_done("13b")
    video_router_fec(card, ranks)
    phase_done("13c")
    text_streams(card)
    upnp_mapping(card)
    phase_done("13d")
    sfu_cross(dev, card)
    print(f"phase 13 took {time.perf_counter() - t13:.1f} s [{card}]", flush=True)

    phase_done(13)

    # phase 14: the mixed fleet (14a one paced loop, 14b per-member
    # threads), the host-codec legs (14c), the quirk session on sound cards
    # at full width (14d) and CPU vs card (14e), the device layer (14f)
    t14 = time.perf_counter()
    _, fleet_loop_launches, fleet_loop_ticks = fleet_run(kernels, dev, card, "loop")
    phase_done("14a")
    _, fleet_thread_launches, fleet_thread_ticks = fleet_run(kernels, dev, card, "threads")
    phase_done("14b")
    host_codec_legs(dev, card)
    phase_done("14c")
    quirk_launches = session_edge(kernels, dev, card, QUIRK_LEGS, QUIRK_TICKS, phase="14d",
                                  sound_card=True)
    phase_done("14d")
    rec_cpu, rec_gpu = session_cross(dev, CROSS_QUIRK_LEGS, CROSS_QUIRK_TICKS, sound_card=True)
    bar = quality_bar(rec_cpu, rec_gpu, leg_step=1)
    print(f"session 14e: {CROSS_QUIRK_LEGS} + {CROSS_QUIRK_LEGS} legs x {CROSS_QUIRK_TICKS} "
          f"ticks of 14d's quirk session on a FileSndCard over LoopbackPair, the CPU against the "
          f"card, the clients' recordings of every listener: audio_diff_min "
          f"{bar['audio_diff_min']:.6f}, rms_err {bar['rms_err']:.3e}, max_abs_err "
          f"{bar['max_abs_err']:.3e}, energy_gap_db_max {bar['energy_gap_db_max']:.4f}, pass "
          f"{bar['pass']}", flush=True)
    if not bar["pass"]:
        raise AssertionError(f"session 14e cpu vs gpu quality bar failed: {bar}")
    phase_done("14e")
    device_gating(dev, card)
    print(f"phase 14 took {time.perf_counter() - t14:.1f} s [{card}]", flush=True)

    phase_done(14)

    # phase 15: leg sharding: 15a / 15b the flagship at full width over four
    # gloo ranks on the card (aligned groups; conferences across every
    # shard), 15c the dry run, 15d one NCCL rank, 15e the offset kernel
    shard_launches, shard_ticks = phase15(kernels, dev, card, phase_done)

    phase_done(15)

    # phase 16: the programs around the package: 16a the conference example
    # at 1,024 legs, 16b the CLI's bench, 16c two CLI call processes a pair,
    # 16d the gateway example at 1,024 legs, 16e the IVR and the secured
    # call, 16f the CLI's other subcommands, 16g the CPU against the card
    program_runs = phase16(kernels, dev, card, phase_done)

    phase_done(16)

    # launches over the main-path runs that were counted: the flagship, the
    # three e2e runs, the session and the wideband call at full width, the
    # gateway and its codec chains, the captures' build and their replay, the
    # negotiated calls' media, the video pixel path (none: PyTorch ops), the
    # audio SFU, the mixed fleet in both modes (a tick: the flagship member's),
    # the quirk session, the sharded flagship (counted in each rank), the
    # conference example's server and its clients (each a tick of its own),
    # the CLI's bench, its call leg and the gateway example
    runs = {"flagship": (launches, TICKS),
            "e2e": ({k: e2e_launches[k] + srtp_launches[k] + big_launches[k] for k in launches},
                    e2e_ticks + srtp_ticks + big_ticks),
            "session": (session_launches, SESSION_TICKS),
            "wideband": (wide_launches, WIDE_TICKS),
            "gateway": (gw_launches, GATEWAY_ROUNDS),
            "captures_built": (built_launches, CAPTURE_TICKS),
            "captured": (cap_launches, CAPTURE_TICKS),
            "negotiated": (setup_launches, SETUP_TICKS),
            "video": (video_launches, VIDEO_TICKS),
            "sfu": (sfu_launches, SFU_TICKS),
            "fleet_loop": (fleet_loop_launches, fleet_loop_ticks),
            "fleet_threads": (fleet_thread_launches, fleet_thread_ticks),
            "quirk_session": (quirk_launches, QUIRK_TICKS),
            # a tick of a rank: 15a and 15b's four ranks and 15d's one
            "sharded": (shard_launches, shard_ticks)}
    runs.update({f"chain_{codec}": (c, CHAIN_TICKS) for codec, c in chain_launches.items()})
    runs.update(program_runs)
    entries = kernel_entries(results, adpcm_results, session_results, wide_results, runs)
    entries += ec_kernel_entries(results, session_results, wide_results, runs)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def programs_only(n):
    """``python3 chip_smoke.py --programs N``: phase 16 alone, ``n`` times
    on the card, after the kernels' and the edge's builds (the spread of
    its readings over runs of one call); each run prints phase 16's lines
    and its seconds, no result line, and any failed bar ends the script
    non-zero."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, REPO)
    from mediastreamer2_tpu_torch import native
    from mediastreamer2_tpu_torch.ops import kernels
    card = card_line()
    print(f"card: {card}", flush=True)
    kernels.build()
    native.build()
    native.build_pump()
    for i in range(n):
        t0 = time.perf_counter()
        runs = phase16(kernels, torch.device("cuda", 0), card)
        print(f"programs run {i}: {time.perf_counter() - t0:.1f} s, launches a tick "
              f"{ {r: {k: v / t for k, v in c.items() if v} for r, (c, t) in runs.items()} } "
              f"[{card}]", flush=True)


def calls_only(n):
    """``python3 chip_smoke.py --calls N``: 16c alone, ``n`` times on the
    card (the spread of its pairs' readings): each run's lines, a failed
    bar printed and the next run started; non-zero at the end if any
    failed."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, REPO)
    from mediastreamer2_tpu_torch.ops import kernels
    card = card_line()
    print(f"card: {card}", flush=True)
    kernels.build()
    failed = 0
    for i in range(n):
        with tempfile.TemporaryDirectory(prefix="ms2_calls_") as tmp:
            try:
                cli_calls(torch.device("cuda", 0), card, tmp)
            except AssertionError as e:
                failed += 1
                print(f"calls run {i}: {e}", flush=True)
    print(f"calls: {n - failed} of {n} runs held the bar [{card}]", flush=True)
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--programs"]:
        programs_only(int(sys.argv[2]))
    elif sys.argv[1:2] == ["--calls"]:
        calls_only(int(sys.argv[2]))
    else:
        main()
