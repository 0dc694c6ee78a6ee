"""Runnable example: a fully secured call between two in-process
endpoints: ICE nomination over real localhost UDP, DTLS-SRTP key
agreement negotiating an AEAD-GCM suite, SDP-style fingerprint
verification, then two-way encrypted audio with an audio_diff check
(counterpart of the JAX package's ``examples/secure_call.py``).

    python -m mediastreamer2_tpu_torch.examples.secure_call [--zrtp] [--seconds 3]

The same composition as the reference's mediastream.c + CallSetup:
ICE check list -> DTLS handshake on the nominated pair (or ZRTP with
--zrtp) -> SRTP-wrapped media transport -> AudioStreamBatch both ways.
The call passes when the received audio is above 0.9 audio_diff against
what was sent.

Departure from the JAX example: ``--device`` replaces ``--cpu`` (which was
always on); it defaults to the CUDA card (raising without one), and
``--device cpu`` runs the kernels' plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

SETUP_DEADLINE_S = 10.0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seconds", type=int, default=3)
    ap.add_argument("--zrtp", action="store_true",
                    help="use ZRTP (RFC 6189) instead of DTLS-SRTP")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    return ap


def run(args) -> dict:
    """Returns whether the call was secured (``secured``), its set-up
    seconds, suite and SAS, the packets sent and the similarity of the
    received audio to the sent signal (``similarity``)."""
    from mediastreamer2_tpu_torch.core.block import tick_samples
    from mediastreamer2_tpu_torch.core.factory import Factory
    from mediastreamer2_tpu_torch.models.audio_stream import AudioStreamBatch
    from mediastreamer2_tpu_torch.models.call_setup import CallSetup
    from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff

    key_agreement = "zrtp" if args.zrtp else "dtls"
    a = CallSetup(controlling=True, key_agreement=key_agreement)
    b = CallSetup(controlling=False, key_agreement=key_agreement)
    try:
        if not args.zrtp:
            # SDP a=fingerprint exchange (signalling plane)
            a.set_remote_fingerprint(b.local_fingerprint())
            b.set_remote_fingerprint(a.local_fingerprint())
        a.set_remote(*b.local_credentials(), [("127.0.0.1", b.sock.local_port)])
        b.set_remote(*a.local_credentials(), [("127.0.0.1", a.sock.local_port)])
        t0 = time.time()
        while time.time() - t0 < SETUP_DEADLINE_S and not (a.ready and b.ready):
            a.iterate()
            b.iterate()
            time.sleep(0.01)
        setup_s = time.time() - t0
        if not (a.ready and b.ready):
            print("call setup failed")
            return {"secured": False, "setup_s": setup_s, "similarity": 0.0}
        print(f"secured in {setup_s:.2f}s (suite: {a.srtp_suite})"
              + (f" SAS: {a.zrtp.sas}" if args.zrtp else ""), flush=True)

        factory = Factory()
        S = tick_samples(8000)
        ticks = args.seconds * 100
        rng = np.random.default_rng(1)
        sig = (0.3 * np.sin(2 * np.pi * 350 * np.arange(S * ticks) / 8000)
               + 0.05 * rng.standard_normal(S * ticks)).astype(np.float32)
        tx = AudioStreamBatch(factory, 1, mic_signal=sig, device=args.device)
        rx = AudioStreamBatch(factory, 1, record_ticks=ticks + 40, device=args.device)
        tx.ticker.warm_up()
        rx.ticker.warm_up()
        tx.set_transport(0, a.media_transport())
        rx.set_transport(0, b.media_transport())
        rx.start(ticks + 40)
        tx.run(ticks + 10)
        tx.stop()
        rx.stop()
        sim, _ = audio_diff(sig, rx.get_recording()[0])
        st = tx.get_stats(0)
        print(f"sent={st.sent_packets} similarity={sim:.3f} "
              f"up_bw={tx.sessions[0].up_bw.bps() / 1000:.0f} kbps")
        return {"secured": True, "setup_s": setup_s, "suite": a.srtp_suite,
                "sas": (a.zrtp.sas, b.zrtp.sas) if args.zrtp else None,
                "sent": st.sent_packets, "similarity": sim}
    finally:
        a.close()
        b.close()


def main(argv=None) -> int:
    r = run(build_parser().parse_args(argv))
    return 0 if r["secured"] and r["similarity"] > 0.9 else 1


if __name__ == "__main__":
    sys.exit(main())
