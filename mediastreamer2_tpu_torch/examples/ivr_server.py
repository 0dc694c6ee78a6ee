"""Runnable example: a batched IVR (interactive voice response) server:
announcements into the send path and RFC 4733 DTMF menu navigation, the
building blocks every reference user combines for voice menus
(audiostream.c local player branch + msrtp.c telephone-event receive).
Counterpart of the JAX package's ``examples/ivr_server.py``.

    python -m mediastreamer2_tpu_torch.examples.ivr_server --legs 16 --seconds 12

The example runs self-contained over loopback: every "caller" leg hears a
welcome prompt, presses a digit at tick 150 (sent as RFC 4733
telephone-events), and the IVR answers with the digit's tone. Both
streams tick by hand, not paced.

Departure from the JAX example: ``--device`` replaces ``--cpu`` (which was
always on); it defaults to the CUDA card (raising without one), and
``--device cpu`` runs the kernels' plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

DIGITS = "123456789*0#"
CHOOSE_TICK = 150           # the callers press their digits here
RATE = 8000


def prompt_tone(rate: int, freqs, dur_s: float = 0.6):
    """A simple multi-tone 'prompt' (stand-in for a recorded file)."""
    t = np.arange(int(rate * dur_s)) / rate
    sig = sum(0.25 * np.sin(2 * np.pi * f * t) for f in freqs)
    env = np.minimum(1.0, np.minimum(t / 0.02, (dur_s - t) / 0.02) * 50)
    return (sig * env).astype(np.float32)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--legs", type=int, default=16)
    ap.add_argument("--seconds", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    return ap


def run(args) -> dict:
    """Returns the IVR's received selections (``received``: [(leg,
    digit)]), the callers' choices, how many arrived right (``correct``),
    the callers' recordings [legs, samples] and their peak."""
    from mediastreamer2_tpu_torch.core.factory import Factory
    from mediastreamer2_tpu_torch.models.audio_stream import (AudioStreamBatch,
                                                              AudioStreamFeatures)
    from mediastreamer2_tpu_torch.net.rtp import LoopbackPair

    B = args.legs
    factory = Factory()
    # IVR side: announcement mixer + DTMF regeneration into the answer path
    ivr = AudioStreamBatch(
        factory, B, rate=RATE, features=AudioStreamFeatures(local_play=True, dtmf=True),
        mic_signal=np.zeros(80 * args.seconds * 100, np.float32), device=args.device)
    # caller side: records what it hears, sends digits
    callers = AudioStreamBatch(factory, B, rate=RATE, record_ticks=args.seconds * 100,
                               device=args.device)
    pairs = [LoopbackPair() for _ in range(B)]
    menu_choice = {}
    for leg in range(B):
        ivr.set_transport(leg, pairs[leg].endpoint(0))
        callers.set_transport(leg, pairs[leg].endpoint(1))
        ivr.enable_dtmf_receive(leg, play_tone=True, tone_ms=200)

    ivr.ticker.realtime = callers.ticker.realtime = False
    ivr.ticker.warm_up()
    callers.ticker.warm_up()

    # step 1: welcome prompt to every caller
    ivr.play_announcement(prompt_tone(RATE, (440, 660)))
    print(f"IVR up: {B} legs, welcome prompt playing", flush=True)

    for t in range(args.seconds * 100):
        if t == CHOOSE_TICK:               # callers choose a menu entry
            for leg in range(B):
                d = DIGITS[leg % len(DIGITS)]
                menu_choice[leg] = d
                callers.send_dtmf(leg, d, duration_ms=120)
        ivr.ticker.do_tick()
        callers.ticker.do_tick()

    got = list(getattr(ivr, "dtmf_received", []))
    ok = sum(1 for leg, d in got if menu_choice.get(leg) == d)
    rec = callers.get_recording()
    heard = float(np.abs(rec).max()) if rec is not None else 0.0
    ivr.stop()
    callers.stop()
    return {"legs": B, "received": got, "choices": menu_choice, "correct": ok,
            "recording": rec, "peak": heard}


def main(argv=None) -> int:
    r = run(build_parser().parse_args(argv))
    B = r["legs"]
    print(f"menu selections received: {len(r['received'])}/{B} "
          f"(correct digit: {r['correct']}/{B})")
    print(f"callers heard audio (peak {r['peak']:.2f}): "
          f"{'yes' if r['peak'] > 0.05 else 'NO'}")
    return 0 if r["correct"] == B and r["peak"] > 0.05 else 1


if __name__ == "__main__":
    sys.exit(main())
