"""Runnable example: a ulaw@8k -> G.722@16k transcoding gateway (the
B2BUA shape; audio_stream_start_from_io parity). Counterpart of the JAX
package's ``examples/transcode_gateway.py``.

    python -m mediastreamer2_tpu_torch.examples.transcode_gateway --legs 16 \\
        --in-port 5004 --out 127.0.0.1:5008 --seconds 30

Leg n receives mu-law RTP on port in_port + 2n and sends G.722 to the
--out host at port + 2n, paced at the 10 ms tick.

Departure from the JAX example: ``--device`` replaces ``--tpu``; it
defaults to the CUDA card (raising without one), and ``--device cpu``
runs the kernels' plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--legs", type=int, default=16)
    ap.add_argument("--in-port", type=int, default=5004)
    ap.add_argument("--out", default="127.0.0.1:5008")
    ap.add_argument("--seconds", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    return ap


def run(args, on_ready=None) -> dict:
    """Transcode for ``args.seconds`` (paced); returns the ticker's counts.
    ``on_ready(gateway)``, when given, is called with the ``TranscodeBatch``
    once its sockets are bound, before the first tick."""
    from mediastreamer2_tpu_torch.core.factory import Factory
    from mediastreamer2_tpu_torch.models.transcode import TranscodeBatch
    from mediastreamer2_tpu_torch.net.rtp import UdpTransport

    host, port = args.out.split(":")
    tc = TranscodeBatch(Factory(), args.legs, codec_in="ulaw", rate_in=8000,
                        codec_out="g722", rate_out=16000, device=args.device)
    transports = []
    try:
        for leg in range(args.legs):
            rx = UdpTransport(local_port=args.in_port + 2 * leg)
            transports.append(rx)
            tx = UdpTransport(remote=(host, int(port) + 2 * leg))
            transports.append(tx)
            tc.set_transports(leg, rx=rx, tx=tx)
        print(f"gateway: {args.legs} legs, ulaw@8k :{args.in_port}+2n -> "
              f"g722@16k {args.out}+2n", flush=True)
        if on_ready is not None:
            on_ready(tc)
        tc.run(args.seconds * 100)
        tk = tc.ticker
        return {"legs": args.legs, "ticks": tk.stats.ticks, "late_ticks": tk.stats.late_ticks,
                "load": tk.get_average_load(), "mean_step_ms": tk.stats.mean_step_ms,
                "phase_ms": dict(tk.phase_ms)}
    finally:
        for t in transports:
            t.close()


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
