"""Runnable example: a G.711 conference server at scale on the native
batched RTP edge, the deployment shape of this framework (counterpart of
the JAX package's ``examples/conference_server.py``).

    python -m mediastreamer2_tpu_torch.examples.conference_server --legs 256 \\
        --port 5004 --conf-size 4 --seconds 30

Every leg sends RTP (PCMU, SSRC base+index) to --port and receives its
conference mix-minus back. For this example the reply address is a single
--client host:port (BUNDLE-style multiplexing; production would track
per-SSRC sources). Conference k is legs k*conf_size .. k*conf_size +
conf_size - 1 (``group_id = leg // conf_size``, a tensor on the device).

Departures from the JAX example: ``--device`` replaces ``--tpu``; it
defaults to the CUDA card (raising without one), and ``--device cpu``
runs the kernels' plain versions on the CPU. The socket asks for 16 MB
buffers (at 1,024 legs a tick's packets outgrow the default), and is
closed when the run ends.
"""
from __future__ import annotations

import argparse
import contextlib
import socket
import sys

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--legs", type=int, default=64)
    ap.add_argument("--port", type=int, default=5004)
    ap.add_argument("--client", default="127.0.0.1:5006")
    ap.add_argument("--conf-size", type=int, default=4)
    ap.add_argument("--ssrc-base", type=lambda v: int(v, 0), default=0x5000)
    ap.add_argument("--seconds", type=int, default=30)
    ap.add_argument("--srtp-seed", default=None,
                    help="hex seed: derive per-leg SRTP master keys "
                         "(AES_CM_128_HMAC_SHA1_80) and protect inline in "
                         "the native edge; the client derives the same "
                         "keys from the same seed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    return ap


def run(args, on_ready=None) -> dict:
    """Serve for ``args.seconds`` (paced) and return the ticker's counts
    (ticks, late ticks, load, mean host ms a tick) and every leg's edge
    statistics (``edge_stats``: got, lost, late, recv). ``on_ready(server)``,
    when given, is called with the ``AudioStreamBatch`` once its socket is
    bound, before its first tick."""
    from mediastreamer2_tpu_torch.core.factory import Factory
    from mediastreamer2_tpu_torch.models.audio_stream import AudioStreamBatch

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for opt in (socket.SO_RCVBUF, socket.SO_SNDBUF):
            with contextlib.suppress(OSError):      # a tick of every leg queues here
                sock.setsockopt(socket.SOL_SOCKET, opt, 1 << 24)
        sock.bind(("0.0.0.0", args.port))
        sock.setblocking(False)
        host, port = args.client.split(":")
        server = AudioStreamBatch(Factory(), args.legs, conference=True, device=args.device)
        srtp_keys = None
        if args.srtp_seed:
            rng = np.random.default_rng(int(args.srtp_seed, 16))
            srtp_keys = [(rng.bytes(16), rng.bytes(14)) for _ in range(args.legs)]
        server.enable_batch_edge(rx_sock=sock, tx_sock=sock, remote=(host, int(port)),
                                 ssrc_base=args.ssrc_base, srtp_keys=srtp_keys)
        tk = server.ticker
        with tk.on_stream():
            tk.params["conf"]["group_id"] = torch.div(
                torch.arange(args.legs, dtype=torch.int32, device=tk.device), args.conf_size,
                rounding_mode="floor")
        if on_ready is not None:
            on_ready(server)
        tk.warm_up()
        print(f"conference server: {args.legs} legs on :{args.port}, "
              f"groups of {args.conf_size}, replies to {args.client}", flush=True)
        server.run(args.seconds * 100)
        print("stats leg0:", server.edge_rx.stats(0))
        print("ticker:", tk.stats, flush=True)
        return {"legs": args.legs, "ticks": tk.stats.ticks, "late_ticks": tk.stats.late_ticks,
                "load": tk.get_average_load(), "mean_step_ms": tk.stats.mean_step_ms,
                "phase_ms": dict(tk.phase_ms),
                "edge_stats": [server.edge_rx.stats(i) for i in range(args.legs)]}
    finally:
        sock.close()


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
