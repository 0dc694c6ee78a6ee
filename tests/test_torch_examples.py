"""The port's four examples (``mediastreamer2_tpu_torch/examples/``) at
``--device cpu``: the conference server at 8 legs with this test as its
client (leg 0 talks: legs 1-3 hear it, leg 0 and legs 4-7 stay silent),
the IVR at 4 legs against the JAX package's example (the same printed
counts and exit code), the secured call with DTLS-SRTP and ZRTP, and the
gateway at 4 legs (the G.722 it sends, decoded, is the tone it was sent);
and each example and ``entry`` as ``python -m`` from a fresh interpreter
(exit 0)."""
import importlib.util
import os
import select
import sys
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from mediastreamer2_tpu_torch.examples import (conference_server, ivr_server,  # noqa: E402
                                               secure_call, transcode_gateway)
from mediastreamer2_tpu_torch.net.rtp import RtpPacket  # noqa: E402
from mediastreamer2_tpu_torch.ops.g711 import (float_to_pcm16, pcm16_to_float,  # noqa: E402
                                               ulaw_decode, ulaw_encode)
from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = (conference_server, ivr_server, secure_call, transcode_gateway)


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py's phase 16 helpers (free ports, a thread that keeps
    its result, the G.722 decode of a received stream)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mulaw(x):
    return ulaw_encode(float_to_pcm16(torch.from_numpy(np.asarray(x, np.float32)))).numpy() \
        .astype(np.uint8)


def _decoded(payloads):
    codes = np.frombuffer(b"".join(payloads), np.uint8).astype(np.int32)
    return pcm16_to_float(ulaw_decode(torch.from_numpy(codes))).numpy()


@pytest.mark.parametrize("srtp_seed", [None, "5eed"], ids=["clear", "srtp"])
def test_conference_server_mix_minus_with_this_test_as_client(smoke, srtp_seed):
    """8 legs in groups of 4 for 2 s; this test sends every leg's RTP (SSRC
    base + leg), leg 0 with speech and the rest with silence, from the
    server's first reply on: legs 1-3 hear leg 0, leg 0 (mix-minus) and the
    second conference hear nothing. With ``--srtp-seed`` both sides derive
    each leg's AES_CM_128_HMAC_SHA1_80 keys from the seed, and this test
    protects and unprotects with the port's ``SrtpContext``."""
    from mediastreamer2_tpu_torch.net.srtp import SrtpContext
    from mediastreamer2_tpu_torch.utils.signals import make_speechlike
    legs, ticks, base = 8, 150, 0x5000
    sock = smoke.udp_socket()
    port = smoke.free_ports(1, host="0.0.0.0")
    argv = ["--legs", str(legs), "--port", str(port), "--client",
            f"127.0.0.1:{sock.getsockname()[1]}", "--seconds", "2", "--device", "cpu"]
    tx_ctx = rx_ctx = None
    if srtp_seed:
        argv += ["--srtp-seed", srtp_seed]
        rng = np.random.default_rng(int(srtp_seed, 16))
        keys = [(rng.bytes(16), rng.bytes(14)) for _ in range(legs)]
        tx_ctx = [SrtpContext(k, s) for k, s in keys]
        rx_ctx = [SrtpContext(k, s) for k, s in keys]
    server = smoke._Thread(lambda: conference_server.run(
        conference_server.build_parser().parse_args(argv)), "conference server")
    speech = _mulaw(make_speechlike(80 * ticks, 8000, seed=20))
    silence = _mulaw(np.zeros(80))
    got = {leg: {} for leg in range(legs)}

    def drain():
        while True:
            try:
                data = sock.recv(2048)
            except BlockingIOError:
                return
            if rx_ctx is not None:
                data = rx_ctx[int.from_bytes(data[8:12], "big") - base].unprotect(data)
                assert data is not None, "a reply failed SRTP authentication"
            p = RtpPacket.unpack(data)
            got[p.ssrc - base][p.seq] = p.payload
    try:
        server.start()
        deadline = time.monotonic() + 60
        while not select.select([sock], [], [], 0.05)[0]:
            assert server.is_alive() and time.monotonic() < deadline, "no reply"
        t0 = time.monotonic()
        for k in range(ticks):
            for leg in range(legs):
                pay = speech[80 * k:80 * (k + 1)] if leg == 0 else silence
                data = RtpPacket(payload_type=0, seq=k, timestamp=80 * k, ssrc=base + leg,
                                 payload=pay.tobytes()).pack()
                if tx_ctx is not None:
                    data = tx_ctx[leg].protect(data)
                sock.sendto(data, ("127.0.0.1", port))
            drain()
            time.sleep(max(0.0, t0 + 0.01 * (k + 1) - time.monotonic()))
        res = server.join_result(60)
        drain()
    finally:
        sock.close()
    assert res["ticks"] == 200 and len(res["edge_stats"]) == legs
    assert min(s["recv"] for s in res["edge_stats"]) == ticks      # none failed auth
    heard = {leg: _decoded([p for _, p in sorted(got[leg].items())]) for leg in range(legs)}
    said = _decoded([speech.tobytes()])
    rms = {leg: float(np.sqrt(np.mean(x.astype(np.float64) ** 2))) for leg, x in heard.items()}
    for leg in (1, 2, 3):
        assert audio_diff(said, heard[leg])[0] > 0.95, leg
    for leg in (0, 4, 5, 6, 7):
        assert rms[leg] < 0.01 * rms[1], (leg, rms)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ivr_server_prints_what_jax_prints(monkeypatch, capsys):
    port_rc = ivr_server.main(["--legs", "4", "--seconds", "3", "--device", "cpu"])
    port_out = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["ivr_server.py", "--legs", "4", "--seconds", "3"])
    jax_rc = _jax_example("ivr_server").main()
    jax_out = capsys.readouterr().out.splitlines()
    assert port_rc == jax_rc == 0
    assert port_out[0] == jax_out[0] == "IVR up: 4 legs, welcome prompt playing"
    assert port_out[1] == jax_out[1] == "menu selections received: 4/4 (correct digit: 4/4)"
    assert port_out[2].endswith(": yes") and jax_out[2].endswith(": yes")


def test_ivr_server_run_reports_each_selection():
    r = ivr_server.run(ivr_server.build_parser().parse_args(
        ["--legs", "3", "--seconds", "3", "--device", "cpu"]))
    assert sorted(r["received"]) == [(0, "1"), (1, "2"), (2, "3")]
    assert r["correct"] == 3 and r["choices"] == {0: "1", 1: "2", 2: "3"}
    assert r["recording"].shape == (3, 300 * 80) and r["peak"] > 0.05


@pytest.mark.parametrize("zrtp", [False, True], ids=["dtls", "zrtp"])
def test_secure_call(zrtp, capsys):
    argv = (["--zrtp"] if zrtp else []) + ["--seconds", "2", "--device", "cpu"]
    assert secure_call.main(argv) == 0
    r = secure_call.run(secure_call.build_parser().parse_args(argv))
    assert r["secured"] and r["similarity"] > 0.9 and r["sent"] >= 200
    if zrtp:
        assert r["suite"] == "AES_CM_128_HMAC_SHA1_80" and r["sas"][0] == r["sas"][1]
    else:
        assert r["suite"].startswith("AEAD_AES_") and r["sas"] is None
    assert "secured in " in capsys.readouterr().out


def test_transcode_gateway_sends_the_tone_it_was_sent(smoke):
    """4 legs for 1 s: a mu-law tone a leg into ``in_port + 2n``, a tick's
    packets once the gateway has run up to two ticks behind them; the G.722
    each ``out + 2n`` receives, decoded and halved to 8 kHz, is the tone
    from tick 40 on."""
    legs, seconds = 4, 1
    ticks = 100 * seconds
    base = smoke.free_ports(2 * legs, host="127.0.0.1")
    freq = 300.0 + 100.0 * np.arange(legs)[:, None]
    tone = (0.3 * np.sin(2 * np.pi * freq * np.arange(80 * ticks) / 8000)).astype(np.float32)
    codes = np.stack([_mulaw(t) for t in tone])
    sent = np.stack([_decoded([c.tobytes()]) for c in codes])
    rcv = [smoke.udp_socket(base + 1 + 2 * n) for n in range(legs)]
    tx = smoke.udp_socket()
    ready = []
    argv = ["--legs", str(legs), "--in-port", str(base), "--out", f"127.0.0.1:{base + 1}",
            "--seconds", str(seconds), "--device", "cpu"]
    gw = smoke._Thread(lambda: transcode_gateway.run(
        transcode_gateway.build_parser().parse_args(argv), on_ready=ready.append), "gateway")
    try:
        gw.start()
        while not ready and gw.is_alive():
            time.sleep(0.001)
        tk = ready[0].ticker
        for k in range(ticks):
            while tk.stats.ticks < k - 2 and gw.is_alive():
                time.sleep(0.0005)
            for n in range(legs):
                tx.sendto(RtpPacket(payload_type=0, seq=k, timestamp=80 * k, ssrc=n,
                                    payload=codes[n, 80 * k:80 * (k + 1)].tobytes()).pack(),
                          ("127.0.0.1", base + 2 * n))
        res = gw.join_result(60)
        pkts = []
        for r in rcv:
            leg = []
            while True:
                try:
                    leg.append(RtpPacket.unpack(r.recv(2048)))
                except BlockingIOError:
                    break
            pkts.append(sorted(leg, key=lambda p: p.seq))
    finally:
        for s in rcv + [tx]:
            s.close()
    assert res["ticks"] == ticks and all(len(p) == ticks for p in pkts)
    assert all(p.payload_type == 9 and len(p.payload) == 80 for leg in pkts for p in leg)
    g722 = np.stack([np.frombuffer(b"".join(p.payload for p in leg), np.uint8) for leg in pkts])
    out = smoke.decode_captures(torch.device("cpu"), g722, ticks).reshape(legs, -1, 2).mean(axis=2)
    sims, _ = smoke.settled_sims(sent, out, 80 * 40)
    assert sims.min() > 0.95, sims


@pytest.mark.parametrize("example", EXAMPLES, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_examples_default_to_the_card(example, monkeypatch):
    """``--device`` defaults to the CUDA card (the JAX examples' ``--tpu`` /
    ``--cpu``), and without one the example raises before it serves."""
    assert example.build_parser().parse_args([]).device is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {conference_server: ["--port", "0", "--seconds", "1"],
            transcode_gateway: ["--legs", "1", "--in-port", "0", "--seconds", "1"]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(argv.get(example, ["--seconds", "1"]))


@pytest.mark.parametrize("module", ["examples.conference_server", "examples.ivr_server",
                                    "examples.secure_call", "examples.transcode_gateway",
                                    "entry"])
def test_runs_as_python_m_on_the_cpu(smoke, module):
    """Each example and ``entry`` runs as ``python -m
    mediastreamer2_tpu_torch.<module> --device cpu`` from a fresh
    interpreter and exits 0, printing its first line (the servers run 1 s
    with no client; the IVR and the secured call by their own checks)."""
    import subprocess
    base = smoke.free_ports(4, host="127.0.0.1")
    argv, first = {
        "examples.conference_server": (["--legs", "4", "--port", str(base), "--client",
                                        f"127.0.0.1:{base + 1}", "--seconds", "1"],
                                       "conference server: 4 legs"),
        "examples.ivr_server": (["--legs", "2", "--seconds", "3"], "IVR up: 2 legs"),
        "examples.secure_call": (["--seconds", "1"], "secured in "),
        "examples.transcode_gateway": (["--legs", "1", "--in-port", str(base + 2), "--out",
                                        f"127.0.0.1:{base + 3}", "--seconds", "1"],
                                       "gateway: 1 legs"),
        "entry": ([], "entry: flagship x 64 on cpu"),
    }[module]
    p = subprocess.run([sys.executable, "-m", f"mediastreamer2_tpu_torch.{module}", *argv,
                        "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                       timeout=60, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, (p.stdout + p.stderr)[-1500:]
    assert first in p.stdout, p.stdout[-1500:]
