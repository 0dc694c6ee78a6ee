"""The port's FlexFEC (``net/fec.py``) against the JAX package's on the
CPU: the four FEC cases of ``test_fec_h26x.py`` (single loss by a row,
a double loss a row cannot fix, a burst by the columns, an L-shaped loss by
iterating rows and columns) as one parametrised test run through both
packages, each encoder's repair packets byte-equal to the other's, and a
seeded random loss pattern over both packages' decoders."""
import numpy as np
import pytest

from mediastreamer2_tpu.net import fec as j_fec
from mediastreamer2_tpu.net import rtp as j_rtp
from mediastreamer2_tpu_torch.net import fec as t_fec
from mediastreamer2_tpu_torch.net import rtp as t_rtp

PKGS = {"jax": (j_fec, j_rtp), "torch": (t_fec, t_rtp)}

# name: (L, D, scheme, packets, payload seed and sizes, lost seqs,
#        repairs expected, recovered expected)
CASES = {
    "single_loss_row": (5, 4, "row", 10, (0, 40, 13), {3}, 2, {3}),
    "double_loss_row": (4, 4, "row", 4, None, {1, 2}, 1, set()),
    "burst_columns": (4, 3, "col", 12, (1, 30, 7), set(range(4, 8)), 4, set(range(4, 8))),
    "l_shape_2d": (4, 4, "2d", 16, (2, 25, 5), {0, 1, 4}, 8, {0, 1, 4}),
}


def _media(rtp, n, payload):
    if payload is None:                         # the double-loss case's fixed bytes
        return [rtp.RtpPacket(0, s, s, 7, bytes([s]) * 20) for s in range(n)]
    seed, base, mod = payload
    rng = np.random.default_rng(seed)
    return [rtp.RtpPacket(0, s, s * 160, 7, rng.bytes(base + s % mod)) for s in range(n)]


def _run(pkg, case):
    fec, rtp = PKGS[pkg]
    L, D, scheme, n, payload, lost, _, _ = CASES[case]
    enc = fec.FecEncoder(L=L, D=D, scheme=scheme)
    dec = fec.FecDecoder()
    media = _media(rtp, n, payload)
    repairs = [r for p in media for r in enc.push(p)]
    for p in media:
        if p.seq not in lost:
            dec.push_media(p)
    recovered = [r for rp in repairs for r in dec.push_repair(rp)]
    return media, repairs, recovered, dec


@pytest.mark.parametrize("case", CASES)
def test_fec_cases_match_jax(case):
    *_, n_repairs, want = CASES[case]
    jm, jr, jrec, jdec = _run("jax", case)
    tm, tr, trec, tdec = _run("torch", case)
    assert len(tr) == n_repairs
    assert [r.pack() for r in tr] == [r.pack() for r in jr]           # byte-equal repairs
    assert sorted(r.seq for r in trec) == sorted(want)
    for r in trec:
        assert r.payload == tm[r.seq].payload and r.timestamp == tm[r.seq].timestamp
    assert [(r.seq, r.timestamp, r.payload) for r in trec] == \
        [(r.seq, r.timestamp, r.payload) for r in jrec]
    assert (tdec.recovered, tdec.unrecoverable, len(tdec.pending)) == \
        (jdec.recovered, jdec.unrecoverable, len(jdec.pending))


@pytest.mark.parametrize("scheme", ["row", "col", "2d"])
def test_random_loss_recovers_the_same_packets(scheme):
    """300 packets of seeded sizes, 10% of media and repairs lost: both
    packages' decoders recover the same packets, each equal to what was
    sent."""
    rng = np.random.default_rng(21)
    sizes = rng.integers(20, 1200, 300)
    payloads = [rng.bytes(int(n)) for n in sizes]
    lost = rng.random(600) < 0.10
    out = {}
    for pkg, (fec, rtp) in PKGS.items():
        enc = fec.FecEncoder(L=5, D=5, scheme=scheme)
        dec = fec.FecDecoder()
        recovered, k = [], 0
        for s, pl in enumerate(payloads):
            p = rtp.RtpPacket(96, s, 90 * s, 5, pl)
            if not lost[k]:
                dec.push_media(p)
            k += 1
            for r in enc.push(p):
                r = rtp.RtpPacket.unpack(r.pack())
                if not lost[k]:
                    recovered += dec.push_repair(r)
                k += 1
        out[pkg] = [(r.seq, r.timestamp, r.payload) for r in recovered]
    assert out["torch"] == out["jax"] and out["torch"]
    for seq, ts, pl in out["torch"]:
        assert pl == payloads[seq] and ts == 90 * seq


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="row, col or 2d"):
        t_fec.FecEncoder(scheme="diagonal")
