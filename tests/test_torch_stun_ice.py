"""The port's STUN and ICE (``net/stun.py``, ``net/ice.py``) against the
JAX package's: ports of ``tests/test_ice.py``, ``tests/test_ice_foreign_agent.py``
and the ICE part of ``tests/test_srtcp_srflx.py``, each scenario run through
both packages with the same randomness (``random`` seeded, ``os.urandom``
a seeded stream: ufrags, passwords, tiebreakers, transaction ids) and held
to the same wire bytes, candidates, pair states and nominations. Plain
Python on both sides, so the results must be equal."""
import dataclasses
import os
import random
import struct

import pytest

from mediastreamer2_tpu.net import ice as jice
from mediastreamer2_tpu.net import stun as jstun
from mediastreamer2_tpu_torch.net import ice as tice
from mediastreamer2_tpu_torch.net import stun as tstun
from test_ice_foreign_agent import ForeignAgent

PKGS = {"jax": (jstun, jice), "torch": (tstun, tice)}


@pytest.fixture
def fixed(monkeypatch):
    """``fixed(seed)``: seed ``random`` and make ``os.urandom`` a stream
    seeded the same, so that each package's run draws the same bytes."""
    def reseed(seed):
        random.seed(seed)
        rng = random.Random(seed)
        monkeypatch.setattr(os, "urandom", lambda n: rng.randbytes(n))
    return reseed


def both(fixed, scenario, seed=1):
    """``scenario(stun, ice)`` through each package from the same seed:
    {package: result}; the two results must be equal."""
    out = {}
    for name, (stun, ice) in PKGS.items():
        fixed(seed)
        out[name] = scenario(stun, ice)
    assert out["torch"] == out["jax"]
    return out["torch"]


def _pairs(cl):
    return [(dataclasses.astuple(p.local), dataclasses.astuple(p.remote), p.state,
             p.nominated, p.priority) for p in cl.pairs]


# -- STUN ------------------------------------------------------------------------
def test_stun_messages_are_byte_equal_and_cross_parse(fixed):
    def build(stun, ice):
        req = stun.make_binding_request(username="a:b", priority=123, controlling=True,
                                        tiebreaker=42, use_candidate=True)
        resp = stun.make_binding_response(req, "192.168.1.77", 54321)
        err = stun.StunMessage(stun.BINDING_ERROR, req.transaction_id)
        err.set_error(487, "Role Conflict")
        ind = stun.StunMessage(stun.BINDING_INDICATION)
        return (req.pack(password="secret"), req.pack(), resp.pack(password="pw"),
                err.pack(fingerprint=False), ind.pack(), stun.make_binding_request().pack())
    wire = both(fixed, build)
    for data in wire:
        assert jstun.is_stun(data) and tstun.is_stun(data)
    # each package parses the other's bytes, integrity and attributes alike
    for src, dst in ((jstun, tstun), (tstun, jstun)):
        got = dst.StunMessage.unpack(wire[0])
        assert got.msg_type == src.BINDING_REQUEST
        assert got.attrs[dst.ATTR_USERNAME] == b"a:b"
        assert struct.unpack("!I", got.attrs[dst.ATTR_PRIORITY])[0] == 123
        assert dst.ATTR_USE_CANDIDATE in got.attrs
        assert got.check_integrity("secret") and not got.check_integrity("wrong")
        assert dst.StunMessage.unpack(wire[2]).get_xor_mapped_address() == ("192.168.1.77",
                                                                            54321)
        assert dst.StunMessage.unpack(wire[3]).get_error() == 487


def test_stun_rtp_demux():
    from mediastreamer2_tpu_torch.net.rtp import RtpPacket
    rtp = RtpPacket(0, 1, 2, 3, b"xx").pack()
    assert not tstun.is_stun(rtp)
    assert tstun.is_stun(tstun.make_binding_request().pack())


# -- ICE (tests/test_ice.py) ---------------------------------------------------------
class FakeNet:
    """Deliver datagrams between two ICE agents with optional loss; logs
    every datagram sent."""
    def __init__(self, loss_seq=()):
        self.inboxes = {0: [], 1: []}
        self.loss_seq = set(loss_seq)
        self.count = 0
        self.log = []

    def sender(self, idx):
        def send(addr, data):
            self.count += 1
            self.log.append((idx, addr, data))
            if self.count in self.loss_seq:
                return
            self.inboxes[1 - idx].append((addr, data))
        return send

    def deliver(self, cl0, cl1, addr0, addr1):
        for idx, cl in ((0, cl0), (1, cl1)):
            inbox, self.inboxes[idx] = self.inboxes[idx], []
            for _, data in inbox:
                cl.handle_stun(data, addr1 if idx == 0 else addr0)


ADDR_A, ADDR_B = ("10.0.0.1", 7000), ("10.0.0.2", 7002)


def run_ice(ice, loss_seq=(), controlling_b=False):
    net = FakeNet(loss_seq)
    a = ice.IceSession(controlling=True)
    b = ice.IceSession(controlling=controlling_b)
    a.set_remote_credentials(b.local_ufrag, b.local_pwd)
    b.set_remote_credentials(a.local_ufrag, a.local_pwd)
    cla = a.add_check_list(net.sender(0), ADDR_A)
    clb = b.add_check_list(net.sender(1), ADDR_B)
    cla.add_remote_candidate(ice.Candidate.make(*ADDR_B))
    clb.add_remote_candidate(ice.Candidate.make(*ADDR_A))
    t = 0.0
    for _ in range(30):
        t += 0.6
        cla.process(now=t)
        clb.process(now=t)
        net.deliver(cla, clb, ADDR_A, ADDR_B)
        net.deliver(cla, clb, ADDR_A, ADDR_B)  # responses to triggered checks
        if a.state == ice.IS_COMPLETED and b.state == ice.IS_COMPLETED:
            break
    return a, b, cla, clb, net


def _ice_summary(a, b, cla, clb, net):
    return (a.state, b.state, a.controlling, b.controlling, _pairs(cla), _pairs(clb),
            net.log)


@pytest.mark.parametrize("loss_seq", [(), (1, 2)], ids=["clean", "first-checks-lost"])
def test_ice_completes_equal(fixed, loss_seq):
    def scenario(stun, ice):
        return _ice_summary(*run_ice(ice, loss_seq))
    a_state, b_state, _, _, pairs_a, pairs_b, log = both(fixed, scenario)
    assert a_state == b_state == tice.IS_COMPLETED
    assert pairs_a[0][3] and pairs_a[0][1][5] == 7002      # nominated, remote port
    assert log                                             # the same datagrams, byte for byte


def test_ice_role_conflict_resolved_by_tiebreaker(fixed):
    """RFC 8445 §7.3.1.1: both agents start controlling; the one whose
    tiebreaker loses switches to controlled, and the call still completes."""
    def scenario(stun, ice):
        return _ice_summary(*run_ice(ice, controlling_b=True))
    a_state, b_state, a_ctl, b_ctl, _, _, _ = both(fixed, scenario, seed=5)
    assert a_state == b_state == tice.IS_COMPLETED
    assert a_ctl != b_ctl


def test_ice_restart(fixed):
    def scenario(stun, ice):
        a, b, cla, clb, _ = run_ice(ice)
        old = (a.local_ufrag, a.local_pwd, a.tiebreaker)
        a.restart()
        return old, (a.local_ufrag, a.local_pwd, a.tiebreaker), a.state, cla.pairs
    old, new, state, pairs = both(fixed, scenario)
    assert old != new and state == tice.IS_RUNNING and pairs == []


def test_candidate_priorities_foundations_and_sdp():
    for typ in ("host", "srflx", "prflx", "relay"):
        for comp in (1, 2):
            for pref in (65535, 100):
                j = jice.Candidate.make("1.2.3.4", 5678, typ, component=comp, local_pref=pref)
                t = tice.Candidate.make("1.2.3.4", 5678, typ, component=comp, local_pref=pref)
                assert dataclasses.astuple(t) == dataclasses.astuple(j)
                assert t.sdp() == j.sdp()
    c = tice.Candidate.make("1.2.3.4", 5678, "host")
    assert "1.2.3.4 5678 typ host" in c.sdp()
    assert c.priority >> 24 == 126
    for g, d in ((10, 20), (20, 10), (7, 7)):
        pj = jice.CandidatePair(jice.Candidate.make("1.1.1.1", 1), jice.Candidate.make("2.2.2.2", 2))
        pt = tice.CandidatePair(tice.Candidate.make("1.1.1.1", 1), tice.Candidate.make("2.2.2.2", 2))
        for ctl in (True, False):
            pj.compute_priority(ctl)
            pt.compute_priority(ctl)
            assert pt.priority == pj.priority


def test_ta_pacing_limits_new_checks(fixed):
    """RFC 8445 6.1.4.2: at most one NEW check per Ta across the session."""
    def scenario(stun, ice):
        sent = []
        s = ice.IceSession(controlling=True)
        s.set_remote_credentials("u", "p")
        cl = s.add_check_list(lambda addr, data: sent.append((addr, data)), ("10.0.0.1", 1000))
        for k in range(6):
            cl.add_remote_candidate(ice.Candidate.make(f"10.0.1.{k + 2}", 2000))
        counts = []
        now = 100.0
        for dt in (0.0, 0.001, ice.TA_MS / 1e3 + 0.001, ice.TA_MS / 1e3 + 0.002,
                   2 * ice.TA_MS / 1e3 + 0.002, 0.6, 1.2):
            cl.process(now=now + dt)
            counts.append(len(sent))
        return counts, sent, _pairs(cl)
    counts, _, _ = both(fixed, scenario)
    assert counts[1] == counts[0] and counts[2] == counts[0] + 1 and counts[3] == counts[2]


def test_foundation_unfreezing_across_check_lists(fixed):
    def scenario(stun, ice):
        s = ice.IceSession(controlling=True)
        s.set_remote_credentials("u", "p")
        cl1 = s.add_check_list(lambda a, d: None, ("10.0.0.1", 1000))
        cl2 = s.add_check_list(lambda a, d: None, ("10.0.0.1", 1002))
        for cl in (cl1, cl2):
            cl.add_remote_candidate(ice.Candidate.make("10.0.0.2", 2000))
            cl.add_remote_candidate(ice.Candidate.make("10.0.0.9", 2000, "srflx"))
        f = cl1._pair_foundation(cl1.pairs[0])
        for p in cl2.pairs:
            p.state = "frozen"
        s.note_success(f)
        return f, _pairs(cl1), _pairs(cl2), [cl2._pair_foundation(p) for p in cl2.pairs]
    f, _, pairs2, founds = both(fixed, scenario)
    assert any(p[2] == "waiting" and fd == f for p, fd in zip(pairs2, founds))
    assert any(p[2] == "frozen" for p in pairs2)


def test_multi_component_completion(fixed):
    def scenario(stun, ice):
        s = ice.IceSession(controlling=True)
        s.set_remote_credentials("u", "p")
        cl = s.add_check_list(lambda a, d: None, ("10.0.0.1", 1000))
        cl.add_local_candidate(ice.Candidate.make("10.0.0.1", 1001, component=2))
        cl.add_remote_candidate(ice.Candidate.make("10.0.0.2", 2000, component=1))
        cl.add_remote_candidate(ice.Candidate.make("10.0.0.2", 2001, component=2))
        p1 = next(p for p in cl.pairs if p.local.component == 1)
        p2 = next(p for p in cl.pairs if p.local.component == 2)
        p1.state, p1.nominated = "succeeded", True
        cl._update_state()
        states = [cl.state]
        p2.state, p2.nominated = "succeeded", True
        cl._update_state()
        states.append(cl.state)
        return states, cl.selected_pairs[1] is p1, cl.selected_pairs[2] is p2, cl.selected is p1
    assert both(fixed, scenario) == ([tice.IS_RUNNING, tice.IS_COMPLETED], True, True, True)


def test_trickle_candidates_arrive_mid_checks(fixed):
    """RFC 8838: checks start with one dead remote candidate; the real ones
    trickle in later and the session completes; an exhausted list does not
    fail before end-of-candidates."""
    def scenario(stun, ice):
        net = FakeNet()
        a = ice.IceSession(controlling=True)
        b = ice.IceSession(controlling=False)
        a.set_remote_credentials(b.local_ufrag, b.local_pwd)
        b.set_remote_credentials(a.local_ufrag, a.local_pwd)
        cla = a.add_check_list(net.sender(0), ADDR_A)
        clb = b.add_check_list(net.sender(1), ADDR_B)
        cla.add_remote_candidate(ice.Candidate.make("10.9.9.9", 9999))
        t = 0.0
        for _ in range(40):
            t += 0.6
            cla.process(now=t)
            net.inboxes[0].clear()
            net.inboxes[1].clear()
        mid = (cla.state, [p.state for p in cla.pairs])
        cla.add_remote_candidate(ice.Candidate.make(*ADDR_B))
        clb.add_remote_candidate(ice.Candidate.make(*ADDR_A))
        for _ in range(30):
            t += 0.6
            cla.process(now=t)
            clb.process(now=t)
            net.deliver(cla, clb, ADDR_A, ADDR_B)
            net.deliver(cla, clb, ADDR_A, ADDR_B)
            if a.state == ice.IS_COMPLETED and b.state == ice.IS_COMPLETED:
                break
        return mid, _ice_summary(a, b, cla, clb, net)
    (mid_state, mid_pairs), (a_state, b_state, *_rest) = both(fixed, scenario)
    assert mid_state == tice.IS_RUNNING and set(mid_pairs) == {"failed"}
    assert a_state == b_state == tice.IS_COMPLETED


def test_end_of_candidates_makes_exhaustion_final(fixed):
    def scenario(stun, ice):
        net = FakeNet()
        a = ice.IceSession(controlling=True)
        a.set_remote_credentials("u", "p")
        cla = a.add_check_list(net.sender(0), ADDR_A)
        cla.add_remote_candidate(ice.Candidate.make("10.9.9.9", 9999))
        t = 0.0
        for _ in range(40):
            t += 0.6
            cla.process(now=t)
            net.inboxes[1] = []
        before = cla.state
        cla.set_end_of_candidates()
        return before, cla.state, net.log
    before, after, _ = both(fixed, scenario)
    assert (before, after) == (tice.IS_RUNNING, tice.IS_FAILED)


def test_pair_pruning_and_cap(fixed):
    """§6.1.2.4: an srflx local candidate with the host's base is pruned; a
    second interface is not; §6.1.2.5 caps the list; a pruned pair is not
    re-formed when more candidates trickle in."""
    def scenario(stun, ice):
        cla = ice.IceSession(controlling=True).add_check_list(lambda a, d: None, ADDR_A)
        cla.add_remote_candidate(ice.Candidate.make("10.0.0.2", 2000))
        n0 = len(cla.pairs)
        cla.add_local_candidate(ice.Candidate.make("198.51.100.7", 31000, "srflx",
                                                   base=ADDR_A))
        n1 = len(cla.pairs)
        cla.add_local_candidate(ice.Candidate.make("10.0.1.1", 7100))
        n2 = len(cla.pairs)
        for i in range(40):
            cla.add_remote_candidate(ice.Candidate.make(f"10.1.{i}.1", 9000 + i))
        for i in range(30):
            cla.add_local_candidate(ice.Candidate.make(f"10.0.{i}.1", 7000 + i))
        return (n0, n1, n2, len(cla.pairs), _pairs(cla),
                sorted(map(lambda k: (dataclasses.astuple(k[0]), dataclasses.astuple(k[1])),
                           cla._pruned_keys)))
    n0, n1, n2, n, _, _ = both(fixed, scenario)
    assert n1 == n0 and n2 == n0 + 1 and n <= tice.IceCheckList.MAX_PAIRS


def test_simultaneous_ice_restart(fixed):
    def scenario(stun, ice):
        a, b, cla, clb, _ = run_ice(ice)
        a.restart()
        b.restart()
        a.set_remote_credentials(b.local_ufrag, b.local_pwd)
        b.set_remote_credentials(a.local_ufrag, a.local_pwd)
        cla.add_remote_candidate(ice.Candidate.make(*ADDR_B))
        clb.add_remote_candidate(ice.Candidate.make(*ADDR_A))
        net = FakeNet()
        cla.send_fn, clb.send_fn = net.sender(0), net.sender(1)
        t = 100.0
        for _ in range(30):
            t += 0.6
            cla.process(now=t)
            clb.process(now=t)
            net.deliver(cla, clb, ADDR_A, ADDR_B)
            net.deliver(cla, clb, ADDR_A, ADDR_B)
            if a.state == ice.IS_COMPLETED and b.state == ice.IS_COMPLETED:
                break
        return _ice_summary(a, b, cla, clb, net)
    a_state, b_state, *_ = both(fixed, scenario)
    assert a_state == b_state == tice.IS_COMPLETED


# -- srflx gathering (tests/test_srtcp_srflx.py) -----------------------------------
def test_ice_srflx_gathering(fixed):
    def scenario(stun, ice):
        sent = []
        cl = ice.IceSession(controlling=True).add_check_list(
            lambda addr, data: sent.append((addr, data)), ("192.168.1.10", 4000))
        cl.start_srflx_gather(("99.99.99.99", 3478))
        req = stun.StunMessage.unpack(sent[-1][1])
        resp = stun.make_binding_response(req, "203.0.113.7", 61000)
        cl.handle_stun(resp.pack(), ("99.99.99.99", 3478))
        return sent, [dataclasses.astuple(c) for c in cl.local_candidates]
    sent, cands = both(fixed, scenario)
    assert sent[-1][0] == ("99.99.99.99", 3478)
    srflx = [c for c in cands if c[6] == "srflx"]
    assert len(srflx) == 1 and srflx[0][4:6] == ("203.0.113.7", 61000)
    assert srflx[0][3] >> 24 == 100


# -- a foreign agent (tests/test_ice_foreign_agent.py) -------------------------------
def test_ice_completes_against_foreign_agent():
    """The port's agent against the independent RFC 5389 responder: the
    foreign agent accepts the port's MESSAGE-INTEGRITY and FINGERPRINT, and
    the port completes against its hand-built responses."""
    foreign = ForeignAgent("frgn", "foreignpassword1234567", ("10.0.0.9", 9002))
    ours = tice.IceSession(controlling=True)
    ours.set_remote_credentials(foreign.ufrag, foreign.pwd)
    foreign.peer_ufrag, foreign.peer_pwd = ours.local_ufrag, ours.local_pwd
    sent = []
    cl = ours.add_check_list(lambda addr, data: sent.append((addr, data)), ("10.0.0.1", 9000))
    cl.add_remote_candidate(tice.Candidate.make(*foreign.addr))
    t = 0.0
    for _ in range(30):
        t += 0.5
        cl.process(now=t)
        for _, data in sent:
            foreign.handle(data, ("10.0.0.1", 9000))
        sent.clear()
        if foreign.requests_seen == 1 and foreign.use_candidate_seen == 0:
            foreign.send_check(("10.0.0.1", 9000))
        for _, data in foreign.outbox:
            cl.handle_stun(data, foreign.addr)
        foreign.outbox.clear()
        if ours.state == tice.IS_COMPLETED:
            break
    assert foreign.requests_seen >= 1
    assert foreign.integrity_ok == foreign.requests_seen
    assert foreign.fingerprint_ok == foreign.requests_seen
    assert foreign.use_candidate_seen >= 1
    assert ours.state == tice.IS_COMPLETED
    assert (cl.selected.remote.host, cl.selected.remote.port) == foreign.addr


def test_foreign_agent_rejects_tampered_integrity():
    foreign = ForeignAgent("frgn", "foreignpassword1234567", ("10.0.0.9", 9002))
    ours = tice.IceSession(controlling=True)
    ours.set_remote_credentials(foreign.ufrag, foreign.pwd)
    sent = []
    cl = ours.add_check_list(lambda a, d: sent.append((a, d)), ("10.0.0.1", 9000))
    cl.add_remote_candidate(tice.Candidate.make(*foreign.addr))
    cl.process(now=1.0)
    bad = bytearray(sent[0][1])
    bad[25] ^= 0x01
    foreign.handle(bytes(bad), ("10.0.0.1", 9000))
    assert foreign.integrity_ok == 0 and not foreign.outbox


def test_ice_completes_when_rounds_outlast_rto(fixed):
    """Two agents each run process() then read their inbox once a round, as
    CallSetup.iterate() does, and every round lasts 0.6 s, past RTO: each
    check is resent before its answer is read, so every answer names a
    stale transaction, until the last retransmit, which has no successor
    and is answered. The call completes at round 6 all the same (phase 11a's
    rounds of 0.5-0.8 s over 2,048 sockets), with 4 of every 5 checks a
    retransmit."""
    def scenario(stun, ice):
        net = FakeNet()
        a = ice.IceSession(controlling=True)
        b = ice.IceSession(controlling=False)
        a.set_remote_credentials(b.local_ufrag, b.local_pwd)
        b.set_remote_credentials(a.local_ufrag, a.local_pwd)
        cla = a.add_check_list(net.sender(0), ADDR_A)
        clb = b.add_check_list(net.sender(1), ADDR_B)
        cla.add_remote_candidate(ice.Candidate.make(*ADDR_B))
        clb.add_remote_candidate(ice.Candidate.make(*ADDR_A))
        t, rounds = 0.0, 0
        while rounds < 20 and not (a.state == b.state == ice.IS_COMPLETED):
            t += 0.6
            rounds += 1
            for idx, cl, peer in ((0, cla, ADDR_B), (1, clb, ADDR_A)):
                cl.process(now=t)
                inbox, net.inboxes[idx] = net.inboxes[idx], []
                for _, data in inbox:
                    cl.handle_stun(data, peer)
        requests = [d for _, _, d in net.log if d[:2] == b"\x00\x01"]
        return rounds, a.state, b.state, len(requests), net.log
    rounds, a_state, b_state, requests, _ = both(fixed, scenario)
    assert a_state == b_state == tice.IS_COMPLETED
    assert rounds == 6
    assert requests == 2 * (1 + tice.MAX_RETRANS)       # one check, four resends, a side


def test_check_list_counts_its_checks_and_retransmits(fixed):
    """The port's counters (not in the JAX module): with every round past
    RTO, each side's check list sends one check and MAX_RETRANS resends,
    and the counters agree with the requests on the wire."""
    net = FakeNet()
    a = tice.IceSession(controlling=True)
    b = tice.IceSession(controlling=False)
    a.set_remote_credentials(b.local_ufrag, b.local_pwd)
    b.set_remote_credentials(a.local_ufrag, a.local_pwd)
    cla = a.add_check_list(net.sender(0), ADDR_A)
    clb = b.add_check_list(net.sender(1), ADDR_B)
    cla.add_remote_candidate(tice.Candidate.make(*ADDR_B))
    clb.add_remote_candidate(tice.Candidate.make(*ADDR_A))
    assert (cla.checks_sent, cla.retransmits) == (0, 0)
    t = 0.0
    for _ in range(6):
        t += 0.6
        for idx, cl, peer in ((0, cla, ADDR_B), (1, clb, ADDR_A)):
            cl.process(now=t)
            inbox, net.inboxes[idx] = net.inboxes[idx], []
            for _, data in inbox:
                cl.handle_stun(data, peer)
    assert a.state == b.state == tice.IS_COMPLETED
    for idx, cl in ((0, cla), (1, clb)):
        sent = [d for src, _, d in net.log if src == idx and d[:2] == b"\x00\x01"]
        assert (cl.checks_sent, cl.retransmits) == (len(sent), tice.MAX_RETRANS)
        assert cl.checks_sent == 1 + tice.MAX_RETRANS
