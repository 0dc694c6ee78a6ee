"""ICE (RFC 8445/5245) — sessions, check lists, connectivity checks (a copy
of ``mediastreamer2_tpu/net/ice.py``: plain Python).

Reference: src/voip/ice.c (4,895 LoC; API include/mediastreamer2/ice.h:
276-593), driven per-tick from media_stream_iterate
(src/voip/mediastream.c:547) and from inbound STUN packets (:532-533).

Scope: host/srflx/prflx candidate handling, pair formation with RFC
priority math, **Ta-paced** connectivity checks (RFC 8445 §6.1.4.2, one new
check per Ta across the session like ice.c's check timer), **foundation-
based frozen/waiting coordination across check lists** (§6.1.2.6/§7.2.5.3.3:
one pair per foundation starts waiting; a success unfreezes the foundation
everywhere), **multi-component** check lists (RTP+RTCP: completion needs a
nominated pair per component), role conflicts + USE-CANDIDATE nomination,
triggered checks, keepalives, restart.

Beside the JAX module: each ``IceCheckList`` counts the connectivity checks
it sent (``checks_sent``) and, of them, the retransmits (``retransmits``: a
check on a pair already in progress).
"""
from __future__ import annotations

import dataclasses
import random
import string
import time
from typing import Callable, List, Optional, Tuple

from mediastreamer2_tpu_torch.net import stun

# candidate types and RFC 5245 type preferences
TYPE_PREF = {"host": 126, "prflx": 110, "srflx": 100, "relay": 0}

IS_CHECKING, IS_COMPLETED, IS_FAILED, IS_RUNNING = (
    "checking", "completed", "failed", "running")

RTO_MS = 500
MAX_RETRANS = 4
KEEPALIVE_S = 15.0
TA_MS = 50                      # RFC 8445 §6.1.4.2 check pacing


def random_ufrag(n=4):
    return "".join(random.choice(string.ascii_letters + string.digits)
                   for _ in range(n))


@dataclasses.dataclass(frozen=True)
class Candidate:
    foundation: str
    component: int              # 1=RTP, 2=RTCP
    transport: str              # "udp"
    priority: int
    host: str
    port: int
    typ: str                    # host/srflx/prflx/relay
    base: Optional[Tuple[str, int]] = None   # srflx/relay: local base addr

    @classmethod
    def make(cls, host: str, port: int, typ: str = "host",
             component: int = 1, local_pref: int = 65535,
             base: Optional[Tuple[str, int]] = None):
        prio = (TYPE_PREF[typ] << 24) | (local_pref << 8) | (256 - component)
        return cls(foundation=f"{typ}:{host}", component=component,
                   transport="udp", priority=prio, host=host, port=port,
                   typ=typ, base=base)

    def sdp(self) -> str:
        return (f"candidate:{self.foundation} {self.component} "
                f"{self.transport} {self.priority} {self.host} {self.port} "
                f"typ {self.typ}")


@dataclasses.dataclass
class CandidatePair:
    local: Candidate
    remote: Candidate
    state: str = "frozen"       # frozen/waiting/in-progress/succeeded/failed
    nominated: bool = False
    priority: int = 0
    _tx_id: Optional[bytes] = None
    _sent_at: float = 0.0
    _retrans: int = 0

    def compute_priority(self, controlling: bool):
        g = self.local.priority if controlling else self.remote.priority
        d = self.remote.priority if controlling else self.local.priority
        self.priority = (min(g, d) << 32) + (max(g, d) << 1) + (1 if g > d else 0)


class IceCheckList:
    """One per media stream (cf. ice_check_list_* API)."""

    def __init__(self, session: "IceSession", send_fn: Callable[[Tuple[str, int], bytes], None],
                 local_addr: Tuple[str, int]):
        self.session = session
        self.send_fn = send_fn
        self.local_candidates: List[Candidate] = [
            Candidate.make(local_addr[0], local_addr[1], "host")]
        self.remote_candidates: List[Candidate] = []
        self.pairs: List[CandidatePair] = []
        self._pruned_keys: set = set()   # (local, remote) never re-formed
        self.state = IS_RUNNING
        self.selected: Optional[CandidatePair] = None
        self._last_keepalive = time.monotonic()
        # Trickle ICE (RFC 8838): remote candidates may keep arriving
        # after connectivity checks started; the list must not be declared
        # FAILED until the peer signals a=end-of-candidates.
        self.remote_end_of_candidates = False
        self.checks_sent = 0
        self.retransmits = 0

    # -- candidate intake -------------------------------------------------
    def start_srflx_gather(self, stun_server: Tuple[str, int]):
        """Server-reflexive gathering: plain Binding to a STUN server; the
        XOR-MAPPED-ADDRESS response becomes an srflx candidate
        (cf. ice_session_gather_candidates)."""
        req = stun.StunMessage(stun.BINDING_REQUEST)
        self._gather_tx = req.transaction_id
        self.send_fn(stun_server, req.pack())

    def add_local_candidate(self, cand: Candidate):
        self.local_candidates.append(cand)
        self._form_pairs()

    def add_remote_candidate(self, cand: Candidate):
        """Also the trickle entry point (RFC 8838 §10): candidates arriving
        mid-checks pair up immediately and join the Ta-paced schedule."""
        self.remote_candidates.append(cand)
        self._form_pairs()

    def set_end_of_candidates(self):
        """Peer signalled a=end-of-candidates (RFC 8838 §14): exhausting
        the current pairs is now final."""
        self.remote_end_of_candidates = True
        self._update_state()

    @staticmethod
    def _pair_foundation(p: CandidatePair) -> str:
        return f"{p.local.foundation}|{p.remote.foundation}"

    MAX_PAIRS = 100                       # RFC 8445 §6.1.2.5 cap

    def _form_pairs(self):
        # pruned combinations are remembered so later candidate additions
        # do not re-create them as fresh frozen pairs (which would re-sort,
        # re-prune and possibly re-unfreeze them every trickle arrival)
        existing = {(p.local, p.remote) for p in self.pairs}
        existing |= self._pruned_keys
        for l in self.local_candidates:
            for r in self.remote_candidates:
                if l.component == r.component and (l, r) not in existing:
                    p = CandidatePair(l, r, state="frozen")
                    p.compute_priority(self.session.controlling)
                    self.pairs.append(p)
        self.pairs.sort(key=lambda p: -p.priority)
        self._prune_pairs()
        self._unfreeze_initial()

    def _prune_pairs(self):
        """RFC 8445 §6.1.2.4 redundancy pruning: a pair whose local
        candidate is server-reflexive checks FROM ITS BASE anyway, so it
        duplicates the (base, remote) host pair — keep only the
        highest-priority pair per (local base addr, remote addr), and cap
        the list (§6.1.2.5), dropping lowest-priority frozen pairs."""
        seen = {}
        kept = []
        for p in self.pairs:              # already sorted by priority desc
            lb = getattr(p.local, "base", None) or (p.local.host,
                                                    p.local.port)
            key = (lb, p.remote.host, p.remote.port, p.local.component)
            if key in seen:
                self._pruned_keys.add((p.local, p.remote))
                continue                  # redundant lower-priority pair
            seen[key] = p
            kept.append(p)
        if len(kept) > self.MAX_PAIRS:
            # drop only FROZEN pairs beyond the cap — active checks are
            # never killed, so the list may transiently exceed MAX_PAIRS
            # by however many non-frozen pairs sit past the boundary
            for p in kept[self.MAX_PAIRS:]:
                if p.state == "frozen":
                    self._pruned_keys.add((p.local, p.remote))
            kept = kept[:self.MAX_PAIRS] + \
                [p for p in kept[self.MAX_PAIRS:] if p.state != "frozen"]
        self.pairs = kept

    def _unfreeze_initial(self):
        """RFC 8445 §6.1.2.6: per foundation, the highest-priority pair of
        the lowest component number goes waiting; the rest stay frozen
        until a same-foundation check succeeds (possibly in another check
        list of the session)."""
        seen = set()
        succeeded = self.session.succeeded_foundations
        for p in self.pairs:
            f = self._pair_foundation(p)
            if p.state == "frozen" and f in succeeded:
                p.state = "waiting"          # cross-list unfreeze
                continue
            if p.state == "frozen" and (f, p.local.component) not in seen \
                    and p.local.component == min(
                        q.local.component for q in self.pairs
                        if self._pair_foundation(q) == f):
                p.state = "waiting"
            seen.add((f, p.local.component))

    def unfreeze_foundation(self, foundation: str):
        for p in self.pairs:
            if p.state == "frozen" and self._pair_foundation(p) == foundation:
                p.state = "waiting"

    # -- periodic processing (cf. ice_check_list_process) ------------------
    def process(self, now: Optional[float] = None):
        if self.state != IS_RUNNING:
            self._keepalive(now)
            return
        now = time.monotonic() if now is None else now
        # retransmit / timeout in-progress checks
        for p in self.pairs:
            if p.state == "in-progress" and now - p._sent_at > RTO_MS / 1e3:
                if p._retrans >= MAX_RETRANS:
                    p.state = "failed"
                    f = self._pair_foundation(p)
                    if not any(q.state in ("waiting", "in-progress")
                               and self._pair_foundation(q) == f
                               for q in self.pairs):
                        self.unfreeze_foundation(f)   # try the next tier
                else:
                    self._send_check(p, now)
        # launch the next waiting check, Ta-paced across the whole session
        # (ice.c's global check timer; one new check per Ta)
        if self.session.ta_allows(now):
            for p in self.pairs:
                if p.state == "waiting":
                    self._send_check(p, now)
                    self.session.ta_consume(now)
                    break
        self._update_state()

    def _send_check(self, p: CandidatePair, now: float):
        s = self.session
        username = f"{s.remote_ufrag}:{s.local_ufrag}"
        req = stun.make_binding_request(
            username=username, priority=p.local.priority,
            controlling=s.controlling, tiebreaker=s.tiebreaker,
            use_candidate=s.controlling and (s.aggressive or p.nominated))
        p._tx_id = req.transaction_id
        self.checks_sent += 1
        self.retransmits += p.state == "in-progress"
        if p.state == "waiting":
            p._retrans = 0
        else:
            p._retrans += 1
        p.state = "in-progress"
        p._sent_at = now
        self.send_fn((p.remote.host, p.remote.port),
                     req.pack(password=s.remote_pwd))

    def _update_state(self):
        """Completion requires a nominated+succeeded pair for EVERY
        component present in the check list (RTP and RTCP when the stream
        is not rtcp-mux — reference multi-component checks)."""
        components = {p.local.component for p in self.pairs}
        if not components:
            return
        self.selected_pairs = {}
        for c in sorted(components):
            hit = next((p for p in self.pairs
                        if p.local.component == c and p.nominated
                        and p.state == "succeeded"), None)
            if hit is not None:
                self.selected_pairs[c] = hit
        if set(self.selected_pairs) == components:
            self.selected = self.selected_pairs[min(components)]
            self.state = IS_COMPLETED
        elif self.pairs and all(p.state == "failed" for p in self.pairs) \
                and self.remote_end_of_candidates:
            # trickle (RFC 8838): more remote candidates may still arrive;
            # only an exhausted list AFTER end-of-candidates is final
            self.state = IS_FAILED

    def _keepalive(self, now):
        now = time.monotonic() if now is None else now
        if self.selected and now - self._last_keepalive > KEEPALIVE_S:
            self._last_keepalive = now
            ind = stun.StunMessage(stun.BINDING_INDICATION)
            self.send_fn((self.selected.remote.host, self.selected.remote.port),
                         ind.pack())

    # -- inbound STUN (cf. ice_handle_stun_packet) --------------------------
    def handle_stun(self, data: bytes, from_addr: Tuple[str, int]):
        try:
            msg = stun.StunMessage.unpack(data)
        except ValueError:
            return
        s = self.session
        if msg.msg_type == stun.BINDING_REQUEST:
            if not msg.check_integrity(s.local_pwd):
                return
            # role conflict resolution (RFC 8445 7.3.1.1)
            their_controlling = stun.ATTR_ICE_CONTROLLING in msg.attrs
            if their_controlling == s.controlling:
                import struct as _s
                their_tb = _s.unpack(
                    "!Q", msg.attrs[stun.ATTR_ICE_CONTROLLING if their_controlling
                                    else stun.ATTR_ICE_CONTROLLED])[0]
                if (s.tiebreaker >= their_tb) == s.controlling:
                    pass                     # they must switch; send 487
                else:
                    s.controlling = not s.controlling
            resp = stun.make_binding_response(msg, *from_addr)
            self.send_fn(from_addr, resp.pack(password=s.local_pwd))
            # peer-reflexive discovery + triggered check
            known = any(r.host == from_addr[0] and r.port == from_addr[1]
                        for r in self.remote_candidates)
            if not known:
                self.add_remote_candidate(Candidate.make(
                    from_addr[0], from_addr[1], "prflx"))
            for p in self.pairs:
                if (p.remote.host, p.remote.port) == from_addr:
                    if stun.ATTR_USE_CANDIDATE in msg.attrs and not s.controlling:
                        p.nominated = True
                    if p.state in ("frozen", "waiting", "failed"):
                        p.state = "waiting"      # triggered check
            self._update_state()
        elif msg.msg_type == stun.BINDING_RESPONSE:
            if getattr(self, "_gather_tx", None) == msg.transaction_id:
                self._gather_tx = None
                mapped = msg.get_xor_mapped_address()
                if mapped:
                    host = self.local_candidates[0]
                    self.add_local_candidate(Candidate.make(
                        mapped[0], mapped[1], "srflx",
                        base=(host.host, host.port)))
                return
            for p in self.pairs:
                if p._tx_id == msg.transaction_id:
                    p.state = "succeeded"
                    # unfreeze this foundation across ALL the session's
                    # check lists (RFC 8445 §7.2.5.3.3)
                    s.note_success(self._pair_foundation(p))
                    if s.controlling:
                        if self.selected is None:
                            # regular nomination: renominate with USE-CANDIDATE
                            if s.aggressive or p.nominated:
                                p.nominated = True
                            else:
                                req = stun.make_binding_request(
                                    username=f"{s.remote_ufrag}:{s.local_ufrag}",
                                    priority=p.local.priority,
                                    controlling=True, tiebreaker=s.tiebreaker,
                                    use_candidate=True)
                                p._tx_id = req.transaction_id
                                p.nominated = True
                                self.send_fn((p.remote.host, p.remote.port),
                                             req.pack(password=s.remote_pwd))
                    self._update_state()
                    break


class IceSession:
    """cf. ice_session_new / ice.h:276-593."""

    def __init__(self, controlling: bool, aggressive: bool = True):
        self.controlling = controlling
        self.aggressive = aggressive
        self.tiebreaker = random.getrandbits(64)
        self.local_ufrag = random_ufrag()
        self.local_pwd = random_ufrag(22)
        self.remote_ufrag = ""
        self.remote_pwd = ""
        self.check_lists: List[IceCheckList] = []
        self.succeeded_foundations: set = set()
        self._next_check_at = 0.0

    # -- Ta check pacing (shared across check lists, ice.c check timer) ----
    def ta_allows(self, now: float) -> bool:
        return now >= self._next_check_at

    def ta_consume(self, now: float):
        self._next_check_at = now + TA_MS / 1e3

    def note_success(self, foundation: str):
        self.succeeded_foundations.add(foundation)
        for cl in self.check_lists:
            cl.unfreeze_foundation(foundation)

    def set_remote_credentials(self, ufrag: str, pwd: str):
        self.remote_ufrag = ufrag
        self.remote_pwd = pwd

    def add_check_list(self, send_fn, local_addr) -> IceCheckList:
        cl = IceCheckList(self, send_fn, local_addr)
        self.check_lists.append(cl)
        return cl

    @property
    def state(self) -> str:
        if all(cl.state == IS_COMPLETED for cl in self.check_lists):
            return IS_COMPLETED
        if any(cl.state == IS_FAILED for cl in self.check_lists):
            return IS_FAILED
        return IS_RUNNING

    def restart(self):
        """cf. ice_session_restart (ice.h:593)."""
        self.tiebreaker = random.getrandbits(64)
        self.local_ufrag = random_ufrag()
        self.local_pwd = random_ufrag(22)
        self.succeeded_foundations.clear()
        for cl in self.check_lists:
            cl.pairs.clear()
            cl.remote_candidates.clear()
            cl._pruned_keys.clear()
            cl.state = IS_RUNNING
            cl.selected = None
