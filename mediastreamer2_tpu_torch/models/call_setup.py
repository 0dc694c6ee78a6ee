"""CallSetup — compose NAT traversal + key agreement + SRTP on one socket
(port of ``mediastreamer2_tpu/models/call_setup.py``: plain Python over the
port's ``net/``).

The reference drives this composition from ``media_stream_iterate``
(src/voip/mediastream.c:542-573: ICE check-list processing, STUN packet
demux at :532-533, encryption-changed events) with everything multiplexed
on the RTP socket.  CallSetup owns that multiplexing:

  UdpTransport ── demux ──> STUN -> IceCheckList
                          > DTLS -> DtlsSrtpSession -> SRTP keys
                          > ZRTP -> ZrtpSession     -> SRTP keys
                          > RTP/RTCP -> the media Transport view

``media_transport()`` returns a Transport whose send() targets the
nominated pair and whose recv_all() yields only media packets — wrap it in
SrtpTransport once keys arrive (on_secrets), then hand it to
AudioStreamBatch.set_transport.

Beside the JAX module: ``demuxed`` counts what the demux sorted (stun,
dtls, zrtp, media packets), ``close()`` also frees the DTLS session, and
``media_transport()`` refuses a failed or unkeyed call with an
``AssertionError`` raised explicitly (it stays under ``python -O``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from mediastreamer2_tpu_torch.net.rtp import Transport, UdpTransport
from mediastreamer2_tpu_torch.net import stun
from mediastreamer2_tpu_torch.net.ice import IceSession, Candidate, IS_COMPLETED
from mediastreamer2_tpu_torch.net.dtls import DtlsSrtpSession, is_dtls
from mediastreamer2_tpu_torch.net.zrtp import ZrtpSession, is_zrtp
from mediastreamer2_tpu_torch.net.srtp import SrtpContext, SrtcpContext, SrtpTransport


class _MediaView(Transport):
    def __init__(self, setup: "CallSetup"):
        self.setup = setup

    def send(self, data: bytes):
        dest = self.setup.remote_media_addr()
        if dest is not None:
            self.setup.sock.sock.sendto(data, dest)

    def recv_all(self) -> List[bytes]:
        self.setup.poll()
        out, self.setup._media_rx = self.setup._media_rx, []
        return out

    def close(self):
        pass


class CallSetup:
    def __init__(self, controlling: bool, local_port: int = 0,
                 key_agreement: str = "none"):
        self.sock = UdpTransport(local_port=local_port)
        self.ice = IceSession(controlling=controlling)
        self.check_list = self.ice.add_check_list(
            self._send_to, ("127.0.0.1", self.sock.local_port))
        self._media_rx: List[bytes] = []
        self.demuxed = {"stun": 0, "dtls": 0, "zrtp": 0, "media": 0}
        self.key_agreement = key_agreement
        self.dtls: Optional[DtlsSrtpSession] = None
        self.zrtp: Optional[ZrtpSession] = None
        self.srtp_keys = None          # (tx_key, tx_salt, rx_key, rx_salt)
        self.srtp_suite = "AES_CM_128_HMAC_SHA1_80"   # ZRTP/SDES default
        self.sas: Optional[str] = None
        self._expected_fingerprint: Optional[str] = None
        self.security_failed = False   # set on fingerprint mismatch
        if key_agreement == "dtls":
            self.dtls = DtlsSrtpSession(is_server=not controlling)
        elif key_agreement == "zrtp":
            self.zrtp = ZrtpSession(send=self._send_media_path)
            self.zrtp.on_secrets = self._on_zrtp_secrets
            self.zrtp.on_sas = lambda s: setattr(self, "sas", s)

    # -- addressing -------------------------------------------------------
    def local_candidates_sdp(self) -> List[str]:
        return [c.sdp() for c in self.check_list.local_candidates]

    def local_credentials(self) -> Tuple[str, str]:
        return self.ice.local_ufrag, self.ice.local_pwd

    def set_remote(self, ufrag: str, pwd: str,
                   candidates: List[Tuple[str, int]],
                   trickle: bool = False):
        """Classic ICE: the SDP carried the full candidate set -> mark
        end-of-candidates so an exhausted list can fail.  trickle=True
        (RFC 8838) keeps the list open; feed more via add_candidate() and
        finish with end_of_candidates()."""
        self.ice.set_remote_credentials(ufrag, pwd)
        for host, port in candidates:
            self.check_list.add_remote_candidate(Candidate.make(host, port))
        if not trickle:
            self.check_list.set_end_of_candidates()

    def add_candidate(self, host: str, port: int, typ: str = "host"):
        """Trickled remote candidate (RFC 8838 §10)."""
        self.check_list.add_remote_candidate(Candidate.make(host, port, typ))

    def end_of_candidates(self):
        self.check_list.set_end_of_candidates()

    def local_fingerprint(self) -> Optional[str]:
        """SHA-256 cert fingerprint for our SDP ``a=fingerprint`` line."""
        return self.dtls.local_fingerprint() if self.dtls is not None else None

    def set_remote_fingerprint(self, fp: str):
        """Expected peer cert fingerprint from the remote SDP a=fingerprint.

        The reference verifies the DTLS peer certificate against the SDP
        fingerprint (src/crypto/dtls_srtp.cpp fingerprint check); without
        this, an on-path attacker could complete the handshake and obtain
        the SRTP keys.  Accepts "sha-256 AA:BB:..." or the bare hex form.
        """
        fp = fp.strip()
        if " " in fp:
            fp = fp.split(None, 1)[1]
        self._expected_fingerprint = fp.upper()

    def remote_media_addr(self) -> Optional[Tuple[str, int]]:
        sel = self.check_list.selected
        if sel is not None:
            return (sel.remote.host, sel.remote.port)
        # pre-nomination fallback: highest-priority remote candidate
        if self.check_list.remote_candidates:
            return max(self.check_list.remote_candidates,
                       key=lambda c: c.priority).host, \
                max(self.check_list.remote_candidates,
                    key=lambda c: c.priority).port
        return None

    def _send_to(self, addr, data: bytes):
        self.sock.sock.sendto(data, addr)

    def _send_media_path(self, data: bytes):
        dest = self.remote_media_addr()
        if dest is not None:
            self.sock.sock.sendto(data, dest)

    def attach_turn(self, turn_client):
        """Register the TURN allocation that produced this call's relay
        candidate: iterate() then drives its refresh lifecycle (RFC 5766
        allocation + permission keepalive, ice.c's TURN timers)."""
        self._turn = turn_client

    # -- the per-iterate pump (cf. media_stream_iterate) --------------------
    def iterate(self):
        self.check_list.process()
        if getattr(self, "_turn", None) is not None:
            self._turn.maintain()
        self.poll()
        if self.dtls is not None and self.ice.state == IS_COMPLETED:
            if not self.dtls.is_established:
                self.dtls.handshake_step()
            for rec in self.dtls.pop_packets():
                self._send_media_path(rec)
            if self.dtls.is_established and self.srtp_keys is None \
                    and not self.security_failed:
                if self._expected_fingerprint is not None:
                    peer = self.dtls.peer_fingerprint()
                    if peer is None or peer.upper() != self._expected_fingerprint:
                        # MitM: handshake completed with a cert that does not
                        # match the SDP fingerprint — fail the call, never
                        # derive keys (reference dtls_srtp.cpp behaviour).
                        self.security_failed = True
                        return
                ck, cs, sk, ss = self.dtls.export_srtp_keys()
                self.srtp_suite = self.dtls.srtp_suite()
                # client (connect side) sends with client key
                if self.ice.controlling:
                    self.srtp_keys = (ck, cs, sk, ss)
                else:
                    self.srtp_keys = (sk, ss, ck, cs)
        if self.zrtp is not None and self.ice.state == IS_COMPLETED \
                and self.zrtp.state == "idle":
            self.zrtp.start()

    def _on_zrtp_secrets(self, tk, ts, rk, rs):
        self.srtp_keys = (tk, ts, rk, rs)

    def poll(self):
        while True:
            try:
                data, addr = self.sock.sock.recvfrom(65536)
            except (BlockingIOError, OSError):
                break
            if stun.is_stun(data):
                self.demuxed["stun"] += 1
                self.check_list.handle_stun(data, addr)
            elif self.dtls is not None and is_dtls(data):
                self.demuxed["dtls"] += 1
                self.dtls.put_packet(data)
            elif self.zrtp is not None and is_zrtp(data):
                self.demuxed["zrtp"] += 1
                self.zrtp.process(data)
            else:
                self.demuxed["media"] += 1
                self._media_rx.append(data)

    @property
    def ready(self) -> bool:
        if self.security_failed:
            return False
        secure_ok = (self.key_agreement == "none" or self.srtp_keys is not None)
        return self.ice.state == IS_COMPLETED and secure_ok

    def media_transport(self) -> Transport:
        """Plain or SRTP-wrapped media transport, per key_agreement."""
        view = _MediaView(self)
        if self.key_agreement == "none":
            return view
        if self.security_failed:
            raise AssertionError("peer fingerprint mismatch")
        if self.srtp_keys is None:
            raise AssertionError("iterate() until ready first")
        tk, ts, rk, rs = self.srtp_keys
        suite = self.srtp_suite
        return SrtpTransport(view,
                             tx=SrtpContext(tk, ts, suite),
                             rx=SrtpContext(rk, rs, suite),
                             tx_rtcp=SrtcpContext(tk, ts, suite),
                             rx_rtcp=SrtcpContext(rk, rs, suite))

    def close(self):
        self.sock.close()
        if self.dtls is not None:
            self.dtls.close()
