"""uPnP IGD port mapping client (SSDP discovery + SOAP control) (a copy of
``mediastreamer2_tpu/net/upnp.py``: standard library only).

Reference: src/upnp/ (2,456 LoC on libupnp): discover the Internet Gateway
Device, add/remove WAN port mappings, query the external IP — so calls
behind home NATs can receive media.

Implementation: no library — SSDP M-SEARCH over UDP multicast, then plain
HTTP SOAP against the gateway's WANIPConnection control URL (the three
actions the reference uses: AddPortMapping, DeletePortMapping,
GetExternalIPAddress).  Tests run against an in-process fake IGD.

The one change from the JAX module: ``UpnpIgdClient.discover`` takes the
SSDP address to search (``addr``, the multicast group by default) as
``ssdp_msearch`` does, where the JAX module reads only the module-level
``SSDP_ADDR``.
"""
from __future__ import annotations

import re
import socket
import urllib.request
from typing import Dict, List, Optional, Tuple

SSDP_ADDR = ("239.255.255.250", 1900)
ST_IGD = "urn:schemas-upnp-org:device:InternetGatewayDevice:1"
SERVICE_WANIP = "urn:schemas-upnp-org:service:WANIPConnection:1"


def ssdp_msearch(timeout_s: float = 2.0, addr=None) -> List[str]:
    """Discover IGD root-description URLs (LOCATION headers)."""
    addr = addr or SSDP_ADDR
    msg = ("M-SEARCH * HTTP/1.1\r\n"
           f"HOST: {addr[0]}:{addr[1]}\r\n"
           'MAN: "ssdp:discover"\r\n'
           "MX: 2\r\n"
           f"ST: {ST_IGD}\r\n\r\n").encode()
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(timeout_s)
    locations = []
    try:
        s.sendto(msg, addr)
        while True:
            try:
                data, _ = s.recvfrom(4096)
            except socket.timeout:
                break
            m = re.search(rb"(?im)^LOCATION:\s*(\S+)", data)
            if m:
                locations.append(m.group(1).decode())
    finally:
        s.close()
    return locations


def _soap_call(control_url: str, action: str, args: Dict[str, str]) -> str:
    arg_xml = "".join(f"<{k}>{v}</{k}>" for k, v in args.items())
    body = (f'<?xml version="1.0"?>'
            f'<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/"'
            f' s:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">'
            f"<s:Body><u:{action} xmlns:u=\"{SERVICE_WANIP}\">{arg_xml}"
            f"</u:{action}></s:Body></s:Envelope>")
    req = urllib.request.Request(
        control_url, data=body.encode(),
        headers={"Content-Type": 'text/xml; charset="utf-8"',
                 "SOAPAction": f'"{SERVICE_WANIP}#{action}"'})
    with urllib.request.urlopen(req, timeout=5) as resp:
        return resp.read().decode()


class UpnpIgdClient:
    """cf. upnp_igd_context + the mapping API (upnp_igd.c:978-990)."""

    def __init__(self, control_url: str):
        self.control_url = control_url
        self.mappings: List[Tuple[int, str]] = []

    @classmethod
    def discover(cls, timeout_s: float = 2.0, addr=None) -> Optional["UpnpIgdClient"]:
        locs = ssdp_msearch(timeout_s, addr=addr)
        if not locs:
            return None
        # fetch root description, find WANIPConnection controlURL
        with urllib.request.urlopen(locs[0], timeout=5) as resp:
            desc = resp.read().decode()
        m = re.search(r"<serviceType>%s</serviceType>.*?<controlURL>(.*?)"
                      r"</controlURL>" % re.escape(SERVICE_WANIP),
                      desc, re.S)
        if not m:
            return None
        base = locs[0].rsplit("/", 1)[0]
        ctrl = m.group(1)
        url = ctrl if ctrl.startswith("http") else base + ctrl
        return cls(url)

    def get_external_ip(self) -> str:
        xml = _soap_call(self.control_url, "GetExternalIPAddress", {})
        m = re.search(r"<NewExternalIPAddress>(.*?)</NewExternalIPAddress>",
                      xml)
        if not m:
            raise RuntimeError("no external IP in response")
        return m.group(1)

    def add_port_mapping(self, external_port: int, internal_port: int,
                         internal_ip: str, protocol: str = "UDP",
                         description: str = "mediastreamer2_tpu",
                         lease_s: int = 3600) -> bool:
        _soap_call(self.control_url, "AddPortMapping", {
            "NewRemoteHost": "",
            "NewExternalPort": str(external_port),
            "NewProtocol": protocol,
            "NewInternalPort": str(internal_port),
            "NewInternalClient": internal_ip,
            "NewEnabled": "1",
            "NewPortMappingDescription": description,
            "NewLeaseDuration": str(lease_s),
        })
        self.mappings.append((external_port, protocol))
        return True

    def delete_port_mapping(self, external_port: int,
                            protocol: str = "UDP") -> bool:
        _soap_call(self.control_url, "DeletePortMapping", {
            "NewRemoteHost": "",
            "NewExternalPort": str(external_port),
            "NewProtocol": protocol,
        })
        self.mappings = [(p, pr) for p, pr in self.mappings
                         if (p, pr) != (external_port, protocol)]
        return True
