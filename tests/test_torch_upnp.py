"""The port's UPnP IGD client (``net/upnp.py``) against an in-process fake
gateway on localhost (the JAX ``test_upnp.py``'s: an SSDP unicast reply and
HTTP SOAP WANIPConnection), and the port's SOAP requests byte-equal to the
JAX client's for the same calls."""
import http.server
import io
import socket
import threading

import pytest

import test_upnp
from mediastreamer2_tpu.net import upnp as j_upnp
from mediastreamer2_tpu_torch.net import upnp


class RecordingIgd(test_upnp.FakeIgdHandler):
    """The JAX test's fake gateway, keeping every POST's SOAPAction and
    body."""
    posts = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        RecordingIgd.posts.append((self.headers.get("SOAPAction"),
                                   self.headers.get("Content-Type"), body))
        self.rfile = io.BytesIO(body)          # the JAX handler reads it again
        super().do_POST()


@pytest.fixture
def fake_igd():
    srv = http.server.HTTPServer(("127.0.0.1", 0), RecordingIgd)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    test_upnp.FakeIgdHandler.mappings = {}
    RecordingIgd.posts = []
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=5)
    assert not t.is_alive()


@pytest.fixture
def ssdp(fake_igd):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    test_upnp._ssdp_responder(fake_igd, s)
    yield ("127.0.0.1", s.getsockname()[1])
    s.close()


def test_discovery_and_mapping(fake_igd, ssdp):
    assert upnp.ssdp_msearch(timeout_s=1.0, addr=ssdp) == [fake_igd + "/desc.xml"]
    client = upnp.UpnpIgdClient(fake_igd + "/ctl")
    assert client.get_external_ip() == "198.51.100.77"
    assert client.add_port_mapping(7078, 7078, "192.168.1.50")
    assert ("7078", "UDP") in test_upnp.FakeIgdHandler.mappings
    assert client.mappings == [(7078, "UDP")]
    assert client.delete_port_mapping(7078)
    assert ("7078", "UDP") not in test_upnp.FakeIgdHandler.mappings
    assert client.mappings == []


def test_discover_via_description(fake_igd, ssdp, monkeypatch):
    monkeypatch.setattr(upnp, "SSDP_ADDR", ssdp)       # as the JAX test does
    client = upnp.UpnpIgdClient.discover(timeout_s=1.0)
    assert client is not None and client.control_url == fake_igd + "/ctl"


def test_discover_takes_the_ssdp_address(fake_igd, ssdp):
    """The port's one change: ``discover(addr=...)`` searches there,
    without touching the module's ``SSDP_ADDR``."""
    client = upnp.UpnpIgdClient.discover(timeout_s=1.0, addr=ssdp)
    assert client.control_url == fake_igd + "/ctl"
    assert upnp.SSDP_ADDR == ("239.255.255.250", 1900)


def test_soap_requests_equal_to_jax(fake_igd):
    """The same calls through both clients: equal SOAPAction, content type
    and body, request by request."""
    seen = {}
    for name, mod in (("jax", j_upnp), ("torch", upnp)):
        RecordingIgd.posts = []
        c = mod.UpnpIgdClient(fake_igd + "/ctl")
        assert c.get_external_ip() == "198.51.100.77"
        c.add_port_mapping(7078, 7078, "192.168.1.50")
        c.add_port_mapping(5060, 5062, "10.0.0.2", protocol="TCP", description="sip",
                           lease_s=60)
        c.delete_port_mapping(5060, protocol="TCP")
        c.delete_port_mapping(7078)
        seen[name] = list(RecordingIgd.posts)
    assert len(seen["torch"]) == 5
    assert seen["torch"] == seen["jax"]
