"""Sound-device quirk database -- per-device audio hacks (a copy of
``mediastreamer2_tpu/core/quirks.py``: plain Python).

Reference: src/audiofilters/devices.c:58 (SoundDeviceDescription table:
per-device flags like builtin AEC, delay hints, EQ gain ladders) applied by
the session layer at src/voip/audiostream.c:1642-1680 (skip the software
EC when the device cancels echo itself; build mic/speaker equalizers from
the table's gain strings; feed the delay hint to the EC).

The table ships a few representative entries (server-grade USB/virtual
devices); deployments extend it via ``register_quirks``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# flags (cf. DEVICE_HAS_BUILTIN_AEC / _CRAPPY / DEVICE_USE_* in devices.c)
HAS_BUILTIN_AEC = 1
BUILTIN_AEC_CRAPPY = 2
HAS_BUILTIN_AGC = 4


@dataclasses.dataclass
class DeviceQuirks:
    manufacturer: str
    model: str
    flags: int = 0
    delay_ms: int = 0                 # echo-path delay hint for the EC
    recommended_rate: int = 0         # 0 = no constraint
    mic_eq_gains: Optional[List[Tuple[float, float, float]]] = None
    spk_eq_gains: Optional[List[Tuple[float, float, float]]] = None
    # gain ladder entries: (center_hz, gain_linear, width_hz)


_DB: Dict[Tuple[str, str], DeviceQuirks] = {}


def register_quirks(q: DeviceQuirks):
    _DB[(q.manufacturer.lower(), q.model.lower())] = q


def lookup_quirks(manufacturer: str, model: str) -> Optional[DeviceQuirks]:
    return _DB.get((manufacturer.lower(), model.lower()))


def apply_quirks(features, quirks: Optional[DeviceQuirks]):
    """Adjust AudioStreamFeatures per the device table (the
    audiostream.c:1642-1680 logic): a device with a good builtin AEC turns
    the software EC off; EQ gain ladders flow into mic/speaker equalizers;
    the delay hint is attached for the EC."""
    if quirks is None:
        return features
    if quirks.flags & HAS_BUILTIN_AEC and \
            not quirks.flags & BUILTIN_AEC_CRAPPY:
        features.echo_canceller = False
    if quirks.flags & HAS_BUILTIN_AGC:
        features.agc = False
    if quirks.mic_eq_gains:
        features.mic_eq_gains = quirks.mic_eq_gains
    if quirks.spk_eq_gains:
        features.spk_eq_gains = quirks.spk_eq_gains
    features.ec_delay_ms = quirks.delay_ms
    return features


# -- representative built-in entries ----------------------------------------
register_quirks(DeviceQuirks(
    "jabra", "speak 510", flags=HAS_BUILTIN_AEC, delay_ms=0))
register_quirks(DeviceQuirks(
    "poly", "sync 20", flags=HAS_BUILTIN_AEC | HAS_BUILTIN_AGC))
register_quirks(DeviceQuirks(
    "generic", "usb headset", delay_ms=120,
    mic_eq_gains=[(300.0, 1.2, 200.0), (4000.0, 0.8, 1000.0)]))
