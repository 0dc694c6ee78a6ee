"""Video presets & quality ladder (a copy of
``mediastreamer2_tpu/models/video_presets.py``: plain Python).

Reference: src/base/msvideopresets.c + MSVideoConfiguration ladders
consumed by msvideoqualitycontroller.c: choose resolution/fps/bitrate
triples for a target bandwidth/device class.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class VideoConfiguration:
    width: int
    height: int
    fps: float
    bitrate_bps: int

    @property
    def name(self):
        return f"{self.width}x{self.height}@{self.fps:g}"


# the generic ladder (mirrors the reference's default MSVideoConfiguration
# tables: bitrate thresholds choose the size/fps step)
DEFAULT_LADDER: List[VideoConfiguration] = [
    VideoConfiguration(1920, 1080, 30.0, 2_500_000),
    VideoConfiguration(1280, 720, 30.0, 1_500_000),
    VideoConfiguration(960, 540, 30.0, 900_000),
    VideoConfiguration(640, 480, 25.0, 500_000),
    VideoConfiguration(640, 360, 25.0, 380_000),
    VideoConfiguration(352, 288, 20.0, 250_000),
    VideoConfiguration(320, 240, 15.0, 170_000),
    VideoConfiguration(176, 144, 12.0, 100_000),
    VideoConfiguration(160, 120, 10.0, 64_000),
]


class VideoPresets:
    """Named preset collections (cf. ms_video_presets_manager)."""

    def __init__(self):
        self.presets: Dict[str, List[VideoConfiguration]] = {
            "default": DEFAULT_LADDER,
            "high-fps": [dataclasses.replace(c, fps=min(60.0, c.fps * 2))
                         for c in DEFAULT_LADDER],
            "custom": [],
        }

    def register(self, name: str, ladder: List[VideoConfiguration]):
        self.presets[name] = sorted(ladder, key=lambda c: -c.bitrate_bps)

    def get(self, name: str) -> List[VideoConfiguration]:
        return self.presets[name]


class VideoQualityController:
    """Reacts to TMMBR/REMB bandwidth targets + fps/size constraints by
    walking the configuration ladder (parity:
    src/voip/msvideoqualitycontroller.c:381)."""

    def __init__(self, apply_configuration, ladder=None,
                 max_width: Optional[int] = None):
        self.apply = apply_configuration        # fn(VideoConfiguration)
        self.ladder = ladder or DEFAULT_LADDER
        self.max_width = max_width
        self.current: Optional[VideoConfiguration] = None

    def on_bandwidth_estimate(self, bps: int) -> VideoConfiguration:
        """Called on TMMBR/REMB (cf. media_stream TMMBR handling)."""
        candidates = [c for c in self.ladder
                      if self.max_width is None or c.width <= self.max_width]
        chosen = candidates[-1]
        for c in candidates:
            if bps >= c.bitrate_bps:
                chosen = c
                break
        if chosen != self.current:
            self.current = chosen
            self.apply(chosen)
        return chosen
