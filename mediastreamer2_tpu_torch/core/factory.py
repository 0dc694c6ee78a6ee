"""Filter registry and lookup (port of ``mediastreamer2_tpu/core/factory.py``).

Only the registry, lookup and per-filter enable/disable are ported; plugin
loading and codec lookup come with the filters that need them.
"""
from __future__ import annotations

from typing import Dict

from mediastreamer2_tpu_torch.core.filter import FILTER_REGISTRY, FilterDef


class Factory:
    def __init__(self, load_builtins: bool = True):
        if load_builtins:
            import mediastreamer2_tpu_torch.ops  # noqa: F401  (registers the filters)
        self._filters: Dict[str, FilterDef] = dict(FILTER_REGISTRY)
        self._disabled: set = set()

    def lookup(self, name: str) -> FilterDef:
        if name in self._disabled:
            raise KeyError(f"filter '{name}' is disabled")
        try:
            return self._filters[name]
        except KeyError:
            raise KeyError(f"no filter '{name}' registered "
                           f"(have: {sorted(self._filters)})") from None

    def has(self, name: str) -> bool:
        return name in self._filters and name not in self._disabled

    def enable_filter(self, name: str, enabled: bool = True):
        if name not in self._filters:
            raise KeyError(name)
        if enabled:
            self._disabled.discard(name)
        else:
            self._disabled.add(name)
