"""Convert state and params trees between the JAX package and the port.

Both packages use the same key names, so a tree converts leaf by leaf. The
JAX side travels as numpy: bf16 leaves as float32, with the names of the
bf16 leaves of each dict under ``"__bf16__"``, exactly as the JAX echo
canceller's ``get_state_blob`` hands them over. The stochastic-rounding
counter ``srk`` is a uint32 scalar in JAX and an int64 scalar in the port.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

BF16_KEY = "__bf16__"
_UINT32_KEYS = frozenset({"srk"})


def from_jax(tree, device):
    """JAX tree (nested dicts of numpy arrays, ``__bf16__`` lists) -> port
    tree of tensors on ``device``."""
    bf16 = set(np.asarray(tree.get(BF16_KEY, [])).tolist())
    out = {}
    for k, v in tree.items():
        if k == BF16_KEY:
            continue
        if isinstance(v, Mapping):
            out[k] = from_jax(v, device)
            continue
        a = np.array(v)
        if k in bf16:
            out[k] = torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                               dtype=torch.bfloat16)
        elif a.dtype == np.uint32:
            out[k] = torch.from_numpy(a.astype(np.int64)).to(device)
        else:
            out[k] = torch.from_numpy(a).to(device)
    return out


def to_numpy(tree):
    """Port tree -> JAX-side numpy tree: bf16 leaves as float32 named under
    ``__bf16__``, ``srk`` as uint32."""
    out = {}
    bf16 = []
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = to_numpy(v)
        elif v.dtype == torch.bfloat16:
            bf16.append(k)
            out[k] = v.detach().float().cpu().numpy()
        elif k in _UINT32_KEYS:
            out[k] = (v.detach().cpu().numpy() & 0xFFFFFFFF).astype(np.uint32)
        else:
            out[k] = v.detach().cpu().numpy()
    if bf16:
        out[BF16_KEY] = np.array(bf16)
    return out
