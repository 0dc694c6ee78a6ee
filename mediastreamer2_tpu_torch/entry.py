"""The port's entry point (counterpart of ``entry()`` in the JAX package's
``__graft_entry__.py:26-34``; its ``dryrun_multichip`` is
``parallel/dryrun.py``).

``entry(device=None)`` returns ``(fwd, (state, params, ext_in))`` for one
tick of the flagship conference leg at batch 64 (``models/flagship.py``:
mic and speaker reference at 48 kHz -> AEC -> AGC -> 48k->16k -> mix-minus in
groups of 4): ``fwd(state, params, ext_in) -> (new_state, ext_out)``.
``ext_in`` is ``example_inputs(64)`` as tensors on the device. ``device=None``
runs on the CUDA card and raises without one; ``"cpu"`` runs the kernels'
plain versions. ``fwd`` updates the AEC's taps in ``state`` in place, as
every step of the port does.

    python -m mediastreamer2_tpu_torch.entry [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import torch

from mediastreamer2_tpu_torch.core.factory import Factory
from mediastreamer2_tpu_torch.core.ticker import resolve_device
from mediastreamer2_tpu_torch.models.flagship import build_flagship, example_inputs

BATCH = 64
CONF_SIZE = 4


def entry(device=None):
    """One tick of the flagship at batch 64: ``(fwd, (state, params, ext_in))``."""
    dev = resolve_device(device)
    cg, params = build_flagship(Factory(), BATCH, dev, conf_size=CONF_SIZE)
    state = cg.init_state(dev)
    ext_in = {k: torch.from_numpy(v).to(dev) for k, v in example_inputs(BATCH).items()}

    def fwd(state, params, ext_in):
        new_state, ext_out, _events = cg.step(state, params, ext_in)
        return new_state, ext_out

    return fwd, (state, params, ext_in)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    fwd, (state, params, ext_in) = entry(args.device)
    _, out = fwd(state, params, ext_in)
    y = out["out"]
    print(f"entry: flagship x {BATCH} on {y.device}: out {tuple(y.shape)}, "
          f"finite {bool(torch.isfinite(y).all())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
