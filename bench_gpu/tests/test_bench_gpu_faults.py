"""A run with its timed path broken underneath comes out not correct; the
sound run and the control (the reference in the program's place, products
in TF32) are told apart. Each cell's faults: the step returns its state
unchanged; half of the batch is left out; an answer is altered where it is
produced. (No cell runs across chips, so none has an exchange to leave
out.) CPU, 16 legs, the cells' own configurations and loops."""
import time

import pytest
import torch

from bench_gpu import harness

LEGS = 16
CELLS = ["flagship48k.unpaced", "pcmu_bridge.unpaced", "flagship48k.paced"]


def _state_copy(tree):
    return {k: _state_copy(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _restore_rows(state, old, rows):
    for k, v in state.items():
        if isinstance(v, dict):
            _restore_rows(v, old[k], rows)
        elif v.dim() and v.shape[0] == LEGS:
            v[rows] = old[k][rows]


class Broken:
    """The system, with one fault planted in its tick."""

    def __init__(self, system, fault):
        self.system, self.fault = system, fault
        self.readback = system.readback

    @property
    def state(self):
        return self.system.state

    def tick(self, ins):
        old = _state_copy(self.system.state)
        outs = self.system.tick(ins)
        if self.fault == "state_unchanged":
            self.system.state = old
        elif self.fault == "half_the_batch":
            half = slice(LEGS // 2, LEGS)
            _restore_rows(self.system.state, old, half)
            outs = {k: v.clone() for k, v in outs.items()}
            for v in outs.values():
                v[half] = 0
        elif self.fault == "answer_altered":
            outs = {k: v.clone() for k, v in outs.items()}
            for v in outs.values():
                v[:, 0] = v[:, 0] ^ 1 if v.dtype == torch.uint8 else v[:, 0] + 0.01
        return outs


class FaultyCell(harness.Cell):
    fault = None

    def build(self):
        super().build()
        if self.fault:
            self.system = Broken(self.system, self.fault)


def _run(cell, seed, fault=None, variant="port"):
    c = FaultyCell(cell, seed, "cpu", variant=variant, legs=LEGS)
    c.fault = fault
    return c.run(0.2, False, time.perf_counter(), harness.BENCH_DIR / "out")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell, 2 ** 31 + 17)
    assert r["correct"], r["compared"]
    assert list(r)[-1] == "compared"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
def test_fault_is_not_correct(cell, fault):
    r = _run(cell, 2 ** 31 + 18, fault)
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = _run(cell, 2 ** 31 + 19, variant="control")
    assert not r["correct"], r["compared"]
