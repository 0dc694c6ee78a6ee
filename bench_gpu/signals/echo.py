"""An echo-coupled mic: near-end noise at ``noise_rms`` plus ``gain``
times the signal ``of`` delayed by ``delay`` samples, on a circular time
axis (frozen from ``models/flagship.echo_coupled_inputs`` at 19e7661)."""
import torch

from bench_gpu import signals
from bench_gpu.reference import ops


def make(sig, made, legs, R, randn, device):
    far = signals.continuous(made[sig["of"]])
    mic = randn(legs, R * ops.tick_samples(int(sig["rate"]))).mul_(float(sig["noise_rms"]))
    mic.add_(torch.roll(far, int(sig["delay"]), dims=1), alpha=float(sig["gain"]))
    return signals.ring(mic, R)
