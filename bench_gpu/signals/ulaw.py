"""White noise at ``rms``, ``rate`` Hz, mu-law coded, as uint8 codes in
host memory (pinned where the run's device is a card): each tick uploads
its codes."""
import torch

from bench_gpu.reference import ops


def make(sig, made, legs, R, randn, device):
    x = randn(R, legs, ops.tick_samples(int(sig["rate"]))).mul_(float(sig["rms"]))
    codes = ops.ulaw_encode(ops.float_to_pcm16(x)).to(torch.uint8)
    host = torch.empty(codes.shape, dtype=torch.uint8, pin_memory=device.type == "cuda")
    host.copy_(codes)
    return host
