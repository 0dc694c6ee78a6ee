"""The benchmark of the PyTorch + CUDA port (``mediastreamer2_tpu_torch``):
one cell run once by ``python3 -m bench_gpu.run``. See ``harness.py``."""
