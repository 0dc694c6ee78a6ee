"""The port's runnable examples (``python -m mediastreamer2_tpu_torch.examples.<name>``):
each has ``run(args) -> dict`` for callers that read its results and
``main(argv) -> int`` that prints the JAX example's lines."""
