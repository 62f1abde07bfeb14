"""Entry points of the port's LM framework: ``python -m
repro_torch.launch.serve`` (the training entry point waits for the optimizer's
port)."""
