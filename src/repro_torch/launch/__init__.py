"""Entry points of the port's LM framework: ``python -m
repro_torch.launch.serve`` and ``python -m repro_torch.launch.train``."""
