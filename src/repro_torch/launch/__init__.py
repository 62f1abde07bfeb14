"""Entry points of the port's LM framework: ``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.dryrun`` (with ``mesh``, ``compile`` and
``hlo_analysis``, the step accountant)."""
