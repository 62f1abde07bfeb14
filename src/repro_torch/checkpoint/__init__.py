from repro_torch.checkpoint.manager import CheckpointManager, restore, save
