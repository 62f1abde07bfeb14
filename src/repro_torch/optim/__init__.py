"""The port of the reference's ``repro/optim``: AdamW with float32,
bfloat16 or int8 moments, and the int8 error-feedback gradient codec."""
from repro_torch.optim.optimizer import (OptimizerConfig, adamw_init,
                                         adamw_update, dequantize_i8,
                                         global_norm, lr_schedule,
                                         quantize_i8)

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update", "dequantize_i8",
           "global_norm", "lr_schedule", "quantize_i8"]
