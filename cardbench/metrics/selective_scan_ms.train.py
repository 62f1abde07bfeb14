"""Device milliseconds a traced training step spends in Hymba's selective
scan: the program's ``selective_scan`` spans (``models.model_zoo.
_mamba1_forward``, around ``models.ssm.selective_scan`` alone, the D skip
and the gate outside) of every phase, the forward, its recompute and its
backward (bracketed by identity autograd markers), from the program's
span collector (``harness/program_spans.py``)."""
from cardbench.harness.program_spans import per_step_ms

UNIT, LAYER, MOVES = "ms", "ssm mixer", "train_tokens_per_s"


def read(ctx):
    return per_step_ms(ctx, "selective_scan")
