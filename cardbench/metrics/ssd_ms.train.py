"""Device milliseconds a traced training step spends in the SSD scan: the
program's ``ssd`` spans (``models.model_zoo._ssm_forward``, around
``models.ssm.ssd_chunked``) of every phase, the forward, its recompute
and its backward (bracketed by identity autograd markers), from the
program's span collector (``harness/program_spans.py``)."""
from cardbench.harness.program_spans import per_step_ms

UNIT, LAYER, MOVES = "ms", "ssm mixer", "train_tokens_per_s"


def read(ctx):
    return per_step_ms(ctx, "ssd")
