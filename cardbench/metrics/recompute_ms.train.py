"""Device milliseconds a traced training step spends recomputing blocks:
the program's ``block`` spans (``models.model_zoo._decoder_block``) of
phase ``recompute``, opened while the step's ``backward`` span is open
(part of ``backward_ms.train``), from the program's span collector
(``harness/program_spans.py``)."""
from cardbench.harness.program_spans import per_step_ms

UNIT, LAYER, MOVES = "ms", "train step", "train_tokens_per_s"


def read(ctx):
    return per_step_ms(ctx, "block/recompute")
