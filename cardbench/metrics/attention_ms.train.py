"""Device milliseconds a traced training step spends in attention: the
program's ``attention`` spans (``models.model_zoo._attention``: what
follows the Q/K/V projections, RoPE, ``models.layers.
flash_attention_xla`` and the heads' output) of every phase, the
forward, its recompute and its backward (bracketed by identity autograd
markers), from the program's span collector
(``harness/program_spans.py``)."""
from cardbench.harness.program_spans import per_step_ms

UNIT, LAYER, MOVES = "ms", "attention", "train_tokens_per_s"


def read(ctx):
    return per_step_ms(ctx, "attention")
