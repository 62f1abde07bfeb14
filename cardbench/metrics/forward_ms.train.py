"""Device milliseconds a traced training step spends in the program's
``forward`` spans (``models.steps.value_and_grad``, around the loss
function: embedding, blocks, head and loss; one a micro-batch), from
the program's span collector (``harness/program_spans.py``)."""
from cardbench.harness.program_spans import per_step_ms

UNIT, LAYER, MOVES = "ms", "train step", "train_tokens_per_s"


def read(ctx):
    return per_step_ms(ctx, "forward")
