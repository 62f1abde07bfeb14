"""Device milliseconds a traced training step spends in the program's
``optimizer`` span (``models.steps.make_train_step``, around
``optim.adamw_update``: the global norm, the clip and the per-leaf
updates), from the program's span collector
(``harness/program_spans.py``)."""
from cardbench.harness.program_spans import per_step_ms

UNIT, LAYER, MOVES = "ms", "train step", "train_tokens_per_s"


def read(ctx):
    return per_step_ms(ctx, "optimizer")
