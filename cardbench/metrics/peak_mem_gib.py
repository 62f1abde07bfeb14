"""The device memory the window allocated at its peak
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start), in GiB."""
UNIT, LAYER, MOVES = "GiB", None, None


def read(ctx):
    b = ctx.get("window_peak_bytes")
    return None if b is None else b / 2 ** 30
