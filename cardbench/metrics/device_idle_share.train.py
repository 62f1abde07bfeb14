"""The share of the traced training steps' window in which no operation
ran on the device, in percent: 1 - (union of the device operations'
intervals) / (the window, synchronised at both ends)."""
UNIT, LAYER, MOVES = "%", "device", "train_tokens_per_s"


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "train" or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
