"""Training tokens a second: batch x seq tokens of every step that ended
in the window, over the time from the window's start to the end of its
last step (each step synchronised)."""
UNIT, LAYER, MOVES = "tokens/s", None, None


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return ctx["steps"] * ctx["tokens_per_step"] / ctx["window_s"]
