"""Seconds from the process's start to the window's start: imports, the
card's context, weights, traffic, the first steps (which warm up every
shape)."""
UNIT, LAYER, MOVES = "s", None, None


def read(ctx):
    return ctx.get("setup_s")
