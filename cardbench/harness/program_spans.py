"""What the program's own spans say about the traced steps: the port's
span collector (``repro_torch.kvi.obs.spans``) switches itself on while
a ``torch.profiler`` session is active, so after a ``--trace 1`` run it
holds the traced steps alone (the window and the checked steps run with
no profiler, the reference opens no span). A program without the
collector, or one that recorded no step, gives nothing to read."""
from __future__ import annotations


def per_step_ms(ctx: dict, key: str):
    """Device ms a traced training step spends in the spans ``key`` (a
    span name, or ``name/phase``), summed over the collector's steps and
    divided by their number; ``None`` when there is nothing to read."""
    if ctx.get("kind") != "train":
        return None
    try:
        from repro_torch.kvi.obs import spans
    except ImportError:         # a program without spans
        return None
    got = spans.collected()
    if not got or key not in got["spans"]:
        return None
    return got["spans"][key]["device_ms"] / got["steps"]
