"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, dense rates without sparsity, at the full power limit)."""
from __future__ import annotations

# (substring of torch.cuda.get_device_name(), bf16 dense FLOP/s)
PEAKS = (
    ("H100 80GB HBM3", 989e12),     # H100 SXM5
)


def bf16_flops(kind: str):
    """The card's dense bf16 peak, or None for a card not in the table."""
    for key, flops in PEAKS:
        if key in kind:
            return flops
    return None
