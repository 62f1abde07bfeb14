"""LM serving on the port: the continuous-batching engine over a
fixed-slot KV cache (``repro_torch.serving.engine``)."""
from repro_torch.serving.engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
