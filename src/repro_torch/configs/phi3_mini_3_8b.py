"""phi3-mini-3.8b — [arXiv:2404.14219; unverified] 32L d_model=3072 32H
(kv=32, MHA) d_ff=8192 vocab=32064, RoPE + SwiGLU."""
from repro_torch.configs.base import ArchSpec, ModelConfig, Parallelism

MODEL = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
)

PARALLELISM = Parallelism(
    fsdp=False,
    sequence_parallel=True,
    remat="block",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SPEC = ArchSpec(MODEL, PARALLELISM, source="[arXiv:2404.14219; unverified]")
