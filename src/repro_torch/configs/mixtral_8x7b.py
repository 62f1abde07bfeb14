"""mixtral-8x7b — [arXiv:2401.04088; hf] 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000, MoE 8 experts top-2, sliding-window attention."""
from repro_torch.configs.base import ArchSpec, ModelConfig, Parallelism

MODEL = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    num_experts_per_tok=2,
    sliding_window=4096,
    rope_theta=1e6,
)

# SWA => KV cache bounded by the window => long_500k decode is sub-quadratic.
PARALLELISM = Parallelism(
    fsdp=True,
    sequence_parallel=True,
    remat="block",
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SPEC = ArchSpec(MODEL, PARALLELISM, source="[arXiv:2401.04088; hf]")
