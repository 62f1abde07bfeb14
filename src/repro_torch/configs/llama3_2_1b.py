"""llama3.2-1b — [hf:meta-llama/Llama-3.2-1B; unverified] 16L d_model=2048
32H (GQA kv=8) d_ff=8192 vocab=128256."""
from repro_torch.configs.base import ArchSpec, ModelConfig, Parallelism

MODEL = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=5e5,
    tie_embeddings=True,
)

PARALLELISM = Parallelism(
    fsdp=False,
    sequence_parallel=False,
    remat="block",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SPEC = ArchSpec(MODEL, PARALLELISM, source="[hf:meta-llama/Llama-3.2-1B; unverified]")
