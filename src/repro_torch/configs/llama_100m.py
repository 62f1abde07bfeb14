"""llama-100m — in-house ~100M-parameter llama-style config used by the
end-to-end training example (examples/train_lm.py). Not one of the 10
assigned architectures; included so the example trains a REAL (non-reduced)
model on CPU in reasonable wall time."""
from repro_torch.configs.base import ArchSpec, ModelConfig, Parallelism

MODEL = ModelConfig(
    name="llama100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    d_ff=3072,
    vocab_size=32000,
    tie_embeddings=True,
)

PARALLELISM = Parallelism(
    fsdp=False,
    sequence_parallel=False,
    remat="none",
    shapes=("train_4k",),
)

SPEC = ArchSpec(MODEL, PARALLELISM, source="[in-house example config]")
