"""seamless-m4t-medium — [arXiv:2308.11596; hf] 12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206, encoder-decoder, audio frontend stubbed
(input_specs provides precomputed frame embeddings)."""
from repro_torch.configs.base import ArchSpec, ModelConfig, Parallelism

MODEL = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,               # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    frontend="frames",
)

PARALLELISM = Parallelism(
    fsdp=False,
    sequence_parallel=False,
    remat="block",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SPEC = ArchSpec(MODEL, PARALLELISM, source="[arXiv:2308.11596; hf]")
