"""pixtral-12b — [hf:mistralai/Pixtral-12B-2409; unverified] 40L d_model=5120
32H (GQA kv=8) d_ff=14336 vocab=131072; pixtral-ViT frontend stubbed
(input_specs provides precomputed patch embeddings), mistral-nemo backbone."""
from repro_torch.configs.base import ArchSpec, ModelConfig, Parallelism

MODEL = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e6,
    frontend="patch",
    frontend_len=1024,           # image patch tokens prepended to the text
)

PARALLELISM = Parallelism(
    fsdp=True,
    sequence_parallel=True,
    remat="block",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SPEC = ArchSpec(MODEL, PARALLELISM, source="[hf:mistralai/Pixtral-12B-2409; unverified]")
