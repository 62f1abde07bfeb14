"""stablelm-12b — [hf:stabilityai/stablelm-2-1_6b family; hf] 40L d_model=5120
32H (GQA kv=8) d_ff=13824 vocab=100352."""
from repro_torch.configs.base import ArchSpec, ModelConfig, Parallelism

MODEL = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
)

PARALLELISM = Parallelism(
    fsdp=True,
    sequence_parallel=True,
    remat="block",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SPEC = ArchSpec(MODEL, PARALLELISM, source="[hf:stabilityai/stablelm-2-12b; hf]")
