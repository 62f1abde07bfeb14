"""deepseek-7b — [arXiv:2401.02954; hf] 30L d_model=4096 32H (kv=32, i.e. MHA)
d_ff=11008 vocab=102400, llama-style."""
from repro_torch.configs.base import ArchSpec, ModelConfig, Parallelism

MODEL = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
)

PARALLELISM = Parallelism(
    fsdp=True,
    sequence_parallel=True,
    remat="block",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SPEC = ArchSpec(MODEL, PARALLELISM, source="[arXiv:2401.02954; hf]")
