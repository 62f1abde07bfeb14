"""hymba-1.5b — [arXiv:2411.13676; hf] 32L d_model=1600 25H (GQA kv=5)
d_ff=5504 vocab=32001, ssm_state=16 — parallel attention + mamba heads in
every layer (hybrid head module)."""
from repro_torch.configs.base import ArchSpec, ModelConfig, Parallelism

MODEL = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=2048,         # hymba uses SWA in all but a few layers
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    ssm_conv=4,
    ssm_groups=1,
)

# SWA + SSM => sub-quadratic decode => long_500k runs.
# 25 heads are not divisible by the 16-way model axis: attention shards over
# batch only (DP); FFN/vocab still use tensor parallelism (see sharding rules).
PARALLELISM = Parallelism(
    fsdp=False,
    sequence_parallel=False,
    remat="block",
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SPEC = ArchSpec(MODEL, PARALLELISM, source="[arXiv:2411.13676; hf]")
