"""grok-1-314b — [hf:xai-org/grok-1; unverified] 64L d_model=6144 48H
(GQA kv=8) d_ff=32768 vocab=131072, MoE 8 experts top-2."""
from repro_torch.configs.base import ArchSpec, ModelConfig, Parallelism

MODEL = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    num_experts_per_tok=2,
)

# 314B params: fp32 master + Adam moments don't fit 256 x 16GiB chips, so this
# arch uses int8 (error-compensated) moment storage + FSDP + SP + full remat.
# Full attention => long_500k skipped (quadratic), see DESIGN.md.
PARALLELISM = Parallelism(
    fsdp=True,
    sequence_parallel=True,
    remat="full",
    moment_dtype="int8",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SPEC = ArchSpec(MODEL, PARALLELISM, source="[hf:xai-org/grok-1; unverified]")
