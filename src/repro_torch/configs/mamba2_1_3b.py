"""mamba2-1.3b — [arXiv:2405.21060; unverified] 48L d_model=2048 attention-free
SSD (state-space duality), ssm_state=128, vocab=50280."""
from repro_torch.configs.base import ArchSpec, ModelConfig, Parallelism

MODEL = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    ssm_conv=4,
    ssm_groups=1,
)

# Attention-free => O(1)-state decode => long_500k runs.
# SP shards the residual stream's seq dim: 48 layers of saved carries at
# 4k x gb256 would otherwise cost 12 GiB/chip of remat checkpoints.
PARALLELISM = Parallelism(
    fsdp=False,
    sequence_parallel=True,
    remat="block",
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SPEC = ArchSpec(MODEL, PARALLELISM, source="[arXiv:2405.21060; unverified]")
