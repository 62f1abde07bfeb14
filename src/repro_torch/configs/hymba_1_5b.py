"""hymba-1.5b — [arXiv:2411.13676; hf] 32L d_model=1600 25H (GQA kv=5)
d_ff=5504 vocab=32001, ssm_state=16 — parallel attention + mamba heads in
every layer (hybrid head module).

The published block (nvidia/Hymba-1.5B-Base): 128 learned meta tokens
prepended to every sequence; attention with a window of 1024 but in
layers 0, 15 and 31, the meta tokens visible to every query; 25 query
heads of 64 over 5 K/V heads, values 128 wide; K/V made by 17 layers and
reused by the rest of their group; Mamba-1 selective-scan heads over
d_inner 3200 (state 16, dt rank 100, RMS norms on dt, B and C, a conv
with bias); both paths normed, averaged and projected once; a SwiGLU MLP
of 5504. 1,522,797,824 parameters (the embedding unpadded).

The values are recalled from the model's ``config.json``
(``num_memory_tokens``, ``global_attn_idx``, ``kv_reuse_group``,
``v_head_dim``, ``mamba_*``, ``rms_norm_eps``, ``tie_word_embeddings``):
no copy of that file is in the repository to check them against. The
reference package's hymba-1.5b is a stand-in (Mamba-2 heads, window 2048
everywhere, no meta tokens, no K/V sharing); the port reaches it through
the fields' defaults."""
from repro_torch.configs.base import ArchSpec, ModelConfig, Parallelism

#: the published K/V reuse groups: each layer reads its group's first
KV_GROUPS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14),
             (16, 17, 18), (19, 20), (21, 22), (23, 24), (25, 26), (27, 28),
             (29, 30))

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
    sliding_window=1024,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=4,
    ssm_conv=4,
    ssm_groups=1,
    norm_eps=1e-6,
    tie_embeddings=True,
    meta_tokens=128,
    global_layers=(0, 15, 31),
    kv_groups=KV_GROUPS,
    v_head_dim=128,
    ssm_kind="mamba1",
    ssm_dt_rank=100,
    hybrid_merge="out_proj",
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
