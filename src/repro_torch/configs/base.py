"""Configuration dataclasses, the port's copy of ``repro.configs.base``.

Two worlds share this module:
  * ModelConfig / ShapeConfig / Parallelism / ArchSpec — the LM
    framework (the 11 architectures of ``repro_torch.configs`` × input
    shapes); ``Parallelism``'s mesh and XLA knobs are kept as data, and
    on one device only ``remat`` and the attention block sizes are read.
  * KlessydraConfig — the paper's coprocessor taxonomy (M, F, D, N) used
    by the cycle model in ``repro_torch.core``, the KVI lowering and the
    serving engine.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


# ---------------------------------------------------------------------------
# LM framework configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (one instance per assigned arch)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0               # query heads (0 for attention-free)
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25

    # --- attention flavor ---
    sliding_window: int = 0          # 0 => full causal attention
    rope_theta: float = 10_000.0

    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1

    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0          # >0 => enc-dec model

    # --- modality frontend stub ---
    frontend: str = "none"           # none | patch | frames
    frontend_len: int = 0            # patches / frames prepended (vlm) or enc input (audio)

    # --- numerics ---
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- hybrid head block (hymba-1.5b as published); the defaults keep
    # every other arch, and the reference's hybrid stand-in, as they are ---
    meta_tokens: int = 0             # learned rows prepended to every sequence
    global_layers: Tuple[int, ...] = ()  # full attention; the window elsewhere
    kv_groups: Tuple[Tuple[int, ...], ...] = ()  # layers reusing the first's K/V
    v_head_dim: int = 0              # value head width (0 => head_dim)
    ssm_kind: str = "mamba2"         # mamba2 (SSD heads) | mamba1 (selective
    #                                  scan: dt rank, dt/B/C norms, conv bias)
    ssm_dt_rank: int = 0             # mamba1: dt's low-rank width
    hybrid_merge: str = "per_path"   # per_path: each path projected to d_model
    #                                  and normed; out_proj: both d_inner-wide
    #                                  paths normed, averaged, one projection

    def __post_init__(self):
        # lists (a JSON override) as tuples, so the config stays hashable
        object.__setattr__(self, "global_layers",
                           tuple(int(l) for l in self.global_layers))
        object.__setattr__(self, "kv_groups", tuple(
            tuple(int(l) for l in g) for g in self.kv_groups))
        if self.ssm_kind not in ("mamba2", "mamba1"):
            raise ValueError(f"ssm_kind {self.ssm_kind!r}")
        if self.hybrid_merge not in ("per_path", "out_proj"):
            raise ValueError(f"hybrid_merge {self.hybrid_merge!r}")
        for g in self.kv_groups:
            if len({l in self.global_layers for l in g}) != 1:
                raise ValueError(f"K/V group {g} mixes global and windowed "
                                 f"layers")

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def value_dim(self) -> int:
        return self.v_head_dim or self.head_dim

    @property
    def per_layer_attention(self) -> bool:
        """Whether attention differs by layer (global layers, shared K/V):
        K/V weights and caches are then stacked over producing layers."""
        return bool(self.global_layers or self.kv_groups)

    def layer_window(self, layer: int) -> int:
        """The attention window of ``layer`` (0: full causal)."""
        return 0 if layer in self.global_layers else self.sliding_window

    def kv_source(self, layer: int) -> int:
        """The layer whose K/V ``layer`` attends with (itself, or the
        first layer of its sharing group)."""
        for g in self.kv_groups:
            if layer in g:
                return g[0]
        return layer

    @property
    def kv_producers(self) -> Tuple[int, ...]:
        """The layers that make K/V, in order."""
        return tuple(l for l in range(self.num_layers)
                     if self.kv_source(l) == l)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: (name, kind, seq_len, global_batch)."""

    name: str
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int

    def replace(self, **kw) -> "ShapeConfig":
        return dataclasses.replace(self, **kw)


# The four assigned LM shapes (identical sets for all 10 archs).
SHAPES: dict = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class Parallelism:
    """How an arch maps onto the mesh. Follows the paper's TLP/DLP lens:
    ``data``(+``pod``) axes carry thread-level parallelism, ``model`` carries
    data-level parallelism (tensor sharding + kernel lanes)."""

    fsdp: bool = False               # shard param d_model dim over "data"
    sequence_parallel: bool = False  # shard residual seq dim over "model"
    expert_parallel: bool = False    # shard experts over "pod" when divisible
    remat: str = "block"             # none | block | full
    scan_layers: bool = True
    moment_dtype: str = "float32"    # Adam moment storage (int8 => compressed)
    grad_accum: int = 1
    attn_q_block: int = 2048         # XLA flash attention block sizes
    attn_kv_block: int = 2048
    # --- beyond-paper perf knobs (§Perf hillclimbs; defaults = baseline) ---
    swa_block_skip: bool = False     # sliding-window: only visit KV blocks
    #                                  inside the window (true FLOP cut)
    moe_decode_group: bool = False   # decode MoE: one routing group per
    #                                  local batch (kills capacity padding)
    pure_dp: bool = False            # small models: use the model axis as
    #                                  extra data parallelism + ZeRO sharding
    #                                  (the paper's TLP/DLP rebalance)
    mixed_precision: bool = False    # bf16 compute params + f32 master:
    #                                  backward collectives go bf16 (halved)
    attn_repeat_kv: bool = False     # GQA: repeat K/V to H heads instead of
    #                                  grouped-q reshape — keeps the score
    #                                  einsum head-sharded (no per-block
    #                                  all-to-all resharding)
    moe_capacity_sharding: bool = False  # shard MoE dispatch slots (C) over
    #                                  "model" instead of expert width (F):
    #                                  w_down contraction becomes local (no
    #                                  [B,E,C,D] all-reduce per layer)
    # Which shape cells run for this arch ("long_500k" only for sub-quadratic).
    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")

    def replace(self, **kw) -> "Parallelism":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ArchSpec:
    """Everything the launcher needs for one --arch id."""

    model: ModelConfig
    parallelism: Parallelism
    source: str = ""                 # provenance note [paper/hf; tier]


# ---------------------------------------------------------------------------
# Klessydra (paper) configs
# ---------------------------------------------------------------------------

# Internal MFU functional units (contended individually by the
# heterogeneous-MIMD scheme; see repro_torch.core.isa.Unit — kept as string
# literals here so configs stay import-light).
MFU_UNITS = ("adder", "multiplier", "shifter", "cmp", "move")


def _is_pow2(x: int) -> bool:
    return x >= 1 and (x & (x - 1)) == 0


@dataclass(frozen=True)
class KlessydraConfig:
    """The paper's coprocessor design space: SPMI count M, MFU count F,
    lanes D, SPMs N, plus SPM capacity and hart count.

    Degenerate combinations are rejected at construction time (M < 1,
    F > M, non-power-of-two D, zero-byte SPMs, ...) with a ``ValueError``
    naming the offending field — the design-space sweeps rely on this
    being the single validation point.
    """

    name: str
    M: int = 1                       # number of SPM interfaces
    F: int = 1                       # number of MFUs
    D: int = 1                       # lanes per MFU (= SPM banks)
    N: int = 4                       # number of SPMs per SPMI
    harts: int = 3                   # IMT hardware threads
    spm_kbytes: int = 4              # capacity of each SPM (KiB)
    elem_bytes: int = 4              # 32-bit fixed point (paper default)
    mem_port_bytes: int = 4          # 32-bit main-memory port
    vector_setup_cycles: int = 5     # "initial latency between 4 and 8 cycles"
    mem_latency_cycles: int = 2      # main memory access latency
    # Narrowest SIMD lane the MFU datapath can split a 32-bit bank into:
    # 8 => full sub-word SIMD (4x8-bit or 2x16-bit per bank, the paper's
    # sub-word extension and the simulator's historical behavior);
    # 32 => no sub-word hardware (narrow elements stream one per lane).
    subword_bits: int = 8
    # Per-internal-unit FU replication inside each MFU, as ("unit", count)
    # overrides, e.g. (("multiplier", 2),). Units not listed have one
    # instance. Only the heterogeneous-MIMD scheme (shared MFU contended
    # per internal unit) can exploit counts > 1.
    fu_counts: Tuple[Tuple[str, int], ...] = ()

    def __post_init__(self):
        def bad(fieldname: str, why: str):
            raise ValueError(
                f"KlessydraConfig({self.name!r}): field {fieldname!r} "
                f"{why}")
        if self.M < 1:
            bad("M", f"must be >= 1 SPM interface, got {self.M}")
        if self.F < 1:
            bad("F", f"must be >= 1 MFU, got {self.F}")
        if self.F > self.M:
            bad("F", f"cannot exceed M (more MFUs than SPM interfaces "
                     f"to feed them), got F={self.F} > M={self.M}")
        if not _is_pow2(self.D):
            bad("D", f"must be a power of two >= 1 (SPM bank count), "
                     f"got {self.D}")
        if self.N < 1:
            bad("N", f"must be >= 1 SPM per interface, got {self.N}")
        if self.harts < 1:
            bad("harts", f"must be >= 1, got {self.harts}")
        if self.spm_kbytes < 1:
            bad("spm_kbytes", f"must be >= 1 KiB (a zero-byte SPM can "
                              f"hold no vector), got {self.spm_kbytes}")
        if self.elem_bytes not in (1, 2, 4):
            bad("elem_bytes", f"must be 1, 2 or 4, got {self.elem_bytes}")
        if self.mem_port_bytes < 1:
            bad("mem_port_bytes", f"must be >= 1, got {self.mem_port_bytes}")
        if self.vector_setup_cycles < 0:
            bad("vector_setup_cycles",
                f"must be >= 0, got {self.vector_setup_cycles}")
        if self.mem_latency_cycles < 0:
            bad("mem_latency_cycles",
                f"must be >= 0, got {self.mem_latency_cycles}")
        if self.subword_bits not in (8, 16, 32):
            bad("subword_bits", f"must be 8, 16 or 32, got "
                                f"{self.subword_bits}")
        seen = set()
        for entry in self.fu_counts:
            if (not isinstance(entry, tuple)) or len(entry) != 2:
                bad("fu_counts", f"entries must be (unit, count) pairs, "
                                 f"got {entry!r}")
            unit, count = entry
            if unit not in MFU_UNITS:
                bad("fu_counts", f"unknown MFU unit {unit!r} "
                                 f"(valid: {MFU_UNITS})")
            if unit in seen:
                bad("fu_counts", f"duplicate unit {unit!r}")
            seen.add(unit)
            if not isinstance(count, int) or count < 1:
                bad("fu_counts", f"count for {unit!r} must be an int >= 1, "
                                 f"got {count!r}")

    def fu_count(self, unit: str) -> int:
        """How many instances of one internal functional unit each MFU
        carries (1 unless overridden in ``fu_counts``)."""
        for u, c in self.fu_counts:
            if u == unit:
                return c
        return 1

    @property
    def spm_capacity_bytes(self) -> int:
        """Unified SPM address space per interface: N SPMs of spm_kbytes."""
        return self.N * self.spm_kbytes * 1024

    @property
    def scheme(self) -> str:
        if self.M == 1 and self.F == 1:
            return "SISD" if self.D == 1 else f"SIMD"
        if self.M > 1 and self.F == self.M:
            return "SymMIMD" if self.D == 1 else "SymMIMD+SIMD"
        if self.M > 1 and self.F == 1:
            return "HetMIMD" if self.D == 1 else "HetMIMD+SIMD"
        return "custom"

    def replace(self, **kw) -> "KlessydraConfig":
        return dataclasses.replace(self, **kw)


def klessydra_taxonomy() -> dict:
    """The exact configuration sweep of the paper's Table 2."""
    out = {}
    for D in (1, 2, 4, 8):
        out[f"sisd" if D == 1 else f"simd_d{D}"] = KlessydraConfig(
            name="SISD" if D == 1 else f"SIMD D={D}", M=1, F=1, D=D)
        out[f"sym_mimd_d{D}" if D > 1 else "sym_mimd"] = KlessydraConfig(
            name=f"Sym MIMD D={D}", M=3, F=3, D=D)
        out[f"het_mimd_d{D}" if D > 1 else "het_mimd"] = KlessydraConfig(
            name=f"Het MIMD D={D}", M=3, F=1, D=D)
    return out
