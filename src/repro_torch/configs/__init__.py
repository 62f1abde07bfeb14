"""Config registry: ``--arch <id>`` → ArchSpec (the port's copy of
``repro.configs``; the arch modules are copies of the reference's, value
for value, with the same ``source`` strings).

Arch ids use the exact names from the assignment (dots and dashes); module
files use underscores.
"""
from __future__ import annotations

import dataclasses
from importlib import import_module

from repro_torch.configs.base import (
    ArchSpec,
    KlessydraConfig,
    ModelConfig,
    Parallelism,
    ShapeConfig,
    SHAPES,
    klessydra_taxonomy,
)

# example-only configs (not part of the assigned 10 / the dry-run sweep)
_EXTRA_MODULES = {
    "llama100m": "repro_torch.configs.llama_100m",
}

_ARCH_MODULES = {
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
}


def list_archs() -> list:
    return sorted(_ARCH_MODULES)


def get_spec(arch: str) -> ArchSpec:
    mod = _ARCH_MODULES.get(arch) or _EXTRA_MODULES.get(arch)
    if mod is None:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{list_archs() + sorted(_EXTRA_MODULES)}")
    return import_module(mod).SPEC


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def arch_cells(arch: str) -> list:
    """All (arch, shape) cells assigned to this arch (long_500k only where
    the decode path is sub-quadratic — see DESIGN.md §Arch-applicability)."""
    spec = get_spec(arch)
    return [(arch, s) for s in spec.parallelism.shapes]


def all_cells() -> list:
    return [c for a in list_archs() for c in arch_cells(a)]


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests — same family/topology, tiny dims.
# ---------------------------------------------------------------------------

def reduced_model(cfg: ModelConfig) -> ModelConfig:
    """Shrink a ModelConfig to CPU-smoke scale, preserving the family and
    every structural feature (MoE, GQA ratio, SWA, SSM, enc-dec, frontend)."""
    kw = dict(
        num_layers=2,
        d_model=64,
        vocab_size=512,
    )
    if cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=max(1, 4 * cfg.num_kv_heads // cfg.num_heads),
                  head_dim=16)
    if cfg.d_ff:
        kw.update(d_ff=128)
    if cfg.num_experts:
        # ample capacity: smoke tests compare decode (dropless) vs forward
        # (capacity-dropped) — at tiny scale drops would differ, not a bug
        kw.update(num_experts=4, num_experts_per_tok=min(2, cfg.num_experts_per_tok),
                  capacity_factor=4.0)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2)
    if cfg.frontend_len:
        kw.update(frontend_len=8)
    if cfg.ssm_kind == "mamba1":
        kw.update(ssm_dt_rank=4, ssm_chunk=4)
    if cfg.v_head_dim:
        kw.update(v_head_dim=cfg.v_head_dim * 16 // cfg.head_dim)
    if cfg.meta_tokens or cfg.per_layer_attention:
        # hymba's block at CPU size: a few meta tokens, a window under the
        # tests' sequences, the first and last layer global, a sharing pair
        kw.update(num_layers=4, meta_tokens=4 if cfg.meta_tokens else 0,
                  sliding_window=16 if cfg.sliding_window else 0,
                  global_layers=(0, 3) if cfg.global_layers else (),
                  kv_groups=((1, 2),) if cfg.kv_groups else ())
    return cfg.replace(**kw)


def reduced_shape(shape: ShapeConfig, seq_len: int = 64, batch: int = 2) -> ShapeConfig:
    if shape.kind == "decode":
        return shape.replace(seq_len=seq_len, global_batch=batch)
    return shape.replace(seq_len=seq_len, global_batch=batch)


__all__ = [
    "ArchSpec", "KlessydraConfig", "ModelConfig", "Parallelism", "ShapeConfig",
    "SHAPES", "klessydra_taxonomy", "list_archs", "get_spec", "get_shape",
    "arch_cells", "all_cells", "reduced_model", "reduced_shape",
]
