"""Shared cell machinery for the dry run, the port of the reference's
``repro/launch/compile.py``: build abstract params / opt-state / cache /
batch for an (arch, shape, mesh) cell and the right step, with zero real
allocation (everything is a meta tensor, a meta DTensor on a mesh, until
a driver decides to materialize).

The port compiles nothing: ``lower_cell`` builds the step and its
abstract arguments, and the dry run runs that step once on the meta
device under ``hlo_analysis.analyze_step``. The analytic estimates
(``estimate_device_memory``, ``estimate_hbm_traffic``) are the
reference's arithmetic over templates and rules, and run on an
``AbstractMesh`` as well.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.compat import DeviceMesh
from repro_torch.configs import get_shape, get_spec
from repro_torch.configs.base import ModelConfig, Parallelism, ShapeConfig
from repro_torch.models import model_zoo as zoo
from repro_torch.models import params as params_lib
from repro_torch.models import steps as steps_lib
from repro_torch.models.sharding import Rules, make_rules
from repro_torch.optim.optimizer import (OptimizerConfig, adamw_init,
                                         scale_placements)


@dataclass
class Cell:
    arch: str
    cfg: ModelConfig
    par: Parallelism
    shape: ShapeConfig
    rules: Rules
    mesh: Any


def build_cell(arch: str, shape_name: str, mesh, *, overrides=None) -> Cell:
    spec = get_spec(arch)
    cfg, par = spec.model, spec.parallelism
    if overrides:
        for k, v in overrides.items():
            if hasattr(par, k):
                par = par.replace(**{k: v})
            else:
                cfg = cfg.replace(**{k: v})
    shape = get_shape(shape_name)
    if shape.kind != "train" and cfg.param_dtype == "float32":
        # serving cells load bf16 weights (standard inference checkpoints)
        cfg = cfg.replace(param_dtype="bfloat16")
    rules = make_rules(mesh, cfg, par)
    return Cell(arch, cfg, par, shape, rules, mesh)


def _attach(rules: Rules, template):
    """P-template -> meta tensors, meta DTensors placed by the rules on a
    ``DeviceMesh``."""
    return params_lib.abstract(template, rules)


def abstract_inputs(cell: Cell):
    """Abstract (params, opt_state?, cache?, batch) for the cell's step."""
    cfg, par, shape, rules = cell.cfg, cell.par, cell.shape, cell.rules
    p_t = zoo.param_template(cfg)
    params = _attach(rules, p_t)
    batch = _attach(rules, steps_lib.batch_template(cfg, shape))
    if shape.kind == "train":
        opt_cfg = OptimizerConfig(moment_dtype=par.moment_dtype)
        opt_state = adamw_init(params_lib.abstract(p_t), opt_cfg)
        # re-attach shardings: moments shard like their parameters
        opt_state = _shard_opt_state(opt_state, params, rules)
        return {"params": params, "opt_state": opt_state, "batch": batch}
    if shape.kind == "prefill":
        return {"params": params, "batch": batch}
    cache = _attach(rules, steps_lib.cache_template(cfg, shape))
    return {"params": params, "cache": cache, "batch": batch}


def _shard_opt_state(opt_state, params, rules: Rules):
    """Give Adam moments the same sharding as their parameter (int8 moment
    dicts {q,s}: q like the param, s like the param minus last dim)."""
    if not isinstance(rules.mesh, DeviceMesh):
        return opt_state

    def like_moment(mom, par_leaf):
        if isinstance(mom, dict) and set(mom) == {"q", "s"} and \
                not isinstance(par_leaf, dict):
            pl = par_leaf.placements
            return {"q": params_lib.meta_dtensor(
                        mom["q"].shape, mom["q"].dtype, rules.mesh, pl),
                    # scale: same placements with the last dim whole
                    "s": params_lib.meta_dtensor(
                        mom["s"].shape, mom["s"].dtype, rules.mesh,
                        scale_placements(pl, mom["s"].dim()))}
        if isinstance(mom, dict):
            return {k: like_moment(mom[k], par_leaf[k]) for k in mom}
        return params_lib.meta_dtensor(mom.shape, mom.dtype, rules.mesh,
                                       par_leaf.placements)

    new = dict(opt_state)
    for key in ("m", "v"):
        new[key] = like_moment(opt_state[key], params)
    return new


def make_step_fn(cell: Cell):
    cfg, par, shape, rules = cell.cfg, cell.par, cell.shape, cell.rules
    step = steps_lib.make_step(cfg, rules, par, shape)
    kind = shape.kind
    if kind == "train":
        fn = lambda params, opt_state, batch: step(params, opt_state, batch)
        donate = (0, 1)
    elif kind == "prefill":
        fn = lambda params, batch: step(params, batch)
        donate = ()
    else:
        fn = lambda params, cache, batch: step(params, cache, batch)
        donate = (1,)
    return fn, donate


def lower_cell(cell: Cell):
    """The cell's step and its abstract args: ``(fn, args)``. The port
    lowers nothing (the reference returns ``jit(...).lower(...)``); a
    driver runs ``fn(*args)`` on the meta device."""
    inputs = abstract_inputs(cell)
    fn, _ = make_step_fn(cell)
    if cell.shape.kind == "train":
        args = (inputs["params"], inputs["opt_state"], inputs["batch"])
    elif cell.shape.kind == "prefill":
        args = (inputs["params"], inputs["batch"])
    else:
        args = (inputs["params"], inputs["cache"], inputs["batch"])
    return fn, args


# ---------------------------------------------------------------------------
# analytic per-device memory estimate (the card's HBM fit)
#
# An eager meta run allocates nothing, so the ``fits_hbm`` verdict uses
# this analytic model (the reference's, term for term).
# ---------------------------------------------------------------------------

def _itemsize(dtype: str) -> int:
    return params_lib.torch_dtype(dtype).itemsize


def _sharded_leaf_bytes(p, rules: Rules) -> float:
    spec = rules.spec(p.axes, p.shape)
    denom = 1
    for axes in spec:
        if axes is not None:
            denom *= rules.axis_size(axes)
    n = 1
    for d in p.shape:
        n *= d
    return float(n) * _itemsize(p.dtype) / max(denom, 1)


def _template_bytes(template, rules: Rules) -> float:
    return sum(_sharded_leaf_bytes(p, rules)
               for _, p in params_lib.tree_leaves(template))


def _template_elems(template, rules: Rules) -> float:
    return sum(_sharded_leaf_bytes(p, rules) / _itemsize(p.dtype)
               for _, p in params_lib.tree_leaves(template))


def estimate_device_memory(cell: Cell) -> dict:
    """Per-device HBM bytes by component."""
    cfg, par, shape, rules = cell.cfg, cell.par, cell.shape, cell.rules
    p_t = zoo.param_template(cfg)
    params_b = _template_bytes(p_t, rules)
    batch_b = _template_bytes(steps_lib.batch_template(cfg, shape), rules)
    out = {"params": params_b, "batch": batch_b}

    dsize = rules.axis_size(rules.mapping.get("batch")) or 1
    msize = rules.axis_size("model") if rules.mesh is not None else 1
    B_loc = max(shape.global_batch // max(dsize, 1), 1)
    S = shape.seq_len if shape.kind != "decode" else 1
    sp = rules.axis_size(rules.mapping.get("seq_sp")) \
        if par.sequence_parallel else 1
    S_loc = max(S // max(sp, 1), 1)
    act_bytes = _itemsize(cfg.dtype)

    if shape.kind == "train":
        out["grads"] = params_b                      # params stored in f32
        if par.moment_dtype == "int8":
            out["moments"] = 2 * (params_b / 4 * 1.03)     # q + per-row scales
        elif par.moment_dtype == "bfloat16":
            out["moments"] = 2 * params_b / 2
        else:
            out["moments"] = 2 * params_b
        layers = cfg.num_layers + cfg.encoder_layers
        out["saved_activations"] = (layers * B_loc * S_loc * cfg.d_model *
                                    act_bytes)
        Vp_loc = zoo.padded_vocab(cfg.vocab_size) // max(msize, 1)
        out["logits_transient"] = B_loc * S_loc * Vp_loc * (4 + 2)
    else:
        if shape.kind in ("prefill", "decode"):
            out["cache"] = _template_bytes(
                steps_lib.cache_template(cfg, shape), rules)
    # transient working set of one block (attention tiles + ffn hidden)
    width = max(cfg.d_ff // max(msize, 1),
                (cfg.num_heads or 1) * max(cfg.head_dim, 1) // max(msize, 1),
                cfg.d_inner if cfg.ssm_state else 0,
                par.attn_kv_block * 4)
    out["block_transient"] = 4 * B_loc * min(S_loc, 32768) * width * act_bytes
    out["total"] = float(sum(out.values()))
    return out


# ---------------------------------------------------------------------------
# analytic HBM traffic model (per device, per step) — the roofline memory
# term. The accountant's byte count is recorded as an upper bound (an
# eager step fuses nothing); this model is the fused-granularity
# estimate, every component reported so the numbers can be audited.
# ---------------------------------------------------------------------------

def estimate_hbm_traffic(cell: Cell, *, attention_impl: str = "xla") -> dict:
    """``attention_impl``: ``"xla"`` (the default) is the zoo's plain
    ``flash_attention_xla`` layer, which writes each block's scores to
    HBM; ``"kernel"`` is the port's flash-attention kernel, which keeps
    them on chip (the term vanishes)."""
    cfg, par, shape, rules = cell.cfg, cell.par, cell.shape, cell.rules
    f32, act = 4, _itemsize(cfg.dtype)
    msize = rules.axis_size("model") if rules.mesh is not None else 1
    dsize = rules.axis_size(rules.mapping.get("batch")) or 1
    B_loc = max(shape.global_batch // max(dsize, 1), 1)
    S = shape.seq_len
    train = shape.kind == "train"
    decode = shape.kind == "decode"

    p_t = zoo.param_template(cfg)
    P_loc = _template_elems(p_t, rules)                # param elems / device
    if cfg.num_experts:
        frac_active = zoo.active_param_count(cfg) / zoo.param_count(cfg)
    else:
        frac_active = 1.0

    out = {}
    if train:
        # bf16 casts read 3x (fwd, bwd, remat) + f32 p r/w + grad w/r + m,v r/w
        out["weights"] = P_loc * (3 * act + 3 * f32 + 4 * f32)
    elif decode:
        out["weights"] = P_loc * frac_active * act     # single sparse read
    else:
        out["weights"] = P_loc * act                   # prefill: one full read

    layers = cfg.num_layers + cfg.encoder_layers
    if decode:
        T_loc = B_loc
    else:
        T_loc = B_loc * S
    D = cfg.d_model
    F_loc = cfg.d_ff / max(msize, 1) if cfg.d_ff else 0
    Hhd_loc = max(cfg.num_heads * max(cfg.head_dim, 1) / max(msize, 1), 0)
    di = cfg.d_inner if cfg.ssm_state else 0
    # r/w passes over layer activations: ~10 major ops fwd (x2 for r+w),
    # x2.2 for bwd+remat in training
    passes = 22 * (2.2 if train else 1.0)
    per_layer = T_loc * (D * passes + F_loc * 8 + Hhd_loc * 8 + di * 10) * act
    if cfg.num_experts:
        topk_cf = cfg.num_experts_per_tok * cfg.capacity_factor
        per_layer += T_loc * topk_cf * (D * 8 + F_loc * 8) * act
    out["activations"] = layers * per_layer

    # attention score traffic (the plain layer materializes block scores
    # in HBM; the flash kernel keeps them on chip -> term vanishes)
    if cfg.num_heads and not decode and attention_impl == "xla":
        H_loc = max(cfg.num_heads / max(msize, 1), 1)
        # baseline masks but still computes the full S x S score blocks;
        # swa_block_skip only visits the (window + q_block) span
        if cfg.sliding_window and par.swa_block_skip:
            S_eff = min(S, cfg.sliding_window + par.attn_q_block)
        else:
            S_eff = S
        s2 = B_loc * H_loc * S * S_eff * f32
        out["attn_scores"] = s2 * 4 * (3 if train else 1)
    if decode and cfg.num_heads:
        slots = steps_lib.cache_slots(cfg, shape)
        KV_loc = cfg.num_kv_heads * max(cfg.head_dim, 1) / \
            (max(msize, 1) if cfg.num_kv_heads % max(msize, 1) == 0 else 1)
        out["kv_cache"] = layers * B_loc * slots * KV_loc * 2 * act
    if decode and cfg.ssm_state:
        st = B_loc * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state
        out["ssm_state"] = layers * st * 2 * f32
    Vp_loc = zoo.padded_vocab(cfg.vocab_size) / max(msize, 1)
    toks_logits = T_loc if train else B_loc
    out["logits"] = toks_logits * Vp_loc * ((act + 3 * f32) if train else act)
    out["total"] = float(sum(out.values()))
    return out
