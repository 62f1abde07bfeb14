"""Model FLOPs of a training step of Hymba's hybrid-head LM, and the
selective scan's compulsory HBM bytes, from the configuration's widths
alone.

FLOPs: 6 x the parameters a position multiplies x the positions (the
meta tokens run through every layer; the embedding lookup left out, the
head over the published vocabulary and the real positions alone), plus
attention's two products over the visible pairs and the scan's three
products a (channel, state) a position, forward and backward (3 x the
forward), recompute not counted.

Bytes: what any implementation of the scan has to move, each input read
and each output written once, activations at bfloat16 and parameters at
float32: forward u, dt, B, C and A in, y out; the backward the same
inputs and y's gradient in, the five gradients out. A traced step runs
the forward twice (its recompute under remat) and the backward once."""
from __future__ import annotations

#: H100 SXM5 HBM3 bandwidth, bytes/s (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
ACT, PARAM = 2, 4      # bytes of a bfloat16 activation, a float32 parameter


def d_inner(m: dict) -> int:
    return m["ssm_expand"] * m["d_model"]


def kv_producers(m: dict) -> int:
    reused = sum(len(g) - 1 for g in m["kv_groups"])
    return m["num_layers"] - reused


def layer_params(m: dict) -> int:
    """One layer's parameters that a position multiplies, K/V aside."""
    D, di, F = m["d_model"], d_inner(m), m["d_ff"]
    R, N = m["ssm_dt_rank"], m["ssm_state"]
    return (D * m["num_heads"] * m["head_dim"]     # q
            + 2 * D * di                           # x, z
            + di * (R + 2 * N) + R * di            # x_proj, dt_proj
            + di * D                               # out_proj
            + 3 * D * F)                           # SwiGLU MLP


def params(m: dict) -> int:
    """The matrix parameters a position of the blocks multiplies, the K/V
    projections over their producing layers counted once each."""
    kv = m["d_model"] * m["num_kv_heads"] * (m["head_dim"] + m["v_head_dim"])
    return m["num_layers"] * layer_params(m) + kv_producers(m) * kv


def visible_pairs(S: int, window: int, meta: int) -> int:
    """(query, key) pairs a causal query sees over S positions: within
    ``window`` before it (all when 0), and the first ``meta`` keys."""
    if not window:
        return S * (S + 1) // 2
    n = 0
    for q in range(S):
        lo = max(0, q - window + 1)
        n += q + 1 - lo + min(meta, lo)
    return n


def attention_forward_flops(m: dict, S: int) -> float:
    """Every layer's QK^T and PV over one row of S positions."""
    H, hd, vd = m["num_heads"], m["head_dim"], m["v_head_dim"]
    total = 0
    for l in range(m["num_layers"]):
        w = 0 if l in m["global_layers"] else m["sliding_window"]
        total += 2 * H * (hd + vd) * visible_pairs(S, w, m["meta_tokens"])
    return total


def scan_forward_flops(m: dict, S: int) -> float:
    """One layer's scan over one row: exp(dt A) s, (dt u) B and s C, a
    multiply and an add each, a (channel, state) a position."""
    return 6 * d_inner(m) * m["ssm_state"] * S


def train_step_flops(m: dict, batch: int, seq: int) -> float:
    S = m["meta_tokens"] + seq
    head = m["d_model"] * m["vocab_size"]
    return (6.0 * params(m) * batch * S + 6.0 * head * batch * seq +
            3.0 * batch * (attention_forward_flops(m, S) +
                           m["num_layers"] * scan_forward_flops(m, S)))


def scan_bytes(m: dict, batch: int, seq: int) -> dict:
    """Compulsory HBM bytes of one layer's scan by phase."""
    S = m["meta_tokens"] + seq
    di, N = d_inner(m), m["ssm_state"]
    seq_d, seq_n = batch * S * di * ACT, batch * S * N * ACT
    a = di * N * PARAM
    fwd = 2 * seq_d + 2 * seq_n + a + seq_d            # u, dt, B, C, A; y
    bwd = (3 * seq_d + 2 * seq_n + a) + (2 * seq_d + 2 * seq_n + a)
    return {"forward": fwd, "recompute": fwd, "backward": bwd}


def scan_step_bytes(m: dict, batch: int, seq: int) -> int:
    """A traced step's scan bytes: every layer, every phase."""
    return m["num_layers"] * sum(scan_bytes(m, batch, seq).values())
