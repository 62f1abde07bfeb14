"""Model FLOPs of a training step of an attention-free Mamba-2 model,
from the configuration's widths alone: 6 x the parameters (the
embedding lookup left out, the head over the published vocabulary) x
the tokens, plus the SSD's products, forward and backward (3 x the
forward), recompute not counted."""
from __future__ import annotations


def ssm_params(m: dict) -> int:
    """One layer's Mamba-2 mixer parameters."""
    D, di = m["d_model"], m["ssm_expand"] * m["d_model"]
    H = di // m["ssm_headdim"]
    gn, K = m["ssm_groups"] * m["ssm_state"], m["ssm_conv"]
    return (2 * D * di + 2 * D * gn + D * H      # in-projections z, x, B, C, dt
            + K * (di + 2 * gn)                  # depthwise conv taps
            + 3 * H + di                         # A_log, dt_bias, D; gate norm
            + di * D)                            # out-projection


def ssd_forward_flops(m: dict, seq: int) -> float:
    """One layer's SSD products for one sequence, forward: within each
    chunk C B^T over the causal pairs (once a group) and its product with
    dt x (each head); each chunk's state (B^T dt x) and its read-out
    (C h); the state's hand-over between chunks."""
    di = m["ssm_expand"] * m["d_model"]
    P, N, G = m["ssm_headdim"], m["ssm_state"], m["ssm_groups"]
    H = di // P
    c = min(m["ssm_chunk"], seq)
    nc = -(-seq // c)
    pairs = c * (c + 1) // 2
    return nc * (G * 2 * N * pairs +
                 H * (2 * P * pairs + 2 * c * N * P + 2 * c * N * P +
                      2 * N * P))


def params(m: dict) -> int:
    """The parameters a token's forward multiplies: every layer, the
    final norm and the head over the published vocabulary."""
    D = m["d_model"]
    return m["num_layers"] * (D + ssm_params(m)) + D + D * m["vocab_size"]


def train_step_flops(m: dict, batch: int, seq: int) -> float:
    return (6.0 * params(m) * batch * seq +
            3.0 * m["num_layers"] * batch * ssd_forward_flops(m, seq))
