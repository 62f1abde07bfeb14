"""Plain float32 reference of one training step of Hymba's published
hybrid-head LM, written from the layer equations (arXiv:2411.13676):
learned meta tokens before every row; in each layer attention heads
(GQA with RoPE, a sliding window outside the global layers that leaves
the meta tokens visible, K/V reused from the first layer of a sharing
group) and Mamba-1 selective-scan heads (x and z projections, a causal
conv with bias, x_proj to dt's rank, B and C with an RMS norm on each,
dt_proj with softplus, A per channel and state, D per channel) side by
side on the same normed input; both paths RMS-normed, averaged and
projected once; a SwiGLU MLP; the final norm, the meta rows dropped, the
tied head.

It imports torch and this folder's ``lm.py`` (the products, the norm,
the conv, the loss's masking, AdamW) alone. It takes the configuration
file's ``model``, ``loss`` and ``optimizer`` groups and a tree of float32
weights keyed by path (``embed``, ``meta``, ``kv/wk``, ``blocks/ssm/w_x``,
...), stacked along a leading layer axis (the K/V weights along the
producing layers). The scan is the recurrence one position at a time,
and its gradient the adjoint recurrence one position at a time from the
end (an ``autograd.Function``: no graph node a position).
Each block is recomputed in the backward and the batch taken in blocks
of rows, as ``lm.py`` does. ``product`` as in ``lm.py``: ``None``
float32 (TF32 off), ``"fp8"`` FP8 training's rounding.
"""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _sibling(name: str):
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"cardbench_reference_"
                                                  f"{name}_for_hymba", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


lm = _sibling("lm")


# ---------------------------------------------------------------------------
# the parameter tree
# ---------------------------------------------------------------------------

def d_inner(m: dict) -> int:
    return m["ssm_expand"] * m["d_model"]


def kv_source(m: dict, layer: int) -> int:
    """The layer whose K/V ``layer`` uses: the first of its group."""
    for g in m["kv_groups"]:
        if layer in g:
            return g[0]
    return layer


def producers(m: dict) -> list:
    return [l for l in range(m["num_layers"]) if kv_source(m, l) == l]


def param_specs(cfg: dict) -> list:
    """``(path, shape, law, scale)`` of every leaf, as ``lm.param_specs``
    gives them."""
    m = cfg["model"]
    L, D, Vp = m["num_layers"], m["d_model"], cfg["padded_vocab"]
    H, KV, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    vd, F_, di = m["v_head_dim"], m["d_ff"], d_inner(m)
    N, K, R = m["ssm_state"], m["ssm_conv"], m["ssm_dt_rank"]
    nP = len(producers(m))
    if m["family"] != "hybrid" or m["ssm_kind"] != "mamba1":
        raise ValueError("the hymba reference takes the published block")
    b, s = "blocks/", "blocks/ssm/"
    out = [("embed", (Vp, D), "randn", 0.02),
           ("meta", (m["meta_tokens"], D), "randn", 0.02),
           ("final_norm", (D,), "zeros", None),
           ("kv/wk", (nP, D, KV, hd), "randn", D ** -0.5),
           ("kv/wv", (nP, D, KV, vd), "randn", D ** -0.5),
           (b + "ln1", (L, D), "zeros", None),
           (b + "ln2", (L, D), "zeros", None),
           (b + "attn/wq", (L, D, H, hd), "randn", D ** -0.5),
           (b + "attn_norm", (L, di), "zeros", None),
           (b + "ssm_norm", (L, di), "zeros", None),
           (b + "w_out", (L, di, D), "randn", di ** -0.5),
           (b + "ffn/w_gate", (L, D, F_), "randn", D ** -0.5),
           (b + "ffn/w_up", (L, D, F_), "randn", D ** -0.5),
           (b + "ffn/w_down", (L, F_, D), "randn", F_ ** -0.5),
           (s + "w_x", (L, D, di), "randn", D ** -0.5),
           (s + "w_z", (L, D, di), "randn", D ** -0.5),
           (s + "conv_x", (L, K, di), "randn", K ** -0.5),
           (s + "conv_bias", (L, di), "zeros", None),
           (s + "x_proj", (L, di, R + 2 * N), "randn", di ** -0.5),
           (s + "dt_norm", (L, R), "zeros", None),
           (s + "B_norm", (L, N), "zeros", None),
           (s + "C_norm", (L, N), "zeros", None),
           (s + "w_dt", (L, R, di), "randn", R ** -0.5),
           (s + "dt_bias", (L, di), "dt_bias", None),
           (s + "A_log", (L, di, N), "a_log", None),
           (s + "D_skip", (L, di), "ones", None)]
    if not m.get("tie_embeddings"):
        out.append(("unembed", (D, Vp), "randn", D ** -0.5))
    return sorted(out)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def rope(x, theta):
    """x [B, S, heads, hd] rotated by position, the two halves of each
    head as the pair's parts."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = (torch.arange(S, dtype=torch.float64, device=x.device)[:, None]
           * inv).float()[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int, meta: int, mm):
    """Causal GQA softmax(q k^T / sqrt(hd)) v, a query seeing the keys
    within ``window`` before it (all when 0) and the first ``meta``
    always. q [B,S,H,hd], k [B,S,KV,hd], v [B,S,KV,vd] -> [B,S,H*vd]."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k, v = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    s = mm("bqhk,bchk->bhqc", q, k) / math.sqrt(hd)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    ok = kp <= qp
    if window:
        ok = ok & ((qp - kp < window) | (kp < meta))
    p = torch.softmax(s.masked_fill(~ok, lm.NEG), dim=-1)
    return mm("bhqc,bchv->bqhv", p, v).reshape(B, S, -1)


class _Scan(torch.autograd.Function):
    """s_t = exp(dt_t A) s_{t-1} + (dt_t u_t) B_t^T, y_t = s_t C_t, one
    position at a time from a zero state, every state kept; the backward
    the adjoint recurrence g_t = gy_t C_t + exp(dt_{t+1} A) g_{t+1}, one
    position at a time from the end, and each input's gradient from g
    and the states."""

    @staticmethod
    def forward(ctx, u, dt, A, Bm, Cm):
        dA = torch.exp(dt[..., None] * A)               # [B,S,d,N]
        states = (dt * u)[..., None] * Bm[:, :, None, :]
        for t in range(1, u.shape[1]):      # in place: s_t = w_t + a_t s
            torch.addcmul(states[:, t], dA[:, t], states[:, t - 1],
                          out=states[:, t])
        ctx.save_for_backward(u, dt, A, Bm, Cm, states)
        return torch.einsum("bsdn,bsn->bsd", states, Cm)

    @staticmethod
    def backward(ctx, gy):
        u, dt, A, Bm, Cm, states = ctx.saved_tensors
        S = u.shape[1]
        dA = torch.exp(dt[..., None] * A)
        g = gy[..., None] * Cm[:, :, None, :]
        for t in range(S - 2, -1, -1):      # g_t = gy_t C_t + a_{t+1} g_{t+1}
            torch.addcmul(g[:, t], dA[:, t + 1], g[:, t + 1], out=g[:, t])
        prev = torch.cat([torch.zeros_like(states[:, :1]), states[:, :-1]], 1)
        gla = g * dA * prev                      # d/d(dt A) of each state
        gBx = torch.einsum("bsdn,bsn->bsd", g, Bm)
        return (gBx * dt, torch.einsum("bsdn,dn->bsd", gla, A) + gBx * u,
                torch.einsum("bsdn,bsd->dn", gla, dt),
                torch.einsum("bsdn,bsd->bsn", g, dt * u),
                torch.einsum("bsdn,bsd->bsn", states, gy))


def selective_scan(u, dt, A, Bm, Cm):
    """The scan's outputs y [B,S,d] from u, dt [B,S,d], A [d,N] and Bm,
    Cm [B,S,N] (see ``_Scan``)."""
    return _Scan.apply(u, dt, A, Bm, Cm)


def mamba1_mixer(p, h, m, mm):
    eps, R, N = m["norm_eps"], m["ssm_dt_rank"], m["ssm_state"]
    z = mm("bsd,de->bse", h, p["w_z"])
    xin = mm("bsd,de->bse", h, p["w_x"])
    u = F.silu(lm.depthwise_causal_conv(xin, p["conv_x"]) + p["conv_bias"])
    d_low, Bm, Cm = mm("bse,ef->bsf", u, p["x_proj"]).split([R, N, N], -1)
    d_low = lm.rms(d_low, p["dt_norm"], eps)
    Bm, Cm = lm.rms(Bm, p["B_norm"], eps), lm.rms(Cm, p["C_norm"], eps)
    dt = F.softplus(mm("bsr,re->bse", d_low, p["w_dt"]) + p["dt_bias"])
    y = selective_scan(u, dt, -torch.exp(p["A_log"]), Bm, Cm)
    return (y + u * p["D_skip"]) * F.silu(z)


def block(p, x, kv, m, mm, window, wkv):
    """One layer; ``kv`` the (k, v) it reuses, else made from ``wkv``.
    Returns (x, (k, v))."""
    eps = m["norm_eps"]
    h = lm.rms(x, p["ln1"], eps)
    q = rope(mm("bsd,dhk->bshk", h, p["attn"]["wq"]), m["rope_theta"])
    if kv is None:
        k = rope(mm("bsd,dhk->bshk", h, wkv["wk"]), m["rope_theta"])
        kv = (k, mm("bsd,dhk->bshk", h, wkv["wv"]))
    a = attention(q, kv[0], kv[1], window, m["meta_tokens"], mm)
    s = mamba1_mixer(p["ssm"], h, m, mm)
    y = 0.5 * (lm.rms(a, p["attn_norm"], eps) + lm.rms(s, p["ssm_norm"], eps))
    x = x + mm("bse,ed->bsd", y, p["w_out"])
    h2 = lm.rms(x, p["ln2"], eps)
    f = p["ffn"]
    g = F.silu(mm("bsd,df->bsf", h2, f["w_gate"])) * \
        mm("bsd,df->bsf", h2, f["w_up"])
    return x + mm("bsf,fd->bsd", g, f["w_down"]), kv


# ---------------------------------------------------------------------------
# loss and the step
# ---------------------------------------------------------------------------

def logits_fn(cfg: dict, w: dict, tokens, product=None):
    """The head's logits [B, S, Vp] of ``tokens`` [B, S] (the padded
    columns masked), ``w`` a flat dict of float32 weights by path: the
    meta tokens run through every layer and are dropped after the final
    norm."""
    m, V, M = cfg["model"], cfg["model"]["vocab_size"], \
        cfg["model"]["meta_tokens"]
    mm = lm._Products(product)
    t = lm._nest(w)
    x = t["embed"][tokens.long()]
    x = torch.cat([t["meta"].expand(x.shape[0], -1, -1), x], dim=1)
    prods = producers(m)
    wkv = lm._layers(t["kv"], len(prods))
    kvs = {}
    for l, p in enumerate(lm._layers(t["blocks"], m["num_layers"])):
        src = kv_source(m, l)
        window = 0 if l in m["global_layers"] else m["sliding_window"]
        own = wkv[prods.index(l)] if src == l else None
        x, kv = checkpoint(block, p, x, kvs.get(src) if src != l else None,
                           m, mm, window, own, use_reentrant=False)
        kvs[src] = kv
    x = lm.rms(x, t["final_norm"], m["norm_eps"])[:, M:]
    head = t["embed"].t() if m.get("tie_embeddings") else t["unembed"]
    logits = mm("bsd,dv->bsv", x, head)
    return logits.masked_fill(torch.arange(logits.shape[-1],
                                           device=x.device) >= V, lm.NEG)


def loss_fn(cfg: dict, w: dict, tokens, labels, n, product=None):
    """(nll, total loss) as ``lm.loss_fn``, over :func:`logits_fn`."""
    V = cfg["model"]["vocab_size"]
    logits = logits_fn(cfg, w, tokens, product)
    lse = torch.logsumexp(logits, dim=-1)
    valid = lm._valid(labels, V)
    picked = logits.gather(-1, labels.clamp(0, V - 1).long()[..., None])[..., 0]
    nll = ((lse - picked) * valid).sum() / n
    z = (lse.square() * valid).sum() / n
    return nll, nll + cfg["loss"]["z_loss"] * z


def train(cfg: dict, w0: dict, batches: list, product=None,
          rows=None) -> dict:
    """``lm.train``'s steps and summary, with this model's loss."""
    o, V = cfg["optimizer"], cfg["model"]["vocab_size"]
    w = dict(w0)
    state = {"count": 0, "m": {k: torch.zeros_like(v) for k, v in w.items()},
             "v": {k: torch.zeros_like(v) for k, v in w.items()}}
    out = {"loss": []}
    with lm.exact_float32():
        for i, (tokens, labels) in enumerate(batches):
            n = lm._valid(labels, V).sum().clamp(min=1)
            step = rows or tokens.shape[0]
            g = {k: torch.zeros_like(v) for k, v in w.items()}
            nll = 0.0
            for r in range(0, tokens.shape[0], step):
                leaves = {k: v.detach().requires_grad_(True)
                          for k, v in w.items()}
                part, total = loss_fn(cfg, leaves, tokens[r:r + step],
                                      labels[r:r + step], n, product)
                grads = torch.autograd.grad(total, list(leaves.values()),
                                            allow_unused=True)
                for k, d in zip(leaves, grads):
                    if d is not None:
                        g[k] += d
                nll += float(part.detach())
                del leaves, grads, total, part
            with torch.no_grad():
                w, state, gnorm = lm.adamw_step(o, w, g, state)
            del g
            out["loss"].append(nll)
            if i == 0:
                out["grad_norm"] = gnorm
                out["grad"] = {k: float(v.norm()) / (1 - o["b1"])
                               for k, v in state["m"].items()}
        out["change"] = {k: float((w[k] - w0[k]).norm()) for k in w}
    return out
