"""Plain float32 reference of one training step of a Mamba-2 LM, written
from the layer equations: the embedding, the Mamba-2 mixer (projections,
depthwise causal conv, the SSD recurrence in its chunked dual form, the
gated norm), the final norm, the head (tied or not), cross-entropy with a
z-loss, and AdamW with a warm-up and cosine schedule and global-norm
clipping.

It imports torch alone. It takes the configuration file's ``model``,
``loss`` and ``optimizer`` groups and a tree of float32 weights keyed by
path (``embed``, ``blocks/ssm/w_x``, ...) stacked along a leading layer
axis, and works everything else out itself. Each block is recomputed in
the backward (``torch.utils.checkpoint``) and the batch is taken in
blocks of rows, the gradients summed over them, so that the full-width
model fits on one card in float32.

``product`` picks the precision of the matrix products: ``None`` float32
(TF32 off); ``"fp8"`` the lower-precision control, FP8 training's
recipe: the forward's operands rounded through float8 e4m3 and the
backward's incoming gradients through e5m2, one absmax scale a tensor.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -1e30


# ---------------------------------------------------------------------------
# the parameter tree: paths, shapes and initialisation laws
# ---------------------------------------------------------------------------

def d_inner(m: dict) -> int:
    return m["ssm_expand"] * m["d_model"]


def ssm_heads(m: dict) -> int:
    return d_inner(m) // m["ssm_headdim"]


def param_specs(cfg: dict) -> list:
    """``(path, shape, law, scale)`` of every leaf. ``law`` is ``randn``
    (times ``scale``), ``zeros``, ``ones``, ``a_log`` or ``dt_bias``."""
    m = cfg["model"]
    L, D, Vp = m["num_layers"], m["d_model"], cfg["padded_vocab"]
    out = [("embed", (Vp, D), "randn", 0.02),
           ("final_norm", (D,), "zeros", None),
           ("blocks/ln1", (L, D), "zeros", None)]
    if not m.get("tie_embeddings"):
        out.append(("unembed", (D, Vp), "randn", D ** -0.5))
    if m["family"] != "ssm":
        raise ValueError(f"no reference for family {m['family']!r}")
    di, H = d_inner(m), ssm_heads(m)
    gn, K = m["ssm_groups"] * m["ssm_state"], m["ssm_conv"]
    s = "blocks/ssm/"
    out += [(s + "w_z", (L, D, di), "randn", D ** -0.5),
            (s + "w_x", (L, D, di), "randn", D ** -0.5),
            (s + "w_B", (L, D, gn), "randn", D ** -0.5),
            (s + "w_C", (L, D, gn), "randn", D ** -0.5),
            (s + "w_dt", (L, D, H), "randn", D ** -0.5),
            (s + "conv_x", (L, K, di), "randn", K ** -0.5),
            (s + "conv_B", (L, K, gn), "randn", K ** -0.5),
            (s + "conv_C", (L, K, gn), "randn", K ** -0.5),
            (s + "A_log", (L, H), "a_log", None),
            (s + "dt_bias", (L, H), "dt_bias", None),
            (s + "D_skip", (L, H), "ones", None),
            (s + "gate_norm", (L, di), "zeros", None),
            (s + "w_out", (L, di, D), "randn", di ** -0.5)]
    return sorted(out)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def _round8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded through a float8 type with one absmax scale."""
    s = x.abs().amax().clamp(min=1e-30) / top
    return (x / s).to(dtype).float() * s


class _Fp8(torch.autograd.Function):
    """FP8 training's rounding of a product: operands through e4m3 in the
    forward, the product's incoming gradient through e5m2 before the
    backward's products (gradients to the operands passed straight
    through)."""

    @staticmethod
    def forward(ctx, eq, a, b):
        a = _round8(a, torch.float8_e4m3fn, 448.0)
        b = _round8(b, torch.float8_e4m3fn, 448.0)
        ctx.eq = eq
        ctx.save_for_backward(a, b)
        return torch.einsum(eq, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round8(g, torch.float8_e5m2, 57344.0)
        ins, out = ctx.eq.split("->")
        ia, ib = ins.split(",")
        return (None, torch.einsum(f"{out},{ib}->{ia}", g, b),
                torch.einsum(f"{out},{ia}->{ib}", g, a))


class _Products:
    def __init__(self, product):
        if product not in (None, "fp8"):
            raise ValueError(f"unknown product precision {product!r}")
        self.fp8 = product == "fp8"

    def __call__(self, eq: str, a, b):
        if self.fp8:
            return _Fp8.apply(eq, a, b)
        return torch.einsum(eq, a, b)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + w)


def depthwise_causal_conv(x, w):
    """x [B, S, C], w [K, C]: y_t = sum_k w_k x_{t-K+1+k}, zeros before
    the start."""
    K = w.shape[0]
    y = F.conv1d(x.transpose(1, 2), w.t().unsqueeze(1), padding=K - 1,
                 groups=x.shape[-1])
    return y[..., :x.shape[1]].transpose(1, 2)


def ssd(x, dt, A, Bm, Cm, chunk):
    """The SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
    y_t = h_t^T C_t, per head, in the chunked dual form.

    x [B, S, H, P], dt [B, S, H], A [H], Bm / Cm [B, S, G, N] (head h reads
    group h // (H / G)). Returns y [B, S, H, P]."""
    Bz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    pad = (-S) % chunk
    if pad:    # dt = 0 past the end: no input, no decay
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (Bm, Cm))
    T = S + pad
    nc, c = T // chunk, chunk
    grp = torch.arange(H, device=x.device) // (H // G)
    # [B, H, nc, c, ...]
    xs = x.reshape(Bz, nc, c, H, P).permute(0, 3, 1, 2, 4)
    a = (dt * A).reshape(Bz, nc, c, H).permute(0, 3, 1, 2)
    dts = dt.reshape(Bz, nc, c, H).permute(0, 3, 1, 2)
    Bs = Bm.reshape(Bz, nc, c, G, N)[:, :, :, grp].permute(0, 3, 1, 2, 4)
    Cs = Cm.reshape(Bz, nc, c, G, N)[:, :, :, grp].permute(0, 3, 1, 2, 4)
    cum = a.cumsum(-1)                                  # [B,H,nc,c]
    causal = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    logL = cum[..., :, None] - cum[..., None, :]
    Lm = torch.exp(logL.masked_fill(~causal, NEG))      # [B,H,nc,c,c]
    u = xs * dts[..., None]                             # dt_s x_s
    scores = torch.einsum("bhzin,bhzjn->bhzij", Cs, Bs) * Lm
    y = torch.einsum("bhzij,bhzjp->bhzip", scores, u)
    # each chunk's own contribution to the state at its end
    w_end = torch.exp(cum[..., -1:] - cum)              # [B,H,nc,c]
    st = torch.einsum("bhzj,bhzjn,bhzjp->bhznp", w_end, Bs, u)
    # states entering each chunk
    carry = torch.zeros(Bz, H, N, P, dtype=x.dtype, device=x.device)
    decay = torch.exp(cum[..., -1])                     # [B,H,nc]
    entering = []
    for z in range(nc):
        entering.append(carry)
        carry = carry * decay[:, :, z, None, None] + st[:, :, z]
    h0 = torch.stack(entering, dim=2)                   # [B,H,nc,N,P]
    y = y + torch.einsum("bhzin,bhznp->bhzip", Cs * torch.exp(cum)[..., None],
                         h0)
    return y.permute(0, 2, 3, 1, 4).reshape(Bz, T, H, P)[:, :S]


def mamba2_mixer(p, h, m, mm):
    """The Mamba-2 mixer of one layer: p holds its weights."""
    B, S, _ = h.shape
    H, Pd = ssm_heads(m), m["ssm_headdim"]
    G, N = m["ssm_groups"], m["ssm_state"]
    z = mm("bsd,de->bse", h, p["w_z"])
    xin = F.silu(depthwise_causal_conv(mm("bsd,de->bse", h, p["w_x"]),
                                       p["conv_x"]))
    Bm = F.silu(depthwise_causal_conv(mm("bsd,de->bse", h, p["w_B"]),
                                      p["conv_B"]))
    Cm = F.silu(depthwise_causal_conv(mm("bsd,de->bse", h, p["w_C"]),
                                      p["conv_C"]))
    dt = F.softplus(mm("bsd,dh->bsh", h, p["w_dt"]) + p["dt_bias"])
    xh = xin.reshape(B, S, H, Pd)
    y = ssd(xh, dt, -torch.exp(p["A_log"]), Bm.reshape(B, S, G, N),
            Cm.reshape(B, S, G, N), min(m["ssm_chunk"], S))
    y = (y + xh * p["D_skip"][:, None]).reshape(B, S, H * Pd)
    y = rms(y * F.silu(z), p["gate_norm"], m["norm_eps"])
    return mm("bse,ed->bsd", y, p["w_out"])


def block(p, x, m, mm):
    return x + mamba2_mixer(p["ssm"], rms(x, p["ln1"], m["norm_eps"]), m, mm)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _nest(flat: dict) -> dict:
    out = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def _layers(tree, n):
    """The ``n`` per-layer trees of a tree stacked along its first axis
    (one ``unbind`` a leaf, whose backward is one stack)."""
    if not isinstance(tree, dict):
        return tree.unbind(0)
    parts = {k: _layers(v, n) for k, v in tree.items()}
    return [{k: v[l] for k, v in parts.items()} for l in range(n)]


def loss_fn(cfg: dict, w: dict, tokens, labels, n, product=None):
    """(nll, total loss) of ``tokens`` [B, S] against ``labels``, each
    summed over the valid labels and divided by ``n`` (the valid labels
    of the whole batch these rows belong to); ``w`` a flat dict of
    float32 weights by path."""
    m, V = cfg["model"], cfg["model"]["vocab_size"]
    mm = _Products(product)
    t = _nest(w)
    x = t["embed"][tokens.long()]
    for p in _layers(t["blocks"], m["num_layers"]):
        x = checkpoint(block, p, x, m, mm, use_reentrant=False)
    x = rms(x, t["final_norm"], m["norm_eps"])
    head = t["embed"].t() if m.get("tie_embeddings") else t["unembed"]
    logits = mm("bsd,dv->bsv", x, head)
    logits = logits.masked_fill(torch.arange(logits.shape[-1],
                                             device=x.device) >= V, NEG)
    lse = torch.logsumexp(logits, dim=-1)
    valid = _valid(labels, V)
    picked = logits.gather(-1, labels.clamp(0, V - 1).long()[..., None])[..., 0]
    nll = ((lse - picked) * valid).sum() / n
    z = (lse.square() * valid).sum() / n
    return nll, nll + cfg["loss"]["z_loss"] * z


def _valid(labels, V):
    return (labels >= 0) & (labels < V)


@contextmanager
def exact_float32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def learning_rate(o: dict, step: int) -> float:
    """Linear warm-up over ``warmup_steps``, then a cosine from ``lr`` to
    a tenth of it at ``total_steps``; ``step`` counts from 0."""
    warm = min(1.0, (step + 1) / max(o["warmup_steps"], 1))
    frac = min(1.0, max(0.0, (step - o["warmup_steps"]) /
                        max(o["total_steps"] - o["warmup_steps"], 1)))
    return o["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * frac)))


def adamw_step(o: dict, w: dict, g: dict, state: dict) -> tuple:
    """One AdamW step over flat dicts. ``state`` holds ``count`` and the
    moments ``m`` and ``v``. Decay applies to leaves of 2 dims or more.
    Returns (weights, state, global gradient norm before clipping)."""
    step = state["count"]
    count = step + 1
    lr = learning_rate(o, step)
    gnorm = math.sqrt(sum(float(torch.linalg.vector_norm(x)) ** 2
                          for x in g.values()))
    clip = min(1.0, o["clip_norm"] / max(gnorm, 1e-9))
    bc1, bc2 = 1 - o["b1"] ** count, 1 - o["b2"] ** count
    nw = {}
    for k in w:    # the moments in place, the weights anew
        gk = g[k] * clip
        m, v = state["m"][k], state["v"][k]
        m.mul_(o["b1"]).add_(gk, alpha=1 - o["b1"])
        v.mul_(o["b2"]).addcmul_(gk, gk, value=1 - o["b2"])
        upd = (m / bc1) / ((v / bc2).sqrt() + o["eps"])
        if w[k].dim() >= 2:
            upd = upd + o["weight_decay"] * w[k]
        nw[k] = w[k] - lr * upd
    state["count"] = count
    return nw, state, gnorm


def train(cfg: dict, w0: dict, batches: list, product=None,
          rows=None) -> dict:
    """``len(batches)`` steps from the weights ``w0`` (left as they are),
    each batch taken ``rows`` rows at a time (all at once when None), the
    gradients summed over the blocks. Returns what the comparison reads:
    each step's mean nll (``loss``), step 1's global gradient norm
    (``grad_norm``), step 1's clipped gradient norm by leaf (``grad``),
    the weights' change after the last step by leaf (``change``)."""
    o, V = cfg["optimizer"], cfg["model"]["vocab_size"]
    w = dict(w0)
    state = {"count": 0, "m": {k: torch.zeros_like(v) for k, v in w.items()},
             "v": {k: torch.zeros_like(v) for k, v in w.items()}}
    out = {"loss": []}
    with exact_float32():
        for i, (tokens, labels) in enumerate(batches):
            n = _valid(labels, V).sum().clamp(min=1)
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
                w, state, gnorm = adamw_step(o, w, g, state)
            del g
            out["loss"].append(nll)
            if i == 0:
                out["grad_norm"] = gnorm
                out["grad"] = {k: float(v.norm()) / (1 - o["b1"])
                               for k, v in state["m"].items()}
        out["change"] = {k: float((w[k] - w0[k]).norm()) for k in w}
    return out
