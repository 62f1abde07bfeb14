"""On-card microbenchmarks of the compute kernels: the port of the
matmul / conv2d / FFT / attention / SSD rows of the reference's
``benchmarks/kernel_micro.py`` and of the het-MIMD stage of
``examples/composite_workload.py``.

    python -m repro_torch.kernels.micro [--seed 0] [--only conv,composite]
                                        [--kernel-only]

Runs on the card only: without one it exits 2 and prints no result. For
each workload — the reference's shapes (``REFERENCE``) and the
card-scale shapes of the port's main path (``CARD``) — it builds the
inputs from ``--seed``, runs the kernel through
:mod:`repro_torch.kernels.ops`, holds the output against the plain
version (:mod:`repro_torch.kernels.checks`), and prints one JSON line:
bytes and operations, the H100 roofline terms (bytes over the memory
rate, operations over the peak rate of their type) and the bound, the
kernel's device time (``torch.profiler``) and call time (CUDA events),
the plain version's, and one PyTorch library call's where one computes
the same function. The last line is the card's name and power limit.

``chip_smoke.py`` takes its workloads, costs and timers from here.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from repro_torch.kernels import checks, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import het_mimd as hm
from repro_torch.kernels import spm_conv2d as sc
from repro_torch.kernels import spm_fft as sf
from repro_torch.kernels import spm_matmul as sm
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.common import resolve_device

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit. The data
# sheet gives no INT32 rate: the Hopper architecture white paper gives
# each SM quarter 16 INT32 lanes against 32 FP32 lanes, so INT32 runs at
# half the FP32 rate (a multiply-add counting as two operations).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {
    "bf16": 989e12,        # bf16 tensor cores
    "fp16": 989e12,        # float16 tensor cores
    "int8": 1979e12,       # int8 tensor cores
    "fp32": 67e12,         # FP32 outside the tensor cores (no TF32)
    "int32": 33.5e12,      # INT32 outside the tensor cores
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int8": torch.int8, "int16": torch.int16,
          "uint8": torch.uint8, "int32": torch.int32}
MODULES = {"spm_matmul": sm, "spm_conv2d": sc, "spm_fft": sf,
           "het_mimd": hm, "flash_attention": fa, "ssd_scan": ss}


@dataclass(frozen=True)
class Workload:
    """One kernel call: ``kernel`` names the module, ``shape`` its
    arguments (sizes, ``dtype``, conv ``shift``), ``use`` what users do
    with it."""

    name: str
    kernel: str
    shape: dict
    use: str


REFERENCE = (
    Workload("ref_matmul_bf16_512", "spm_matmul",
             dict(M=512, K=512, N=512, dtype="bfloat16"),
             "benchmarks/kernel_micro.py: spm_matmul 512^3 bf16"),
    Workload("ref_conv_f32_256_f3", "spm_conv2d",
             dict(H=256, W=256, F=3, dtype="float32"),
             "benchmarks/kernel_micro.py: spm_conv2d 256^2 3x3"),
    Workload("ref_fft_64x256", "spm_fft", dict(B=64, n=256),
             "benchmarks/kernel_micro.py: spm_fft 64x256"),
    Workload("ref_attention_1x4x1024x64", "flash_attention",
             dict(B=1, H=4, KV=2, Sq=1024, Skv=1024, hd=64,
                  dtype="bfloat16"),
             "benchmarks/kernel_micro.py: flash_attention 1k causal"),
    Workload("ref_ssd_2x512x4x32", "ssd_scan",
             dict(Bz=2, S=512, H=4, P=32, N=16, G=1, chunk=128,
                  dtype="float32"),
             "benchmarks/kernel_micro.py: ssd_scan 2x512x4x32"),
)

CARD = (
    Workload("matmul_bf16_4096", "spm_matmul",
             dict(M=4096, K=4096, N=4096, dtype="bfloat16"),
             "the intrinsics layer's dense product at LM width"),
    Workload("matmul_int8_4096", "spm_matmul",
             dict(M=4096, K=4096, N=4096, dtype="int8"),
             "the paper's 8-bit sub-word SIMD product"),
    Workload("matmul_f32_2048", "spm_matmul",
             dict(M=2048, K=2048, N=2048, dtype="float32"),
             "full-precision product (no TF32)"),
    Workload("conv_int32_2048_f3", "spm_conv2d",
             dict(H=2048, W=2048, F=3, dtype="int32", shift=4),
             "the paper's fixed-point conv, 3x3 filter"),
    Workload("conv_int32_2048_f11", "spm_conv2d",
             dict(H=2048, W=2048, F=11, dtype="int32", shift=4),
             "the paper's fixed-point conv, 11x11 filter"),
    Workload("conv_f32_2048_f3", "spm_conv2d",
             dict(H=2048, W=2048, F=3, dtype="float32"),
             "float image filtering"),
    Workload("conv_f32_2048_f11", "spm_conv2d",
             dict(H=2048, W=2048, F=11, dtype="float32"),
             "float image filtering, 11x11 filter"),
    Workload("conv_bf16_2048_f3", "spm_conv2d",
             dict(H=2048, W=2048, F=3, dtype="bfloat16"),
             "half-width float image filtering"),
    Workload("conv_int8_2048_f3", "spm_conv2d",
             dict(H=2048, W=2048, F=3, dtype="int8"),
             "8-bit image filtering, saturating (the reference's int8)"),
    Workload("conv_int32_512_f161", "spm_conv2d",
             dict(H=512, W=512, F=161, dtype="int32", shift=4),
             "a filter past the old kernel's shared-memory limit (154)"),
    Workload("fft_16384x256", "spm_fft", dict(B=16384, n=256),
             "batched FFT-256 (the paper's size)"),
    Workload("fft_4096x1024", "spm_fft", dict(B=4096, n=1024),
             "batched 1024-point transform"),
    Workload("composite_paper", "het_mimd",
             dict(H=32, W=32, F=3, nb=4, n=256, m=64, k=64, p=64),
             "examples/composite_workload.py: the paper's composite"),
    Workload("composite_1024", "het_mimd",
             dict(H=1024, W=1024, F=3, nb=1024, n=256, m=1024, k=1024,
                  p=1024),
             "the same composite at card scale"),
    # composite_1024's parts, each alone: the composite against their sum
    # and their maximum says whether its one launch overlaps them
    Workload("part_matmul_f32_1024", "spm_matmul",
             dict(M=1024, K=1024, N=1024, dtype="float32"),
             "composite_1024's matmul hart, alone"),
    Workload("part_fft_1024x256", "spm_fft", dict(B=1024, n=256),
             "composite_1024's FFT hart, alone"),
    Workload("part_conv_f32_1024_f3", "spm_conv2d",
             dict(H=1024, W=1024, F=3, dtype="float32"),
             "composite_1024's conv hart, alone (same-size, padded by "
             "index)"),
    Workload("attn_llama3.2-1b_causal_4096", "flash_attention",
             dict(B=2, H=32, KV=8, Sq=4096, Skv=4096, hd=64,
                  dtype="bfloat16"),
             "configs/llama3_2_1b.py at the train_4k length: causal GQA"),
    Workload("attn_hymba1.5b_swa_8192", "flash_attention",
             dict(B=1, H=25, KV=5, Sq=8192, Skv=8192, hd=64, window=2048,
                  dtype="bfloat16"),
             "hymba-1.5b's heads (configs/hymba_1_5b.py, G = 5) with a "
             "window-2048 shape: the published window is 1024 with 128 "
             "always-visible meta keys, which this kernel does not take"),
    Workload("attn_mixtral_prefill_cont", "flash_attention",
             dict(B=1, H=32, KV=8, Sq=512, Skv=4096, hd=128, window=4096,
                  q_offset=3584, dtype="bfloat16"),
             "configs/mixtral_8x7b.py: a chunked-prefill continuation"),
    Workload("ssd_mamba2-1.3b_4096", "ssd_scan",
             dict(Bz=2, S=4096, H=64, P=64, N=128, G=1, chunk=256,
                  dtype="float32"),
             "configs/mamba2_1_3b.py (d_inner 4096 / headdim 64) at 4k"),
    # inputs the reference takes past the first kernels' limits
    Workload("attn_pixtral12b_causal_4096", "flash_attention",
             dict(B=1, H=32, KV=8, Sq=4096, Skv=4096, hd=160,
                  dtype="bfloat16"),
             "configs/pixtral_12b.py at train_4k: head_dim 160, causal"),
    Workload("fft_256x65536", "spm_fft", dict(B=256, n=65536),
             "a 65536-point transform, past one block's shared memory"),
    Workload("matmul_f16_4096", "spm_matmul",
             dict(M=4096, K=4096, N=4096, dtype="float16"),
             "the dense product in float16"),
    Workload("matmul_int32_2048", "spm_matmul",
             dict(M=2048, K=2048, N=2048, dtype="int32"),
             "an int32 product, the reference's float32 sum (operands in "
             "-90 .. 90: no sum rounds)"),
    Workload("composite_512_f161", "het_mimd",
             dict(H=512, W=512, F=161, nb=1024, n=256, m=1024, k=1024,
                  p=1024),
             "the composite with a 161 x 161 filter (img 672^2): the conv "
             "hart's streamed rows"),
)


def card_line() -> str:
    """``name, power limit`` of the card, as ``nvidia-smi`` reports it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def card_settings() -> None:
    """Hold float32 products and convolutions on the card to full
    float32 (the library calls then compute the kernels' function)."""
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is on; the float32 comparisons "
                           "and library times need it off")


# ---------------------------------------------------------------------------
# inputs, runs and comparisons
# ---------------------------------------------------------------------------

def attention_masks(shape: dict) -> dict:
    """An attention workload's mask arguments (causal unless it says
    otherwise, no window, no offset)."""
    return dict(causal=shape.get("causal", True),
                window=shape.get("window", 0),
                q_offset=shape.get("q_offset", 0))


def _masks(x: dict) -> dict:
    return {key: x[key] for key in ("causal", "window", "q_offset")}


def _ssd(x: dict) -> tuple:
    return x["x"], x["dt"], x["A"], x["B"], x["C"]


def make_inputs(w: Workload, rng: np.random.Generator, device) -> dict:
    s = w.shape
    if w.kernel == "spm_matmul":
        a, b = checks.matmul_operands(rng, s["M"], s["K"], s["N"],
                                      DTYPES[s["dtype"]], device)
        return dict(a=a, b=b)
    if w.kernel == "spm_conv2d":
        img, filt = checks.conv_operands(rng, s["H"], s["W"], s["F"],
                                         DTYPES[s["dtype"]], device)
        return dict(img=img, filt=filt, shift=s.get("shift", 0))
    if w.kernel == "spm_fft":
        return dict(re=checks.random_floats(rng, (s["B"], s["n"]),
                                            torch.float32, device),
                    im=checks.random_floats(rng, (s["B"], s["n"]),
                                            torch.float32, device))
    if w.kernel == "flash_attention":
        q, k, v = checks.attention_operands(
            rng, s["B"], s["H"], s["KV"], s["Sq"], s["Skv"], s["hd"],
            DTYPES[s["dtype"]], device)
        return dict(q=q, k=k, v=v, **attention_masks(s))
    if w.kernel == "ssd_scan":
        return dict(zip(("x", "dt", "A", "B", "C"), checks.ssd_operands(
            rng, s["Bz"], s["S"], s["H"], s["P"], s["N"], s["G"], device,
            DTYPES[s["dtype"]])), chunk=s["chunk"])
    names = ("img", "filt", "fre", "fim", "A", "B")
    return dict(zip(names, checks.het_mimd_operands(
        rng, s["H"], s["W"], s["F"], s["nb"], s["n"], s["m"], s["k"],
        s["p"], device)))


def run_kernel(w: Workload, x: dict):
    """The workload through the intrinsics layer (the kernel on the
    card)."""
    if w.kernel == "spm_matmul":
        return ops.matmul_op(x["a"], x["b"])
    if w.kernel == "spm_conv2d":
        return ops.conv2d_op(x["img"], x["filt"], shift=x["shift"])
    if w.kernel == "spm_fft":
        return ops.fft_op(x["re"], x["im"])
    if w.kernel == "flash_attention":
        return ops.attention_op(x["q"], x["k"], x["v"], **_masks(x))
    if w.kernel == "ssd_scan":
        return ops.ssd_scan_op(*_ssd(x), chunk=x["chunk"])
    return ops.het_mimd_composite(x["img"], x["filt"], x["fre"], x["fim"],
                                  x["A"], x["B"])


def run_plain(w: Workload, x: dict):
    if w.kernel == "spm_matmul":
        return sm.spm_matmul_plain(x["a"], x["b"])
    if w.kernel == "spm_conv2d":
        return sc.spm_conv2d_plain(x["img"], x["filt"], shift=x["shift"])
    if w.kernel == "spm_fft":
        return sf.spm_fft_plain(x["re"], x["im"])
    if w.kernel == "flash_attention":
        return fa.flash_attention_plain(x["q"], x["k"], x["v"], **_masks(x))
    if w.kernel == "ssd_scan":
        xx, dt, A, B, C = _ssd(x)
        return ss.ssd_scan_plain(xx, dt * A[None, None, :], dt, B, C,
                                 chunk=x["chunk"])
    return hm.het_mimd_composite_plain(x["img"], x["filt"], x["fre"],
                                       x["fim"], x["A"], x["B"])


def compare_plain(w: Workload, x: dict, out) -> float:
    """The kernel's output against the plain version on the same
    inputs (:mod:`checks`' bounds); the largest absolute difference."""
    if w.kernel == "spm_matmul":
        return checks.compare_matmul(out, x["a"], x["b"])
    if w.kernel == "spm_conv2d":
        return checks.compare_conv(out, x["img"], x["filt"], x["shift"])
    if w.kernel == "spm_fft":
        return checks.compare_fft(*out, x["re"], x["im"])
    if w.kernel == "flash_attention":
        return checks.compare_attention(out, x["q"], x["k"], x["v"],
                                        **_masks(x))
    if w.kernel == "ssd_scan":
        return checks.compare_ssd(out, *_ssd(x), chunk=x["chunk"])
    return checks.compare_het_mimd(out, x["img"], x["filt"], x["fre"],
                                   x["fim"], x["A"], x["B"])


def attention_library_call(q, k, v, causal, window, q_offset):
    """``F.scaled_dot_product_attention`` computing the kernel's function
    (GQA through ``enable_gqa``): ``is_causal`` where the mask is plain
    causal with Sq = Skv and no offset, else an explicit boolean mask
    (``is_causal`` aligns the diagonal top-left). Rows that see no key
    differ (SDPA gives NaN there); the card workloads have none."""
    Sq, Skv = q.shape[2], k.shape[2]
    if causal and not window and not q_offset and Sq == Skv:
        return lambda: tnf.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    mask = fa.visible(q_offset + torch.arange(Sq, device=q.device),
                      torch.arange(Skv, device=q.device), causal, window)
    return lambda: tnf.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def library_call(w: Workload, x: dict) -> Optional[Callable[[], object]]:
    """One PyTorch call computing the workload's function (three for the
    composite, one per hart), or None where PyTorch has none: an integer
    convolution (a bf16 one takes the filter rounded to bf16), an int8
    product outside ``torch._int_mm``'s shapes, a product of other
    integers (``torch.matmul`` takes none on the card), the SSD scan."""
    if w.kernel == "spm_matmul":
        a, b = x["a"], x["b"]
        if a.dtype.is_floating_point:
            return lambda: torch.matmul(a, b)
        if a.dtype != torch.int8:
            return None
        M, K = a.shape
        if M > 16 and K % 8 == 0 and b.shape[1] % 8 == 0:
            return lambda: torch._int_mm(a, b)
        return None
    if w.kernel == "spm_conv2d":
        img, filt = x["img"], x["filt"]
        F = filt.shape[0]
        if img.dtype not in (torch.float32, torch.bfloat16) or F % 2 == 0:
            return None
        i4, f4 = img[None, None], filt.to(img.dtype)[None, None]
        return lambda: tnf.conv2d(i4, f4, padding=F // 2)
    if w.kernel == "spm_fft":
        z = torch.complex(x["re"], x["im"])
        return lambda: torch.fft.fft(z)
    if w.kernel == "flash_attention":
        return attention_library_call(x["q"], x["k"], x["v"], **_masks(x))
    if w.kernel == "ssd_scan":
        return None
    i4, f4 = x["img"][None, None], x["filt"][None, None]
    z, A, B = torch.complex(x["fre"], x["fim"]), x["A"], x["B"]
    return lambda: (tnf.conv2d(i4, f4), torch.fft.fft(z), torch.matmul(A, B))


# ---------------------------------------------------------------------------
# work, bounds and timing
# ---------------------------------------------------------------------------

def _fft_cost(B: int, n: int) -> Tuple[int, int]:
    # four float32 planes and the twiddle table; 10 flops a butterfly
    return 16 * B * n + 8 * max(n - 1, 1), 5 * B * n * (n.bit_length() - 1)


def _attention_cost(s: dict) -> Tuple[int, List[Tuple[int, str]]]:
    # q, k, v read and o written once; the two products over the pairs
    # each query row sees, at the input type's tensor-core rate
    size = torch.empty((), dtype=DTYPES[s["dtype"]]).element_size()
    B, H, KV, Sq, Skv, hd = (s[c] for c in ("B", "H", "KV", "Sq", "Skv",
                                            "hd"))
    m = attention_masks(s)
    pairs = fa.visible_pairs(Sq, Skv, m["causal"], m["window"],
                             m["q_offset"])
    key = {"bfloat16": "bf16", "float16": "fp16"}.get(s["dtype"], "fp32")
    return ((2 * B * H * Sq + 2 * B * KV * Skv) * hd * size,
            [(4 * B * H * pairs * hd, key)])


def _ssd_cost(s: dict) -> Tuple[int, List[Tuple[int, str]]]:
    # x, da, dt and B, C per group read, y and the state written; the
    # float32 products of each chunk: C B^T once per group and y's over
    # the j <= i half the function needs, the chunk state and C h per head
    size = torch.empty((), dtype=DTYPES[s["dtype"]]).element_size()
    Bz, S, H, P, N, G = (s[c] for c in ("Bz", "S", "H", "P", "N", "G"))
    cs = min(s["chunk"], S)
    tri = cs * (cs + 1) // 2
    nbytes = Bz * S * H * (2 * P * size + 2 * 4) + Bz * S * G * 2 * N * 4 \
        + Bz * H * N * P * 4
    ops = Bz * (S // cs) * (G * 2 * tri * N + H * (2 * tri * P
                                                    + 4 * cs * N * P))
    return nbytes, [(ops, "fp32")]


def ssd_part_costs(s: dict) -> Dict[str, Tuple[int, List[Tuple[int, str]]]]:
    """``(bytes, [(operations, "fp32")])`` of each SSD kernel alone: its
    inputs read once (workspaces included), its outputs written once, a
    multiply-add two operations. The forward's launches (``PARTS``, with B
    and C per group: ``s["G"]``): the scores C B^T once per group over the
    chunk's lower triangle, the chunk states, and y from the scores split
    the function's products (:func:`_ssd_cost`); the scan over chunks adds
    a multiply and an add per state element and chunk. Then the
    backward's (``BWD_PARTS``): its chunk terms and reverse pass as the
    forward's, xbar (the scores' and the state's products again), Shat
    (the heads' dy . x over P), Cbar and Bbar (Shat's product once per
    group, the state term per head, and its row sums with the tile's own
    rows), and the decay's gradient (a dot of sbar and h_c per chunk);
    each workspace of row sums written once and read once."""
    size = torch.empty((), dtype=DTYPES[s["dtype"]]).element_size()
    Bz, S, H, P, N = (s[c] for c in ("Bz", "S", "H", "P", "N"))
    G = s.get("G", H)
    cs = min(s["chunk"], S)
    nc = S // cs
    x, row = Bz * S * H * P * size, Bz * S * H * 4
    states, cum, state = Bz * H * nc * N * P * 4, Bz * H * S * 4, \
        Bz * H * N * P * 4
    chunks, groups = Bz * H * nc, Bz * G * nc
    tri = cs * (cs + 1) // 2
    gbn, tiles = Bz * S * G * N * 4, groups * tri * 4
    rows = lambda n: n * row                             # noqa: E731
    npt, ntn, ntile = (-(-w // 64) for w in (P, N, cs))
    prods = chunks * (2 * tri * P + 2 * cs * N * P)      # y's, xbar's
    return {
        "ssd_scores": (2 * gbn + tiles, [(groups * 2 * tri * N, "fp32")]),
        "ssd_chunk_state": (x + 2 * row + gbn + states + cum,
                            [(chunks * 2 * cs * N * P, "fp32")]),
        "ssd_state_pass": (2 * states + chunks * 4 + state,
                           [(chunks * 2 * N * P, "fp32")]),
        "ssd_train_scan": (2 * x + row + gbn + cum + states + tiles,
                           [(prods, "fp32")]),
        "ssd_bwd_chunk_state": (x + row + gbn + states,
                                [(chunks * 2 * cs * N * P, "fp32")]),
        "ssd_bwd_state_pass": (2 * states + chunks * 4 + 2 * state,
                               [(chunks * 2 * N * P, "fp32")]),
        "ssd_bwd_dx": (3 * x + row + gbn + cum + states + tiles
                       + rows(npt), [(prods, "fp32")]),
        "ssd_bwd_ds": (2 * x + row + cum + 2 * tiles
                       + rows(ntile + 1), [(chunks * 2 * tri * P, "fp32")]),
        "ssd_bwd_dc": (x + row + 3 * gbn + cum + states + tiles + rows(ntn),
                       [(groups * 2 * tri * N + chunks * 2 * cs * N * P,
                         "fp32")]),
        "ssd_bwd_db": (x + row + 3 * gbn + cum + states + tiles + rows(ntn),
                       [(groups * 2 * tri * N + chunks * 2 * cs * N * P,
                         "fp32")]),
        "ssd_bwd_dcum": (2 * states + 2 * row + cum + H * 4 + chunks * 4
                         + rows(npt + ntile + 1 + 2 * ntn),
                         [(chunks * 2 * N * P, "fp32")]),
    }


def cost(w: Workload) -> Tuple[int, List[Tuple[int, str]]]:
    """``(bytes, [(operations, peak key), ...])``: each input read once
    and each output written once; a multiply-add counts as two
    operations, an FFT butterfly as ten; attention and the SSD scan count
    their products only (not exp)."""
    s = w.shape
    if w.kernel == "spm_matmul":
        dt = DTYPES[s["dtype"]]
        M, K, N = s["M"], s["K"], s["N"]
        out = sm.result_dtype(dt)
        size = torch.empty((), dtype=dt).element_size()
        osize = torch.empty((), dtype=out).element_size()
        key = {torch.bfloat16: "bf16", torch.float16: "fp16",
               torch.int8: "int8"}.get(dt, "fp32")
        return (M * K + K * N) * size + M * N * osize, [(2 * M * N * K, key)]
    if w.kernel == "spm_conv2d":
        dt = DTYPES[s["dtype"]]
        H, W, F = s["H"], s["W"], s["F"]
        size = torch.empty((), dtype=dt).element_size()
        return 2 * H * W * size + 4 * F * F, [
            (2 * F * F * H * W, "int32" if dt == torch.int32 else "fp32")]
    if w.kernel == "spm_fft":
        nbytes, flops = _fft_cost(s["B"], s["n"])
        return nbytes, [(flops, "fp32")]
    if w.kernel == "flash_attention":
        return _attention_cost(s)
    if w.kernel == "ssd_scan":
        return _ssd_cost(s)
    H, W, F, m, k, p = (s[c] for c in ("H", "W", "F", "m", "k", "p"))
    fft_bytes, fft_flops = _fft_cost(s["nb"], s["n"])
    conv_bytes = 4 * ((H + F - 1) * (W + F - 1) + F * F + H * W)
    return (conv_bytes + fft_bytes + 4 * (m * k + k * p + m * p),
            [(2 * F * F * H * W, "fp32"), (fft_flops, "fp32"),
             (2 * m * k * p, "fp32")])


def bound(nbytes: int, op_terms) -> Dict[str, object]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rates (summed
    over terms, which share the card)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = sum(n / PEAK_OPS_PER_S[key] for n, key in op_terms) * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, ops_ms=ops_ms, bytes=nbytes,
                ops=sum(n for n, _ in op_terms))


def device_us(ev) -> float:
    """Device time of one averaged profiler event: counted on the device
    events themselves (kernels, memcpy, memset) only — a CPU op reports
    its kernels' time as well, which would count them twice."""
    if (not str(ev.device_type).endswith("CUDA")
            or getattr(ev, "is_user_annotation", False)):
        return 0.0
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0))


def timed(fn, reps: int, match=None) -> dict:
    """Two times per call of ``fn`` after a warm-up: ``call_ms`` from
    CUDA events around ``reps`` back-to-back calls (what a caller pays;
    host-bound when the host enqueues slower than the card runs), and
    ``device_ms`` from a ``torch.profiler`` trace of ``reps`` more calls:
    the device time of events whose name contains ``match`` (a string, or
    any of a tuple of strings, then also ``device_ms_by`` each; every
    device event when None), or None when the trace holds no device
    time; ``top_kernel`` names the device event that took the most (which
    backend a library call ran on)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = (match,) if isinstance(match, str) else match
    events = [(device_us(ev), ev.key) for ev in prof.key_averages()
              if names is None or any(m in ev.key for m in names)]
    us = sum(t for t, _ in events)
    top = max(events, default=(0.0, None))
    out = dict(call_ms=call_ms, device_ms=us / 1e3 / reps or None,
               top_kernel=top[1] if top[0] else None)
    if names is not None and len(names) > 1:
        out["device_ms_by"] = {m: sum(t for t, k in events if m in k)
                               / 1e3 / reps or None for m in names}
    return out


def times(kernel: dict, plain: dict, library: Optional[dict] = None) -> dict:
    """The JSON's times: the kernel's device time (its call time when
    the profiler sees no device time), the plain version's and the
    library call's likewise, each beside its call time."""
    out = dict(ms=kernel["device_ms"] or kernel["call_ms"],
               ms_source="profiler" if kernel["device_ms"] else "events",
               call_ms=kernel["call_ms"],
               plain_ms=plain["device_ms"] or plain["call_ms"],
               plain_call_ms=plain["call_ms"], library_ms=None,
               library_call_ms=None)
    if library is not None:
        out.update(library_ms=library["device_ms"] or library["call_ms"],
                   library_call_ms=library["call_ms"],
                   library_kernel=library["top_kernel"])
    return out


def reps_for(fn, budget_ms: float = 100.0) -> int:
    """Enough back-to-back calls to fill about ``budget_ms``, 3 to 200."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return int(min(200, max(3, budget_ms / max(start.elapsed_time(end),
                                               1e-3))))


def tensor_core_call(w: Workload) -> bool:
    """Whether the workload's call runs a tensor-core kernel on the card
    (bf16, float16 and int8 products, bf16 and float16 attention up to
    hd 256)."""
    mod = MODULES[w.kernel]
    if not hasattr(mod, "uses_tensor_cores"):
        return False
    dt = DTYPES[w.shape["dtype"]]
    if w.kernel == "flash_attention":
        return mod.uses_tensor_cores(dt, w.shape["hd"])
    return mod.uses_tensor_cores(dt)


COUNTERS = ("launch_count", "tc_launch_count")


def launches_per_call(kernel: str, shape: Optional[dict] = None) -> int:
    """Kernel launches of one call of the workload's kernel module: one,
    the SSD scan's four, or, for an FFT of more than 16384 points
    (``shape["n"]``), its stage passes, transform and gather."""
    if kernel == "spm_fft" and shape is not None:
        return sf.launches_for(shape["n"])
    return getattr(MODULES[kernel], "LAUNCHES_PER_CALL", 1)


def device_names(kernel: str) -> Tuple[str, ...]:
    """The device names of the module's kernels, as the profiler sees
    them (each a substring of the event's name; the FFT's ``spm_fft_``
    covers its stage and gather kernels too)."""
    parts = getattr(MODULES[kernel], "PARTS", None)
    if parts:
        return tuple(f"{p}_kernel" for p in parts)
    return ("spm_fft_",) if kernel == "spm_fft" else (f"{kernel}_kernel",)


def save_counts() -> dict:
    """Every kernel module's launch counters (and the SSD scan's by
    kernel), to set back with :func:`restore_counts`."""
    return {name: ({c: getattr(mod, c) for c in COUNTERS if hasattr(mod, c)},
                   dict(getattr(mod, "part_launches", {})))
            for name, mod in MODULES.items()}


def restore_counts(saved: dict) -> None:
    for name, (counts, parts) in saved.items():
        mod = MODULES[name]
        for c, n in counts.items():
            setattr(mod, c, n)
        if parts:
            mod.part_launches.update(parts)


def reset_counts() -> None:
    """Every kernel module's launch counters to 0."""
    restore_counts({name: ({c: 0 for c in counts}, dict.fromkeys(parts, 0))
                    for name, (counts, parts) in save_counts().items()})


def time_workload(w: Workload, x: dict) -> dict:
    """Kernel, plain and library times of one workload, beside its
    bound; ``path`` names the kernel that ran. A tensor-core product
    also times its operand glue (``tc_operands``: padding, and int8's
    transposed B) as ``glue_ms`` (device; None where it launches
    nothing) and ``glue_call_ms``: the kernel's ``ms`` leaves it out,
    its ``call_ms`` holds it. The kernel's launch counters are restored
    afterwards: timing launches are not the main path's."""
    saved = save_counts()
    kern = lambda: run_kernel(w, x)                         # noqa: E731
    plain = lambda: run_plain(w, x)                         # noqa: E731
    lib = library_call(w, x)
    k = timed(kern, reps_for(kern), device_names(w.kernel))
    t = times(k, timed(plain, reps_for(plain)),
              None if lib is None else timed(lib, reps_for(lib)))
    if "device_ms_by" in k:
        t["device_ms_by"] = k["device_ms_by"]
    restore_counts(saved)
    t["path"] = "tensor cores" if tensor_core_call(w) else "CUDA cores"
    if w.kernel == "spm_matmul" and tensor_core_call(w):
        glue = lambda: sm.tc_operands(x["a"], x["b"])       # noqa: E731
        g = timed(glue, reps_for(glue))
        t.update(glue_ms=g["device_ms"], glue_call_ms=g["call_ms"])
    return dict(t, **bound(*cost(w)))


def time_kernel(w: Workload, x: dict) -> dict:
    """The kernel's device and call times alone, beside its bound; the
    launch counters restored afterwards."""
    saved = save_counts()
    kern = lambda: run_kernel(w, x)                         # noqa: E731
    k = timed(kern, reps_for(kern), device_names(w.kernel))
    restore_counts(saved)
    return dict(ms=k["device_ms"] or k["call_ms"],
                ms_source="profiler" if k["device_ms"] else "events",
                call_ms=k["call_ms"], **bound(*cost(w)))


#: ``ssd_scan.ssd_train`` at the benchmark cell's row: mamba2-1.3b at 8 x
#: 4096 tokens (configs/mamba2_1_3b.py), bf16 activations and B and C per
#: group as the zoo makes them, chunk 256
SSD_TRAIN_CELL = dict(Bz=8, S=4096, H=64, P=64, N=128, G=1, chunk=256,
                      dtype="bfloat16")
#: the device names of ``ssd_train``'s kernels: the forward's (the op's),
#: then the backward's own (its chunk terms and reverse pass run the
#: forward's chunk-state and state-pass kernels again)
SSD_TRAIN_KERNELS = tuple(f"{p}_kernel" for p in ss.PARTS)
SSD_BWD_KERNELS = ("ssd_bwd_dx_kernel", "ssd_bwd_ds_kernel",
                   "ssd_bwd_dbc_kernel", "ssd_bwd_dcum_kernel")


def time_ssd_train(s: dict, rng: np.random.Generator, device) -> dict:
    """``ssd_train``'s forward (without autograd, as remat's first pass
    runs it) and its forward and backward under autograd at ``s``, each
    beside the plain layer's (``models.ssm.ssd_chunked_plain``, what
    ``ssd_chunked`` runs on CPU tensors) and its bound (the parts' costs
    of :func:`ssd_part_costs` summed), with device ms by kernel; the
    backward is their difference. Launch counters set back."""
    from repro_torch.models.ssm import ssd_chunked_plain
    saved = save_counts()
    dt_ = DTYPES[s["dtype"]]
    ops = checks.ssd_train_operands(rng, s["Bz"], s["S"], s["H"], s["P"],
                                    s["N"], s["G"], device, dt_, dt_)
    ins, dy = tuple(t.requires_grad_(True) for t in ops[:5]), ops[6]
    costs = ssd_part_costs(s)

    def forward(fn):
        def run():
            with torch.no_grad():
                fn(*ins, chunk=s["chunk"])
        return run

    def forward_backward(fn):
        def run():
            y, _ = fn(*ins, chunk=s["chunk"])
            torch.autograd.grad(y, ins, dy)
        return run

    def summed(parts):
        return bound(sum(costs[p][0] for p in parts),
                     [(sum(costs[p][1][0][0] for p in parts), "fp32")])

    out = {}
    for label, wrap, names, parts in (
            ("forward", forward, SSD_TRAIN_KERNELS, ss.PARTS),
            ("forward_backward", forward_backward,
             SSD_TRAIN_KERNELS + SSD_BWD_KERNELS,
             ss.PARTS + ss.BWD_PARTS)):
        kern, plain = wrap(ss.ssd_train), wrap(ssd_chunked_plain)
        k = timed(kern, reps_for(kern), names)
        out[label] = dict(times(k, timed(plain, reps_for(plain))),
                          device_ms_by=k["device_ms_by"], **summed(parts))
    f, fb = out["forward"], out["forward_backward"]
    out["backward"] = dict(ms=fb["ms"] - f["ms"],
                           plain_ms=fb["plain_ms"] - f["plain_ms"],
                           **summed(ss.BWD_PARTS))
    restore_counts(saved)
    return out


#: ``kernels.selective_scan`` at the benchmark cell's shape: hymba-1.5b at
#: 8 x 1024 tokens and 128 meta tokens (configs/hymba_1_5b.py), bf16 u, B
#: and C, float32 dt, as the zoo's mixer gives them
SELECTIVE_SCAN_CELL = dict(Bz=8, S=1152, d=3200, N=16, dtype="bfloat16")
#: the H100 SXM's exponentials a second: 16 SFU results a clock on each of
#: its 132 SMs (the CUDA programming guide's throughput table, compute
#: capability 9.0) at its 1,980 MHz boost clock (NVIDIA's data sheet)
EXP_PER_S = 132 * 16 * 1.98e9


def selective_scan_costs(s: dict) -> Dict[str, Dict[str, float]]:
    """Each direction's compulsory bytes (every input read once, every
    output written once, in the types the cell gives them: u, B, C and the
    gradients of u, B and C in ``s["dtype"]``, dt, A, y, the states and
    the other gradients float32; no initial state) and exponentials (B S
    d N a walk: the forward needs one, the backward at least one), beside
    the bound they set."""
    Bz, S, d, N = s["Bz"], s["S"], s["d"], s["N"]
    act = torch.tensor([], dtype=DTYPES[s["dtype"]]).element_size()
    sd, sn, a = Bz * S * d, Bz * S * N, d * N * 4
    fwd = sd * (act + 4) + 2 * sn * act + a + sd * 4 + Bz * d * N * 4
    bwd = (sd * (act + 4) + 2 * sn * act + a + sd * 4 + Bz * d * N * 4
           + sd * (act + 4) + 2 * sn * act + a)
    exps = Bz * S * d * N
    out = {}
    for label, nbytes in (("forward", fwd), ("backward", bwd),
                          ("forward_backward", fwd + bwd)):
        walks = 2 if label == "forward_backward" else 1
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        exp_ms = walks * exps / EXP_PER_S * 1e3
        out[label] = dict(bytes=nbytes, exps=walks * exps, bytes_ms=bytes_ms,
                          exp_ms=exp_ms, bound_ms=max(bytes_ms, exp_ms),
                          bound_by="bytes" if bytes_ms >= exp_ms
                          else "exponentials")
    return out


def time_selective_scan(s: dict, rng: np.random.Generator, device) -> dict:
    """The Mamba-1 scan at ``s``: the forward (no checkpoints, as remat's
    first pass and prefill run it), the forward and the backward from its
    checkpoints (the backward their difference), each beside the plain
    ``models.ssm._SelectiveScan`` (chunk 4, under autograd) and
    :func:`selective_scan_costs`' bound; device ms from the profiler by
    kernel. Launch counters set back."""
    from repro_torch.kernels import selective_scan as sk
    from repro_torch.models import ssm
    saved = dict(sk.part_launches), sk.launch_count
    u, dt, A, B, C, _, gy, _ = checks.selective_scan_operands(
        rng, s["Bz"], s["S"], s["d"], s["N"], device, DTYPES[s["dtype"]])
    ins = tuple(t.detach().clone().requires_grad_(True)
                for t in (u, dt, A, B, C))
    costs = selective_scan_costs(s)
    names = tuple(f"{p}_kernel" for p in sk.PARTS + sk.BWD_PARTS)

    def forward():
        sk.scan_forward(u, dt, A, B, C, None, False)

    def both():
        _, _, ck = sk.scan_forward(u, dt, A, B, C, None, True)
        sk.scan_backward(u, dt, A, B, C, ck, gy, None, False)

    def plain_forward():
        with torch.no_grad():
            ssm._SelectiveScan.apply(u, dt, A, B, C, None, 4)

    def plain_both():
        y, _ = ssm._SelectiveScan.apply(*ins, None, 4)
        torch.autograd.grad(y, ins, gy)

    out = {"tiling": sk.TILINGS[sk.tiling_for(s["N"])]}
    for label, fn, plain in (("forward", forward, plain_forward),
                             ("forward_backward", both, plain_both)):
        k = timed(fn, reps_for(fn), names)
        p = timed(plain, reps_for(plain))
        out[label] = dict(ms=k["device_ms"] or k["call_ms"],
                          call_ms=k["call_ms"],
                          device_ms_by=k["device_ms_by"],
                          plain_ms=p["device_ms"] or p["call_ms"],
                          plain_call_ms=p["call_ms"], **costs[label])
    f, fb = out["forward"], out["forward_backward"]
    out["backward"] = dict(ms=fb["ms"] - f["ms"],
                           plain_ms=fb["plain_ms"] - f["plain_ms"],
                           **costs["backward"])
    sk.part_launches.update(saved[0])
    sk.launch_count = saved[1]
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="",
                    help="comma-separated parts of workload names to run "
                         "(default: every workload)")
    ap.add_argument("--kernel-only", action="store_true",
                    help="time the kernel alone (no plain version, no "
                         "library call)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("micro: no CUDA device available; the microbenchmarks run on "
              "the card only", file=sys.stderr)
        return 2
    device = resolve_device(None)
    card_settings()
    card = card_line()
    rng = np.random.default_rng(args.seed)
    parts = [p for p in args.only.split(",") if p]
    for w in REFERENCE + CARD:
        if parts and not any(p in w.name for p in parts):
            continue
        x = make_inputs(w, rng, device)
        err = compare_plain(w, x, run_kernel(w, x))
        t = time_kernel(w, x) if args.kernel_only else time_workload(w, x)
        rec = dict(name=w.name, kernel=w.kernel, shape=w.shape, use=w.use,
                   max_abs_err_vs_plain=err, **t)
        print(json.dumps(rec) + f"; card: {card}")
        del x
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
