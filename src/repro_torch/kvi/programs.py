"""The paper's three computation kernels, authored ONCE as KVI programs.

Each builder returns a backend-neutral :class:`~repro_torch.kvi.ir.KviProgram`;
run it on any registered backend::

    prog = conv2d_program(img, filt, shift=4)
    get_backend("torch").run(prog)       # fused CUDA kernels

This is the PyTorch port's copy of ``repro.kvi.programs``: the builders
emit the same items, vregs, buffers and ``mem_init`` as the reference's,
so both packages run the same programs.

Kernels (paper §PERFORMANCE RESULTS): 2D convolution (3x3..11x11 filters,
zero padding, fixed-point post-scaling), radix-2 DIF FFT-256 (Q15
twiddles, contiguous-half butterflies, final bit-reversal), MatMul 64x64
(row-vector accumulation resident / kdotp-streamed). 32-bit fixed point
throughout, as in the paper.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.kvi.backend import BackendResult
from repro_torch.kvi.ir import KviProgram, KviProgramBuilder, np_dtype

# ---------------------------------------------------------------------------
# 2D convolution, FxF filter, zero padding, fixed-point post-scale
# ---------------------------------------------------------------------------


def conv2d_program(img: np.ndarray, filt: np.ndarray,
                   shift: int = 0, elem_bytes: int = 4) -> KviProgram:
    """``elem_bytes`` selects the sub-word precision (4/2/1 for
    32/16/8-bit fixed point); narrow elements pack more SIMD lanes per
    SPM bank on hardware with sub-word support (config.subword_bits)."""
    S = img.shape[0]
    F = filt.shape[0]
    pad = F // 2
    Sp = S + 2 * pad
    padded = np.zeros((Sp, Sp), np_dtype(elem_bytes))
    padded[pad:pad + S, pad:pad + S] = img
    b = KviProgramBuilder(f"conv{S}x{S}_f{F}")
    hin = b.mem_in("img", padded, elem_bytes=elem_bytes)
    rin = b.vreg("in", Sp * Sp, elem_bytes=elem_bytes)
    acc = b.vreg("acc", S, elem_bytes=elem_bytes)
    tmp = b.vreg("tmp", S, elem_bytes=elem_bytes)
    b.scalar(40)                                  # kernel prologue
    b.kmemld(rin, hin)
    for i in range(S):
        b.scalar(6)                               # row loop bookkeeping
        first = True
        for fr in range(F):
            for fc in range(F):
                w = int(filt[fr, fc])
                src = rin.view((i + fr) * Sp + fc, S)
                b.scalar(3)
                if first:
                    b.ksvmulsc(acc, src, scalar=w)
                    first = False
                else:
                    b.ksvmulsc(tmp, src, scalar=w)
                    b.kaddv(acc, acc, tmp)
        if shift:
            b.ksrav(acc, acc, scalar=shift)
        hrow = b.mem_out(f"row{i}", S, elem_bytes=elem_bytes)
        b.kmemstr(hrow, acc)
    return b.build(alg_ops=2 * S * S * F * F, kind="conv2d", S=S, F=F,
                   shift=shift, elem_bytes=elem_bytes)


def conv2d_result(res: BackendResult, S: Optional[int] = None) -> np.ndarray:
    rows = sorted(((k, v) for k, v in res.outputs.items()
                   if k.startswith("row")),
                  key=lambda kv: int(kv[0][3:]))
    return np.stack([v for _, v in rows], axis=0)


# ---------------------------------------------------------------------------
# MatMul. Two code paths, chosen by SPM capacity exactly as a programmer
# would (paper: a 64x64 int32 B [16 KiB] does NOT fit the 3x4 KiB
# scratchpads and must be streamed):
#   * resident: B held in SPM, row-vector accumulation (ksvmulsc + kaddv)
#   * streamed: A rows resident, B^T columns streamed per output element,
#     kdotp per element (vector MAC through the multiplier + adder tree)
# ---------------------------------------------------------------------------


def matmul_program(A: np.ndarray, B: np.ndarray, shift: int = 0,
                   resident: Optional[bool] = None,
                   spm_bytes: Optional[int] = None,
                   elem_bytes: int = 4) -> KviProgram:
    n, m = A.shape
    _, p = B.shape
    dt = np_dtype(elem_bytes)
    if resident is None:
        cap = spm_bytes if spm_bytes is not None else 4 * 4 * 1024
        resident = (m * p + 2 * p + n) * elem_bytes <= cap
    b = KviProgramBuilder(f"matmul{n}x{p}")

    if resident:
        hB = b.mem_in("B", B.astype(dt), elem_bytes=elem_bytes)
        rB = b.vreg("B", m * p, elem_bytes=elem_bytes)
        acc = b.vreg("acc", p, elem_bytes=elem_bytes)
        tmp = b.vreg("tmp", p, elem_bytes=elem_bytes)
        b.scalar(40)                              # kernel prologue
        b.kmemld(rB, hB)
        for i in range(n):
            b.scalar(3)                           # row loop bookkeeping
            for k in range(m):
                b.scalar(2)                       # a-scalar load + addr bump
                aik = int(A[i, k])
                row = rB.view(p * k, p)
                if k == 0:
                    b.ksvmulsc(acc, row, scalar=aik)
                else:
                    b.ksvmulsc(tmp, row, scalar=aik)
                    b.kaddv(acc, acc, tmp)
            if shift:
                b.ksrav(acc, acc, scalar=shift)
            hrow = b.mem_out(f"row{i}", p, elem_bytes=elem_bytes)
            b.kmemstr(hrow, acc)
        return b.build(alg_ops=2 * n * m * p, kind="matmul", n=n, p=p,
                       shift=shift, resident=True, elem_bytes=elem_bytes)

    # streamed path: per output element, kdotp(A_row, B_col)
    Bt = np.ascontiguousarray(B.astype(dt).T)
    arow = b.vreg("arow", m, elem_bytes=elem_bytes)
    bcol = b.vreg("bcol", m, elem_bytes=elem_bytes)
    acc = b.vreg("acc", p, elem_bytes=elem_bytes)
    b.scalar(40)                                  # kernel prologue
    for i in range(n):
        b.scalar(3)
        hA = b.mem_in(f"arow{i}", A[i].astype(dt), elem_bytes=elem_bytes)
        b.kmemld(arow, hA)
        for j in range(p):
            b.scalar(3)                           # col pointer, loop, store rd
            hcol = b.mem_in(f"bcol{i}_{j}", Bt[j], elem_bytes=elem_bytes)
            b.kmemld(bcol, hcol)
            if shift:
                b.kdotpps(acc[j], arow, bcol, shift)
            else:
                b.kdotp(acc[j], arow, bcol)
            # register-file result written to acc[j]: one scalar store
            b.scalar(1)
        hrow = b.mem_out(f"row{i}", p, elem_bytes=elem_bytes)
        b.kmemstr(hrow, acc)
    return b.build(alg_ops=2 * n * m * p, kind="matmul", n=n, p=p,
                   shift=shift, resident=False, elem_bytes=elem_bytes)


def matmul_result(res: BackendResult, n: Optional[int] = None) -> np.ndarray:
    return conv2d_result(res)


# ---------------------------------------------------------------------------
# FFT-256: radix-2 DIF, contiguous-half butterflies, Q15 twiddles,
# final bit-reversal (element copies — deliberately DLP-unfriendly,
# matching the paper's observation that FFT gains come from TLP).
# ---------------------------------------------------------------------------

Q = 15

# twiddle Q-format per element width: Q15 products fit int32; narrower
# fixed-point uses a correspondingly narrower fraction (Q7/Q3) so the
# sub-word sweep's programs stay executable end to end
_Q_BY_WIDTH = {4: 15, 2: 7, 1: 3}


def _twiddles(m: int, q: int = Q, dtype=np.int32) -> tuple:
    k = np.arange(m // 2)
    w = np.exp(-2j * np.pi * k / m)
    return ((w.real * (1 << q)).astype(dtype),
            (w.imag * (1 << q)).astype(dtype))


def fft_program(x_re: np.ndarray, x_im: np.ndarray,
                elem_bytes: int = 4) -> KviProgram:
    n = len(x_re)
    assert n & (n - 1) == 0
    dt = np_dtype(elem_bytes)
    q = _Q_BY_WIDTH[elem_bytes]
    b = KviProgramBuilder(f"fft{n}")
    hre = b.mem_in("x_re", x_re.astype(dt), elem_bytes=elem_bytes)
    him = b.mem_in("x_im", x_im.astype(dt), elem_bytes=elem_bytes)

    def vreg(name, length):
        return b.vreg(name, length, elem_bytes=elem_bytes)

    are = vreg("re", n)
    aim = vreg("im", n)
    t1 = vreg("t1", n // 2)
    t2 = vreg("t2", n // 2)
    dre = vreg("dre", n // 2)
    dim = vreg("dim", n // 2)
    # per-size twiddle vectors, loaded once
    tw = {}
    m = n
    while m >= 2:
        wre, wim = _twiddles(m, q, dt)
        rr = vreg(f"wre{m}", m // 2)
        ri = vreg(f"wim{m}", m // 2)
        b.kmemld(rr, b.mem_in(f"wre{m}", wre, elem_bytes=elem_bytes))
        b.kmemld(ri, b.mem_in(f"wim{m}", wim, elem_bytes=elem_bytes))
        tw[m] = (rr, ri)
        m //= 2
    b.scalar(40)                                  # kernel prologue
    b.kmemld(are, hre)
    b.kmemld(aim, him)

    def butterfly(base: int, m: int):
        """DIF butterfly on the contiguous block [base, base+m)."""
        h = m // 2
        lo_re, hi_re = are.view(base, h), are.view(base + h, h)
        lo_im, hi_im = aim.view(base, h), aim.view(base + h, h)
        wre, wim = tw[m]
        th1, th2 = t1[:h], t2[:h]
        vdre, vdim = dre[:h], dim[:h]
        b.scalar(6)
        # d = lo - hi (complex), top = lo + hi
        b.ksubv(vdre, lo_re, hi_re)
        b.ksubv(vdim, lo_im, hi_im)
        b.kaddv(lo_re, lo_re, hi_re)
        b.kaddv(lo_im, lo_im, hi_im)
        # hi = d * w  (Q-format fixed point)
        b.kvmul(th1, vdre, wre)
        b.ksrav(th1, th1, scalar=q)
        b.kvmul(th2, vdim, wim)
        b.ksrav(th2, th2, scalar=q)
        b.ksubv(hi_re, th1, th2)
        b.kvmul(th1, vdre, wim)
        b.ksrav(th1, th1, scalar=q)
        b.kvmul(th2, vdim, wre)
        b.ksrav(th2, th2, scalar=q)
        b.kaddv(hi_im, th1, th2)

    m = n
    while m >= 2:
        for base in range(0, n, m):
            butterfly(base, m)
        m //= 2

    # bit-reversal reorder via element copies (vector length 1)
    nb = int(np.log2(n))
    out_re = vreg("out_re", n)
    out_im = vreg("out_im", n)
    for i in range(n):
        j = int(f"{i:0{nb}b}"[::-1], 2)
        b.scalar(2)
        b.kvcp(out_re[j], are[i])
        b.kvcp(out_im[j], aim[i])
    ore = b.mem_out("out_re", n, elem_bytes=elem_bytes)
    oim = b.mem_out("out_im", n, elem_bytes=elem_bytes)
    b.kmemstr(ore, out_re)
    b.kmemstr(oim, out_im)
    return b.build(alg_ops=10 * (n // 2) * nb, kind="fft", n=n,
                   elem_bytes=elem_bytes)


def fft_result(res: BackendResult) -> np.ndarray:
    return (res.outputs["out_re"].astype(np.float64) +
            1j * res.outputs["out_im"].astype(np.float64))


# ---------------------------------------------------------------------------
# Pipeline stress kernel: the shape of naively-generated code — staged
# element-wise chains stitched with whole-register kvcp moves (fusion
# breakers) and speculative products nothing consumes (dead code). The
# optimizing pass pipeline collapses it to one fused chain; used by
# benchmarks/bench_kvi_passes.py and the pass tests.
# ---------------------------------------------------------------------------


def pipeline_demo_program(x: np.ndarray, stages: int = 4) -> KviProgram:
    """``stages`` rounds of ``t = relu(3 * (v + v)); v = copy(t)`` plus a
    dead ``t * t`` per round. Unoptimized: every ``kvcp`` cuts the
    element-wise chain (one extra fused kernel launch per stage on the
    torch backend, an SPM copy on the hardware model) and the dead
    products burn MFU cycles. Optimized: one fused region, no copies, no
    dead work — bit-identical outputs."""
    n = int(x.size)
    b = KviProgramBuilder(f"pipeline_demo{n}x{stages}")
    hx = b.mem_in("x", x.astype(np.int32))
    v = b.vreg("v0", n)
    b.scalar(10)                                  # kernel prologue
    b.kmemld(v, hx)
    for s in range(stages):
        b.scalar(4)                               # stage bookkeeping
        t = b.vreg(f"t{s}", n)
        b.kaddv(t, v, v)
        b.ksvmulsc(t, t, scalar=3)
        b.krelu(t, t)
        dead = b.vreg(f"dead{s}", n)
        b.kvmul(dead, t, t)                       # never observed
        nv = b.vreg(f"v{s + 1}", n)
        b.kvcp(nv, t)                             # full-register move
        v = nv
    hy = b.mem_out("y", n)
    b.kmemstr(hy, v)
    return b.build(alg_ops=3 * n * stages, kind="pipeline_demo",
                   n=n, stages=stages)


def pipeline_demo_oracle(x: np.ndarray, stages: int = 4) -> np.ndarray:
    v = x.astype(np.int64)
    for _ in range(stages):
        v = np.maximum((v + v) * 3, 0)
    return v.astype(np.int32)
