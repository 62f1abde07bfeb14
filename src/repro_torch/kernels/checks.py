"""Kernel-against-plain-version checks, shared by ``chip_smoke.py`` and
the card tests (``tests/test_torch_cuda.py``).

Each check builds random operands with numpy from a seed, runs the
kernel's wrapper and its plain PyTorch version on the same tensors of
one device, and raises ``AssertionError`` unless the two agree — bit for
bit for integers, within the stated tolerance for floats. On a CPU
device both sides are the plain version, which is how the CPU tests keep
these helpers themselves honest. The ``compare_*`` helpers hold an
output the caller already has (a main-path run's) against the plain
version on the same inputs.

Float tolerances are error bounds, not fitted numbers. A float32 sum of
k terms lies within ``gamma(k) * sum(|terms|)`` of the exact sum
(``gamma(k) = k u / (1 - k u)``, u = 2^-24), whatever the order, so two
sums in different orders lie within twice that; the composite's conv
hart (k = F^2) is held to it. For a matmul that worst case grows as K u and would pass a TF32
product at K in the thousands, so products are held to a probabilistic
bound instead (:func:`dot_tolerance`). A bf16 output adds up to one bf16
step (2^-7 relative) between two roundings. An FFT stage adds at most
~4 u times the row's L1 norm (which bounds every intermediate), so
log2(n) stages in two implementations stay within ``8 log2(n) u L1``.
conv2d and the FFT round every operation as their plain versions do, so
on the card they are expected to agree exactly: ``spm_conv2d`` is held to
that, in every dtype; for the FFT and the composite the bound is what is
enforced, and the returned maximum shows the rest.

Attention and the SSD scan are held to a worst-case bound relative to
the sum of absolute terms (:func:`attention_tolerance`,
:func:`ssd_tolerance`), capped at the JAX tests' own tolerance for these
kernels (``tests/kernels/test_kernels.py``: rtol = atol = 2e-3 for
attention, 3e-3 for the SSD scan), so the card check is never looser
than the CPU one; a bf16 output adds one bf16 step.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_vops as fv
from repro_torch.kernels import het_mimd as hm
from repro_torch.kernels import kdotp as kd
from repro_torch.kernels import kvi_walk as kw
from repro_torch.kernels import ops
from repro_torch.kernels import spm_conv2d as sc
from repro_torch.kernels import spm_fft as sf
from repro_torch.kernels import spm_matmul as sm
from repro_torch.kernels import ssd_scan as ss

_NP = {torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32,
       torch.float32: np.float32, torch.uint8: np.uint8}
U32 = 2.0 ** -24                   # float32 unit roundoff
BF16_STEP = 2.0 ** -7              # bf16 spacing relative to the value
F16_STEP = 2.0 ** -10              # float16 spacing relative to the value
LAMBDA = 4.0                       # standard deviations of one sum's error


def random_ints(rng: np.random.Generator, shape, dtype: torch.dtype,
                device) -> torch.Tensor:
    """Full-range random integers of ``dtype`` (so products and sums
    overflow), on ``device``."""
    info = np.iinfo(_NP[dtype])
    return torch.from_numpy(rng.integers(info.min, info.max + 1, shape,
                                         dtype=np.int64).astype(_NP[dtype])
                            ).to(device)


def random_slot_program(rng: np.random.Generator, n_in: int, n_ops: int,
                        dtype: torch.dtype, wide_imm: bool = True
                        ) -> Tuple[tuple, tuple, tuple, int]:
    """A random slot program using every one of the 11 ops (when
    ``n_ops >= 11``): ``(program, in_slots, out_slots, n_slots)``. Some
    ops overwrite an earlier slot, as ``acc = acc + tmp`` does. With
    ``wide_imm`` immediates span int64 (wrapped by add/mul, compared
    exactly by ksvslt); otherwise they fit the element type, which is
    what the reference Pallas kernel accepts (uint8: 0 .. 255)."""
    bits = 8 * torch.empty((), dtype=dtype).element_size()
    ops = list(fv.OPCODES)
    ops += [str(o) for o in rng.choice(ops, max(0, n_ops - len(ops)))]
    ops = [ops[i] for i in rng.permutation(len(ops))][:n_ops]
    lo, hi = (-(1 << 40), 1 << 40) if wide_imm else (
        (0, 1 << bits) if dtype == torch.uint8 else
        (-(1 << (bits - 1)), 1 << (bits - 1)))
    defined = list(range(n_in))
    n_slots = n_in
    written: List[int] = []
    program = []
    for op in ops:
        s1 = int(rng.choice(defined))
        s2 = int(rng.choice(defined)) if op in fv.TWO_SOURCE else None
        if op in ("ksrlv", "ksrav"):
            imm = int(rng.integers(0, bits + 3))
        elif op in ("ksvaddsc", "ksvmulsc", "ksvslt"):
            imm = int(rng.integers(lo, hi))
        else:
            imm = 0
        if written and rng.random() < 0.3:
            d = int(rng.choice(written))
        else:
            d = n_slots
            n_slots += 1
            defined.append(d)
        if d not in written:
            written.append(d)
        program.append((op, d, s1, s2, imm))
    return tuple(program), tuple(range(n_in)), tuple(written), n_slots


def check_fused(rng: np.random.Generator, dtype: torch.dtype, rows: int,
                n: int, device, n_in: int = 6, n_ops: int = 40,
                hazard: bool = False) -> int:
    """Run a random slot program in place on a ``(rows, width)`` register
    file through :func:`fused_vops.fused_vops` and through
    :func:`fused_vops.fused_vops_plain`; raise unless the two files are
    identical. ``hazard`` places the first output window half a window
    after the first input window (overlapping, other offset). Returns
    the largest absolute difference (0)."""
    program, in_slots, out_slots, n_slots = random_slot_program(
        rng, n_in, n_ops, dtype)
    n_out = len(out_slots)
    in_cols = [k * n for k in range(n_in)]
    out_cols = [(n_in + k) * n for k in range(n_out)]
    if hazard:
        out_cols[0] = n // 2
    width = (n_in + n_out) * n + n
    regfile = random_ints(rng, (rows, width), dtype, device)
    record = fv.pack_program(program, in_slots, out_slots, n_slots,
                             torch.device(device))
    win = fv.Windows(in_cols, out_cols, n)
    assert win.hazard == hazard
    got, want = regfile.clone(), regfile.clone()
    fv.fused_vops(record, win, got, got)
    fv.fused_vops_plain(record, win, want, want)
    return _require_equal("fused_vops", got, want)


def check_reduce(rng: np.random.Generator, dtype: torch.dtype, rows: int,
                 n: int, device, *, dot: bool = True, post: int = kd.POST_NONE,
                 scalar: int = 0, mode: int = kd.ORACLE,
                 out_dtype: Optional[torch.dtype] = None) -> float:
    """Reduce random ``(rows, n)`` column windows of a wider tensor into
    one column of a register file, through :func:`kdotp.reduce_rows` and
    :func:`kdotp.reduce_rows_plain`. Integers must agree bit for bit;
    float32 within rtol 1e-5 of the sum of absolute terms (the two sum
    in different orders). Returns the largest absolute difference."""
    out_dtype = out_dtype or (torch.float32 if dtype == torch.float32
                              else torch.int32)
    if dtype == torch.float32:
        src = torch.from_numpy(rng.uniform(-1, 1, (rows, 3 * n + 5))
                               .astype(np.float32)).to(device)
    else:
        src = random_ints(rng, (rows, 3 * n + 5), dtype, device)
    a, b = src[:, 3:3 + n], (src[:, 2 * n + 5:] if dot else None)
    regfile = torch.zeros((rows, 7), dtype=out_dtype, device=device)
    got, want = regfile.clone(), regfile.clone()
    kd.reduce_rows(got[:, 4], a, b, post=post, scalar=scalar, mode=mode)
    kd.reduce_rows_plain(want[:, 4], a, b, post=post, scalar=scalar,
                         mode=mode)
    if dtype != torch.float32:
        return _require_equal("kdotp", got, want)
    terms = (a * b if dot else a).abs().sum(dim=1).max().item()
    err = (got - want).abs().max().item()
    if not err <= 1e-5 * terms:
        raise AssertionError(f"kdotp float32 differs by {err} "
                             f"(allowed {1e-5 * terms})")
    return err


def check_overflow_kdotpps(device) -> None:
    """64 elements, a = 2^20, b = 2^10, shift 8: the exact sum 2^36
    shifted is 2^28 (oracle mode); wrapped to int32 first it is 0 (the
    reference Pallas kernel's order)."""
    a = torch.full((1, 64), 1 << 20, dtype=torch.int32, device=device)
    b = torch.full((1, 64), 1 << 10, dtype=torch.int32, device=device)
    for mode, want in ((kd.ORACLE, 1 << 28), (kd.WRAP32, 0)):
        for fn in (kd.reduce_rows, kd.reduce_rows_plain):
            out = torch.empty((1,), dtype=torch.int32, device=device)
            fn(out, a, b, post=kd.POST_SHIFT, scalar=8, mode=mode)
            if out.item() != want:
                raise AssertionError(f"{fn.__name__} mode {mode}: "
                                     f"{out.item()} != {want}")


def _require_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[:5].tolist()
        raise AssertionError(f"{name} kernel differs from its plain version "
                             f"at {bad}")
    return 0


def main_path_cases() -> Sequence[Tuple[str, dict]]:
    """The (rows, n) shapes the slice's main path gives each kernel:
    conv2d 32x32 rows (n = 32), FFT-256 butterflies (n = 128 down to 1)
    and pipeline_demo (n = 1024) over N = 1024 instances; kdotp rows of
    the streamed 64x64 matmul (n = 64) over N = 128."""
    return (("fused conv32", dict(rows=1024, n=32)),
            ("fused fft256", dict(rows=1024, n=128)),
            ("fused fft256 tail", dict(rows=1024, n=1)),
            ("fused pipeline_demo", dict(rows=1024, n=1024)),
            ("kdotp matmul64", dict(rows=128, n=64)))


# ---------------------------------------------------------------------------
# the KVI walk kernel (kvi_walk): programs, and the kernel against its plain
# version on one packed table
# ---------------------------------------------------------------------------

NP_OF_EB = {1: np.int8, 2: np.int16, 4: np.int32}
RED_OPS = ("kdotp", "kdotpps", "kvred", "ksvaddrf", "ksvmulrf")


def random_kvi_program(program_cls, rng: np.random.Generator, eb: int,
                       n_items: int = 40, L: int = 16):
    """Random element-wise / reduction / copy traffic over overlapping
    windows of a few registers of ``eb``-byte lanes, every register
    stored at the end. ``program_cls`` is a ``KviProgramBuilder`` (the
    port's, or the reference's in the tests)."""
    info = np.iinfo(NP_OF_EB[eb])
    b = program_cls("rand")
    regs = [b.vreg(f"r{k}", L, eb) for k in range(4)]
    for k in range(2):
        b.kmemld(regs[k], b.mem_in(f"in{k}", rng.integers(
            info.min, info.max + 1, L).astype(NP_OF_EB[eb]), elem_bytes=eb))

    def win(n):
        r = regs[int(rng.integers(len(regs)))]
        off = int(rng.integers(0, L - n + 1))
        return r.view(off, n)

    ops = ("kaddv", "ksubv", "kvmul", "kvslt", "ksvaddsc", "ksvmulsc",
           "ksrlv", "ksrav", "krelu", "ksvslt", "kvcp") + RED_OPS
    for _ in range(n_items):
        op = str(rng.choice(ops))
        n = int(rng.choice([4, 8, 16]))
        big = int(rng.integers(-(1 << 40), 1 << 40))
        if op in ("kaddv", "ksubv", "kvmul", "kvslt"):
            getattr(b, op)(win(n), win(n), win(n))
        elif op in ("ksvaddsc", "ksvmulsc"):
            getattr(b, op)(win(n), win(n), big)
        elif op == "ksvslt":
            b.ksvslt(win(n), win(n), int(rng.integers(-(1 << 31), 1 << 31)))
        elif op in ("ksrlv", "ksrav"):
            getattr(b, op)(win(n), win(n), int(rng.integers(0, 40)))
        elif op in ("krelu", "kvcp"):
            getattr(b, op)(win(n), win(n))
        elif op in ("kdotp", "kdotpps"):
            args = (win(1), win(n), win(n))
            b.kdotp(*args) if op == "kdotp" else b.kdotpps(
                *args, int(rng.integers(0, 70)))
        elif op == "kvred":
            b.kvred(win(1), win(n))
        else:
            getattr(b, op)(win(1), win(n), big)
        b.scalar(int(rng.integers(0, 3)))
    for k, r in enumerate(regs):
        b.kmemstr(b.mem_out(f"out{k}", L, elem_bytes=eb), r)
    return b.build()


def walk_edge_programs(program_cls, rng: np.random.Generator,
                       big_lanes: int = 30000) -> dict:
    """Programs at the walk's hard spots, by name: overlapping ``kvcp``
    (both directions, shorter and longer than a block), a hazard region
    (an output window over an input window at another offset), a
    ``kmemld`` after a ``kmemstr`` of the same buffer, unsigned and
    64-bit ``mem_init`` into narrower lanes, reductions into narrower
    dsts, register files of three widths side by side, and a register
    file of ``big_lanes`` int32 lanes (above the shared-memory cap)."""
    def ints(n, dt, lo=None, hi=None):
        info = np.iinfo(dt)
        return rng.integers(info.min if lo is None else lo,
                            (info.max if hi is None else hi) + 1, n,
                            dtype=np.int64).astype(dt)

    progs = {}
    b = program_cls("overlap_kvcp")
    x = b.vreg("x", 320, 2)
    b.kmemld(x, b.mem_in("in_x", ints(320, np.int16), elem_bytes=2))
    b.kvcp(x.view(3, 24), x.view(0, 24))
    b.kvcp(x.view(0, 24), x.view(5, 24))
    b.kvcp(x.view(17, 300), x.view(2, 300))
    b.kvcp(x.view(1, 300), x.view(9, 300))
    b.kmemstr(b.mem_out("x", 320, elem_bytes=2), x)
    progs["overlap_kvcp"] = b.build()

    b = program_cls("hazard")
    x, y = b.vreg("x", 300, 4), b.vreg("y", 300, 4)
    b.kmemld(x, b.mem_in("in_x", ints(300, np.int32)))
    b.kmemld(y, b.mem_in("in_y", ints(300, np.int32)))
    b.kaddv(x.view(5, 290), x.view(0, 290), y.view(0, 290))
    b.ksvmulsc(y.view(0, 290), y.view(3, 290), 77)
    b.kmemstr(b.mem_out("x", 300), x)
    b.kmemstr(b.mem_out("y", 300), y)
    progs["hazard"] = b.build()

    b = program_cls("load_after_store")
    x, y = b.vreg("x", 48, 4), b.vreg("y", 48, 4)
    tmp = b.mem_out("tmp", 48)
    b.kmemld(x, b.mem_in("in_x", ints(48, np.int32)))
    b.ksvaddsc(x, x, 7)
    b.kmemstr(tmp, x)
    b.kmemld(y, tmp)
    b.kaddv(y, y, x)
    b.kmemstr(b.mem_out("y", 48), y)
    progs["load_after_store"] = b.build()

    b = program_cls("unsigned_into_narrow")
    a8, a16, a32 = b.vreg("a8", 40, 1), b.vreg("a16", 40, 2), \
        b.vreg("a32", 40, 4)
    c16 = b.vreg("c16", 40, 2)
    b.kmemld(a8, b.mem_in("in_u16", ints(40, np.uint16), elem_bytes=1))
    b.kmemld(a16, b.mem_in("in_u32", ints(40, np.uint32), elem_bytes=2))
    b.kmemld(c16, b.mem_in("in_u8", ints(40, np.uint8), elem_bytes=2))
    b.kmemld(a32, b.mem_in("in_i64", ints(40, np.int64)))
    for name, r, eb in (("a8", a8, 1), ("a16", a16, 2), ("c16", c16, 2),
                        ("a32", a32, 4)):
        b.kmemstr(b.mem_out(name, 40, elem_bytes=eb), r)
    progs["unsigned_into_narrow"] = b.build()

    b = program_cls("narrow_dst_reduce")
    x, y = b.vreg("x", 64, 4), b.vreg("y", 64, 4)
    acc8, acc16 = b.vreg("acc8", 4, 1), b.vreg("acc16", 4, 2)
    b.kmemld(x, b.mem_in("in_x", ints(64, np.int32)))
    b.kmemld(y, b.mem_in("in_y", ints(64, np.int32)))
    b.kdotp(acc8[0], x, y)
    b.kvred(acc8[1], x)
    b.ksvmulrf(acc8[2], x, 2_000_000_011)
    b.kdotpps(acc16[0], x, y, 9)
    b.ksvaddrf(acc16[1], y, -(1 << 40))
    b.kdotpps(acc16[2], x, y, 70)
    b.kmemstr(b.mem_out("acc8", 4, elem_bytes=1), acc8)
    b.kmemstr(b.mem_out("acc16", 4, elem_bytes=2), acc16)
    progs["narrow_dst_reduce"] = b.build()

    b = program_cls("mixed_widths")
    r = {eb: b.vreg(f"r{eb}", 96, eb) for eb in (1, 2, 4)}
    t = {eb: b.vreg(f"t{eb}", 96, eb) for eb in (1, 2, 4)}
    for eb in (1, 2, 4):
        b.kmemld(r[eb], b.mem_in(f"r{eb}", ints(96, NP_OF_EB[eb]),
                                 elem_bytes=eb))
        b.kvmul(t[eb], r[eb], r[eb])
        b.ksvaddsc(t[eb], t[eb], 1000)
        b.ksrav(t[eb], t[eb], 3)
    b.kvred(t[1][95], r[1])
    b.kdotp(t[2][0], r[2], t[2])
    for eb in (1, 2, 4):
        b.kmemstr(b.mem_out(f"t{eb}", 96, elem_bytes=eb), t[eb])
    progs["mixed_widths"] = b.build()

    b = program_cls("big_regfile")
    x, y = b.vreg("x", big_lanes, 4), b.vreg("y", big_lanes, 4)
    b.kmemld(x, b.mem_in("in_x", ints(big_lanes, np.int32)))
    b.ksvmulsc(y, x, 3)
    b.kaddv(y, y, x)
    b.kdotp(y[0], x, y)
    b.kmemstr(b.mem_out("y", big_lanes), y)
    progs["big_regfile"] = b.build()
    return progs


def compile_walk(program):
    """The program's compiled walk, as ``TorchBackend`` builds it (the
    walk does not depend on the device)."""
    from repro_torch.kvi.torch_backend import TorchBackend
    return TorchBackend(device="cpu")._compile(program)


def random_stack(rng, key: tuple, N: int, width: int, device):
    """Random ``(N, width)`` contents for a walk buffer ``key``: full-range
    integers, 0/1 for bool, floats within +-1e6."""
    if key[0] != "in":
        return random_ints(rng, (N, width), key[1], device)
    dt = np.dtype(key[1])
    if dt.kind == "b":
        arr = rng.integers(0, 2, (N, width)).astype(dt)
    elif dt.kind == "f":
        arr = rng.uniform(-1e6, 1e6, (N, width)).astype(dt)
    else:
        info = np.iinfo(dt)
        arr = rng.integers(info.min, info.max, (N, width), dtype=dt,
                           endpoint=True)
    return torch.from_numpy(arr).to(device)


def check_walk(rng: np.random.Generator, walk, N: int, device, *,
               smem_cap: int = kw.ARENA_SMEM_CAP,
               threads: int = kw.THREADS,
               max_grid: int = kw.MAX_GRID) -> "kw.WalkRecord":
    """Pack ``walk``, run it over N instances of random input stacks
    through :func:`kvi_walk.run_walk` and :func:`kvi_walk.run_walk_plain`
    on the same tensors of ``device`` (store stacks from the same random
    start), and raise unless every store stack is identical. Returns the
    record."""
    record = kw.pack_walk(walk, smem_cap=smem_cap, threads=threads)
    inputs = [random_stack(rng, k, N, record.width(k), device)
              for k in record.in_keys]
    got = [random_stack(rng, k, N, record.width(k), device)
           for k in record.st_keys]
    want = [t.clone() for t in got]
    if torch.device(device).type == "cuda":
        kw.run_walk(record, inputs, got, N, max_grid=max_grid)
    else:
        kw.run_walk_plain(record, inputs, got, N)
    kw.run_walk_plain(record, inputs, want, N)
    for k, g, w in zip(record.st_keys, got, want):
        _require_equal(f"kvi_walk store stack {k[1]}", g, w)
    return record


# ---------------------------------------------------------------------------
# the paper's compute kernels (spm_matmul, spm_conv2d, spm_fft, het_mimd)
# ---------------------------------------------------------------------------

def gamma(k: int) -> float:
    """The float32 error factor of a sum of ``k`` terms."""
    return k * U32 / (1 - k * U32)


def require_close(name: str, got: torch.Tensor, want: torch.Tensor,
                  atol) -> float:
    """Raise unless ``|got - want| <= atol`` everywhere (``atol`` a number
    or a tensor broadcast against ``got``); return the largest
    absolute difference."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: got {got.dtype} {tuple(got.shape)}, "
                             f"want {want.dtype} {tuple(want.shape)}")
    err = (got.double() - want.double()).abs()
    bad = ~(err <= atol)
    if bool(bad.any()):
        raise AssertionError(f"{name} differs from its plain version by up "
                             f"to {err.max().item()} at "
                             f"{bad.nonzero()[:5].tolist()}")
    return err.max().item() if err.numel() else 0.0


def _no_tf32(device) -> None:
    if torch.device(device).type == "cuda" and \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: float32 products would not be "
                             "the function the kernels compute")


def random_floats(rng: np.random.Generator, shape, dtype: torch.dtype,
                  device) -> torch.Tensor:
    """Standard normal values, rounded to ``dtype``, on ``device``."""
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)
                            ).to(device=device, dtype=dtype)


#: operand ranges of the float32-accumulating integer types in the
#: checks: every partial sum below 2^24 at K up to 2048 (90^2 2048 =
#: 16 588 800), so exact in any order, and the two implementations must
#: agree bit for bit
SMALL_INTS = {torch.int16: (-90, 91), torch.int32: (-90, 91),
              torch.uint8: (0, 16)}


def small_ints(rng, shape, dtype, device) -> torch.Tensor:
    lo, hi = SMALL_INTS[dtype]
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(_NP[dtype])
                            ).to(device)


def matmul_operands(rng, M, K, N, dtype, device):
    if dtype == torch.int8:
        return (random_ints(rng, (M, K), dtype, device),
                random_ints(rng, (K, N), dtype, device))
    if dtype in SMALL_INTS:
        return (small_ints(rng, (M, K), dtype, device),
                small_ints(rng, (K, N), dtype, device))
    return (random_floats(rng, (M, K), dtype, device),
            random_floats(rng, (K, N), dtype, device))


def dot_tolerance(a: torch.Tensor, b: torch.Tensor, sums: int = 2
                  ) -> torch.Tensor:
    """``[M, N]`` float64: ``sums * LAMBDA * u * sqrt(K (K + 1) / 2) *
    |t_ij|``, where ``|t_ij|`` is the 2-norm of the K products ``a[i, k]
    b[k, j]``: the distance allowed between ``sums`` float32 sums of them
    (2: two float32 implementations; 1: one against the exact sum).

    Taking rounding errors as independent (Higham and Mary's
    probabilistic model), one sum lies within ``LAMBDA u sqrt(sum_k
    s_k^2)`` of the exact sum with probability at least ``1 - 2
    exp(-LAMBDA^2 / 2)``, s_k its partial sums; Cauchy-Schwarz bounds
    |s_k| by ``sqrt(k) |t_ij|``. Random data keeps |s_k| near ``|t_ij|
    sqrt(k / K)``, so an FP32 sum stays far inside. A TF32 product
    (inputs rounded to 11 significant bits) errs with a standard
    deviation of about ``0.8 2^-11 |t_ij|``, some 1100 / K times this
    bound: at the K of the checks (at most 2048 in float32) part of its
    entries fall outside, as the TF32 controls (:func:`reject_tf32`)
    show."""
    K = a.shape[1]
    t = ((a.double() ** 2) @ (b.double() ** 2)).sqrt()
    return sums * LAMBDA * U32 * (K * (K + 1) / 2) ** 0.5 * t


def output_step(dtype: torch.dtype) -> float:
    """The spacing of a 16-bit float output relative to its value (0 for
    other types): what rounding the same float32 result may add."""
    return {torch.bfloat16: BF16_STEP, torch.float16: F16_STEP}.get(dtype, 0.0)


def matmul_tolerance(a, b, want) -> torch.Tensor:
    """:func:`dot_tolerance` for two implementations, plus one step of a
    bf16 or float16 output."""
    return dot_tolerance(a, b) + output_step(want.dtype) * want.double().abs()


def compare_matmul(got, a, b, out_dtype=None) -> float:
    """``got`` (an ``spm_matmul`` output) against the plain version:
    integer operands bit for bit (int8 sums wrap exactly; the others are
    :data:`SMALL_INTS`, whose float32 sums are exact); floats within
    :func:`matmul_tolerance`."""
    want = sm.spm_matmul_plain(a, b, out_dtype=out_dtype)
    if not a.dtype.is_floating_point:
        return _require_equal("spm_matmul", got, want)
    _no_tf32(a.device)
    return require_close("spm_matmul", got, want,
                         matmul_tolerance(a, b, want))


def tf32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a @ b`` in TF32, the control of :func:`reject_tf32`: on
    the card cuBLAS with TF32 allowed for this call; on the CPU, which
    has no TF32, the inputs rounded to TF32 (11 significant bits, to
    nearest) and multiplied exactly."""
    if a.device.type == "cuda":
        flag = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return torch.matmul(a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flag

    def tf32(x):
        bits = x.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return (tf32(a).double() @ tf32(b).double()).float()


def reject_tf32(got, a, b) -> dict:
    """A control for :func:`compare_matmul`: ``got`` is float32 ``a @ b``
    computed in TF32. Raise unless the check rejects it; return how far
    it is outside (largest error, the tolerance there, the largest
    error-to-tolerance ratio and the share of entries outside)."""
    want = sm.spm_matmul_plain(a, b)
    tol = matmul_tolerance(a, b, want)
    err = (got.double() - want.double()).abs()
    ratio = err / tol
    out = dict(shape=[a.shape[0], a.shape[1], b.shape[1]],
               max_abs_err=err.max().item(),
               tol_at_max=tol.flatten()[err.argmax()].item(),
               max_err_over_tol=ratio.max().item(),
               share_outside=(ratio > 1).double().mean().item())
    try:
        compare_matmul(got, a, b)
    except AssertionError:
        return out
    raise AssertionError(f"the float32 matmul check passes a TF32 "
                         f"product: {out}")


def check_matmul(rng, M, K, N, dtype, device, out_dtype=None) -> float:
    a, b = matmul_operands(rng, M, K, N, dtype, device)
    return compare_matmul(sm.spm_matmul(a, b, out_dtype=out_dtype), a, b,
                          out_dtype)


#: the int8 wrap case: M, N and K = 2^17 + 4096 terms of (-128)(-128)
WRAP_M, WRAP_N, WRAP_K = 65, 17, (1 << 17) + 4096


def check_int8_wrap(device) -> int:
    """Constant -128 int8 operands, 65 x (2^17 + 4096) x 17: every exact
    sum, K 16384 = 2^31 + 2^26, passes 2^31, so the int32 accumulator
    wraps (a saturating one would stop at 2^31 - 1). The product must
    equal the plain version and (K 16384 mod 2^32) read as int32, bit for
    bit. Returns that value."""
    a = torch.full((WRAP_M, WRAP_K), -128, dtype=torch.int8, device=device)
    b = torch.full((WRAP_K, WRAP_N), -128, dtype=torch.int8, device=device)
    got = sm.spm_matmul(a, b)
    _require_equal("spm_matmul int8 wrap", got, sm.spm_matmul_plain(a, b))
    wrapped = (WRAP_K * 16384 + (1 << 31)) % (1 << 32) - (1 << 31)
    _require_equal("spm_matmul int8 wrap", got, torch.full_like(got, wrapped))
    return wrapped


def conv_operands(rng, H, W, F, dtype, device):
    """int32: |img| < 2^20, |filt| < 2^10, so sums overflow int32 from
    F = 3 on; int8 / int16 / uint8: the dtype's whole range and a filter
    in [-3, 4) of the same dtype (uint8 wraps -3..-1 to 253..255), so
    most sums leave the range and saturate; float16: |img|, |filt| ~ 100,
    so sums pass 65504 (inf); float32 and bf16: standard normal, a
    float32 filter."""
    if dtype == torch.int32:
        img = rng.integers(-(1 << 20), 1 << 20, (H, W))
        filt = rng.integers(-(1 << 10), 1 << 10, (F, F))
        return (torch.from_numpy(img.astype(np.int32)).to(device),
                torch.from_numpy(filt.astype(np.int32)).to(device))
    if dtype == torch.float16:
        return (torch.from_numpy(rng.normal(0, 100, (H, W)).astype(
                    np.float16)).to(device),
                torch.from_numpy(rng.normal(0, 100, (F, F)).astype(
                    np.float16)).to(device))
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        np_dt = np.dtype(str(dtype).split(".")[1])
        img = rng.integers(info.min, info.max + 1, (H, W)).astype(np_dt)
        filt = rng.integers(-3, 4, (F, F)).astype(np_dt)
        return (torch.from_numpy(img).to(device),
                torch.from_numpy(filt).to(device))
    return (random_floats(rng, (H, W), dtype, device),
            random_floats(rng, (F, F), torch.float32, device))


def _conv_tolerance(padded, filt, want) -> torch.Tensor:
    F = filt.shape[0]
    tol = 2 * gamma(F * F) * sc.correlate_plain(
        padded.abs().float(), filt.abs().float()).double()
    if want.dtype == torch.bfloat16:
        tol = tol + BF16_STEP * want.double().abs()
    return tol


def compare_conv(got, img, filt, shift=0) -> float:
    """``got`` (an ``spm_conv2d`` output) against the plain version, bit
    for bit in every dtype: the kernel rounds each product and each sum
    of a float image as the plain version does, in the same order, and
    casts back the same way."""
    want = sc.spm_conv2d_plain(img, filt, shift=shift)
    if got.dtype != want.dtype:
        raise AssertionError(f"spm_conv2d: got {got.dtype}, want "
                             f"{want.dtype}")
    return _require_equal("spm_conv2d", got, want)


def check_conv(rng, H, W, F, dtype, device, shift=0) -> float:
    img, filt = conv_operands(rng, H, W, F, dtype, device)
    return compare_conv(sc.spm_conv2d(img, filt, shift=shift), img, filt,
                        shift)


def _fft_tolerance(re, im) -> torch.Tensor:
    stages = max(re.shape[1].bit_length() - 1, 1)
    l1 = (re.double().abs() + im.double().abs()).sum(dim=1, keepdim=True)
    return 8 * stages * U32 * l1


def compare_fft(got_re, got_im, re, im) -> float:
    """``spm_fft`` outputs against the plain version on the same
    twiddles, within ``8 log2(n) u`` times each row's L1 norm."""
    want_re, want_im = sf.spm_fft_plain(re, im)
    tol = _fft_tolerance(re, im)
    return max(require_close("spm_fft re", got_re, want_re, tol),
               require_close("spm_fft im", got_im, want_im, tol))


def check_fft(rng, B, n, device) -> float:
    re = random_floats(rng, (B, n), torch.float32, device)
    im = random_floats(rng, (B, n), torch.float32, device)
    return compare_fft(*sf.spm_fft(re, im), re, im)


def fft_exact_cases(sms: int = sf.SMS) -> Sequence[Tuple[int, int]]:
    """``(B, n)`` for every n = 2^0 .. 2^14: 3 rows (one a block), 1000
    (a small batch's few rows a block) and, where a block holds more than
    one row, one row past ``sms`` full blocks, so the last block is
    partial (``sms``: the card's SM count, which sets the rows a block
    holds at small B)."""
    cases = []
    for log2n in range(sf.MAX_N.bit_length()):
        n = 1 << log2n
        rows = sf.pass_plan(n).rows_per_block
        for B in sorted({3, 1000} | ({rows * sms + 1} if rows > 1 else set())):
            cases.append((B, n))
    return cases


def check_fft_exact(rng, device, log2ns=range(15)) -> int:
    """``spm_fft`` equal to ``spm_fft_plain`` bit for bit at every
    :func:`fft_exact_cases` shape with n = 2^log2n: the kernel rounds each
    operation of each butterfly as the plain version does, on the same
    twiddles, so only the data movement differs. Returns the number of
    shapes checked."""
    sms = sf.sm_count(device) if torch.device(device).type == "cuda" \
        else sf.SMS
    done = 0
    for B, n in fft_exact_cases(sms):
        if n.bit_length() - 1 not in log2ns:
            continue
        re = random_floats(rng, (B, n), torch.float32, device)
        im = random_floats(rng, (B, n), torch.float32, device)
        got_re, got_im = sf.spm_fft(re, im)
        want_re, want_im = sf.spm_fft_plain(re, im)
        _require_equal(f"spm_fft re ({B}, {n})", got_re, want_re)
        _require_equal(f"spm_fft im ({B}, {n})", got_im, want_im)
        done += 1
    return done


def het_mimd_operands(rng, H, W, F, nb, n, m, k, p, device):
    """A zero-padded image (as the reference's callers pad it), a
    filter, FFT planes and matmul operands, all standard normal."""
    img = torch.zeros((H + F - 1, W + F - 1), dtype=torch.float32)
    pad = F // 2
    img[pad:pad + H, pad:pad + W] = random_floats(rng, (H, W),
                                                  torch.float32, "cpu")
    return (img.to(device),
            random_floats(rng, (F, F), torch.float32, device),
            random_floats(rng, (nb, n), torch.float32, device),
            random_floats(rng, (nb, n), torch.float32, device),
            random_floats(rng, (m, k), torch.float32, device),
            random_floats(rng, (k, p), torch.float32, device))


def compare_het_mimd(got, img, filt, fre, fim, A, B) -> float:
    """The composite's four outputs against its plain version, each
    within its part's bound (conv and FFT as above, the matmul within
    :func:`dot_tolerance`)."""
    _no_tf32(A.device)
    conv, ore, oim, mm = hm.het_mimd_composite_plain(img, filt, fre, fim,
                                                     A, B)
    tol_mm = dot_tolerance(A, B)
    tol_fft = _fft_tolerance(fre, fim)
    return max(
        require_close("het_mimd conv", got[0], conv,
                      _conv_tolerance(img, filt, conv)),
        require_close("het_mimd fft re", got[1], ore, tol_fft),
        require_close("het_mimd fft im", got[2], oim, tol_fft),
        require_close("het_mimd matmul", got[3], mm, tol_mm))


def check_het_mimd(rng, H, W, F, nb, n, m, k, p, device) -> float:
    ops = het_mimd_operands(rng, H, W, F, nb, n, m, k, p, device)
    return compare_het_mimd(hm.het_mimd_composite(*ops), *ops)


# ---------------------------------------------------------------------------
# the LM-scale kernels (flash_attention, ssd_scan)
# ---------------------------------------------------------------------------

ATTENTION_TOL = 2e-3       # tests/kernels/test_kernels.py:80
SSD_TOL = 3e-3             # tests/kernels/test_kernels.py:113-115


def _capped(name, got, want, rel_tol, abs_terms, cap) -> float:
    """Raise unless ``|got - want| <= min(rel_tol * abs_terms, cap (1 +
    |want|))``, plus one step of a bf16 or float16 output; the largest
    absolute difference."""
    tol = torch.minimum(rel_tol * abs_terms.double(),
                        cap * (1 + want.double().abs()))
    tol = tol + output_step(want.dtype) * want.double().abs()
    return require_close(name, got, want, tol)


def attention_operands(rng, B, H, KV, Sq, Skv, hd, dtype, device):
    """q [B, H, Sq, hd], k and v [B, KV, Skv, hd], standard normal."""
    return (random_floats(rng, (B, H, Sq, hd), dtype, device),
            random_floats(rng, (B, KV, Skv, hd), dtype, device),
            random_floats(rng, (B, KV, Skv, hd), dtype, device))


def attention_tolerance(q, k, v, causal, window, q_offset):
    """``(rel, abs_terms)``: each output lies within ``rel * abs_terms``
    of the plain version's. ``abs_terms`` is the plain version run on
    ``|v|``, the weighted sum of |v| each output is a normalised sum of.
    A score is a float32 sum of hd terms, off by at most ``gamma(hd)
    s_abs`` in each implementation (``s_abs`` = scale * the largest
    ||q row|| * the largest ||k row||, Cauchy-Schwarz); a shift d of the
    scores moves each normalised weight by a factor within exp(+-2d);
    the sums l and acc add ``gamma(Skv)`` each; exp and the division a
    few ulps. Two implementations double the per-implementation terms."""
    hd, Skv = q.shape[-1], k.shape[2]
    s_abs = fa.scale_of(hd) * q.float().norm(dim=-1).max().item() * \
        k.float().norm(dim=-1).max().item()
    rel = 4 * gamma(hd) * s_abs + 4 * gamma(Skv) + 16 * U32
    terms = fa.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                     causal=causal, window=window,
                                     q_offset=q_offset)
    return rel, terms


def compare_attention(got, q, k, v, *, causal=True, window=0,
                      q_offset=0) -> float:
    """A ``flash_attention`` output against the plain version on the
    same inputs, within :func:`attention_tolerance` capped at the JAX
    test's 2e-3 (plus one bf16 step for bf16). A row that sees no key
    must be 0 in both (its tolerance is 0)."""
    _no_tf32(q.device)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    rel, terms = attention_tolerance(q, k, v, causal, window, q_offset)
    return _capped("flash_attention", got, want, rel, terms, ATTENTION_TOL)


def check_attention(rng, B, H, KV, Sq, Skv, hd, device, dtype=torch.float32,
                    causal=True, window=0, q_offset=0) -> float:
    q, k, v = attention_operands(rng, B, H, KV, Sq, Skv, hd, dtype, device)
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    return compare_attention(got, q, k, v, causal=causal, window=window,
                             q_offset=q_offset)


def ssd_operands(rng, Bz, S, H, P, N, G, device, dtype=torch.float32):
    """The reference test's inputs: x [Bz, S, H, P] standard normal (in
    ``dtype``), dt ~ U(0.001, 0.1), A = -exp(N(0, 0.5)) per head, B and C
    [Bz, S, G, N] standard normal; all but x float32."""
    x = random_floats(rng, (Bz, S, H, P), dtype, device)
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (Bz, S, H)).astype(
        np.float32)).to(device)
    A = -torch.from_numpy(np.exp(rng.normal(0, 0.5, (H,))).astype(
        np.float32)).to(device)
    return (x, dt, A, random_floats(rng, (Bz, S, G, N), torch.float32, device),
            random_floats(rng, (Bz, S, G, N), torch.float32, device))


def ssd_tolerance(x, da, dt, B, C, chunk):
    """``(rel, y_terms, state_terms)``: y and the state lie within ``rel``
    times the plain version run on |x|, |dt|, |B|, |C| (which bounds the
    sum of absolute terms of every output) of the plain version's. Per
    implementation: the products C.B and C h (``gamma(N)`` each), the
    chunk's sum (``gamma(cs)``), the cumsum inside each exp (its error is
    at most ``gamma(cs) cs max|da|``, doubled by the exp of a
    difference), a few ulps of exp and products, and the state carrying
    ``gamma(cs) + gamma(N) + 8 u`` more from every chunk."""
    S, N = x.shape[1], B.shape[-1]
    cs = ss.chunk_size(S, chunk)
    nc = S // cs
    da_max = da.abs().max().item() if da.numel() else 0.0
    one = (2 * gamma(N) + gamma(cs) + 2 * gamma(cs) * cs * da_max
           + 8 * U32 + nc * (gamma(cs) + gamma(N) + 8 * U32))
    y_terms, s_terms = ss.ssd_scan_plain(x.float().abs(), da, dt.abs(),
                                         B.abs(), C.abs(), chunk=chunk)
    return 2 * one, y_terms, s_terms


def compare_ssd(got, x, dt, A, B, C, *, chunk=256) -> float:
    """An ``ssd_scan_op`` output (y, state [Bz, H, N, P]) against the
    plain version on the same inputs, within :func:`ssd_tolerance`
    capped at the JAX test's 3e-3 (plus one bf16 step for a bf16 y)."""
    _no_tf32(x.device)
    ins = ss.kernel_inputs(x, dt, A, B, C)
    want_y, want_s = ss.ssd_scan_plain(*ins, chunk=chunk)
    rel, y_terms, s_terms = ssd_tolerance(*ins, chunk)
    return max(_capped("ssd_scan y", got[0], want_y, rel, y_terms, SSD_TOL),
               _capped("ssd_scan state", got[1], want_s, rel, s_terms,
                       SSD_TOL))


def check_ssd(rng, Bz, S, H, P, N, G, chunk, device,
              dtype=torch.float32) -> float:
    args = ssd_operands(rng, Bz, S, H, P, N, G, device, dtype)
    return compare_ssd(ops.ssd_scan_op(*args, chunk=chunk), *args,
                       chunk=chunk)


def ssd_part_cases() -> Sequence[dict]:
    """Shapes of the three SSD kernels' checks, each alone: a chunk of 48
    (no whole 64 tile), N 40, P 24, one chunk and three; N and P past one
    tile, with 4-byte copies (N 70, then P 21 and N 37); four row tiles
    at the mamba2 row's widths."""
    return (dict(Bz=1, S=48, H=2, P=24, N=40, chunk=48),
            dict(Bz=2, S=144, H=3, P=24, N=40, chunk=48),
            dict(Bz=1, S=192, H=2, P=80, N=70, chunk=96),
            dict(Bz=1, S=192, H=2, P=21, N=37, chunk=96),
            dict(Bz=1, S=512, H=2, P=64, N=128, chunk=256))


def check_ssd_parts(rng, Bz, S, H, P, N, chunk, device,
                    dtype=torch.float32) -> dict:
    """Each SSD kernel (:data:`ssd_scan.PARTS`) against its plain version
    on the same inputs, one launch each: the chunk states and cum from
    the model's inputs; the scan over chunks and the chunk scan from the
    plain version's own states and cum, so each kernel is held alone.
    Tolerances, per implementation and doubled for two: cum, a sum of cs
    terms in another order (``gamma(cs)`` of the running sum of |da|);
    the chunk states, a sum of cs terms (``gamma(cs)``), a few ulps of
    the products and the exp, and the exp's argument off by the cum's
    error (``2 gamma(cs) cs max|da|``); the scan over chunks the same
    rounded multiply and add in the same order, a few ulps of exp per
    chunk; the chunk scan ``ssd_tolerance``'s terms without the cum's and
    the carried state's. Each relative to the plain version run on
    absolute values, capped at the JAX test's 3e-3 (plus one bf16 step
    for a bf16 y). Returns the largest absolute difference by kernel."""
    _no_tf32(device)
    x, da, dt, B, C = ss.kernel_inputs(*ssd_operands(
        rng, Bz, S, H, P, N, 1, device, dtype))
    cs = ss.chunk_size(S, chunk)
    nc = S // cs
    err = {}
    got_s, got_cum = ss.chunk_state(x, da, dt, B, cs)
    want_s, want_cum = ss.chunk_state_plain(x, da, dt, B, cs)
    run_abs = torch.cumsum(da.abs().transpose(1, 2).reshape(Bz, H, nc, cs),
                           dim=-1).reshape(Bz, H, S)
    e_cum = require_close("ssd_chunk_state cum", got_cum, want_cum,
                          2 * gamma(cs) * run_abs.double())
    terms, _ = ss.chunk_state_plain(x.float().abs(), da, dt.abs(), B.abs(),
                                    cs)
    da_max = da.abs().max().item()
    rel = 2 * (gamma(cs) + 8 * U32 + 2 * gamma(cs) * cs * da_max)
    err["ssd_chunk_state"] = max(e_cum, _capped(
        "ssd_chunk_state", got_s, want_s, rel, terms, SSD_TOL))
    got_h, got_f = ss.state_pass(want_s.clone(), want_cum, cs)
    want_h, want_f = ss.state_pass_plain(want_s.clone(), want_cum, cs)
    h_terms, f_terms = ss.state_pass_plain(want_s.abs(), want_cum, cs)
    rel = 2 * (nc + 1) * 8 * U32
    err["ssd_state_pass"] = max(
        _capped("ssd_state_pass h_in", got_h, want_h, rel, h_terms, SSD_TOL),
        _capped("ssd_state_pass state", got_f, want_f, rel, f_terms,
                SSD_TOL))
    got_y = ss.chunk_scan(x, dt, B, C, want_cum, want_h, cs)
    want_y = ss.chunk_scan_plain(x, dt, B, C, want_cum, want_h, cs)
    y_terms = ss.chunk_scan_plain(x.float().abs(), dt.abs(), B.abs(),
                                  C.abs(), want_cum, want_h.abs(), cs)
    rel = 2 * (2 * gamma(N) + gamma(cs) + 8 * U32)
    err["ssd_chunk_scan"] = _capped("ssd_chunk_scan", got_y, want_y, rel,
                                    y_terms, SSD_TOL)
    return err


MATMUL_TYPES = ((torch.float32, None), (torch.bfloat16, None),
                (torch.bfloat16, torch.float32), (torch.int8, None))
CONV_TYPES = ((torch.int32, 0), (torch.int32, 4), (torch.int32, 31),
              (torch.int32, 35), (torch.int32, 40), (torch.float32, 0),
              (torch.bfloat16, 0), (torch.float16, 3), (torch.int8, 3),
              (torch.int16, 3), (torch.uint8, 3))
#: q / x dtypes every attention and SSD case runs in
LM_TYPES = (torch.float32, torch.bfloat16)


def compute_kernel_cases() -> Sequence[Tuple[str, dict]]:
    """``(kernel, shape)``: odd shapes (nothing a multiple of a tile;
    images smaller than a filter; FFT rows from 1 point to the 16384
    that needs the opt-in shared memory) for the four compute kernels,
    then for attention and the SSD scan; and one matmul of whole tiles,
    which the tensor-core kernel takes without padding."""
    return (
        ("spm_matmul", dict(M=256, K=512, N=384)),
        ("spm_matmul", dict(M=1, K=1, N=1)),
        ("spm_matmul", dict(M=33, K=65, N=17)),
        ("spm_matmul", dict(M=129, K=257, N=63)),
        ("spm_matmul", dict(M=70, K=5, N=200)),
        ("spm_conv2d", dict(H=33, W=31, F=3)),
        ("spm_conv2d", dict(H=64, W=48, F=5)),
        ("spm_conv2d", dict(H=17, W=45, F=4)),
        ("spm_conv2d", dict(H=5, W=7, F=11)),
        # a 1 x 1 image; 16-byte rows of every dtype (W 64); tiles past a
        # block's first (the ring running on into the next tile), with
        # and without 16-byte rows; F above the old kernel's limit of 154
        # and F = 1024, on images smaller than the filter
        ("spm_conv2d", dict(H=1, W=1, F=3)),
        ("spm_conv2d", dict(H=19, W=64, F=3)),
        ("spm_conv2d", dict(H=3001, W=2048, F=5)),
        ("spm_conv2d", dict(H=4099, W=2050, F=3)),
        ("spm_conv2d", dict(H=24, W=20, F=161)),
        ("spm_conv2d", dict(H=9, W=13, F=1024)),
        ("spm_fft", dict(B=3, n=64)),
        ("spm_fft", dict(B=4, n=2)),
        ("spm_fft", dict(B=2, n=1)),
        ("spm_fft", dict(B=1000, n=8)),
        ("spm_fft", dict(B=3, n=4096)),
        ("spm_fft", dict(B=2, n=16384)),
        ("het_mimd", dict(H=32, W=32, F=3, nb=4, n=128, m=32, k=48, p=16)),
        ("het_mimd", dict(H=35, W=19, F=4, nb=5, n=8192, m=33, k=17,
                          p=70)),
        # matmul edges off the 64 x 64 and 128 x 64 tiles; K of one, a
        # few and many slabs (1023: a partial last slab); one FFT row
        ("het_mimd", dict(H=40, W=33, F=3, nb=9, n=256, m=129, k=1, p=65)),
        ("het_mimd", dict(H=17, W=64, F=5, nb=3, n=1024, m=129, k=5,
                          p=65)),
        ("het_mimd", dict(H=33, W=31, F=3, nb=1, n=2048, m=129, k=1023,
                          p=65)),
        # no length a multiple of a 64 tile; G = 1, 2, 5; every mask;
        # rows that see no key (q_offset 80, window 8); hd 1 to 128
        ("flash_attention", dict(B=2, H=4, KV=2, Sq=100, Skv=100, hd=64)),
        ("flash_attention", dict(B=1, H=5, KV=1, Sq=77, Skv=77, hd=96,
                                 causal=False)),
        ("flash_attention", dict(B=1, H=10, KV=2, Sq=130, Skv=130, hd=128,
                                 window=33)),
        ("flash_attention", dict(B=1, H=4, KV=2, Sq=32, Skv=64, hd=16,
                                 window=8, q_offset=80)),
        ("flash_attention", dict(B=1, H=2, KV=1, Sq=65, Skv=200, hd=40,
                                 q_offset=135)),
        ("flash_attention", dict(B=1, H=3, KV=3, Sq=1, Skv=1, hd=1)),
        # chunks below, at and above a 64 tile; P and N past one tile
        ("ssd_scan", dict(Bz=2, S=128, H=4, P=16, N=8, G=2, chunk=32)),
        ("ssd_scan", dict(Bz=1, S=100, H=3, P=20, N=12, G=1, chunk=256)),
        ("ssd_scan", dict(Bz=1, S=192, H=2, P=80, N=70, G=2, chunk=96)),
        ("ssd_scan", dict(Bz=1, S=1, H=1, P=1, N=1, G=1, chunk=1)),
        ("ssd_scan", dict(Bz=1, S=48, H=2, P=24, N=40, G=1, chunk=48)),
        ("ssd_scan", dict(Bz=2, S=144, H=3, P=24, N=40, G=1, chunk=48)),
    )


def case_paths(kernel: str) -> dict:
    """The launches of one :func:`check_compute_case` of ``kernel`` on
    the card, by path: the matmul's bf16 and int8 variants and bf16
    attention run the tensor-core kernels, float32 the CUDA-core ones;
    the other kernels have CUDA-core kernels only. A call of the SSD scan
    is ``ssd_scan.LAUNCHES_PER_CALL`` launches."""
    types = {"spm_matmul": [dt for dt, _ in MATMUL_TYPES],
             "spm_conv2d": [dt for dt, _ in CONV_TYPES],
             "flash_attention": LM_TYPES, "ssd_scan": LM_TYPES}.get(
                 kernel, [torch.float32])
    mod = {"spm_matmul": sm, "flash_attention": fa}.get(kernel)
    tc = sum(mod.uses_tensor_cores(dt) for dt in types) if mod else 0
    per_call = ss.LAUNCHES_PER_CALL if kernel == "ssd_scan" else 1
    return {"tensor_cores": tc, "cuda_cores": (len(types) - tc) * per_call}


def check_compute_case(rng, kernel: str, shape: dict, device) -> float:
    """Every dtype / shift variant of one :func:`compute_kernel_cases`
    entry (one launch each); returns the largest absolute difference."""
    if kernel == "spm_matmul":
        return max(check_matmul(rng, dtype=dt, device=device, out_dtype=od,
                                **shape) for dt, od in MATMUL_TYPES)
    if kernel == "spm_conv2d":
        return max(check_conv(rng, dtype=dt, device=device, shift=s,
                              **shape) for dt, s in CONV_TYPES)
    if kernel == "spm_fft":
        return check_fft(rng, device=device, **shape)
    if kernel == "flash_attention":
        return max(check_attention(rng, device=device, dtype=dt, **shape)
                   for dt in LM_TYPES)
    if kernel == "ssd_scan":
        return max(check_ssd(rng, device=device, dtype=dt, **shape)
                   for dt in LM_TYPES)
    return check_het_mimd(rng, device=device, **shape)


# ---------------------------------------------------------------------------
# the inputs the reference takes past the first kernels' limits (head
# widths above 128, float16, negative windows, the whole matmul domain,
# FFTs above 16384 points, uint8 intrinsics, wide SSD states, large
# composite filters): each held against its plain version, each required
# to launch its kernel
# ---------------------------------------------------------------------------

def _matmul_edges(rng, device) -> float:
    """XLA's casts at their edges, bit for bit against the plain version
    and the values the reference gives: int32 (1 << 24) + 1 rounds to
    2^24 on its way to float32; 128 x 2^20 x 2^10 = 2^37 saturates to
    +-(2^31 - 1 or 2^31); a NaN sum gives 0; an int8 product into
    float16 overflows to inf and into int16 wraps."""
    def run(a, b, od, want):
        a, b = a.to(device), b.to(device)
        got = sm.spm_matmul(a, b, out_dtype=od)
        _require_equal("spm_matmul edge", got,
                       sm.spm_matmul_plain(a, b, out_dtype=od))
        _require_equal("spm_matmul edge", got.cpu(),
                       torch.tensor(want, dtype=got.dtype))
    i32 = torch.int32
    run(torch.tensor([[(1 << 24) + 1]], dtype=i32),
        torch.tensor([[1]], dtype=i32), None, [[1 << 24]])
    run(torch.full((1, 128), 1 << 20, dtype=i32),
        torch.tensor([[1 << 10, -(1 << 10)]] * 128, dtype=i32), None,
        [[2147483647, -2147483648]])
    run(torch.tensor([[float("nan"), 1.0]]), torch.ones((2, 1)), i32, [[0]])
    a8 = torch.full((1, 130), 127, dtype=torch.int8)
    b8 = torch.full((130, 1), 127, dtype=torch.int8)
    run(a8, b8, torch.float16, [[float("inf")]])
    run(a8, b8, torch.int16, [[-382]])
    return 0.0


def _attention(dtype, hd, causal=True, window=0, q_offset=0, S=200, H=4,
               KV=2):
    return lambda rng, dev: check_attention(
        rng, 1, H, KV, S, S, hd, dev, dtype=dtype, causal=causal,
        window=window, q_offset=q_offset)


def _matmul(dtype, out_dtype=None, M=130, K=257, N=70):
    return lambda rng, dev: check_matmul(rng, M, K, N, dtype, dev,
                                         out_dtype=out_dtype)


def _fft_exact(B, n):
    def run(rng, dev):
        re = random_floats(rng, (B, n), torch.float32, dev)
        im = random_floats(rng, (B, n), torch.float32, dev)
        got, want = sf.spm_fft(re, im), sf.spm_fft_plain(re, im)
        _require_equal(f"spm_fft re ({B}, {n})", got[0], want[0])
        _require_equal(f"spm_fft im ({B}, {n})", got[1], want[1])
        return 0.0
    return run


def _kdotp_u8(n):
    def run(rng, dev):
        a = torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8)).to(dev)
        b = torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8)).to(dev)
        for got, want in ((kd.kdotp(a, b), (a.long() * b.long()).sum()),
                          (kd.kvred(a), a.long().sum())):
            want = int(want.to(torch.int32))
            if got.dtype != torch.int32 or int(got) != want:
                raise AssertionError(f"uint8 kdotp / kvred: {int(got)} != "
                                     f"{int(want)}")
        return float(check_reduce(rng, torch.uint8, 4, n // 4, dev,
                                  mode=kd.WRAP32))
    return run


#: name -> (module, its counter that must move, expected moves, the check
#: (rng, device) -> largest absolute difference)
EDGE_CHECKS = {
    "attn_hd256_bf16": (fa, "tc_launch_count", 1,
                        _attention(torch.bfloat16, 256)),
    "attn_pixtral_hd160_bf16": (fa, "tc_launch_count", 1,
                                _attention(torch.bfloat16, 160, H=8, KV=2)),
    "attn_hd256_f32": (fa, "launch_count", 1,
                       _attention(torch.float32, 256, causal=False)),
    "attn_f16": (fa, "tc_launch_count", 1,
                 _attention(torch.float16, 64, window=33)),
    "attn_f16_hd176": (fa, "tc_launch_count", 1,
                       _attention(torch.float16, 176, causal=False, S=90,
                                  H=2, KV=1)),
    "attn_f16_hd320": (fa, "launch_count", 1,
                       _attention(torch.float16, 320, S=70, H=2, KV=1)),
    "attn_negwin_causal": (fa, "tc_launch_count", 1,
                           _attention(torch.bfloat16, 64, window=-5)),
    "attn_negwin_full": (fa, "launch_count", 1,
                         _attention(torch.float32, 64, causal=False,
                                    window=-20, q_offset=3)),
    "attn_negwin_full_bf16": (fa, "tc_launch_count", 1,
                              _attention(torch.bfloat16, 128, causal=False,
                                         window=-70)),
    "matmul_int16": (sm, "launch_count", 1, _matmul(torch.int16)),
    "matmul_uint8": (sm, "launch_count", 1, _matmul(torch.uint8)),
    "matmul_int32": (sm, "launch_count", 1, _matmul(torch.int32)),
    "matmul_f16": (sm, "tc_launch_count", 1,
                   _matmul(torch.float16, M=129, K=257, N=63)),
    "matmul_f16_f32out": (sm, "tc_launch_count", 1,
                          _matmul(torch.float16, torch.float32)),
    "matmul_int8_f32out": (sm, "tc_launch_count", 1,
                           _matmul(torch.int8, torch.float32)),
    "matmul_int8_bf16out": (sm, "tc_launch_count", 1,
                            _matmul(torch.int8, torch.bfloat16)),
    "matmul_int32_edges": (sm, "launch_count", 5, _matmul_edges),
    "fft_2x32768": (sf, "launch_count", sf.launches_for(32768),
                    _fft_exact(2, 32768)),
    "fft_1x131072": (sf, "launch_count", sf.launches_for(131072),
                     _fft_exact(1, 131072)),
    "kdotp_kvred_u8_65536": (kd, "launch_count", 3, _kdotp_u8(65536)),
    "fused_vops_u8_1024x1024": (fv, "launch_count", 1,
                                lambda rng, dev: float(check_fused(
                                    rng, torch.uint8, 1024, 1024, dev))),
    "ssd_n1024": (ss, "launch_count", ss.LAUNCHES_PER_CALL,
                  lambda rng, dev: check_ssd(rng, 1, 1024, 8, 64, 1024, 1,
                                             256, dev)),
    "ssd_f16": (ss, "launch_count", ss.LAUNCHES_PER_CALL,
                lambda rng, dev: check_ssd(rng, 2, 512, 4, 64, 128, 1, 256,
                                           dev, dtype=torch.float16)),
    "het_mimd_f161": (hm, "launch_count", 1,
                      lambda rng, dev: check_het_mimd(rng, 70, 50, 161, 4,
                                                      256, 65, 33, 70, dev)),
}


def check_edge(rng, name: str, device) -> dict:
    """One :data:`EDGE_CHECKS` entry on ``device``: ``{"max_abs_err",
    "launches"}``. Raises unless it agrees with its plain version and,
    on the card, its counter moved by the expected launches (on the CPU
    the plain versions launch nothing)."""
    mod, counter, expected, fn = EDGE_CHECKS[name]
    before = getattr(mod, counter)
    err = fn(rng, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    moved = getattr(mod, counter) - before
    want = expected if torch.device(device).type == "cuda" else 0
    if moved != want:
        raise AssertionError(f"{name}: {mod.__name__}.{counter} moved by "
                             f"{moved}, expected {want}")
    return {"max_abs_err": float(err), "launches": moved}
