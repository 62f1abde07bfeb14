"""Kernel-against-plain-version checks, shared by ``chip_smoke.py`` and
the card tests (``tests/test_torch_cuda.py``).

Each check builds random operands with numpy from a seed, runs the
kernel's wrapper and its plain PyTorch version on the same tensors of
one device, and raises ``AssertionError`` unless the two agree — bit for
bit for integers, within the stated tolerance for float32. On a CPU
device both sides are the plain version, which is how the CPU tests keep
these helpers themselves honest.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import kdotp as kd
from repro_torch.kernels import fused_vops as fv

_NP = {torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32,
       torch.float32: np.float32}


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
    what the reference Pallas kernel accepts."""
    bits = 8 * torch.empty((), dtype=dtype).element_size()
    ops = list(fv.OPCODES)
    ops += [str(o) for o in rng.choice(ops, max(0, n_ops - len(ops)))]
    ops = [ops[i] for i in rng.permutation(len(ops))][:n_ops]
    lo, hi = (-(1 << 40), 1 << 40) if wide_imm else (
        -(1 << (bits - 1)), 1 << (bits - 1))
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
