"""The port's batched FFT (repro_torch.kernels.spm_fft) against the
reference Pallas kernel (repro.kernels.ops.fft_op, interpret mode on the
CPU) and the oracles, at rtol 1e-3 and atol 1e-3 n (the JAX test's).
Run with ``-s`` to see the largest error observed at each shape."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.spm_fft import _bitrev as ref_bitrev
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spm_fft as sf

SHAPES = [(8, 256), (3, 64), (1, 1024), (4, 2), (2, 1)]


@pytest.mark.parametrize("B,n", SHAPES)
def test_vs_pallas(B, n):
    rng = np.random.default_rng(B * n)
    re = rng.normal(0, 1, (B, n)).astype(np.float32)
    im = rng.normal(0, 1, (B, n)).astype(np.float32)
    wre, wim = (np.asarray(x) for x in jops.fft_op(jnp.asarray(re),
                                                   jnp.asarray(im)))
    gre, gim = sf.spm_fft(torch.from_numpy(re), torch.from_numpy(im))
    assert gre.dtype == gim.dtype == torch.float32
    for got, want in ((gre.numpy(), wre), (gim.numpy(), wim)):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * n)
    ore, oim = (np.asarray(x) for x in jref.fft_ref(jnp.asarray(re),
                                                    jnp.asarray(im)))
    tre, tim = tref.fft_ref(torch.from_numpy(re), torch.from_numpy(im))
    np.testing.assert_allclose(tre.numpy(), ore, rtol=1e-5, atol=1e-5 * n)
    np.testing.assert_allclose(tim.numpy(), oim, rtol=1e-5, atol=1e-5 * n)
    err = max(np.abs(gre.numpy() - wre).max(), np.abs(gim.numpy() - wim).max())
    print(f"spm_fft ({B}, {n}): max |port - pallas| = {err:.3e}")


def test_bitrev_and_twiddles_follow_the_reference():
    for n in (1, 2, 8, 1024):
        np.testing.assert_array_equal(sf._bitrev(n), ref_bitrev(n))
    tw = sf.twiddles(256, "cpu").numpy()
    h = 1
    while h < 256:
        k = jnp.arange(h, dtype=jnp.float32)
        ang = -2.0 * np.pi * k / (2 * h)        # the reference kernel's
        np.testing.assert_allclose(tw[0, h - 1:2 * h - 1], np.cos(ang),
                                   atol=2e-7)
        np.testing.assert_allclose(tw[1, h - 1:2 * h - 1], np.sin(ang),
                                   atol=2e-7)
        h *= 2


def test_integer_planes_are_taken_as_float32():
    re = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    gre, gim = sf.spm_fft(re, torch.zeros_like(re))
    want = np.fft.fft(re.numpy().astype(np.float64))
    np.testing.assert_allclose(gre.numpy(), want.real, atol=1e-4)
    np.testing.assert_allclose(gim.numpy(), want.imag, atol=1e-4)


@pytest.mark.parametrize("n", [3, 12, 32768])
def test_rejects_unsupported_lengths(n):
    x = torch.zeros((1, n))
    with pytest.raises(ValueError):
        sf.spm_fft(x, x)


# ---------------------------------------------------------------------------
# the kernel's pass plan, and a numpy model of its data movement
# ---------------------------------------------------------------------------

def _swz(e):
    """The kernel's shared-memory swizzle (spm_tiles.cuh, fft_swz)."""
    return e ^ (((e >> 5) ^ (e >> 10)) & 31)


def _rev(j, bits):
    return np.array([int(f"{x:0{bits}b}"[::-1], 2) if bits else 0
                     for x in np.ravel(j)]).reshape(np.shape(j))


def _passes(plan, log2n):
    """(R, s_hi, s_lo) of each pass, as fft_tile walks them."""
    out, s_hi = [], log2n - 1
    for R in plan.radices:
        out.append((R, s_hi, s_hi - R + 1))
        s_hi -= R
    return out


def _items(log2n, rows, R, s_hi, s_lo, first):
    """fft_pass's work items in thread order: each one's base index in
    the block (row, index bits above and below the pass)."""
    lq = log2n - 1 - s_hi
    w = np.arange(rows << (log2n - R))
    if first or s_lo >= 5:
        ql = w & ((1 << s_lo) - 1)
        qh = (w >> s_lo) & ((1 << lq) - 1)
        r = w >> (s_lo + lq)
    else:
        qh = w & ((1 << lq) - 1)
        ql = (w >> lq) & ((1 << s_lo) - 1)
        r = w >> (lq + s_lo)
    return (r << log2n) | (qh << (s_hi + 1)) | ql, ql


def _model(re, im, plan, tw):
    """fft_tile in numpy, block by block: each pass gathers its work
    items' points from the swizzled block, runs the radix-2 butterflies
    on them stage by stage in float32 (each operation rounded), and
    scatters them back; then the rows are read back bit-reversed."""
    B, n = re.shape
    log2n = n.bit_length() - 1
    wre, wim = tw
    out_re, out_im = np.empty_like(re), np.empty_like(im)
    for row0 in range(0, B, plan.rows_per_block):
        rows = min(plan.rows_per_block, B - row0)
        sre = np.zeros(plan.smem_bytes // 8, np.float32)
        sim = np.zeros_like(sre)
        for p, (R, s_hi, s_lo) in enumerate(_passes(plan, log2n)):
            base, ql = _items(log2n, rows, R, s_hi, s_lo, p == 0)
            idx = base[:, None] + (np.arange(1 << R) << s_lo)[None, :]
            if p == 0:
                xr = re[row0:row0 + rows].ravel()[idx]
                xi = im[row0:row0 + rows].ravel()[idx]
            else:
                xr, xi = sre[_swz(idx)], sim[_swz(idx)]
            for st in range(R - 1, -1, -1):
                h = 1 << (s_lo + st)
                for j in range(1 << R):
                    if j >> st & 1:
                        continue
                    k = h - 1 + ql + ((j & ((1 << st) - 1)) << s_lo)
                    wr, wi = wre[k], wim[k]
                    ar, ai = xr[:, j].copy(), xi[:, j].copy()
                    br, bi = xr[:, j + (1 << st)], xi[:, j + (1 << st)]
                    dr, di = ar - br, ai - bi
                    xr[:, j], xi[:, j] = ar + br, ai + bi
                    xr[:, j + (1 << st)] = dr * wr - di * wi
                    xi[:, j + (1 << st)] = dr * wi + di * wr
            sre[_swz(idx)], sim[_swz(idx)] = xr, xi
        e = np.arange(rows * n)
        src = _swz((e - (e & (n - 1))) | _rev(e & (n - 1), log2n))
        out_re[row0:row0 + rows] = sre[src].reshape(rows, n)
        out_im[row0:row0 + rows] = sim[src].reshape(rows, n)
    return out_re, out_im


@pytest.mark.parametrize("n", [1 << k for k in range(15)])
def test_pass_plan_covers_every_stage_once(n):
    """Each of the log2(n) stages once, from half-size n / 2 down, in
    passes of 1 to 4 (n = 1: one pass of none); the first pass's threads
    fill at most one block; shared memory within 227 KB at any batch."""
    log2n = n.bit_length() - 1
    for batch in (None, 1, 3, 1000, 1 << 20):
        plan = sf.pass_plan(n, batch)
        stages = [s for _, s_hi, s_lo in _passes(plan, log2n)
                  for s in range(s_hi, s_lo - 1, -1)]
        assert stages == list(range(log2n - 1, -1, -1))
        assert plan.radices == (0,) if n == 1 else \
            all(1 <= r <= sf.MAX_RADIX for r in plan.radices)
        assert len(plan.radices) <= 4
        assert plan.threads_per_row == n >> plan.radices[0]
        assert plan.rows_per_block * plan.threads_per_row <= sf.THREADS \
            or plan.rows_per_block == 1
        assert plan.smem_bytes == 8 * -(-plan.rows_per_block * n // 32) * 32
        assert plan.smem_bytes <= 232448         # a block's limit, 227 KB
        packed = plan.packed
        assert [packed >> (4 + 4 * p) & 15 for p in range(packed & 15)] \
            == list(plan.radices)
        if batch is not None and batch >= sf.SMS:    # >= 132 blocks
            assert -(-batch // plan.rows_per_block) >= sf.SMS
    assert sf.pass_plan(n).rows_per_block == max(
        1, sf.THREADS // sf.pass_plan(n).threads_per_row)


@pytest.mark.parametrize("B,n", [(3, 1), (5, 2), (1000, 8), (40, 64),
                                 (33, 256), (9, 1024), (2, 16384)])
def test_pass_model_equals_plain_bit_for_bit(B, n):
    """The kernel's passes, work items, twiddle indices, swizzle and
    bit-reversed read, modelled in numpy float32, give spm_fft_plain's
    planes bit for bit (B leaves a partial last block where a block holds
    more than one row)."""
    rng = np.random.default_rng(n + B)
    re = rng.normal(0, 1, (B, n)).astype(np.float32)
    im = rng.normal(0, 1, (B, n)).astype(np.float32)
    plan = sf.pass_plan(n, B)
    assert plan.rows_per_block == 1 or B % plan.rows_per_block
    got = _model(re, im, plan, sf.twiddles(n, "cpu").numpy())
    want = sf.spm_fft_plain(torch.from_numpy(re), torch.from_numpy(im))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32),
                                      w.numpy().view(np.int32))


def _wavefronts(words):
    """Shared-memory wavefronts of one warp access: the most distinct
    words any bank serves."""
    banks = {}
    for w in words:
        banks.setdefault(w % 32, set()).add(w)
    return max(len(s) for s in banks.values())


@pytest.mark.parametrize("n,worst", [(256, [2, 1, 1]), (1024, [1, 1, 1, 1]),
                                     (16384, [1, 1, 1, 1, 1])])
def test_exchanges_are_free_of_bank_conflicts(n, worst):
    """The most wavefronts any warp access of each pass (its writes, and
    the next pass's reads, which are the same words) and of the
    bit-reversed read takes in a full block at the sizes the card runs:
    one everywhere but the first pass's writes at n = 256 (2-way)."""
    log2n = n.bit_length() - 1
    plan = sf.pass_plan(n)
    rows = plan.rows_per_block
    got = []
    for p, (R, s_hi, s_lo) in enumerate(_passes(plan, log2n)):
        base, _ = _items(log2n, rows, R, s_hi, s_lo, p == 0)
        got.append(max(_wavefronts(_swz(base[w:w + 32] + (j << s_lo)))
                       for w in range(0, len(base), 32)
                       for j in range(1 << R)))
    e = np.arange(rows * n)
    src = _swz((e - (e & (n - 1))) | _rev(e & (n - 1), log2n))
    got.append(max(_wavefronts(src[o + c:o + 128:4])
                   for o in range(0, rows * n, 128) for c in range(4)))
    assert got == worst


def test_exact_card_check_shapes_leave_partial_blocks():
    """checks.check_fft_exact (the card's bit-for-bit check) covers every
    n = 2^0 .. 2^14, and a partial last block wherever a block holds more
    than one row; on the CPU both of its sides are the plain version."""
    from repro_torch.kernels import checks
    cases = checks.fft_exact_cases()
    assert {n for _, n in cases} == {1 << k for k in range(15)}
    for n in {n for _, n in cases}:
        if sf.pass_plan(n).rows_per_block > 1:
            assert any(B % sf.pass_plan(n, B).rows_per_block
                       for B, m in cases if m == n)
    assert checks.check_fft_exact(np.random.default_rng(0), "cpu",
                                  log2ns=(0, 1, 3)) == 9
