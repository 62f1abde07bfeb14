"""The port's same-size conv2d (repro_torch.kernels.spm_conv2d) against
the reference Pallas kernel (repro.kernels.ops.conv2d_op, interpret mode
on the CPU) and the reference oracle: int32 bit for bit (also where the
sums overflow int32, and with shifts 0, 4 and 31), float32 within 1e-5,
bf16 within 2 ulp, int8 / int16 / uint8 / float16 exactly (sums past
the output range: the saturating cast, and float16's overflow to inf).
Inputs come from numpy with a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spm_conv2d as sc
from repro_torch.kvi import array_from_reference

SHAPES = [(32, 32, 3), (64, 48, 5), (16, 16, 7), (33, 31, 3),
          (17, 23, 4)]                       # F = 4: the asymmetric pad


def _port(img, filt, shift=0):
    return sc.spm_conv2d(array_from_reference(img),
                         array_from_reference(filt), shift=shift)


@pytest.mark.parametrize("H,W,F", SHAPES)
def test_int32_exact(H, W, F):
    """The JAX test's ranges and shift."""
    rng = np.random.default_rng(H * W + F)
    img = jnp.asarray(rng.integers(-128, 128, (H, W)), jnp.int32)
    filt = jnp.asarray(rng.integers(-8, 8, (F, F)), jnp.int32)
    want = np.asarray(jops.conv2d_op(img, filt, shift=4))
    got = _port(img, filt, shift=4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shift", [0, 4, 31])
@pytest.mark.parametrize("H,W,F", [(33, 31, 3), (17, 23, 4), (16, 16, 7)])
def test_int32_overflow_wraps_then_shifts(H, W, F, shift):
    """|img| < 2^20 and |filt| < 2^10: the sums pass 2^31; the wrapped
    int32 is shifted, as the reference does."""
    rng = np.random.default_rng(F + shift)
    img = jnp.asarray(rng.integers(-(1 << 20), 1 << 20, (H, W)), jnp.int32)
    filt = jnp.asarray(rng.integers(-(1 << 10), 1 << 10, (F, F)), jnp.int32)
    want = np.asarray(jops.conv2d_op(img, filt, shift=shift))
    np.testing.assert_array_equal(_port(img, filt, shift).numpy(), want)
    np.testing.assert_array_equal(
        tref.conv2d_ref(array_from_reference(img), array_from_reference(filt),
                        shift=shift).numpy(),
        np.asarray(jref.conv2d_ref(img, filt, shift=shift)))


@pytest.mark.parametrize("H,W,F", [(64, 64, 3), (17, 23, 4), (33, 31, 5)])
def test_float32_within_1e_5(H, W, F):
    rng = np.random.default_rng(F)
    img = jnp.asarray(rng.normal(0, 1, (H, W)), jnp.float32)
    filt = jnp.asarray(rng.normal(0, 1, (F, F)), jnp.float32)
    want = np.asarray(jops.conv2d_op(img, filt, shift=3))   # shift ignored
    got = _port(img, filt, shift=3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _ulp_bf16(x):
    """The spacing of bf16 at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("H,W,F", [(32, 32, 3), (17, 23, 4)])
def test_bfloat16_within_2_ulp(H, W, F):
    rng = np.random.default_rng(F + 1)
    img = jnp.asarray(rng.normal(0, 1, (H, W)), jnp.bfloat16)
    filt = jnp.asarray(rng.normal(0, 1, (F, F)), jnp.bfloat16)
    want = np.asarray(jops.conv2d_op(img, filt)).astype(np.float64)
    got = _port(img, filt)
    assert got.dtype == torch.bfloat16
    assert np.all(np.abs(got.double().numpy() - want) <= 2 * _ulp_bf16(want))


NARROW = {"int8": np.int8, "int16": np.int16, "uint8": np.uint8,
          "float16": np.float16}


def _narrow_operands(rng, H, W, F, name):
    """Integers: the dtype's whole range, a filter in [-3, 4) cast to the
    dtype (a uint8 filter wraps -3..-1 to 253..255, as numpy and the
    reference's astype do), so most sums leave the range; float16: sums
    up to ~1e5, past float16's 65504."""
    dt = NARROW[name]
    if name == "float16":
        return (rng.normal(0, 100, (H, W)).astype(dt),
                rng.normal(0, 100, (F, F)).astype(dt))
    info = np.iinfo(dt)
    return (rng.integers(info.min, int(info.max) + 1, (H, W)).astype(dt),
            rng.integers(-3, 4, (F, F)).astype(dt))


@pytest.mark.parametrize("name", sorted(NARROW))
@pytest.mark.parametrize("H,W,F", SHAPES)
def test_other_dtypes_match_the_reference(H, W, F, name):
    """float32 accumulation, then XLA's cast: integers truncated and
    saturated, float16 rounded to nearest even; ``shift`` ignored."""
    rng = np.random.default_rng(H * W + F + len(name))
    img, filt = _narrow_operands(rng, H, W, F, name)
    want = np.asarray(jops.conv2d_op(jnp.asarray(img), jnp.asarray(filt),
                                     shift=3))
    got = _port(jnp.asarray(img), jnp.asarray(filt), shift=3)
    assert str(got.dtype) == f"torch.{name}" and want.dtype == img.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if name != "float16":
        info = np.iinfo(img.dtype)
        assert np.isin(want, [info.min, info.max]).any()   # saturated
    else:
        assert np.isinf(want).any()                        # overflowed


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64,
                                   torch.complex64])
def test_other_dtypes_raise(dtype):
    """JAX narrows int64 / float64 images before the reference kernel,
    and its float32 accumulator drops a complex image's imaginary part."""
    with pytest.raises(TypeError):
        sc.spm_conv2d(torch.zeros((4, 4), dtype=dtype),
                      torch.zeros((3, 3), dtype=dtype))


def test_rejects_bad_filters():
    img = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        sc.spm_conv2d(img, torch.zeros((3, 2), dtype=torch.int32))


def _np_same_conv(img, filt, shift):
    """The same-size correlation as an int64 numpy sum, wrapped to int32,
    then shifted."""
    F = filt.shape[0]
    H, W = img.shape
    pad = F // 2
    p = np.pad(img.astype(np.int64), ((pad, F - 1 - pad), (pad, F - 1 - pad)))
    acc = np.zeros((H, W), np.int64)
    for fr in range(F):
        for fc in range(F):
            acc += p[fr:fr + H, fc:fc + W] * np.int64(filt[fr, fc])
    return acc.astype(np.int32) >> shift


def test_large_filter_computes_on_the_cpu():
    """F = 161, past the old kernel's shared-memory limit (154): the CPU
    path takes any F."""
    rng = np.random.default_rng(161)
    img = rng.integers(-(1 << 20), 1 << 20, (24, 20)).astype(np.int32)
    filt = rng.integers(-(1 << 10), 1 << 10, (161, 161)).astype(np.int32)
    got = sc.spm_conv2d(torch.from_numpy(img), torch.from_numpy(filt),
                        shift=4)
    np.testing.assert_array_equal(got.numpy(), _np_same_conv(img, filt, 4))


@pytest.mark.parametrize("bad", [None, float("nan"), float("inf")])
def test_padding_taps_skipped_only_when_they_add_nothing(bad):
    """The plain version skips the taps that read only padding; with a
    NaN or an infinity in the filter it runs them all (0 * w is then
    NaN), equal to the full loop either way."""
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.normal(0, 1, (5, 7)).astype(np.float32))
    filt = torch.from_numpy(rng.normal(0, 1, (13, 13)).astype(np.float32))
    if bad is not None:
        filt[0, 0] = bad
    assert (sc.live_taps(5, 7, filt) is None) == (bad is not None)
    padded = torch.nn.functional.pad(img, (6, 6, 6, 6))
    full = sc.correlate_plain(padded, filt)
    np.testing.assert_array_equal(sc.spm_conv2d_plain(img, filt).numpy(),
                                  full.numpy())


def test_shared_memory_grows_linearly_in_f():
    """The kernel streams input rows and the filter rows in use, not an
    F x F window: F = 1024 fits a block at every block width."""
    for tx in (32, 64, 128, 256):
        for dt in sc.DTYPES:
            sizes = [sc.smem_bytes(dt, F, tx) for F in (256, 512, 1024)]
            assert sizes[2] - sizes[1] == 2 * (sizes[1] - sizes[0])
            assert sizes[2] <= sc.SMEM_LIMIT
    assert sc.smem_bytes(torch.int32, 3000, 32) > sc.SMEM_LIMIT


def test_block_shapes_fill_the_card():
    """8 rows a thread where that still gives 24 warps an SM, else 4;
    blocks no wider than the image, then narrower until there are two
    tiles an SM."""
    assert sc.rows_per_thread(2048, 2048, 132) == 8
    assert sc.rows_per_thread(1024, 1024, 132) == 4
    assert sc.rows_per_thread(512, 512, 132) == 4
    assert sc.block_threads(2048, 2048, 8, 132) == 256
    assert sc.block_threads(1024, 1024, 4, 132) == 128
    assert sc.block_threads(512, 512, 4, 132) == 32
    assert sc.block_threads(1, 1, 4, 132) == 32
    assert sc.tiles(2048, 2048, 256, 8) == 2 * 256


def test_card_checks_rehearsed_on_the_cpu():
    """``checks.check_compute_case`` over every conv dtype / shift variant
    at the card cases' small shapes, on the CPU (plain against plain):
    the operands of each dtype build and compare exactly."""
    from repro_torch.kernels import checks
    rng = np.random.default_rng(2)
    small = [s for k, s in checks.compute_kernel_cases()
             if k == "spm_conv2d" and s["H"] * s["W"] <= 64 * 64]
    assert {s["F"] for s in small} >= {1024, 161, 11, 4, 3}
    for shape in small:
        assert checks.check_compute_case(rng, "spm_conv2d", shape,
                                         "cpu") == 0
    img, filt = checks.conv_operands(rng, 9, 9, 3, torch.uint8, "cpu")
    assert filt.dtype == torch.uint8 and int(filt.max()) >= 253
