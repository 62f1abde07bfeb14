"""Mamba-1's selective scan on the card (``repro_torch.kernels.
selective_scan``, which ``models.ssm.selective_scan`` runs on CUDA
tensors): the path follows the device, the CPU's plain scan unchanged,
the kernels' segment-checkpoint algorithm (its plain mirror) against
autograd through the recurrence in float64, and, marked ``cuda`` (skipped
without a card, decided in a fixture), the kernels against the plain
version, bit for bit from run to run, the shapes they refuse, and their
launches in a remat train step.

No JAX here: the reference side is the port's plain scan and autograd.
Run the card tests on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_selective_scan.py
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import checks
from repro_torch.kernels import selective_scan as sk
from repro_torch.kernels.build import nvcc_path
from repro_torch.models import ssm

# (Bz, S, d, N, K): S not a multiple of the segment K (the kernels' 16,
# and 8 and 4), N ragged and past 16
CASES = [(2, 37, 5, 3, 16), (1, 21, 3, 16, 8), (2, 10, 4, 20, 4),
         (1, 16, 2, 13, 16)]
IDS = ["S37-K16-N3", "S21-K8-N16", "S10-K4-N20", "S16-K16-N13"]


def _inputs(Bz, S, d, N, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g, dtype=dtype)  # noqa: E731
    u, dt = r(Bz, S, d), F.softplus(r(Bz, S, d) - 2)
    A = -torch.exp(r(d, N) * 0.5)
    return (u, dt, A, r(Bz, S, N), r(Bz, S, N), r(Bz, d, N)), r(Bz, S, d), \
        r(Bz, d, N)


def _grads(fn, ins, gy, glast, init=True):
    """fn's y, final state and the gradients of its inputs (the initial
    state's when given) for the output gradients gy and glast (None: the
    final state left out)."""
    leaves = [t.clone().requires_grad_(True) for t in ins[:5 + init]]
    y, last = fn(*leaves[:5], initial_state=leaves[5] if init else None)
    outs, grads = ((y, last), (gy, glast)) if glast is not None else \
        ((y,), (gy,))
    return (y.detach(), last.detach()) + torch.autograd.grad(
        outs, leaves, grads)


def test_the_path_follows_the_device():
    assert ssm.selective_scan_path(torch.zeros(1)) == "plain"
    assert ssm.selective_scan_path(torch.zeros(1, device="meta")) == "plain"


@pytest.mark.parametrize("init", [True, False], ids=["init", "no-init"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_selective_scan_on_cpu_is_unchanged(dtype, init):
    """On CPU tensors ``models.ssm.selective_scan`` is the plain
    ``_SelectiveScan``, bit for bit, in value and gradient, and launches
    nothing."""
    ins, gy, glast = _inputs(2, 45, 6, 16, torch.float32, seed=3)
    ins = tuple(t.to(dtype) if i in (0, 3, 4) else t
                for i, t in enumerate(ins))
    before = dict(sk.part_launches)

    def plain(u, dt, A, B, C, initial_state):
        return ssm._SelectiveScan.apply(u, dt, A, B, C, initial_state, 4)

    got = _grads(lambda *a, **k: ssm.selective_scan(*a, chunk=4, **k), ins,
                 gy, glast, init)
    want = _grads(plain, ins, gy, glast, init)
    assert sk.part_launches == before
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("init,final_grad", [(True, True), (False, True),
                                             (True, False)],
                         ids=["init-glast", "no-init", "no-glast"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_mirror_equals_autograd_of_the_recurrence(case, init,
                                                            final_grad):
    """In float64, the kernels' algorithm (``scan_forward_plain``'s
    checkpoints every K positions, ``scan_backward_plain``'s segments in
    reverse) against autograd through ``selective_scan_ref``: the
    equations of ``csrc/selective_scan.cu`` to float64 rounding."""
    *shape, K = case
    ins, gy, glast = _inputs(*shape, seed=sum(case))
    want = _grads(ssm.selective_scan_ref, ins, gy,
                  glast if final_grad else None, init)
    s0 = ins[5] if init else None
    y, last, ck = sk.scan_forward_plain(*ins[:5], s0, K)
    assert ck.shape == (shape[0], -(-shape[1] // K), shape[2], shape[3])
    got = (y, last) + sk.scan_backward_plain(
        *ins[:5], ck, gy, glast if final_grad else None, K, init)
    for g, w in zip(got, want):
        assert g is not None and g.dtype == torch.float64
        assert (g - w).abs().max().item() <= 1e-12 * (1 + w.abs().max())


def test_function_on_cpu_runs_the_plain_mirrors():
    """The kernels' ``autograd.Function`` on CPU tensors runs the mirrors:
    ``checks.check_selective_scan`` passes (against the plain scan and
    float64) at every card case but the cell's, and no launch counts."""
    before = dict(sk.part_launches)
    for shape in checks.selective_scan_cases():
        for dtype in (torch.float32, torch.bfloat16):
            err = checks.check_selective_scan(np.random.default_rng(2),
                                              device="cpu", dtype=dtype,
                                              **shape)
            assert set(err) == set(checks.SELECTIVE_SCAN_OUTPUTS)
    assert sk.part_launches == before


def test_tilings():
    """Every tiling fills a block's 128 threads and keeps its segment's
    states in 64 registers a thread; N picks four lanes of four states up
    to 16 and eight lanes past it."""
    for t, (ns, q) in enumerate(sk.TILINGS):
        g = sk.geometry(t)
        assert g["DC"] * q == sk.THREADS and g["K"] * ns <= 64
    assert [sk.tiling_for(n) for n in (1, 16, 17, 32)] == [0, 0, 1, 1]
    assert sk.segments(1152, 0) == 72 and sk.segments(1153, 0) == 73


def test_shapes_it_refuses_raise():
    ins, _, _ = _inputs(1, 8, 4, 6, torch.float32)
    u, dt, A, B, C, s0 = ins
    with pytest.raises(ValueError, match="A \\[d, N\\]"):
        sk.selective_scan(u, dt, A[:1], B, C)
    with pytest.raises(ValueError, match="initial state"):
        sk.selective_scan(u, dt, A, B, C, initial_state=s0.transpose(1, 2))
    wide, _, _ = _inputs(1, 8, 4, 33, torch.float32)
    with pytest.raises(ValueError, match="N = 33"):
        sk.selective_scan(*wide[:5])
    with pytest.raises(ValueError, match="float tensors"):
        sk.selective_scan(u.int(), dt, A, B, C)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.selective_scan(*(t.to("meta") for t in ins[:5]))


def test_costs_at_the_cell():
    """The timings' bounds at hymba's cell: B S d N exponentials a walk,
    which bound the forward; the backward's float32 gradients of y and dt
    make its bytes the larger."""
    from repro_torch.kernels import micro
    c = micro.selective_scan_costs(micro.SELECTIVE_SCAN_CELL)
    sd = 8 * 1152 * 3200
    assert c["forward"]["exps"] == sd * 16 == 471_859_200
    assert c["forward_backward"]["exps"] == 2 * sd * 16
    assert c["forward"]["bytes"] == sd * (2 + 4 + 4) + 2 * 8 * 1152 * 16 * 2 \
        + 3200 * 16 * 4 + 8 * 3200 * 16 * 4
    assert c["forward"]["bound_by"] == "exponentials"
    assert c["backward"]["bound_by"] == "bytes"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", checks.LM_TYPES, ids=str)
@pytest.mark.parametrize("shape", checks.selective_scan_card_cases(),
                         ids=lambda s: "-".join(f"{k}{v}"
                                                for k, v in s.items()))
def test_kernels_equal_the_plain_version(card, shape, dtype):
    """y, the final state and all six gradients of the kernels against
    the plain scan on the same CUDA tensors, each within
    ``checks.check_selective_scan``'s tolerance (twice the plain float32
    version's own error against float64, plus 64 float32 roundings and a
    16-bit output's step); u, B and C in ``dtype``; one launch of each
    part."""
    before = dict(sk.part_launches)
    err = checks.check_selective_scan(np.random.default_rng(13),
                                      device=card, dtype=dtype, **shape)
    torch.cuda.synchronize()
    assert set(err) == set(checks.SELECTIVE_SCAN_OUTPUTS)
    assert {k: sk.part_launches[k] - before[k] for k in before} == \
        dict.fromkeys(sk.PARTS + sk.BWD_PARTS, 1)


@pytest.mark.cuda
def test_gradients_are_bitwise_repeatable(card):
    """No float atomics: two runs give the same bits, outputs and
    gradients, at the cell's widths."""
    ops = checks.selective_scan_operands(np.random.default_rng(14), 8, 1152,
                                         3200, 16, card, torch.bfloat16)
    first = checks.selective_scan_outputs(sk.selective_scan, *ops)
    second = checks.selective_scan_outputs(sk.selective_scan, *ops)
    for name, a, b in zip(checks.SELECTIVE_SCAN_OUTPUTS, first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_shapes_the_kernels_refuse_raise(card):
    """On CUDA tensors the wrapper raises on what the kernels do not take,
    before any launch; nothing falls back to the plain scan."""
    ops = checks.selective_scan_operands(np.random.default_rng(15), 1, 8, 4,
                                         33, card)
    before = dict(sk.part_launches)
    with pytest.raises(ValueError, match="N = 33"):
        ssm.selective_scan(*ops[:5], chunk=4)
    u, dt, A, B, C = checks.selective_scan_operands(
        np.random.default_rng(15), 1, 8, 4, 16, card)[:5]
    with pytest.raises(ValueError, match="float32, bf16 or float16"):
        ssm.selective_scan(u.double(), dt, A, B, C, chunk=4)
    with pytest.raises(ValueError, match="A in float32"):
        ssm.selective_scan(u, dt, A.double(), B, C, chunk=4)
    with pytest.raises(ValueError, match="empty"):
        ssm.selective_scan(u[:, :0], dt[:, :0], A, B[:, :0], C[:, :0],
                           chunk=4)
    assert sk.part_launches == before


@pytest.mark.cuda
def test_remat_train_step_launches_each_part(card):
    """A reduced hymba's train step with the blocks recomputed: every
    layer's scan takes the kernels, twice forward (the forward and its
    recompute) and once backward."""
    from repro_torch.configs import get_spec, reduced_model
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import params as params_lib
    from repro_torch.models import steps
    from repro_torch.models.sharding import make_rules
    from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
    spec = get_spec("hymba-1.5b")
    cfg = reduced_model(spec.model)
    par = spec.parallelism.replace(remat="block", fsdp=False,
                                   sequence_parallel=False)
    rules = make_rules(None, cfg, par)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = params_lib.initialize(zoo.param_template(cfg), 0, device=card)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 100, (2, 128)).astype(
        np.int32)).to(card) for k in ("tokens", "labels")}
    step = steps.make_train_step(cfg, rules, par, opt)
    before = dict(sk.part_launches)
    _, _, met = step(params, adamw_init(params, opt), batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(met["loss"]))
    L = cfg.num_layers
    got = {k: sk.part_launches[k] - before[k] for k in before}
    assert got == {**dict.fromkeys(sk.PARTS, 2 * L),
                   **dict.fromkeys(sk.BWD_PARTS, L)}
