"""The SSD scan for training (``repro_torch.kernels.ssd_scan.ssd_train``,
which ``models.ssm.ssd_chunked`` runs on CUDA tensors): its plain
backward (``ssd_backward_plain``, what the ``autograd.Function`` runs on
CPU tensors) against autograd, ``ssd_chunked`` on CPU tensors unchanged,
and, marked ``cuda`` (skipped without a card, decided in a fixture), the
card's kernels against the plain version, bit for bit from run to run,
and their launches in a remat train step.

No JAX here: the reference side is the port's plain layer and autograd.
Run the card tests on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_train.py
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import checks
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.build import nvcc_path
from repro_torch.models import ssm

# (Bz, S, H, P, N, G, chunk): S not a multiple of the chunk; G 1 and 2
# with H / G > 1; N 16 and 128; P 24 and 64
CASES = [(2, 100, 4, 24, 16, 2, 32), (1, 96, 4, 64, 128, 1, 32),
         (2, 64, 6, 24, 128, 2, 16), (1, 80, 2, 64, 16, 1, 64)]
IDS = ["S100-G2-N16-P24", "S96-G1-N128-P64", "S64-G2-N128-P24",
       "S80-G1-N16-P64"]


def _inputs(Bz, S, H, P, N, G, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(Bz, S, H, P, generator=g, dtype=dtype)
    dt = torch.rand(Bz, S, H, generator=g, dtype=dtype) * 0.099 + 0.001
    A = -torch.exp(torch.randn(H, generator=g, dtype=dtype) * 0.5)
    B = torch.randn(Bz, S, G, N, generator=g, dtype=dtype)
    C = torch.randn(Bz, S, G, N, generator=g, dtype=dtype)
    h0 = torch.randn(Bz, H, P, N, generator=g, dtype=dtype)
    dy = torch.randn(Bz, S, H, P, generator=g, dtype=dtype)
    dh = torch.randn(Bz, H, P, N, generator=g, dtype=dtype)
    return (x, dt, A, B, C, h0), dy, dh


def _grads(fn, ins, dy, dh, chunk, init=True, final_grad=True):
    """fn's y, final state and the gradients of its inputs (the initial
    state's when given) for the output gradients dy and dh."""
    leaves = [t.clone().requires_grad_(True) for t in ins[:5 + init]]
    y, final = fn(*leaves[:5], chunk=chunk,
                  initial_state=leaves[5] if init else None)
    outs, grads = (y, final), (dy, dh)
    if not final_grad:
        outs, grads = (y,), (dy,)
    return (y.detach(), final.detach()) + torch.autograd.grad(
        outs, leaves, grads)


@pytest.fixture
def kernel_path(monkeypatch):
    """``ssd_chunked`` taking the kernels' path (``ssd_train``: padding,
    layouts, the Function) on CPU tensors, where the Function runs the
    plain versions."""
    monkeypatch.setattr(ssm, "ssd_path", lambda x: "kernel")


@pytest.mark.parametrize("init,final_grad", [(True, True), (False, True),
                                             (True, False)],
                         ids=["init-dfinal", "no-init", "no-dfinal"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_plain_equals_autograd_of_the_plain_forward(case, init,
                                                             final_grad):
    """In float64, the Function's plain backward against autograd through
    its plain forward (the chunked algorithm in float64 ops): the
    equations of ``csrc/ssd_train.cu`` to float64 rounding."""
    *shape, chunk = case
    ins, dy, dh = _inputs(*shape, seed=sum(case))
    cs = chunk
    S = shape[1]
    pad = -S % cs

    def padded(x, dt, A, B, C, chunk, initial_state):
        y, f, *_ = ss._forward(
            F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
            F.pad(B, (0, 0, 0, 0, 0, pad)), F.pad(C, (0, 0, 0, 0, 0, pad)),
            None if initial_state is None
            else initial_state.transpose(-1, -2), chunk)
        return y[:, :S], f.transpose(-1, -2)

    def function(x, dt, A, B, C, chunk, initial_state):
        y, f = ss.ssd_train(
            F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
            F.pad(B, (0, 0, 0, 0, 0, pad)), F.pad(C, (0, 0, 0, 0, 0, pad)),
            chunk=chunk, initial_state=initial_state)
        return y[:, :S], f

    want = _grads(padded, ins, dy, dh, cs, init, final_grad)
    got = _grads(function, ins, dy, dh, cs, init, final_grad)
    assert len(got) == len(want) == 7 + init
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_path_equals_autograd_of_ssd_chunked(case, kernel_path):
    """``ssd_chunked`` through the kernels' path (padding, the Function,
    its plain backward) against autograd of ``ssd_chunked``'s plain body,
    float64 inputs, every input's gradient (the initial state's too) and
    both outputs' gradients. The plain body computes in float32 whatever
    its inputs, so it lies within float32 rounding of the float64 path:
    held to 1e-5 of each tensor's largest magnitude (sums of up to a few
    hundred float32 terms and a float32 cumsum inside the exps; 2e-6 to
    9e-6 seen)."""
    *shape, chunk = case
    ins, dy, dh = _inputs(*shape, seed=sum(case))
    got = _grads(ssm.ssd_chunked, ins, dy, dh, chunk)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(ssm, "ssd_path", lambda x: "plain")
        want = _grads(ssm.ssd_chunked, ins, dy, dh, chunk)
    for name, g, w in zip(checks.SSD_TRAIN_OUTPUTS, got, want):
        assert g.shape == w.shape, name
        err = (g - w.to(g.dtype)).abs().max().item()
        assert err <= 1e-5 * w.abs().max().item(), (name, err)


def _ssd_chunked_seed(x, dt, A, B, C, *, chunk, initial_state=None):
    """``ssd_chunked``'s plain body as it was before the kernels' path,
    verbatim (S a multiple of the chunk)."""
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, cs = S // chunk, chunk
    rep = H // G

    x_ = x.float().reshape(Bz, nc, cs, H, P)
    dt_ = dt.float().reshape(Bz, nc, cs, H)
    B_ = B.float().reshape(Bz, nc, cs, G, N)
    C_ = C.float().reshape(Bz, nc, cs, G, N)
    a = dt_ * A.float()
    a_h = a.permute(0, 1, 3, 2)
    cum = torch.cumsum(a_h, dim=-1)
    xdt = x_ * dt_[..., None]
    seg = ssm._segsum_decay(a_h)
    cb = torch.einsum("bcign,bcjgn->bcgij", C_, B_)
    cb = cb.repeat_interleave(rep, dim=2)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", cb * seg, xdt)
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    Bh = B_.repeat_interleave(rep, dim=3).permute(0, 1, 3, 2, 4)
    states = torch.einsum("bchj,bchjn,bcjhp->bchpn",
                          decay_to_end, Bh, xdt)
    chunk_decay = torch.exp(cum[..., -1])
    h = (torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)
    Ch = C_.repeat_interleave(rep, dim=3).permute(0, 1, 3, 2, 4)
    y_inter = torch.einsum("bchin,bchpn->bcihp",
                           Ch * torch.exp(cum)[..., None], h_prevs)
    y = (y_intra + y_inter).reshape(Bz, S, H, P)
    return y.to(x.dtype), h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", CASES[1:3], ids=IDS[1:3])
def test_ssd_chunked_on_cpu_is_unchanged(case, dtype):
    """On CPU tensors ``ssd_chunked`` is the plain layer, bit for bit, in
    value and gradient, and launches nothing."""
    *shape, chunk = case
    ins, dy, dh = _inputs(*shape, dtype=torch.float32, seed=sum(case))
    ins = (ins[0].to(dtype),) + ins[1:]
    before = dict(ss.part_launches)
    got = _grads(ssm.ssd_chunked, ins, dy.to(dtype), dh, chunk)
    want = _grads(_ssd_chunked_seed, ins, dy.to(dtype), dh, chunk)
    assert ss.part_launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_the_path_follows_the_device():
    assert ssm.ssd_path(torch.zeros(1)) == "plain"
    assert ssm.ssd_path(torch.zeros(1, device="meta")) == "plain"


def test_function_on_cpu_runs_the_plain_versions():
    """The Function's forward and backward on CPU tensors are the plain
    versions exactly (``checks.check_ssd_train`` finds 0 everywhere), and
    count no launch."""
    before = dict(ss.part_launches)
    for dtype in (torch.float32, torch.bfloat16):
        err = checks.check_ssd_train(np.random.default_rng(2), 2, 128, 4, 24,
                                     16, 2, 32, "cpu", dtype)
        assert err == dict.fromkeys(checks.SSD_TRAIN_OUTPUTS, 0.0)
    assert ss.part_launches == before


@pytest.mark.parametrize("G", [64, 1])
def test_train_costs(G):
    """The training launches' operations (``micro.ssd_part_costs``): with
    a group a head, the scores and y split the three-kernel scan's chunk
    scan; with one group the scores are the heads' share, and the
    backward's Cbar and Bbar products (Shat's once a group) likewise."""
    from repro_torch.kernels import micro
    shape = dict(micro.SSD_TRAIN_CELL, G=G)
    c = {k: v[1][0][0] for k, v in micro.ssd_part_costs(shape).items()}
    assert set(c) == set(ss.PARTS + ss.TRAIN_PARTS + ss.BWD_PARTS)
    chunks, tri = 8 * 64 * 16, 256 * 257 // 2
    if G == 64:
        assert c["ssd_scores"] + c["ssd_train_scan"] == c["ssd_chunk_scan"]
    assert c["ssd_scores"] == 8 * G * 16 * 2 * tri * 128
    assert c["ssd_train_scan"] == c["ssd_bwd_dx"] == chunks * (
        2 * tri * 64 + 2 * 256 * 128 * 64)
    assert c["ssd_bwd_dc"] == c["ssd_bwd_db"] == c["ssd_scores"] + \
        c["ssd_bwd_chunk_state"]
    assert micro.bound(*micro.ssd_part_costs(shape)["ssd_bwd_dcum"])[
        "bound_by"] == "bytes"


def test_shapes_it_refuses_raise():
    ins, _, _ = _inputs(1, 100, 2, 8, 4, 1)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ss.ssd_train(*ins[:5], chunk=32)
    x, dt, A, B, C, h0 = _inputs(1, 64, 2, 8, 4, 1)[0]
    with pytest.raises(ValueError, match="A \\[2\\]"):
        ss.ssd_train(x, dt, A[:1], B, C, chunk=32)
    with pytest.raises(ValueError, match="initial state"):
        ss.ssd_train(x, dt, A, B, C, chunk=32,
                     initial_state=h0.transpose(-1, -2))


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
@pytest.mark.parametrize("dtype", checks.LM_TYPES + (torch.float16,),
                         ids=str)
@pytest.mark.parametrize("shape", checks.ssd_train_card_cases(),
                         ids=lambda s: "-".join(f"{k}{v}"
                                                for k, v in s.items()))
def test_train_kernels_equal_the_plain_version(card, shape, dtype):
    """y, the final state and every gradient of the card's kernels
    against the plain version on the same CUDA tensors, within
    ``checks.ssd_train_tolerance``; B and C in x's type at a 16-bit x (as
    the model gives them); one launch of each part."""
    before = dict(ss.part_launches)
    bc = torch.float32 if dtype == torch.float32 else dtype
    err = checks.check_ssd_train(np.random.default_rng(13), device=card,
                                 dtype=dtype, bc_dtype=bc, **shape)
    torch.cuda.synchronize()
    assert set(err) == set(checks.SSD_TRAIN_OUTPUTS)
    assert {k: ss.part_launches[k] - before[k]
            for k in ss.TRAIN_PARTS + ss.BWD_PARTS} == dict.fromkeys(
                ss.TRAIN_PARTS + ss.BWD_PARTS, 1)


@pytest.mark.cuda
def test_train_gradients_are_bitwise_repeatable(card):
    """No float atomics: two runs give the same bits, outputs and
    gradients, at the cell's widths."""
    ops = checks.ssd_train_operands(np.random.default_rng(14), 2, 1024, 64,
                                    64, 128, 1, card, torch.bfloat16,
                                    torch.bfloat16)
    first = checks.ssd_train_outputs(*ops, 256)
    second = checks.ssd_train_outputs(*ops, 256)
    for name, a, b in zip(checks.SSD_TRAIN_OUTPUTS, first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_remat_train_step_launches_each_part(card):
    """A reduced mamba2's train step with the blocks recomputed: every
    layer's scan takes the kernels, twice forward (the forward and its
    recompute) and once backward."""
    from repro_torch.configs import get_spec, reduced_model
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import params as params_lib
    from repro_torch.models import steps
    from repro_torch.models.sharding import make_rules
    from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
    spec = get_spec("mamba2-1.3b")
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
    before = dict(ss.part_launches)
    _, _, met = step(params, adamw_init(params, opt), batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(met["loss"]))
    L = cfg.num_layers
    got = {k: ss.part_launches[k] - before[k]
           for k in ss.TRAIN_PARTS + ss.BWD_PARTS}
    assert got == {**dict.fromkeys(ss.TRAIN_PARTS, 2 * L),
                   **dict.fromkeys(ss.BWD_PARTS, L)}
