"""The hymba configuration's own pieces: the plain reference
(``reference/hymba.py``) against its configuration and a scan written
out position by position under autograd, the hybrid FLOP and byte counts
(``flops/hybrid.py``) against sums worked by hand, and the readers of
its three metrics."""
import json

import pytest
import torch

from conftest import ROOT

from cardbench.flops import hybrid
from cardbench.harness import manifest, weights
from cardbench.reference import hymba

CFG = json.loads((ROOT / "cardbench/configs/hymba-1.5b.json").read_text())
CELL = "train.hymba-1.5b.s1k"


def test_param_specs_count_the_published_parameters():
    specs = hymba.param_specs(CFG)
    n = sum(torch.Size(shape).numel() for _, shape, _, _ in specs)
    m = CFG["model"]
    pad = (CFG["padded_vocab"] - m["vocab_size"]) * m["d_model"]
    assert n == CFG["derived"]["params"] == 1_523_205_824
    assert n - pad == CFG["derived"]["published_params"] == 1_522_797_824
    assert len(hymba.producers(m)) == CFG["derived"]["kv_producers"] == 17
    assert {law for _, _, law, _ in specs} == {"randn", "zeros", "ones",
                                               "a_log", "dt_bias"}


def tiny_config() -> dict:
    cfg = json.loads(json.dumps(CFG))
    cfg["model"].update(num_layers=4, d_model=16, num_heads=2,
                        num_kv_heads=1, head_dim=8, v_head_dim=16, d_ff=24,
                        vocab_size=50, sliding_window=4, meta_tokens=2,
                        global_layers=[0, 3], kv_groups=[[1, 2]],
                        ssm_state=4, ssm_dt_rank=2)
    cfg["padded_vocab"] = 64
    return cfg


def hand_rolled_scan(u, dt, A, Bm, Cm):
    """The recurrence one position at a time, every step under
    autograd."""
    s = torch.zeros(u.shape[0], u.shape[2], A.shape[1], dtype=u.dtype)
    ys = []
    for t in range(u.shape[1]):
        s = torch.exp(dt[:, t, :, None] * A) * s + \
            (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None, :]
        ys.append((s * Cm[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1)


def test_the_scan_and_its_gradient_are_the_recurrence():
    g = torch.Generator().manual_seed(0)
    f64 = dict(dtype=torch.float64)
    ins = [torch.randn(2, 9, 5, generator=g, **f64),
           torch.rand(2, 9, 5, generator=g, **f64) * 2,
           -torch.rand(5, 3, generator=g, **f64) * 8,
           torch.randn(2, 9, 3, generator=g, **f64),
           torch.randn(2, 9, 3, generator=g, **f64)]
    ins = [x.requires_grad_() for x in ins]
    y, want = hymba.selective_scan(*ins), hand_rolled_scan(*ins)
    torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)
    gy = torch.randn_like(y)
    for a, b in zip(torch.autograd.grad((y * gy).sum(), ins),
                    torch.autograd.grad((want * gy).sum(), ins)):
        torch.testing.assert_close(a, b, rtol=1e-11, atol=1e-11)


def test_one_step_equals_one_with_a_hand_rolled_scan(monkeypatch):
    cfg = tiny_config()
    w0 = weights.make(hymba.param_specs(cfg), 5, "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 50, (2, 11), generator=gen)
    feed = [(toks[:, :-1], toks[:, 1:])]
    got = hymba.train(cfg, w0, feed, rows=1)
    monkeypatch.setattr(hymba, "selective_scan", hand_rolled_scan)
    want = hymba.train(cfg, w0, feed, rows=1)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
    for part in ("grad", "change"):
        for k in want[part]:
            assert got[part][k] == pytest.approx(want[part][k], rel=1e-4,
                                                 abs=1e-7), (part, k)


def test_the_window_leaves_the_meta_tokens_visible():
    q = torch.zeros(1, 7, 1, 2)
    k = torch.zeros(1, 7, 1, 2)
    v = torch.eye(7)[None, :, None, :]          # each key's own column
    out = hymba.attention(q, k, v, 2, 2, lambda eq, a, b:
                          torch.einsum(eq, a, b))[0]
    # equal scores: each query weighs its visible keys equally
    seen = (out > 0).int().tolist()
    assert seen[6] == [1, 1, 0, 0, 0, 1, 1]     # meta 0, 1 and the window
    assert seen[2] == [1, 1, 1, 0, 0, 0, 0]


SMALL = {"num_layers": 3, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
         "head_dim": 4, "v_head_dim": 8, "d_ff": 16, "vocab_size": 10,
         "ssm_expand": 2, "ssm_state": 2, "ssm_dt_rank": 2,
         "meta_tokens": 2, "sliding_window": 2, "global_layers": [0],
         "kv_groups": [[1, 2]]}


def test_hybrid_step_flops_by_hand():
    m = SMALL
    # a layer: q 8 * 2 * 4; x, z 2 * 8 * 16; x_proj 16 * (2 + 4); dt_proj
    # 2 * 16; out 16 * 8; MLP 3 * 8 * 16
    assert hybrid.layer_params(m) == 64 + 256 + 96 + 32 + 128 + 384 == 960
    # K/V of layers 0 and 1: 8 x 1 head x (4 + 8)
    assert hybrid.params(m) == 3 * 960 + 2 * 96 == 3072
    # 5 positions (2 meta + 3): causal 15 pairs; with a window of 2 and 2
    # meta keys queries 0..4 see 1, 2, 3, 4, 4
    assert hybrid.visible_pairs(5, 0, 2) == 15
    assert hybrid.visible_pairs(5, 2, 2) == 14
    assert hybrid.attention_forward_flops(m, 5) == \
        2 * 2 * 12 * 15 + 2 * (2 * 2 * 12 * 14)
    assert hybrid.scan_forward_flops(m, 5) == 6 * 16 * 2 * 5
    expect = 6 * 3072 * 2 * 5 + 6 * 8 * 10 * 2 * 3 + \
        3 * 2 * (2064 + 3 * 960)
    assert hybrid.train_step_flops(m, 2, 3) == expect == 216864


def test_scan_bytes_by_hand():
    # batch 2 x 5 positions: a [.., d_inner 16] activation 320 bytes at
    # bf16, a [.., N 2] one 40, A 16 x 2 float32 128
    got = hybrid.scan_bytes(SMALL, 2, 3)
    assert got["forward"] == got["recompute"] == 2 * 320 + 2 * 40 + 128 + 320
    assert got["backward"] == (3 * 320 + 80 + 128) + (2 * 320 + 80 + 128)
    assert hybrid.scan_step_bytes(SMALL, 2, 3) == 3 * (2 * 1168 + 2016)


def test_the_cell_and_its_metrics():
    cell = manifest.load_cell(ROOT / "BENCHMARK.json", CELL)
    assert cell.config["reference"] == "hymba"
    assert cell.traffic == {"kind": "token_stream", "batch": 8, "seq": 1024,
                            "batches": 16}
    names = {m["name"] for m in cell.per_layer}
    assert {"selective_scan_ms.train", "attention_ms.train",
            "selective_scan_roofline.train"} <= names
    assert "ssd_ms.train" not in names
    for name in ("selective_scan_ms.train", "attention_ms.train",
                 "selective_scan_roofline.train"):
        reader = manifest.load_metric(name)
        assert reader.read({}) is None
        assert reader.read({"kind": "train"}) is None


def test_the_roofline_share_from_the_span_time(monkeypatch):
    from cardbench.harness import program_spans
    reader = manifest.load_metric("selective_scan_roofline.train")
    monkeypatch.setattr(reader, "per_step_ms", lambda ctx, key: 1000.0)
    m = CFG["model"]
    nbytes = hybrid.scan_step_bytes(m, 8, 1024)
    got = reader.read({"kind": "train", "tokens_per_step": 8192})
    assert got == pytest.approx(100 * nbytes / 3.35e12)
    # another cell's steps: nothing to read
    assert reader.read({"kind": "train", "tokens_per_step": 32768}) is None
    assert program_spans.per_step_ms({"kind": "serve"}, "x") is None
