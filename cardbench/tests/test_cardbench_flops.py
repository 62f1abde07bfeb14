"""The model FLOP counts against sums written out by hand."""
import dataclasses
import json

from conftest import ROOT

from cardbench.flops import ssm


def _model(name):
    return json.loads((ROOT / "cardbench" / "configs" /
                       f"{name}.json").read_text())["model"]


def test_mamba2_step_flops_by_hand():
    m = _model("mamba2-1.3b")
    # a layer: ln1 2048; in-projections z, x 2 * 2048 * 4096, B, C
    # 2 * 2048 * 128, dt 2048 * 64; conv 4 * (4096 + 256); A, dt bias, D
    # 3 * 64; gate norm 4096; out 4096 * 2048
    layer = (2048 + 2 * 2048 * 4096 + 2 * 2048 * 128 + 2048 * 64 +
             4 * 4352 + 192 + 4096 + 4096 * 2048)
    assert layer == 25_844_928
    params = 48 * layer + 2048 + 2048 * 50277
    assert ssm.params(m) == params == 1_343_525_888
    # SSD, one layer and sequence: 16 chunks of 256, 32896 causal pairs,
    # 1 group of state 128, 64 heads of 64
    ssd = 16 * (2 * 128 * 32896 + 64 * (2 * 64 * 32896 + 4 * 256 * 128 * 64 +
                                        2 * 128 * 64))
    assert ssm.ssd_forward_flops(m, 4096) == ssd
    expect = 6 * params * 8 * 4096 + 3 * 48 * 8 * ssd
    assert ssm.train_step_flops(m, 8, 4096) == expect


def test_param_counts_match_the_program():
    """The benchmark's count is the program's parameters less the
    embedding table, plus the head over the published vocabulary (the
    head is the table, tied)."""
    from repro_torch.configs import get_spec
    from repro_torch.models import model_zoo as zoo
    cfg = json.loads((ROOT / "cardbench" / "configs" /
                      "mamba2-1.3b.json").read_text())
    m, Vp = cfg["model"], cfg["padded_vocab"]
    n = zoo.param_count(dataclasses.replace(get_spec(cfg["arch"]).model,
                                            **m))
    assert n == cfg["derived"]["params"]
    assert zoo.padded_vocab(m["vocab_size"]) == Vp
    assert ssm.params(m) == n - Vp * m["d_model"] + m["vocab_size"] * \
        m["d_model"]
