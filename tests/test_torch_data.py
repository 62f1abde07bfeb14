"""The port's data pipeline (repro_torch.data.pipeline, a copy of the
reference's): the reference's checks (tests/test_data.py) re-run on the
port, and every batch byte-equal to the reference's for each family's
input layout, both sources, several steps and host splits."""
import numpy as np
import pytest

import repro.configs as rcfg
from repro.data import pipeline as rpipe
from repro_torch.configs import get_spec, list_archs, reduced_model
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import (DataConfig, DataPipeline,
                                       SyntheticTokens, make_batch_fn)
from repro_torch.models.steps import LABEL_IGNORE
from test_torch_lm_params import port_spec


def _pipe(num_hosts=1, host_id=0, seed=0, arch="llama3.2-1b"):
    cfg = reduced_model(get_spec(arch).model)
    shape = ShapeConfig("t", "train", 64, 8)
    return DataPipeline(cfg, shape, DataConfig(
        seed=seed, num_hosts=num_hosts, host_id=host_id))


def test_batch_is_pure_function_of_step():
    p1, p2 = _pipe(), _pipe()
    for step in (0, 5, 1000):
        b1, b2 = p1.batch_at(step), p2.batch_at(step)
        for k in b1:
            assert np.array_equal(b1[k], b2[k])


def test_different_steps_differ():
    p = _pipe()
    assert not np.array_equal(p.batch_at(0)["tokens"], p.batch_at(1)["tokens"])


def test_host_sharding_disjoint_and_covering():
    """2-host split: concat of host batches == the 1-host global batch."""
    full = _pipe(num_hosts=1).batch_at(3)["tokens"]
    h0 = _pipe(num_hosts=2, host_id=0).batch_at(3)["tokens"]
    h1 = _pipe(num_hosts=2, host_id=1).batch_at(3)["tokens"]
    assert np.array_equal(np.concatenate([h0, h1]), full)


def test_labels_are_shifted_tokens():
    b = _pipe().batch_at(0)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_synthetic_has_learnable_structure():
    """pattern reuse => repeated 16-grams across sequences."""
    src = SyntheticTokens(512, seed=0)
    seqs = [src.sequence(i, 256) for i in range(20)]
    grams = {}
    for s in seqs:
        for i in range(0, 240, 16):
            grams[tuple(s[i:i + 8])] = grams.get(tuple(s[i:i + 8]), 0) + 1
    assert max(grams.values()) >= 3


def test_prefetch_iterator_matches_batch_at():
    p = _pipe()
    it = p.iterate(start_step=2)
    got = next(it)
    want = p.batch_at(2)
    p.close()
    for k in want:
        assert np.array_equal(got[k], want[k])


def test_vlm_labels_mask_the_patches():
    cfg = reduced_model(get_spec("pixtral-12b").model)
    b = _pipe(arch="pixtral-12b").batch_at(0)
    assert (b["labels"][:, :cfg.frontend_len] == LABEL_IGNORE).all()
    assert b["patch_embeds"].shape == (8, cfg.frontend_len, cfg.d_model)


def _both(arch, dc_kw, shape=(64, 8), source_file=None):
    tcfg = reduced_model(port_spec(arch).model)
    rc = rcfg.reduced_model(rcfg.get_spec(arch).model)
    S, B = shape
    if source_file:
        dc_kw = dict(dc_kw, source="file", path=str(source_file))
    return (DataPipeline(tcfg, ShapeConfig("t", "train", S, B),
                         DataConfig(**dc_kw)),
            rpipe.DataPipeline(rc, rcfg.ShapeConfig("t", "train", S, B),
                               rpipe.DataConfig(**dc_kw)))


@pytest.mark.parametrize("arch", list_archs() + ["llama100m"])
@pytest.mark.parametrize("dc_kw", [dict(seed=0), dict(seed=7),
                                   dict(seed=3, num_hosts=2, host_id=1)])
def test_batches_byte_equal_the_reference(arch, dc_kw):
    port, ref = _both(arch, dc_kw)
    for step in (0, 1, 17):
        got, want = port.batch_at(step), ref.batch_at(step)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), (arch, step, k)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "seamless-m4t-medium",
                                  "pixtral-12b"])
def test_file_source_byte_equal_the_reference(arch, tmp_path):
    text = tmp_path / "corpus.txt"
    text.write_bytes(bytes(range(256)) * 3 + b"the quick brown fox " * 40)
    port, ref = _both(arch, dict(seed=1), source_file=text)
    for step in (0, 4):
        got, want = port.batch_at(step), ref.batch_at(step)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), (arch, step, k)
    short = tmp_path / "short.txt"
    short.write_bytes(b"abc")
    port, ref = _both("llama3.2-1b", dict(seed=2), source_file=short)
    assert port.batch_at(0)["tokens"].tobytes() == \
        ref.batch_at(0)["tokens"].tobytes()


def test_make_batch_fn_is_batch_at():
    cfg = reduced_model(get_spec("mamba2-1.3b").model)
    shape = ShapeConfig("t", "train", 32, 4)
    fn = make_batch_fn(cfg, shape, DataConfig(seed=5))
    want = DataPipeline(cfg, shape, DataConfig(seed=5)).batch_at(9)
    got = fn(9)
    assert all(np.array_equal(got[k], want[k]) for k in want)
