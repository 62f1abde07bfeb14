"""The traffic generator: the same seed gives the same batches, every
seed the same shapes, and the labels are the tokens shifted by one."""
import json

import numpy as np
import pytest
from conftest import ROOT

from cardbench.harness import traffic

MIX = json.loads((ROOT / "cardbench" / "traffic" /
                  "pretrain-8x4096.json").read_text())


def _small():
    return dict(MIX, batch=2, seq=256)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3])
def test_same_seed_same_batches(seed):
    a = traffic.batches(_small(), 50277, seed, 3)
    b = traffic.batches(_small(), 50277, seed, 3)
    for x, y in zip(a, b):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(x[k], y[k])


def test_seeds_differ_and_shapes_do_not():
    a = traffic.batches(_small(), 50277, 1, 2)
    b = traffic.batches(_small(), 50277, 2, 2)
    assert not np.array_equal(a[0]["tokens"], b[0]["tokens"])
    for x in a + b:
        assert x["tokens"].shape == x["labels"].shape == (2, 256)
        assert x["tokens"].dtype == np.int32


def test_rows_are_a_stream_over_the_vocabulary():
    bs = traffic.batches(_small(), 100, 5, 4)
    rows = np.concatenate([b["tokens"] for b in bs])
    for b in bs:
        # labels are the next tokens
        np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
        assert b["tokens"].min() >= 0 and b["labels"].max() < 100
    assert len({r.tobytes() for r in rows}) == len(rows)   # rows all differ
    assert len(np.unique(rows)) == 100               # the whole vocabulary


def test_the_real_mix_makes_its_batches():
    bs = traffic.batches(MIX, 50277, 2 ** 31 + 1, 2)
    assert bs[0]["tokens"].shape == (MIX["batch"], MIX["seq"])
