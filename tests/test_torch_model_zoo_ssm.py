"""The port's model zoo against the reference's, SSM and hybrid families
(mamba2-1.3b; hymba-1.5b as the reference has it, attention with a
sliding window beside Mamba-2 heads, built from the reference's config)
at reduced size, as ``test_torch_model_zoo_dense.py`` holds the dense
family: conv and SSD state caches too. Then the reference's own
consistency checks on the port's own configs, whose hymba-1.5b is the
published block: its ring after the meta tokens' slots included."""
import numpy as np
import pytest

from test_torch_lm_params import (OUTPUTS, check_decode_after_prefill,
                                  check_output, zoo_cases, zoo_pair)

ARCHS = ["mamba2-1.3b", "hymba-1.5b"]

pair = pytest.fixture(scope="module", params=zoo_cases(ARCHS),
                      ids="-".join)(zoo_pair)


@pytest.mark.parametrize("what", OUTPUTS)
def test_port_equals_reference(pair, what):
    check_output(pair, what)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    check_decode_after_prefill(arch)


def test_swa_ring_cache_consistency():
    cache = check_decode_after_prefill("hymba-1.5b", seq=48, batch=1,
                                       next_tok=np.array([[7]], np.int32))
    # 4 meta slots and a ring of the window of 16; Mamba-1's state
    # [d_inner 128, N 16] a layer
    assert cache["layers"]["k"].shape[2] == 4 + 16
    assert cache["layers"]["state"].shape[1:] == (1, 128, 16)
