"""The port's model zoo against the reference's, SSM and hybrid families
(mamba2-1.3b; hymba-1.5b, attention with a sliding window beside
Mamba-2 heads) at reduced size, as ``test_torch_model_zoo_dense.py``
holds the dense family: conv and SSD state caches too. Then the
reference's own consistency checks on the port, hymba's SWA ring
included."""
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
    assert cache["layers"]["k"].shape[2] == 32
    assert cache["layers"]["state"].shape[1:] == (1, 8, 16, 16)
