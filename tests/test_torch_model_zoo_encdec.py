"""The port's model zoo against the reference's, audio (encoder-decoder,
seamless-m4t-medium: self and cross attention, the cross K/V cached)
and vision-language (pixtral-12b: patch embeddings before the text)
families at reduced size, as ``test_torch_model_zoo_dense.py`` holds
the dense family; then the reference's own consistency check on the
port."""
import pytest

from test_torch_lm_params import (OUTPUTS, check_decode_after_prefill,
                                  check_output, zoo_cases, zoo_pair)

ARCHS = ["seamless-m4t-medium", "pixtral-12b"]

pair = pytest.fixture(scope="module", params=zoo_cases(ARCHS),
                      ids="-".join)(zoo_pair)


@pytest.mark.parametrize("what", OUTPUTS)
def test_port_equals_reference(pair, what):
    check_output(pair, what)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    check_decode_after_prefill(arch)
