"""The port's model zoo against the reference's, dense family
(llama3.2-1b, deepseek-7b, stablelm-12b, phi3-mini-3.8b, llama100m) at
reduced size: the train forward's logits, prefill's logits and cache,
two decode steps' logits and the cache after them, on the reference's
weights carried across (float32 at 1e-4, bfloat16 at 5e-2, integer
cache fields exactly); then the reference's own consistency check on
the port (decode after prefill equals the forward)."""
import pytest

from test_torch_lm_params import (OUTPUTS, check_decode_after_prefill,
                                  check_output, zoo_cases, zoo_pair)

ARCHS = ["llama3.2-1b", "deepseek-7b", "stablelm-12b", "phi3-mini-3.8b",
         "llama100m"]

pair = pytest.fixture(scope="module", params=zoo_cases(ARCHS),
                      ids="-".join)(zoo_pair)


@pytest.mark.parametrize("what", OUTPUTS)
def test_port_equals_reference(pair, what):
    check_output(pair, what)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    check_decode_after_prefill(arch)
