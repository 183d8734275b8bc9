"""Phase0 spec tests, fork choice, on_block, cases 0, 2, 4, ...: each
``test_*`` function of the JAX package's modules and its twin in the
port run in generator mode on the phase0 fork, and their part lists must
be equal part by part (``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.phase0.fork_choice import (
    test_on_block as jax_on_block,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    case_names,
    hold_case,
    paired_cases,
    port_harness,
)
from consensus_specs_tpu_torch.test.phase0.fork_choice import (
    test_on_block as port_on_block,
)
from tests.torch_threads import one_thread

one_thread()

MODULES = {
    "on_block": (jax_on_block, port_on_block),
}


@pytest.mark.parametrize("key", sorted(MODULES))
def test_same_case_names(key):
    expected, port = MODULES[key]
    assert case_names(port) == case_names(expected)


@pytest.mark.parametrize("key,name", paired_cases(MODULES, part=0, parts=2))
def test_phase0_case(key, name):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name))
