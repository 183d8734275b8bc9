"""Phase0 spec tests, attester and proposer slashings (block_processing):
each ``test_*`` function of the JAX package's modules and its twin in
the port run in generator mode on the phase0 fork, and their part lists
must be equal part by part
(``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.phase0.block_processing import (
    test_process_attester_slashing as jax_attester_slashing,
    test_process_proposer_slashing as jax_proposer_slashing,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    case_names,
    hold_case,
    paired_cases,
    port_harness,
)
from consensus_specs_tpu_torch.test.phase0.block_processing import (
    test_process_attester_slashing as port_attester_slashing,
    test_process_proposer_slashing as port_proposer_slashing,
)
from tests.torch_threads import one_thread

one_thread()

MODULES = {
    "attester_slashing": (jax_attester_slashing, port_attester_slashing),
    "proposer_slashing": (jax_proposer_slashing, port_proposer_slashing),
}


@pytest.mark.parametrize("key", sorted(MODULES))
def test_same_case_names(key):
    expected, port = MODULES[key]
    assert case_names(port) == case_names(expected)


@pytest.mark.parametrize("key,name", paired_cases(MODULES))
def test_phase0_case(key, name):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name))
