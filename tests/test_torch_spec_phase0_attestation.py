"""Phase0 spec tests, attestations (block_processing): each ``test_*``
function of the JAX package's modules and its twin in the port run in
generator mode on the phase0 fork, and their part lists must be equal
part by part (``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.phase0.block_processing import (
    test_process_attestation as jax_attestation,
    test_process_attestation_edge as jax_attestation_edge,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    case_names,
    hold_case,
    paired_cases,
    port_harness,
)
from consensus_specs_tpu_torch.test.phase0.block_processing import (
    test_process_attestation as port_attestation,
    test_process_attestation_edge as port_attestation_edge,
)
from tests.torch_threads import one_thread

one_thread()

MODULES = {
    "attestation": (jax_attestation, port_attestation),
    "attestation_edge": (jax_attestation_edge, port_attestation_edge),
}


@pytest.mark.parametrize("key", sorted(MODULES))
def test_same_case_names(key):
    expected, port = MODULES[key]
    assert case_names(port) == case_names(expected)


@pytest.mark.parametrize("key,name", paired_cases(MODULES))
def test_phase0_case(key, name):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name))
