"""Phase0 spec tests, unit tests: each ``test_*`` function of the JAX
package's modules and its twin in the port run in generator mode on the
phase0 fork, and their part lists must be equal part by part
(``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.phase0.unittests import (
    test_config_invariants as jax_config_invariants,
    test_epoch_machinery as jax_epoch_machinery,
    test_networking as jax_networking,
    test_validator_unittest as jax_validator_unittest,
    test_weak_subjectivity as jax_weak_subjectivity,
)
from consensus_specs_tpu.test.phase0.unittests.fork_choice import (
    test_on_attestation as jax_on_attestation,
    test_on_tick as jax_on_tick,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    case_names,
    hold_case,
    paired_cases,
    port_harness,
)
from consensus_specs_tpu_torch.test.phase0.unittests import (
    test_config_invariants as port_config_invariants,
    test_epoch_machinery as port_epoch_machinery,
    test_networking as port_networking,
    test_validator_unittest as port_validator_unittest,
    test_weak_subjectivity as port_weak_subjectivity,
)
from consensus_specs_tpu_torch.test.phase0.unittests.fork_choice import (
    test_on_attestation as port_on_attestation,
    test_on_tick as port_on_tick,
)
from tests.torch_threads import one_thread

one_thread()

MODULES = {
    "config_invariants": (jax_config_invariants, port_config_invariants),
    "epoch_machinery": (jax_epoch_machinery, port_epoch_machinery),
    "networking": (jax_networking, port_networking),
    "on_attestation": (jax_on_attestation, port_on_attestation),
    "on_tick": (jax_on_tick, port_on_tick),
    "validator_unittest": (jax_validator_unittest, port_validator_unittest),
    "weak_subjectivity": (jax_weak_subjectivity, port_weak_subjectivity),
}


@pytest.mark.parametrize("key", sorted(MODULES))
def test_same_case_names(key):
    expected, port = MODULES[key]
    assert case_names(port) == case_names(expected)


@pytest.mark.parametrize("key,name", paired_cases(MODULES))
def test_phase0_case(key, name):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name))
