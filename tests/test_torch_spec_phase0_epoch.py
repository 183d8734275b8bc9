"""Phase0 spec tests, epoch processing: each ``test_*`` function of the JAX
package's modules and its twin in the port run in generator mode on the
phase0 fork, and their part lists must be equal part by part
(``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.phase0.epoch_processing import (
    test_process_final_updates as jax_final_updates,
    test_process_justification_and_finalization as jax_justification_and_finalization,
    test_process_registry_updates as jax_registry_updates,
    test_process_slashings as jax_slashings,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    case_names,
    hold_case,
    paired_cases,
    port_harness,
)
from consensus_specs_tpu_torch.test.phase0.epoch_processing import (
    test_process_final_updates as port_final_updates,
    test_process_justification_and_finalization as port_justification_and_finalization,
    test_process_registry_updates as port_registry_updates,
    test_process_slashings as port_slashings,
)
from tests.torch_threads import one_thread

one_thread()

MODULES = {
    "final_updates": (jax_final_updates, port_final_updates),
    "justification_and_finalization": (jax_justification_and_finalization, port_justification_and_finalization),
    "registry_updates": (jax_registry_updates, port_registry_updates),
    "slashings": (jax_slashings, port_slashings),
}


@pytest.mark.parametrize("key", sorted(MODULES))
def test_same_case_names(key):
    expected, port = MODULES[key]
    assert case_names(port) == case_names(expected)


@pytest.mark.parametrize("key,name", paired_cases(MODULES))
def test_phase0_case(key, name):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name))
