"""Altair spec tests, epoch processing:
each ``test_*`` function of the JAX package's modules and its twin in
the port run in generator mode on every fork the case covers, and
their part lists must be equal part by part
(``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.altair.epoch_processing import (
    test_process_inactivity_updates as jax_inactivity_updates,
    test_process_participation_flag_updates as jax_participation_flag_updates,
    test_process_sync_committee_updates as jax_sync_committee_updates,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    case_names,
    hold_case,
    paired_runs,
    port_harness,
)
from consensus_specs_tpu_torch.test.altair.epoch_processing import (
    test_process_inactivity_updates as port_inactivity_updates,
    test_process_participation_flag_updates as port_participation_flag_updates,
    test_process_sync_committee_updates as port_sync_committee_updates,
)

MODULES = {
    "participation_flag_updates": (jax_participation_flag_updates, port_participation_flag_updates),
    "sync_committee_updates": (jax_sync_committee_updates, port_sync_committee_updates),
    "inactivity_updates": (jax_inactivity_updates, port_inactivity_updates),
}


@pytest.mark.parametrize("key", sorted(MODULES))
def test_same_case_names(key):
    expected, port = MODULES[key]
    assert case_names(port) == case_names(expected)


@pytest.mark.parametrize("key,name,fork", paired_runs(MODULES))
def test_altair_case(key, name, fork):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name), fork)
