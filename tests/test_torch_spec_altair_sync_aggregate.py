"""Altair spec tests, sync aggregates (block_processing):
each ``test_*`` function of the JAX package's modules and its twin in
the port run in generator mode on every fork the case covers, and
their part lists must be equal part by part
(``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.altair.block_processing import (
    test_process_sync_aggregate as jax_sync_aggregate,
    test_process_sync_aggregate_random as jax_sync_aggregate_random,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    case_names,
    hold_case,
    paired_runs,
    port_harness,
)
from consensus_specs_tpu_torch.test.altair.block_processing import (
    test_process_sync_aggregate as port_sync_aggregate,
    test_process_sync_aggregate_random as port_sync_aggregate_random,
)

MODULES = {
    "sync_aggregate": (jax_sync_aggregate, port_sync_aggregate),
    "sync_aggregate_random": (jax_sync_aggregate_random, port_sync_aggregate_random),
}


@pytest.mark.parametrize("key", sorted(MODULES))
def test_same_case_names(key):
    expected, port = MODULES[key]
    assert case_names(port) == case_names(expected)


@pytest.mark.parametrize("key,name,fork", paired_runs(MODULES))
def test_altair_case(key, name, fork):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name), fork)
