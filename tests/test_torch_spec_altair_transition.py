"""Altair spec tests, the fork transitions:
each ``test_*`` function of the JAX package's modules and its twin in
the port run in generator mode on every fork the case covers, and
their part lists must be equal part by part
(``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.altair.transition import (
    test_transition as jax_transition,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    case_names,
    hold_case,
    paired_runs,
    port_harness,
)
from consensus_specs_tpu_torch.test.altair.transition import (
    test_transition as port_transition,
)

MODULES = {
    "transition": (jax_transition, port_transition),
}


@pytest.mark.parametrize("key", sorted(MODULES))
def test_same_case_names(key):
    expected, port = MODULES[key]
    assert case_names(port) == case_names(expected)


@pytest.mark.parametrize("key,name,fork", paired_runs(MODULES))
def test_altair_case(key, name, fork):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name), fork)
