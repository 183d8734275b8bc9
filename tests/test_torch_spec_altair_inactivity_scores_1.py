"""Altair spec tests, inactivity scores (rewards), runs 1, 3, 5, ...:
each ``test_*`` function of the JAX package's modules and its twin in
the port run in generator mode on every fork the case covers, and
their part lists must be equal part by part
(``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.altair.rewards import (
    test_inactivity_scores as jax_inactivity_scores,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    case_names,
    hold_case,
    paired_runs,
    port_harness,
)
from consensus_specs_tpu_torch.test.altair.rewards import (
    test_inactivity_scores as port_inactivity_scores,
)
from tests.torch_threads import one_thread

one_thread()

MODULES = {
    "inactivity_scores": (jax_inactivity_scores, port_inactivity_scores),
}


@pytest.mark.parametrize("key", sorted(MODULES))
def test_same_case_names(key):
    expected, port = MODULES[key]
    assert case_names(port) == case_names(expected)


@pytest.mark.parametrize("key,name,fork", paired_runs(MODULES, part=1, parts=2))
def test_altair_case(key, name, fork):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name), fork)
