"""Altair spec tests, the upgrade to altair (fork):
each ``test_*`` function of the JAX package's modules and its twin in
the port run in generator mode on every fork the case covers, and
their part lists must be equal part by part
(``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.altair.fork import (
    test_upgrade_to_altair as jax_upgrade_to_altair,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    case_names,
    hold_case,
    paired_runs,
    port_harness,
)
from consensus_specs_tpu_torch.test.altair.fork import (
    test_upgrade_to_altair as port_upgrade_to_altair,
)
from tests.torch_threads import one_thread

one_thread()

MODULES = {
    "upgrade_to_altair": (jax_upgrade_to_altair, port_upgrade_to_altair),
}


@pytest.mark.parametrize("key", sorted(MODULES))
def test_same_case_names(key):
    expected, port = MODULES[key]
    assert case_names(port) == case_names(expected)


@pytest.mark.parametrize("key,name,fork", paired_runs(MODULES))
def test_altair_case(key, name, fork):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name), fork)
