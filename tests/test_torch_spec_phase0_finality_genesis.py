"""Phase0 spec tests, finality and genesis: each ``test_*`` function of the
JAX package's modules and its twin in the port run in generator mode on
the phase0 fork, and their part lists must be equal part by part
(``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.phase0.finality import (
    test_finality as jax_finality,
)
from consensus_specs_tpu.test.phase0.genesis import (
    test_genesis as jax_genesis,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    case_names,
    hold_case,
    paired_cases,
    port_harness,
)
from consensus_specs_tpu_torch.test.phase0.finality import (
    test_finality as port_finality,
)
from consensus_specs_tpu_torch.test.phase0.genesis import (
    test_genesis as port_genesis,
)
from tests.torch_threads import one_thread

one_thread()

MODULES = {
    "finality": (jax_finality, port_finality),
    "genesis": (jax_genesis, port_genesis),
}


@pytest.mark.parametrize("key", sorted(MODULES))
def test_same_case_names(key):
    expected, port = MODULES[key]
    assert case_names(port) == case_names(expected)


@pytest.mark.parametrize("key,name", paired_cases(MODULES))
def test_phase0_case(key, name):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name))
