"""Phase0 spec tests, rewards, cases 2, 5, 8, ...: each ``test_*`` function
of the JAX package's modules and its twin in the port run in generator
mode on the phase0 fork, and their part lists must be equal part by part
(``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.phase0.rewards import (
    test_rewards as jax_rewards,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    hold_case,
    paired_cases,
    port_harness,
)
from consensus_specs_tpu_torch.test.phase0.rewards import (
    test_rewards as port_rewards,
)
from tests.torch_threads import one_thread

one_thread()

MODULES = {
    "rewards": (jax_rewards, port_rewards),
}


@pytest.mark.parametrize("key,name", paired_cases(MODULES, part=2, parts=3))
def test_phase0_case(key, name):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name))
