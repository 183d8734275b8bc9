"""Merge spec tests, every module:
each ``test_*`` function of the JAX package's modules and its twin in
the port run in generator mode on every fork the case covers, and
their part lists must be equal part by part
(``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.merge.block_processing import (
    test_process_execution_payload as jax_execution_payload,
)
from consensus_specs_tpu.test.merge.fork import (
    test_upgrade_to_merge as jax_upgrade_to_merge,
)
from consensus_specs_tpu.test.merge.fork_choice import (
    test_on_merge_block as jax_on_merge_block,
)
from consensus_specs_tpu.test.merge.genesis import (
    test_initialization as jax_genesis_initialization,
)
from consensus_specs_tpu.test.merge.sanity import (
    test_blocks as jax_sanity_blocks,
)
from consensus_specs_tpu.test.merge.unittests import (
    test_terminal_validity as jax_terminal_validity,
    test_transition_predicates as jax_transition_predicates,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    case_names,
    hold_case,
    paired_runs,
    port_harness,
)
from consensus_specs_tpu_torch.test.merge.block_processing import (
    test_process_execution_payload as port_execution_payload,
)
from consensus_specs_tpu_torch.test.merge.fork import (
    test_upgrade_to_merge as port_upgrade_to_merge,
)
from consensus_specs_tpu_torch.test.merge.fork_choice import (
    test_on_merge_block as port_on_merge_block,
)
from consensus_specs_tpu_torch.test.merge.genesis import (
    test_initialization as port_genesis_initialization,
)
from consensus_specs_tpu_torch.test.merge.sanity import (
    test_blocks as port_sanity_blocks,
)
from consensus_specs_tpu_torch.test.merge.unittests import (
    test_terminal_validity as port_terminal_validity,
    test_transition_predicates as port_transition_predicates,
)
from tests.torch_threads import one_thread

one_thread()

MODULES = {
    "transition_predicates": (jax_transition_predicates, port_transition_predicates),
    "terminal_validity": (jax_terminal_validity, port_terminal_validity),
    "genesis_initialization": (jax_genesis_initialization, port_genesis_initialization),
    "execution_payload": (jax_execution_payload, port_execution_payload),
    "sanity_blocks": (jax_sanity_blocks, port_sanity_blocks),
    "on_merge_block": (jax_on_merge_block, port_on_merge_block),
    "upgrade_to_merge": (jax_upgrade_to_merge, port_upgrade_to_merge),
}


@pytest.mark.parametrize("key", sorted(MODULES))
def test_same_case_names(key):
    expected, port = MODULES[key]
    assert case_names(port) == case_names(expected)


@pytest.mark.parametrize("key,name,fork", paired_runs(MODULES))
def test_merge_case(key, name, fork):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name), fork)
