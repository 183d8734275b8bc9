"""Sharding spec tests, every module: each ``test_*`` function of the JAX
package's modules and its twin in the port run in generator mode on
every fork the case covers (sharding and custody_game), and their part
lists must be equal part by part
(``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.sharding.block_processing import (
    test_process_attested_shard_work as jax_attested_shard_work,
    test_process_shard_header as jax_shard_header,
    test_process_shard_proposer_slashing as jax_shard_proposer_slashing,
)
from consensus_specs_tpu.test.sharding.epoch_processing import (
    test_shard_work_cycle as jax_shard_work_cycle,
)
from consensus_specs_tpu.test.sharding.unittests import (
    test_shard_math as jax_shard_math,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    case_names,
    hold_case,
    paired_runs,
    port_harness,
)
from consensus_specs_tpu_torch.test.sharding.block_processing import (
    test_process_attested_shard_work as port_attested_shard_work,
    test_process_shard_header as port_shard_header,
    test_process_shard_proposer_slashing as port_shard_proposer_slashing,
)
from consensus_specs_tpu_torch.test.sharding.epoch_processing import (
    test_shard_work_cycle as port_shard_work_cycle,
)
from consensus_specs_tpu_torch.test.sharding.unittests import (
    test_shard_math as port_shard_math,
)
from tests.torch_threads import one_thread

one_thread()

MODULES = {
    "shard_header": (jax_shard_header, port_shard_header),
    "shard_proposer_slashing": (jax_shard_proposer_slashing,
                                port_shard_proposer_slashing),
    "attested_shard_work": (jax_attested_shard_work, port_attested_shard_work),
    "shard_work_cycle": (jax_shard_work_cycle, port_shard_work_cycle),
    "shard_math": (jax_shard_math, port_shard_math),
}


@pytest.mark.parametrize("key", sorted(MODULES))
def test_same_case_names(key):
    expected, port = MODULES[key]
    assert case_names(port) == case_names(expected)


@pytest.mark.parametrize("key,name,fork", paired_runs(MODULES))
def test_sharding_case(key, name, fork):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name), fork)
