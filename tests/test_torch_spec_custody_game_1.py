"""Custody-game spec tests, every module, runs 1, 3, 5, ...: each
``test_*`` function of the JAX package's modules and its twin in the port
run in generator mode on the custody_game fork, and their part lists must
be equal part by part (``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.custody_game.block_processing import (
    test_process_attestation as jax_attestation,
    test_process_chunk_challenge as jax_chunk_challenge,
    test_process_custody_key_reveal as jax_custody_key_reveal,
    test_process_custody_slashing as jax_custody_slashing,
    test_process_early_derived_secret_reveal as jax_early_reveal,
)
from consensus_specs_tpu.test.custody_game.epoch_processing import (
    test_custody_epoch_passes as jax_custody_epoch_passes,
)
from consensus_specs_tpu.test.custody_game.sanity import (
    test_blocks as jax_sanity_blocks,
)
from consensus_specs_tpu_torch.test.custody_game.block_processing import (
    test_process_attestation as port_attestation,
    test_process_chunk_challenge as port_chunk_challenge,
    test_process_custody_key_reveal as port_custody_key_reveal,
    test_process_custody_slashing as port_custody_slashing,
    test_process_early_derived_secret_reveal as port_early_reveal,
)
from consensus_specs_tpu_torch.test.custody_game.epoch_processing import (
    test_custody_epoch_passes as port_custody_epoch_passes,
)
from consensus_specs_tpu_torch.test.custody_game.sanity import (
    test_blocks as port_sanity_blocks,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    hold_case,
    paired_runs,
    port_harness,
)
from tests.torch_threads import one_thread

one_thread()

MODULES = {
    "attestation": (jax_attestation, port_attestation),
    "chunk_challenge": (jax_chunk_challenge, port_chunk_challenge),
    "custody_key_reveal": (jax_custody_key_reveal, port_custody_key_reveal),
    "custody_slashing": (jax_custody_slashing, port_custody_slashing),
    "early_derived_secret_reveal": (jax_early_reveal, port_early_reveal),
    "custody_epoch_passes": (jax_custody_epoch_passes,
                             port_custody_epoch_passes),
    "sanity_blocks": (jax_sanity_blocks, port_sanity_blocks),
}


@pytest.mark.parametrize("key,name,fork", paired_runs(MODULES, part=1,
                                                    parts=2))
def test_custody_game_case(key, name, fork):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name), fork)
