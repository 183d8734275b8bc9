"""`operations` test-vector generator of the port: every process_* op
handler (reference: tests/generators/operations/main.py; format
tests/formats/operations/README.md)."""
import sys

from ..gen_from_tests import combine_mods, run_state_test_generators

_T = "consensus_specs_tpu_torch.test"

PHASE0_MODS = {
    "attestation": f"{_T}.phase0.block_processing.test_process_attestation",
    "attester_slashing": f"{_T}.phase0.block_processing.test_process_attester_slashing",
    "block_header": f"{_T}.phase0.block_processing.test_process_block_header",
    "deposit": f"{_T}.phase0.block_processing.test_process_deposit",
    "proposer_slashing": f"{_T}.phase0.block_processing.test_process_proposer_slashing",
    "randao": f"{_T}.phase0.block_processing.test_process_randao",
    "voluntary_exit": f"{_T}.phase0.block_processing.test_process_voluntary_exit",
}
ALTAIR_MODS = combine_mods(PHASE0_MODS, combine_mods(
    {"sync_aggregate": f"{_T}.altair.block_processing.test_process_sync_aggregate"},
    {"sync_aggregate": f"{_T}.altair.block_processing.test_process_sync_aggregate_random"},
))
MERGE_MODS = combine_mods(ALTAIR_MODS, {
    "execution_payload": f"{_T}.merge.block_processing.test_process_execution_payload",
})
# The draft forks' handlers (sharding, custody_game) wait for the port's
# sharding and custody_game spec tests (ROADMAP Queue 1 item 3.4); the
# JAX generator's table has them.
ALL_MODS = {
    "phase0": PHASE0_MODS,
    "altair": ALTAIR_MODS,
    "merge": MERGE_MODS,
}


def main(args=None) -> int:
    return run_state_test_generators("operations", ALL_MODS, args=args)


if __name__ == "__main__":
    sys.exit(main())
