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
# draft-fork MODS list only the handlers whose test modules run under
# these forks (the base-fork modules pin with_all_phases = the three
# mainline forks, so inheriting them would yield zero-vector handlers);
# the sharding op modules declare with_phases([SHARDING, CUSTODY_GAME])
SHARDING_MODS = {
    "shard_blob_header": f"{_T}.sharding.block_processing.test_process_shard_header",
    "shard_proposer_slashing": f"{_T}.sharding.block_processing.test_process_shard_proposer_slashing",
    "attested_shard_work": f"{_T}.sharding.block_processing.test_process_attested_shard_work",
}
CUSTODY_GAME_MODS = combine_mods(SHARDING_MODS, {
    "attestation": f"{_T}.custody_game.block_processing.test_process_attestation",
    "custody_key_reveal": f"{_T}.custody_game.block_processing.test_process_custody_key_reveal",
    "early_derived_secret_reveal": f"{_T}.custody_game.block_processing.test_process_early_derived_secret_reveal",
    "chunk_challenge": f"{_T}.custody_game.block_processing.test_process_chunk_challenge",
    "custody_slashing": f"{_T}.custody_game.block_processing.test_process_custody_slashing",
})

ALL_MODS = {
    "phase0": PHASE0_MODS,
    "altair": ALTAIR_MODS,
    "merge": MERGE_MODS,
    "sharding": SHARDING_MODS,
    "custody_game": CUSTODY_GAME_MODS,
}


def main(args=None) -> int:
    return run_state_test_generators("operations", ALL_MODS, args=args)


if __name__ == "__main__":
    sys.exit(main())
