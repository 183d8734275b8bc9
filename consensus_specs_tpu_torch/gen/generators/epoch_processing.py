"""`epoch_processing` test-vector generator of the port: the per-pass
epoch suites (reference: tests/generators/epoch_processing/main.py)."""
import sys

from ..gen_from_tests import combine_mods, run_state_test_generators

_T = "consensus_specs_tpu_torch.test"

PHASE0_MODS = {
    "justification_and_finalization":
        f"{_T}.phase0.epoch_processing.test_process_justification_and_finalization",
    "registry_updates": f"{_T}.phase0.epoch_processing.test_process_registry_updates",
    "slashings": f"{_T}.phase0.epoch_processing.test_process_slashings",
    "final_updates": f"{_T}.phase0.epoch_processing.test_process_final_updates",
}
ALTAIR_MODS = combine_mods(PHASE0_MODS, {
    "inactivity_updates": f"{_T}.altair.epoch_processing.test_process_inactivity_updates",
    "participation_flag_updates":
        f"{_T}.altair.epoch_processing.test_process_participation_flag_updates",
    "sync_committee_updates":
        f"{_T}.altair.epoch_processing.test_process_sync_committee_updates",
})

# draft forks: only the handlers whose suites run under them (the
# shard-work-cycle module declares with_phases([SHARDING, CUSTODY_GAME]))
SHARDING_MODS = {
    "pending_shard_confirmations":
        f"{_T}.sharding.epoch_processing.test_shard_work_cycle",
}
# custody adds its own epoch passes (reveal/challenge deadlines, final
# updates: test_custody_epoch_passes covers all three handlers' suites)
CUSTODY_GAME_MODS = combine_mods(SHARDING_MODS, {
    "custody_epoch_passes":
        f"{_T}.custody_game.epoch_processing.test_custody_epoch_passes",
})

ALL_MODS = {
    "phase0": PHASE0_MODS,
    "altair": ALTAIR_MODS,
    "merge": ALTAIR_MODS,
    "sharding": SHARDING_MODS,
    "custody_game": CUSTODY_GAME_MODS,
}


def main(args=None) -> int:
    return run_state_test_generators("epoch_processing", ALL_MODS, args=args)


if __name__ == "__main__":
    sys.exit(main())
