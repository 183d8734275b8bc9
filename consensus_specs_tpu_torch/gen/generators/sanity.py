"""`sanity` test-vector generator of the port: whole-state-transition
blocks + slots (reference: tests/generators/sanity/main.py; format
tests/formats/sanity/README.md)."""
import sys

from ..gen_from_tests import combine_mods, run_state_test_generators

_T = "consensus_specs_tpu_torch.test"

PHASE0_MODS = {
    "blocks": f"{_T}.phase0.sanity.test_blocks",
    "slots": f"{_T}.phase0.sanity.test_slots",
}
# fork-specific block tests all emit under the OFFICIAL `blocks` handler
# (tests/formats/sanity knows only blocks/slots)
ALTAIR_MODS = combine_mods(PHASE0_MODS, {
    "blocks": f"{_T}.altair.sanity.test_blocks",
})
MERGE_MODS = combine_mods(ALTAIR_MODS, {
    "blocks": f"{_T}.merge.sanity.test_blocks",
})

# custody sanity blocks run the full draft-fork block pipeline
CUSTODY_GAME_MODS = {
    "blocks": f"{_T}.custody_game.sanity.test_blocks",
}

ALL_MODS = {
    "phase0": PHASE0_MODS,
    "altair": ALTAIR_MODS,
    "merge": MERGE_MODS,
    "custody_game": CUSTODY_GAME_MODS,
}


def main(args=None) -> int:
    return run_state_test_generators("sanity", ALL_MODS, args=args)


if __name__ == "__main__":
    sys.exit(main())
