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

# The draft forks' handlers (sharding, custody_game) wait for the port's
# sharding and custody_game spec tests (ROADMAP Queue 1 item 3.4); the
# JAX generator's table has them.
ALL_MODS = {
    "phase0": PHASE0_MODS,
    "altair": ALTAIR_MODS,
    "merge": MERGE_MODS,
}


def main(args=None) -> int:
    return run_state_test_generators("sanity", ALL_MODS, args=args)


if __name__ == "__main__":
    sys.exit(main())
