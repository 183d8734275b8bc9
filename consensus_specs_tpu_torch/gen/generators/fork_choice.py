"""`fork_choice` test-vector generator of the port (reference:
tests/generators/fork_choice; step format
tests/formats/fork_choice/README.md)."""
import sys

from ..gen_from_tests import run_state_test_generators

_T = "consensus_specs_tpu_torch.test"

MODS = {
    "get_head": f"{_T}.phase0.fork_choice.test_get_head",
    "on_block": f"{_T}.phase0.fork_choice.test_on_block",
}
ALL_MODS = {fork: MODS for fork in ("phase0", "altair")}
# the terminal-PoW on_block cases only exist from the merge on
ALL_MODS["merge"] = dict(MODS, on_merge_block=f"{_T}.merge.fork_choice.test_on_merge_block")


def main(args=None) -> int:
    return run_state_test_generators("fork_choice", ALL_MODS, args=args)


if __name__ == "__main__":
    sys.exit(main())
