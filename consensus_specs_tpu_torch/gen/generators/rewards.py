"""`rewards` test-vector generator of the port (reference:
tests/generators/rewards)."""
import sys

from ..gen_from_tests import run_state_test_generators

_T = "consensus_specs_tpu_torch.test"

MODS = {"basic": f"{_T}.phase0.rewards.test_rewards"}
ALTAIR_MODS = dict(
    MODS, inactivity_scores=f"{_T}.altair.rewards.test_inactivity_scores"
)
ALL_MODS = {
    "phase0": MODS,
    "altair": ALTAIR_MODS,
    "merge": ALTAIR_MODS,
}


def main(args=None) -> int:
    return run_state_test_generators("rewards", ALL_MODS, args=args)


if __name__ == "__main__":
    sys.exit(main())
