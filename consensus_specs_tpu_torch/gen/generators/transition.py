"""`transition` test-vector generator of the port: chains crossing
upgrade boundaries (reference: tests/generators/transition)."""
import sys

from ..gen_from_tests import run_state_test_generators

_T = "consensus_specs_tpu_torch.test"

ALL_MODS = {
    "phase0": {"core": f"{_T}.altair.transition.test_transition"},
}


def main(args=None) -> int:
    return run_state_test_generators("transition", ALL_MODS, args=args)


if __name__ == "__main__":
    sys.exit(main())
