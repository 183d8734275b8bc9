"""`forks` test-vector generator of the port: upgrade_to_* transition
suites (reference: tests/generators/forks)."""
import sys

from ..gen_from_tests import run_state_test_generators

_T = "consensus_specs_tpu_torch.test"

ALL_MODS = {
    "phase0": {"fork": f"{_T}.altair.fork.test_upgrade_to_altair"},
    "altair": {"fork": f"{_T}.merge.fork.test_upgrade_to_merge"},
}


def main(args=None) -> int:
    return run_state_test_generators("forks", ALL_MODS, args=args)


if __name__ == "__main__":
    sys.exit(main())
