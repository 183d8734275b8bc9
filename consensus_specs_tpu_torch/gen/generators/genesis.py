"""`genesis` test-vector generator of the port (reference:
tests/generators/genesis)."""
import sys

from ..gen_from_tests import run_state_test_generators

_T = "consensus_specs_tpu_torch.test"

ALL_MODS = {
    "phase0": {"initialization": f"{_T}.phase0.genesis.test_genesis"},
    "merge": {"initialization": f"{_T}.merge.genesis.test_initialization"},
}


def main(args=None) -> int:
    return run_state_test_generators("genesis", ALL_MODS, args=args)


if __name__ == "__main__":
    sys.exit(main())
