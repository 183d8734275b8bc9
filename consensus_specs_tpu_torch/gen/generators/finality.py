"""`finality` test-vector generator of the port (reference:
tests/generators/finality)."""
import sys

from ..gen_from_tests import run_state_test_generators

_T = "consensus_specs_tpu_torch.test"

MODS = {"finality": f"{_T}.phase0.finality.test_finality"}
ALL_MODS = {fork: MODS for fork in ("phase0", "altair", "merge")}


def main(args=None) -> int:
    return run_state_test_generators("finality", ALL_MODS, args=args)


if __name__ == "__main__":
    sys.exit(main())
