"""`random` test-vector generator of the port: seeded randomized-transition
scenarios (reference: tests/generators/random). Both the handwritten seeds
(test_random) and the code-generated scenario-matrix modules
(test_random_matrix, regenerated by `python tools/torch_gen_random_tests.py`)
emit vectors."""
import sys

from ..gen_from_tests import combine_mods, run_state_test_generators

_T = "consensus_specs_tpu_torch.test"

PHASE0_MODS = combine_mods(
    {"random": f"{_T}.phase0.random.test_random"},
    {"random": f"{_T}.phase0.random.test_random_matrix"},
)
ALTAIR_MODS = combine_mods(
    {"random": f"{_T}.phase0.random.test_random"},
    {"random": f"{_T}.altair.random.test_random_matrix"},
)
ALL_MODS = {
    "phase0": PHASE0_MODS,
    "altair": ALTAIR_MODS,
    "merge": ALTAIR_MODS,
}


def main(args=None) -> int:
    return run_state_test_generators("random", ALL_MODS, args=args)


if __name__ == "__main__":
    sys.exit(main())
