"""`shuffling` test-vector generator of the port: full swap-or-not permutation mappings
per (seed, count) (reference: tests/generators/shuffling/main.py:12-17;
format tests/formats/shuffling/README.md)."""
import sys

from ...builder import build_spec_module
from ...utils.hash_function import hash as sha256
from ..gen_runner import run_generator
from ..gen_typing import TestCase, TestProvider

COUNTS = [0, 1, 2, 3, 5, 8, 16, 21, 64, 100]
SEED_COUNT = 30


def _case(spec, seed, count):
    def case_fn():
        # the full permutation: mapping[i] = shuffled position of index i
        raw = spec.compute_shuffled_index
        fn = getattr(raw, "__wrapped_raw__", raw)
        mapping = [int(fn(spec.uint64(i), spec.uint64(count), seed)) for i in range(count)]
        return [("mapping", "data", {
            "seed": "0x" + seed.hex(),
            "count": count,
            "mapping": mapping,
        })]

    return case_fn


def make_cases():
    for preset in ("minimal", "mainnet"):
        spec = build_spec_module("phase0", preset)
        for seed_index in range(SEED_COUNT):
            seed = sha256(seed_index.to_bytes(4, "little"))
            for count in COUNTS:
                yield TestCase(
                    fork_name="phase0",
                    preset_name=preset,
                    runner_name="shuffling",
                    handler_name="core",
                    suite_name="shuffle",
                    case_name=f"shuffle_0x{seed.hex()[:8]}_{count}",
                    case_fn=_case(spec, seed, count),
                )


def main(args=None) -> int:
    provider = TestProvider(prepare=lambda: None, make_cases=make_cases)
    return run_generator("shuffling", [provider], args=args)


if __name__ == "__main__":
    sys.exit(main())
