"""`ssz_static` test-vector generator of the port: seeded random objects for every SSZ
container of every built spec, with serialized bytes + hash_tree_root
(reference: tests/generators/ssz_static/main.py:21-36; format
tests/formats/ssz_static/README.md)."""
import sys
import zlib
from random import Random

from ...builder import IMPLEMENTED_FORKS, build_spec_module
from ...debug.encode import encode
from ...debug.random_value import RandomizationMode, get_random_ssz_object
from ...utils.ssz.ssz_typing import Container
from ..gen_runner import run_generator
from ..gen_typing import TestCase, TestProvider

MAX_BYTES_LENGTH = 1000
MAX_LIST_LENGTH = 10


def _spec_containers(spec):
    out = {}
    for name, obj in vars(spec).items():
        if (
            isinstance(obj, type)
            and issubclass(obj, Container)
            and obj is not Container
            and obj.fields()
        ):
            out[name] = obj
    return sorted(out.items())


def _case(spec, name, typ, mode, seed, count):
    def case_fn():
        rng = Random(seed)
        value = get_random_ssz_object(
            rng, typ, MAX_BYTES_LENGTH, MAX_LIST_LENGTH, mode,
            chaos=mode == RandomizationMode.mode_random and count > 0,
        )
        roots = {"root": "0x" + value.hash_tree_root().hex()}
        return [
            ("roots", "data", roots),
            ("serialized", "ssz", value.encode_bytes()),
            ("value", "data", encode(value)),
        ]

    return case_fn


def make_cases():
    for preset in ("minimal", "mainnet"):
        for fork in IMPLEMENTED_FORKS:
            spec = build_spec_module(fork, preset)
            for name, typ in _spec_containers(spec):
                for mode in (
                    RandomizationMode.mode_random,
                    RandomizationMode.mode_zero,
                    RandomizationMode.mode_max,
                    RandomizationMode.mode_nil_count,
                    RandomizationMode.mode_one_count,
                    RandomizationMode.mode_max_count,
                ):
                    for count in range(2 if mode == RandomizationMode.mode_random else 1):
                        # stable across processes (builtin hash is salted,
                        # which would re-randomize vectors every run)
                        seed = zlib.crc32(
                            f"{preset}/{fork}/{name}/{mode.value}/{count}".encode()
                        )
                        yield TestCase(
                            fork_name=fork,
                            preset_name=preset,
                            runner_name="ssz_static",
                            handler_name=name,
                            suite_name=f"ssz_{mode.to_name()}",
                            case_name=f"case_{count}",
                            case_fn=_case(spec, name, typ, mode, seed, count),
                        )


def main(args=None) -> int:
    provider = TestProvider(prepare=lambda: None, make_cases=make_cases)
    return run_generator("ssz_static", [provider], args=args)


if __name__ == "__main__":
    sys.exit(main())
