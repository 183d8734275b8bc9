"""`ssz_generic` test-vector generator of the port: valid and invalid serializations
for the basic SSZ type families (reference: tests/generators/ssz_generic +
its case modules; format tests/formats/ssz_generic/README.md).

Valid cases carry serialized_bytes + value + root; invalid cases carry only
the malformed serialized bytes (a decoder must reject them).
"""
import sys
from random import Random

from ...debug.encode import encode
from ...utils.ssz.ssz_typing import (
    Bitlist, Bitvector, Container, List, Vector, boolean, uint8, uint16,
    uint32, uint64, uint128, uint256,
)
from ..gen_runner import run_generator
from ..gen_typing import TestCase, TestProvider

UINTS = {"uint8": uint8, "uint16": uint16, "uint32": uint32,
         "uint64": uint64, "uint128": uint128, "uint256": uint256}


class SingleFieldContainer(Container):
    a: uint64


class SmallContainer(Container):
    a: uint16
    b: uint16


class VarContainer(Container):
    a: uint64
    b: List[uint16, 1024]


class ComplexContainer(Container):
    fixed: SmallContainer
    items: List[SmallContainer, 8]
    bits: Bitlist[10]


def _valid(handler, name, value):
    def case_fn(value=value):
        return [
            ("serialized", "ssz", value.encode_bytes()),
            ("value", "data", encode(value)),
            ("meta", "data", {"root": "0x" + value.hash_tree_root().hex()}),
        ]

    return handler, "valid", name, case_fn


def _invalid(handler, name, raw, typ):
    def case_fn(raw=raw, typ=typ):
        # the case is only emittable if the bytes are really invalid
        try:
            typ.decode_bytes(raw)
        except (ValueError, IndexError, AssertionError):
            return [("serialized", "ssz", raw)]
        raise AssertionError(f"bytes unexpectedly decoded as {typ}")

    return handler, "invalid", name, case_fn


def _cases():
    rng = Random(9009)

    # uints: zero / max / random, plus wrong-length invalids
    for name, typ in UINTS.items():
        width = typ.TYPE_BYTE_LENGTH
        yield _valid(name, "zero", typ(0))
        yield _valid(name, "max", typ((1 << (8 * width)) - 1))
        yield _valid(name, "random", typ(rng.getrandbits(8 * width)))
        yield _invalid(name, "one_byte_short", b"\x00" * (width - 1), typ)
        yield _invalid(name, "one_byte_long", b"\x00" * (width + 1), typ)

    # boolean: the only valid encodings are 0x00/0x01
    yield _valid("boolean", "true", boolean(True))
    yield _valid("boolean", "false", boolean(False))
    yield _invalid("boolean", "byte_2", b"\x02", boolean)
    yield _invalid("boolean", "byte_ff", b"\xff", boolean)

    # bitvector: exact byte length with zeroed excess bits
    bv = Bitvector[10]
    yield _valid("bitvector", "bitvec_10_random",
                 bv([rng.choice((True, False)) for _ in range(10)]))
    yield _invalid("bitvector", "bitvec_10_extra_byte", b"\x00" * 3, bv)
    yield _invalid("bitvector", "bitvec_10_high_bit_set", b"\xff\xff", bv)

    # bitlist: delimiter-bit encoding
    bl = Bitlist[8]
    yield _valid("bitlist", "bitlist_8_empty", bl([]))
    yield _valid("bitlist", "bitlist_8_full",
                 bl([True] * 8))
    yield _invalid("bitlist", "bitlist_8_no_delimiter", b"\x00", bl)
    yield _invalid("bitlist", "bitlist_8_too_long", b"\xff\xff\x03", bl)

    # basic vector
    vec = Vector[uint16, 4]
    yield _valid("basic_vector", "vec_uint16_4",
                 vec([rng.getrandbits(16) for _ in range(4)]))
    yield _invalid("basic_vector", "vec_uint16_4_short", b"\x00" * 7, vec)
    yield _invalid("basic_vector", "vec_uint16_4_long", b"\x00" * 9, vec)

    # containers: fixed, variable, nested
    yield _valid("containers", "single_field", SingleFieldContainer(a=7))
    yield _valid("containers", "small", SmallContainer(a=1, b=2))
    yield _valid("containers", "var", VarContainer(a=3, b=[1, 2, 3]))
    yield _valid("containers", "complex", ComplexContainer(
        fixed=SmallContainer(a=9, b=10),
        items=[SmallContainer(a=1, b=2), SmallContainer(a=3, b=4)],
        bits=[True, False, True],
    ))
    yield _invalid("containers", "small_truncated", b"\x01\x00\x02", SmallContainer)
    # variable container with an offset pointing before the fixed part
    bad_offset = (3).to_bytes(8, "little") + (2).to_bytes(4, "little")
    yield _invalid("containers", "var_bad_offset", bad_offset, VarContainer)
    # first offset must equal the fixed-part length
    wrong_first = (3).to_bytes(8, "little") + (13).to_bytes(4, "little") + b"\x00"
    yield _invalid("containers", "var_wrong_first_offset", wrong_first, VarContainer)


def make_cases():
    for handler, suite, name, case_fn in _cases():
        yield TestCase(
            fork_name="phase0",
            preset_name="general",
            runner_name="ssz_generic",
            handler_name=handler,
            suite_name=suite,
            case_name=name,
            case_fn=case_fn,
        )


def main(args=None) -> int:
    provider = TestProvider(prepare=lambda: None, make_cases=make_cases)
    return run_generator("ssz_generic", [provider], args=args)


if __name__ == "__main__":
    sys.exit(main())
