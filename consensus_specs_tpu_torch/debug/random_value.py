"""Seeded random SSZ object construction for every View type, in the port
(the counterpart of consensus_specs_tpu/debug/random_value.py).

Fills the role of reference eth2spec/debug/random_value.py:17-169 (own
implementation over this repo's ssz_typing): six randomization modes plus a
chaos toggle; the ssz_static generator samples every Container subclass of
every built spec with these.
"""
from enum import Enum
from random import Random
from typing import Type

from ..utils.ssz.ssz_typing import (
    Bitlist, Bitvector, ByteList, ByteVector, Container, List, Union, Vector,
    View, boolean, uint,
)

random_mode_names = ("random", "zero", "max", "nil", "one", "lengthy")


class RandomizationMode(Enum):
    mode_random = 0      # random content and lengths
    mode_zero = 1        # zero values everywhere
    mode_max = 2         # max basic values, single-element collections
    mode_nil_count = 3   # empty variable-size collections
    mode_one_count = 4   # single-element collections, random content
    mode_max_count = 5   # limit-length collections, random content

    def to_name(self):
        return random_mode_names[self.value]

    def is_changing(self):
        return self.value in (0, 4, 5)


def _random_bytes(rng: Random, n: int) -> bytes:
    return bytes(rng.getrandbits(8) for _ in range(n))


def _basic(rng: Random, typ, mode: RandomizationMode):
    if issubclass(typ, boolean):
        if mode == RandomizationMode.mode_zero:
            return typ(False)
        if mode == RandomizationMode.mode_max:
            return typ(True)
        return typ(rng.choice((True, False)))
    width = typ.TYPE_BYTE_LENGTH * 8
    if mode == RandomizationMode.mode_zero:
        return typ(0)
    if mode == RandomizationMode.mode_max:
        return typ((1 << width) - 1)
    return typ(rng.getrandbits(width))


def _collection_length(rng: Random, mode: RandomizationMode, limit: int,
                       max_random: int) -> int:
    if mode == RandomizationMode.mode_nil_count:
        return 0
    if mode == RandomizationMode.mode_one_count:
        return min(1, limit)
    if mode in (RandomizationMode.mode_max_count, RandomizationMode.mode_max):
        return min(limit, max_random) if mode == RandomizationMode.mode_max_count else min(1, limit)
    if mode == RandomizationMode.mode_zero:
        return 0
    return rng.randint(0, min(limit, max_random))


def get_random_ssz_object(rng: Random, typ: Type[View], max_bytes_length: int,
                          max_list_length: int, mode: RandomizationMode,
                          chaos: bool = False) -> View:
    if chaos:
        mode = rng.choice(list(RandomizationMode))

    if issubclass(typ, ByteVector):
        if mode == RandomizationMode.mode_zero:
            return typ(b"\x00" * typ.LENGTH)
        if mode == RandomizationMode.mode_max:
            return typ(b"\xff" * typ.LENGTH)
        return typ(_random_bytes(rng, typ.LENGTH))
    if issubclass(typ, ByteList):
        n = _collection_length(rng, mode, typ.LIMIT, max_bytes_length)
        fill = (b"\xff" if mode == RandomizationMode.mode_max else None)
        return typ(fill * n if fill else _random_bytes(rng, n))
    if issubclass(typ, Bitvector):
        if mode == RandomizationMode.mode_zero:
            return typ([False] * typ.LENGTH)
        if mode == RandomizationMode.mode_max:
            return typ([True] * typ.LENGTH)
        return typ([rng.choice((True, False)) for _ in range(typ.LENGTH)])
    if issubclass(typ, Bitlist):
        n = _collection_length(rng, mode, typ.LIMIT, max_list_length)
        if mode == RandomizationMode.mode_max:
            return typ([True] * n)
        return typ([rng.choice((True, False)) for _ in range(n)])
    if issubclass(typ, (uint, boolean)):
        return _basic(rng, typ, mode)
    if issubclass(typ, Vector):
        return typ([
            get_random_ssz_object(rng, typ.ELEM_TYPE, max_bytes_length,
                                  max_list_length, mode, chaos)
            for _ in range(typ.LENGTH)
        ])
    if issubclass(typ, List):
        n = _collection_length(rng, mode, typ.LIMIT, max_list_length)
        return typ([
            get_random_ssz_object(rng, typ.ELEM_TYPE, max_bytes_length,
                                  max_list_length, mode, chaos)
            for _ in range(n)
        ])
    if issubclass(typ, Container):
        return typ(**{
            name: get_random_ssz_object(rng, field_typ, max_bytes_length,
                                        max_list_length, mode, chaos)
            for name, field_typ in typ.fields().items()
        })
    if issubclass(typ, Union):
        selector = rng.randrange(len(typ.OPTIONS)) if mode.is_changing() else 0
        inner_typ = typ.OPTIONS[selector]
        if inner_typ is None:
            return typ(selector=selector)
        return typ(selector=selector, value=get_random_ssz_object(
            rng, inner_typ, max_bytes_length, max_list_length, mode, chaos
        ))
    raise TypeError(f"cannot randomize {typ}")
