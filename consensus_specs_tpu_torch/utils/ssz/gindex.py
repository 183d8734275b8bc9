"""Generalized indices for SSZ Merkle trees.

Capability parity with reference ssz/merkle-proofs.md:58-248 (the reference
implements this via remerkleable's ``Path`` type, wired in at spec-build time
— reference setup.py:466-472). Spec modules import ``get_generalized_index``
and the altair light client hardcodes the two indices it needs with a
build-time assertion against these values (reference setup.py:476-481).

A generalized index addresses a node in the Merkle tree of an SSZ object:
the root is 1 and the children of node ``i`` are ``2i`` and ``2i+1``
(merkle-proofs.md:58-78).
"""
from typing import Type

from .ssz_typing import (
    Bitlist, Bitvector, ByteList, ByteVector, Container, List, Vector, View,
    chunk_count, is_basic_type, next_power_of_two,
)


class GeneralizedIndex(int):
    """A generalized Merkle-tree index (merkle-proofs.md:58-67)."""


def _item_length(typ: Type[View]) -> int:
    """Byte length of one packed element (merkle-proofs.md:89-98)."""
    if is_basic_type(typ):
        return typ.type_byte_length()
    return 32


def get_elem_type(typ: Type[View], index_or_field) -> Type[View]:
    """Type of the element addressed by a field name or element index
    (merkle-proofs.md:100-110)."""
    if issubclass(typ, Container) and isinstance(index_or_field, str):
        return typ.fields()[index_or_field]
    if issubclass(typ, (List, Vector)):
        return typ.ELEM_TYPE
    if issubclass(typ, (ByteList, ByteVector)):
        from .ssz_typing import uint8

        return uint8
    if issubclass(typ, (Bitvector, Bitlist)):
        from .ssz_typing import boolean

        return boolean
    raise TypeError(f"cannot index into {typ}")


def get_generalized_index(typ: Type[View], *path) -> GeneralizedIndex:
    """Generalized index of the node addressed by ``path`` — a sequence of
    field names (containers), element indices (vectors/lists/bitfields), or
    the sentinel ``'__len__'`` for a list's length mix-in
    (merkle-proofs.md:149-172).
    """
    root = GeneralizedIndex(1)
    for p in path:
        if p == "__len__":
            if not issubclass(typ, (List, ByteList, Bitlist)):
                raise TypeError(f"{typ} has no length mix-in")
            typ = None  # terminal
            root = GeneralizedIndex(root * 2 + 1)
            continue
        if issubclass(typ, Container) and isinstance(p, str):
            names = list(typ.fields())
            pos = names.index(p)
            base = next_power_of_two(len(names))
            root = GeneralizedIndex(root * base + pos)
            typ = typ.fields()[p]
            continue
        # series: account for the length mix-in (lists/bitlists), packing of
        # basic elements, and the bottom-layer padding to a power of two
        pos = int(p)
        elem = get_elem_type(typ, pos)
        packed_pos = pos * _item_length(elem) // 32 if not issubclass(
            typ, (Bitvector, Bitlist)
        ) else pos // 256
        base = next_power_of_two(chunk_count(typ))
        if issubclass(typ, (List, ByteList, Bitlist)):
            root = GeneralizedIndex(root * 2)  # descend into the data subtree
        root = GeneralizedIndex(root * base + packed_pos)
        typ = elem
    return root


def concat_generalized_indices(*indices: GeneralizedIndex) -> GeneralizedIndex:
    """Index of the node addressed by following each index in turn
    (merkle-proofs.md:174-186)."""
    o = GeneralizedIndex(1)
    for i in indices:
        floorpow = 1 << (int(i).bit_length() - 1)
        o = GeneralizedIndex(o * floorpow + (i - floorpow))
    return o


def get_generalized_index_length(index: GeneralizedIndex) -> int:
    """Depth of the node (merkle-proofs.md:188-196)."""
    return int(index).bit_length() - 1


def get_generalized_index_bit(index: GeneralizedIndex, position: int) -> bool:
    """Bit of the path at ``position`` (merkle-proofs.md:198-204)."""
    return (int(index) & (1 << position)) > 0


def generalized_index_sibling(index: GeneralizedIndex) -> GeneralizedIndex:
    return GeneralizedIndex(int(index) ^ 1)


def generalized_index_child(index: GeneralizedIndex, right_side: bool) -> GeneralizedIndex:
    return GeneralizedIndex(int(index) * 2 + int(right_side))


def generalized_index_parent(index: GeneralizedIndex) -> GeneralizedIndex:
    return GeneralizedIndex(int(index) // 2)
