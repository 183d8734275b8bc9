"""Plain data -> SSZ View decoder of the port (inverse of debug/encode.py;
the counterpart of consensus_specs_tpu/debug/decode.py).

Fills the role of reference eth2spec/debug/decode.py:9-42 (own
implementation): rebuilds a typed View from encoder output, re-checking any
embedded hash_tree_root annotations along the way.
"""
from ..utils.ssz.ssz_typing import (
    Bitlist, Bitvector, ByteList, ByteVector, Container, List, Union, Vector,
    boolean, uint,
)


def _bits_from_hex(typ, hexstr, length=None):
    data = bytes.fromhex(hexstr[2:])
    return typ.decode_bytes(data)


def decode(data, typ):
    if issubclass(typ, (uint, boolean)):
        return typ(int(data))
    if issubclass(typ, (ByteVector, ByteList)):
        return typ(bytes.fromhex(data[2:]))
    if issubclass(typ, (Bitvector, Bitlist)):
        return _bits_from_hex(typ, data)
    if issubclass(typ, (Vector, List)):
        return typ([decode(elem, typ.ELEM_TYPE) for elem in data])
    if issubclass(typ, Container):
        values = {}
        for name, field_typ in typ.fields().items():
            values[name] = decode(data[name], field_typ)
            if name + "_hash_tree_root" in data:
                expected = data[name + "_hash_tree_root"].lower()
                got = "0x" + values[name].hash_tree_root().hex()
                assert got == expected, f"{name}: root mismatch {got} != {expected}"
        out = typ(**values)
        if "hash_tree_root" in data:
            expected = data["hash_tree_root"].lower()
            got = "0x" + out.hash_tree_root().hex()
            assert got == expected, f"container root mismatch {got} != {expected}"
        return out
    if issubclass(typ, Union):
        selector = int(data["selector"])
        inner_typ = typ.OPTIONS[selector]
        inner = None if inner_typ is None else decode(data["value"], inner_typ)
        return typ(selector=selector, value=inner)
    raise TypeError(f"cannot decode into {typ}")
