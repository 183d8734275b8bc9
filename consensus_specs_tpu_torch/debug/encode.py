"""SSZ View -> YAML/JSON-friendly plain-data encoder of the port (the
counterpart of consensus_specs_tpu/debug/encode.py).

Fills the role of reference eth2spec/debug/encode.py:8-41 (own
implementation over this repo's ssz_typing). uints render as strings when
they exceed 64 bits (YAML integer safety), byte types as 0x-hex, containers
as dicts (optionally annotated with per-field hash_tree_roots).
"""
from ..utils.ssz.ssz_typing import (
    Bitlist, Bitvector, ByteList, ByteVector, Container, List, Union, Vector,
    boolean, uint,
)


def encode(value, include_hash_tree_roots=False):
    if isinstance(value, boolean):
        return bool(value)
    if isinstance(value, uint):
        if type(value).TYPE_BYTE_LENGTH > 8:
            return str(int(value))  # too wide for YAML int consumers
        return int(value)
    if isinstance(value, (ByteVector, ByteList)):
        return "0x" + bytes(value).hex()
    if isinstance(value, (Bitvector, Bitlist)):
        return "0x" + value.encode_bytes().hex()
    if isinstance(value, (Vector, List)):
        return [encode(elem, include_hash_tree_roots) for elem in value]
    if isinstance(value, Container):
        out = {}
        for name in value.fields():
            field = getattr(value, name)
            out[name] = encode(field, include_hash_tree_roots)
            if include_hash_tree_roots:
                out[name + "_hash_tree_root"] = "0x" + field.hash_tree_root().hex()
        if include_hash_tree_roots:
            out["hash_tree_root"] = "0x" + value.hash_tree_root().hex()
        return out
    if isinstance(value, Union):
        inner = None if value.value is None else encode(value.value, include_hash_tree_roots)
        return {"selector": int(value.selector), "value": inner}
    raise TypeError(f"cannot encode {type(value)}")
