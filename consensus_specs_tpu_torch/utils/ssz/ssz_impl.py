"""SSZ facade: serialize / hash_tree_root / copy / uint_to_bytes.

(reference: tests/core/pyspec/eth2spec/utils/ssz/ssz_impl.py:8-25)
"""
from typing import TypeVar

from .ssz_typing import View, uint

V = TypeVar("V", bound=View)


def serialize(obj: View) -> bytes:
    return obj.encode_bytes()


def hash_tree_root(obj: View) -> "bytes":
    from time import perf_counter

    from ...merkle import levels as _levels
    from .ssz_typing import Bytes32

    t0 = perf_counter()
    root = Bytes32(obj.hash_tree_root())
    _levels.note_root_seconds(perf_counter() - t0)
    if _levels.diff_enabled():
        # CONSENSUS_SPECS_TPU_MERKLE_DIFF=1: re-derive through the pure
        # python oracle on a cold decode and demand bit-identity
        from ...merkle import plane as _plane

        _plane.diff_check(obj, root)
    return root


def uint_to_bytes(n: uint) -> bytes:
    return n.encode_bytes()


def copy(obj: V) -> V:
    return obj.copy()
