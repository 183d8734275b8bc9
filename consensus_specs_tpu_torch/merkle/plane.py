"""Cross-element batched cold Merkleization (the ≥5x cold-root lever).

A cold ``List[Validator]``/``Vector[Bytes48]`` build is where the pure
python path burns its time: every element pays its own
``hash_tree_root`` — a python call tree plus ~2·chunks tiny hashlib
invocations, far below the ``MIN_NATIVE_PAIRS`` batching threshold, so
per-tree level batching never engages. This module turns the loop
sideways: it computes the roots of ALL elements of a series COLUMN-WISE
— one numpy interleave per field column, then one
``sha256_hash_many`` call per TREE LEVEL spanning every element at once
(8 native calls for a million Validators instead of ~9M hashlib calls).

Only statically-shaped element types batch: basics, ``ByteVector``,
``Bitvector``, ``Vector`` (packed or composite), and ``Container``s of
those. Anything with a length mix-in inside (List/Bitlist/ByteList) or
a Union returns ``None`` — the caller falls back to the per-element
walk and ``merkle.fallbacks`` counts it. Supported or not, roots are
bit-identical to the oracle by construction (zero-chunk padding at
level 0 reduces to exactly the sparse ZERO_HASHES rule), and the merkle
smoke + ``CONSENSUS_SPECS_TPU_MERKLE_DIFF=1`` assert it continuously.

This module imports the SSZ engine, so it must only ever be imported
LAZILY from ``ssz_typing`` (which imports ``merkle/levels`` at import
time — the reverse edge would cycle).
"""
from operator import attrgetter
from typing import List, Optional, Sequence

import numpy as np

from . import levels as _levels
from ..utils.ssz.ssz_typing import (
    Bitvector,
    ByteVector,
    Container,
    List as SSZList,
    Vector,
    _bits_to_bytes,
    is_basic_type,
    next_power_of_two,
)

# cross-element batching only pays past a handful of elements; below
# this the per-element walk is as fast and keeps its caches warmer
MIN_PLANE_ELEMS = 8

_PLAN_CACHE = {}


def _supported(typ) -> bool:
    """Statically-shaped element types whose column roots we can batch."""
    cached = _PLAN_CACHE.get(typ)
    if cached is not None:
        return cached
    if is_basic_type(typ):
        ok = True
    elif isinstance(typ, type) and issubclass(typ, (ByteVector, Bitvector)):
        ok = True
    elif isinstance(typ, type) and issubclass(typ, Container):
        ok = all(_supported(t) for t in typ._field_types.values())
    elif (isinstance(typ, type) and issubclass(typ, Vector)
          and not issubclass(typ, SSZList)):
        ok = _supported(typ.ELEM_TYPE)
    else:
        ok = False
    _PLAN_CACHE[typ] = ok
    return ok


def _reduce_rows(blob: bytes, width: int) -> bytes:
    """Merkleize N independent chunk rows of ``width`` (a power of two)
    laid out contiguously: each reduction level is one batched hash call
    across every row at once. Returns the N concatenated roots."""
    while width > 1:
        blob = _levels.hash_pair_blob(blob)
        width >>= 1
    return blob


def _pad_rows(raw: bytes, n: int, row_bytes: int, padded_bytes: int) -> bytes:
    """Lay N rows of ``row_bytes`` into zero-padded rows of
    ``padded_bytes`` (one numpy scatter, no per-row python)."""
    if row_bytes == padded_bytes:
        return raw
    rows = np.zeros((n, padded_bytes), dtype=np.uint8)
    rows[:, :row_bytes] = np.frombuffer(raw, dtype=np.uint8).reshape(
        n, row_bytes)
    return rows.tobytes()


_UINT_DTYPES = {1: np.uint8, 2: np.dtype("<u2"), 4: np.dtype("<u4"),
                8: np.dtype("<u8")}


def _basic_raw(typ, values: Sequence) -> bytes:
    """Little-endian packed encoding of a basic-typed column. Machine-word
    sizes go through one numpy ``fromiter`` instead of a per-value
    ``encode_bytes`` call — the dominant python cost of a cold column."""
    es = typ.type_byte_length()
    dt = _UINT_DTYPES.get(es)
    if dt is not None:
        # basic views are int subclasses — numpy consumes them directly
        return np.fromiter(values, dtype=dt, count=len(values)).tobytes()
    return b"".join(v.encode_bytes() for v in values)


def packed_basic_raw(typ, values: Sequence) -> Optional[bytes]:
    """Packed little-endian encoding of a basic series for the cold
    ``_chunks_root`` build, or ``None`` for non-machine-word widths
    (caller keeps its per-element join)."""
    if typ.type_byte_length() not in _UINT_DTYPES:
        return None
    return _basic_raw(typ, values)


def _column_roots(typ, values: Sequence) -> bytes:
    """Concatenated 32-byte hash_tree_roots of a COLUMN of same-typed
    values — the recursive core. ``typ`` must be ``_supported``."""
    n = len(values)
    if is_basic_type(typ):
        es = typ.type_byte_length()
        return _pad_rows(_basic_raw(typ, values), n, es, 32)
    if issubclass(typ, ByteVector):
        length = typ.LENGTH
        raw = b"".join(bytes(v) for v in values)
        if length <= 32:
            return _pad_rows(raw, n, length, 32)
        width = next_power_of_two((length + 31) // 32)
        return _reduce_rows(_pad_rows(raw, n, length, width * 32), width)
    if issubclass(typ, Bitvector):
        nbytes = (typ.LENGTH + 7) // 8
        raw = b"".join(_bits_to_bytes(v._bits) for v in values)
        width = next_power_of_two((nbytes + 31) // 32)
        return _reduce_rows(_pad_rows(raw, n, nbytes, width * 32), width)
    if issubclass(typ, Container):
        fields = list(typ._field_types.items())
        width = next_power_of_two(len(fields))
        rows = np.zeros((n, width, 32), dtype=np.uint8)
        for f, (name, ftyp) in enumerate(fields):
            # C-level column extraction (fields are plain instance
            # attributes; a python-loop getattr per cell dominates the
            # cold build otherwise)
            col = _column_roots(ftyp, list(map(attrgetter(name), values)))
            rows[:, f, :] = np.frombuffer(col, dtype=np.uint8).reshape(n, 32)
        return _reduce_rows(rows.tobytes(), width)
    if issubclass(typ, Vector):
        etyp = typ.ELEM_TYPE
        m = typ.LENGTH
        if is_basic_type(etyp):
            es = etyp.type_byte_length()
            raw = _basic_raw(etyp, [e for v in values for e in v._elems])
            width = next_power_of_two((m * es + 31) // 32)
            return _reduce_rows(_pad_rows(raw, n, m * es, width * 32), width)
        flat = [e for v in values for e in v._elems]
        sub = _column_roots(etyp, flat)
        width = next_power_of_two(m)
        return _reduce_rows(_pad_rows(sub, n, m * 32, width * 32), width)
    raise TypeError(f"unplanned column type {typ!r}")


def batched_element_roots(elems: Sequence) -> Optional[List[bytes]]:
    """Roots of every element of a composite series in one column-wise
    batched pass, or ``None`` when the plane is off / the element type
    carries dynamic shape (caller falls back to the per-element walk)."""
    n = len(elems)
    if n < MIN_PLANE_ELEMS or not _levels.plane_enabled():
        return None
    typ = type(elems[0])
    if not _supported(typ):
        _levels.counters["fallbacks"] += 1
        return None
    blob = _column_roots(typ, elems)
    return [blob[i << 5 : (i + 1) << 5] for i in range(n)]


def diff_check(obj, root: bytes) -> None:
    """The CONSENSUS_SPECS_TPU_MERKLE_DIFF=1 assert: re-derive ``root``
    through the pure-python oracle on a FRESH decode (cold caches, no
    native calls, no plane) and demand bit-identity."""
    with _levels.forced_mode("python"):
        fresh = type(obj).decode_bytes(obj.encode_bytes())
        oracle = bytes(fresh.hash_tree_root())
    if oracle != bytes(root):
        raise AssertionError(
            f"MERKLE DIVERGED: {type(obj).__name__} native root "
            f"{bytes(root).hex()} != python oracle {oracle.hex()}"
        )
